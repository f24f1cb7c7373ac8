"""The plain references against brute force at small sizes: duplicate
keys, INT64_MIN and INT64_MAX keys, empty sides, wrapping sums, every
filter op; and the comparisons' rules (multisets, order, overflow)."""

from __future__ import annotations

import random

import pytest
import torch

import tiny_cells  # noqa: F401  (the repo's root on the path)
from benchmark.harness.compare import canonical, count_wrong, nonzero_past, rows_differ
from benchmark.harness.streams import Relation
from benchmark.reference import join as rjoin
from benchmark.reference import pipeline as rpipe

I64_MIN, I64_MAX = -2**63, 2**63 - 1
MASK = 2**64 - 1


def wrap(x: int) -> int:
    x &= MASK
    return x - 2**64 if x >= 2**63 else x


def relation(keys, payload_cols, seed):
    rng = random.Random(seed)
    cols = {"key": torch.tensor(keys, dtype=torch.int64)}
    for j in range(payload_cols):
        cols[f"p{j}"] = torch.tensor([rng.randrange(I64_MIN, I64_MAX) for _ in keys],
                                     dtype=torch.int64)
    return {n: c.reshape(-1) for n, c in cols.items()}


def brute_join(build, probe):
    rows = []
    bn = [n for n in build if n != "key"]
    pn = [n for n in probe if n != "key"]
    for i in range(len(build["key"])):
        for j in range(len(probe["key"])):
            if int(build["key"][i]) == int(probe["key"][j]):
                rows.append((int(probe["key"][j]), *[int(build[n][i]) for n in bn],
                             *[int(probe[n][j]) for n in pn]))
    return sorted(rows)


KEY_SETS = {
    "duplicates": ([1, 1, 2, 3, 3, 3, 9], [3, 1, 1, 7, 3, 2, 2, 2]),
    "extremes": ([I64_MIN, I64_MAX, 0, I64_MAX, -1], [I64_MAX, I64_MIN, I64_MIN, 5, -1]),
    "empty_build": ([], [1, 2, 3]),
    "empty_probe": ([1, 2], []),
    "both_empty": ([], []),
    "no_match": ([1, 2, 3], [4, 5, 6]),
}


@pytest.mark.parametrize("case", sorted(KEY_SETS))
def test_join_reference_is_brute_force(case):
    bk, pk = KEY_SETS[case]
    build, probe = relation(bk, 1, 1), relation(pk, 2, 2)
    got = rjoin.join(build, probe)
    assert list(got) == ["key", "r_p0", "s_p0", "s_p1"]
    rows = sorted(zip(*[got[n].tolist() for n in got]))
    assert rows == brute_join(build, probe)


def test_join_reference_random_against_brute_force():
    rng = random.Random(3)
    for _ in range(20):
        bk = [rng.randrange(-5, 6) for _ in range(rng.randrange(0, 40))]
        pk = [rng.randrange(-5, 6) for _ in range(rng.randrange(0, 40))]
        build, probe = relation(bk, 2, 4), relation(pk, 1, 5)
        got = rjoin.join(build, probe)
        assert sorted(zip(*[got[n].tolist() for n in got])) == brute_join(build, probe)


def brute_pipeline(dim, fact, col, op, value):
    ops = {"lt": lambda a: a < value, "le": lambda a: a <= value, "gt": lambda a: a > value,
           "ge": lambda a: a >= value, "eq": lambda a: a == value, "ne": lambda a: a != value}
    kept = {n: [v for v, k in zip(c.tolist(), fact[col].tolist()) if ops[op](k)]
            for n, c in fact.items()}
    kept = {n: torch.tensor(v, dtype=torch.int64) for n, v in kept.items()}
    groups = {}
    for row in brute_join(dim, kept):
        g = groups.setdefault(row[0], [0] * len(row))
        g[0] += 1
        for i, v in enumerate(row[1:], start=1):
            g[i] = wrap(g[i] + v)
    return [(k, *groups[k]) for k in sorted(groups)]


@pytest.mark.parametrize("op", ["lt", "le", "gt", "ge", "eq", "ne"])
@pytest.mark.parametrize("case", ["duplicates", "extremes", "empty_build", "no_match"])
def test_pipeline_reference_is_brute_force(op, case):
    bk, pk = KEY_SETS[case]
    dim, fact = relation(bk, 1, 6), relation(pk * 3, 2, 7)  # more fact rows a key
    value = 2 if case != "extremes" else 0
    got = rpipe.pipeline(dim, fact, "key", op, value)
    assert list(got) == ["key", "count", "sum_r_p0", "sum_s_p0", "sum_s_p1"]
    rows = list(zip(*[got[n].tolist() for n in got]))
    assert rows == brute_pipeline(dim, fact, "key", op, value)  # in ascending key order


def test_pipeline_reference_sums_wrap():
    dim = {"key": torch.tensor([4, 4, 4]), "p0": torch.full((3,), I64_MAX)}
    fact = {"key": torch.tensor([4] * 5), "p0": torch.full((5,), I64_MAX),
            "p1": torch.full((5,), I64_MIN)}
    got = rpipe.pipeline(dim, fact, "key", "lt", 10)
    assert got["count"].tolist() == [15]
    assert got["sum_r_p0"].tolist() == [wrap(15 * I64_MAX)]
    assert got["sum_s_p1"].tolist() == [wrap(15 * I64_MIN)]


def test_count_rule_exact_and_overflow():
    assert count_wrong([5, 5, 4], expected=5, capacity=8) == 1
    # past the capacity only a count past it is right: never truncated
    assert count_wrong([9, 8, 12], expected=12, capacity=8) == 1


def test_rows_compared_as_multisets_and_in_order():
    a = {"key": torch.tensor([3, 1, 2, 1]), "v": torch.tensor([30, 10, 20, 11])}
    perm = torch.tensor([2, 0, 3, 1])
    b = {n: c[perm] for n, c in a.items()}
    ca, cb = canonical(a, ["key", "v"]), canonical(b, ["key", "v"])
    assert rows_differ(ca, cb, ["key", "v"]) == 0
    assert rows_differ(a, b, ["key", "v"]) == 4  # in order, every row moved
    c = dict(a, v=torch.tensor([30, 10, 20, 12]))
    assert rows_differ(canonical(c, ["key", "v"]), ca, ["key", "v"]) == 1
    short = {n: v[:3] for n, v in ca.items()}
    assert rows_differ(short, ca, ["key", "v"]) == 1
    assert nonzero_past({"a": torch.tensor([1, 2, 0, 0]), "b": torch.tensor([1, 0, 3, 0])},
                        2) == 1


def _inputs(bk, pk):
    b, p = relation(bk, 1, 8), relation(pk, 2, 9)
    return {"build": Relation(b, len(bk)), "probe": Relation(p, len(pk))}


def test_wrong_rows_of_a_join_result():
    inputs = _inputs([1, 1, 2, 5], [1, 2, 2, 3, 5])
    exp = rjoin.expected({}, {}, inputs)
    cols = {n: c.flip(0) for n, c in exp.columns.items()}
    assert exp.count == 5 and rjoin.wrong_rows(exp, cols) == 0
    cols["s_p1"][0] += 1
    assert rjoin.wrong_rows(exp, cols) == 1
    assert rjoin.wrong_rows(exp, {"key": cols["key"]}) == exp.count  # columns missing


def test_least_bytes():
    inputs = _inputs([1, 1, 2, 5], [1, 2, 2, 3, 5])
    exp = rjoin.expected({}, {}, inputs)
    # R: 4 rows x 2 columns, S: 5 rows x 3 columns, 5 output rows x 4 columns
    assert rjoin.least_bytes(inputs, exp, 8) == 8 * (8 + 15 + 20) + 4
    assert rjoin.least_bytes(inputs, exp, 2) == 8 * (8 + 15 + 8) + 4
    traffic = {"filter": {"col": "key", "op": "lt", "value": 3}}
    pexp = rpipe.expected({}, traffic, inputs)
    # the whole output table: 16 rows of 5 columns, zeros past the groups included
    assert rpipe.least_bytes(inputs, pexp, 16) == 8 * (8 + 15 + 16 * 5) + 4


@pytest.mark.parametrize("module", [rjoin, rpipe])
def test_control_is_not_the_reference(module):
    big = [2**40 + i for i in range(6)]
    b = {"key": torch.tensor([1, 2, 3]), "p0": torch.tensor(big[:3])}
    p = {"key": torch.tensor([1, 2, 2]), "p0": torch.tensor(big[3:]),
         "p1": torch.tensor(big[:3])}
    inputs = {"build": Relation(b, 3), "probe": Relation(p, 3)}
    traffic = {"filter": {"col": "key", "op": "lt", "value": 10}}
    exp = module.expected({}, traffic, inputs)
    prepared = module.control({}, traffic, inputs, "cpu", 16)
    out = prepared.call()
    n = int(out.num_rows)
    assert n == exp.count
    assert module.wrong_rows(exp, {k: v[:n] for k, v in out.columns.items()}) > 0

