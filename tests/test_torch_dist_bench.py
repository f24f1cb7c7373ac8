"""Config 5's benchmark cell on the CPU (benchmark/queries/dist_join.py's
program): the planned distributed join with the lane local join on an
8-shard LocalMesh, held as a multiset to the benchmark's plain reference
(benchmark/reference/dist_join.py); the placement of device columns
against tpq's placement of numpy ones; the body's spans, its observed
exchange counters and the planner's entry in the per-call records. No
tpq call; small shapes, integer data, every comparison exact."""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.harness.compare import canonical, rows_differ
from benchmark.reference import dist_join as ref
from tpq_torch import datagen, trace
from tpq_torch.columnar import Table, next_pow2
from tpq_torch.dist import (DistTable, dist_hash_join, dist_hash_join_planned, make_mesh,
                            plan_dist_capacities)
from tpq_torch.jit import jit
from tpq_torch.ops import hash_join

torch.set_num_threads(2)

SHARDS = 8
N = SHARDS << 11  # rows a side
I64 = np.int64
EXTREMES = np.array([np.iinfo(I64).min, np.iinfo(I64).max, -1, 0], dtype=I64)


def _relation(keys: np.ndarray, seed: int) -> dict:
    pay = np.random.default_rng(seed).integers(0, 2**62, keys.shape[0], dtype=I64)
    return {"key": keys.astype(I64), "p0": pay}


def _case(name: str):
    """(R columns, S columns, the shard of each side left empty or None)."""
    rng = np.random.default_rng(11)
    if name == "uniform":
        r, s = (datagen.gen_relation_np(N, N, 1, seed) for seed in (1, 2))
        return r, s, None
    if name == "duplicates":  # 64 keys: every key some hundred times a side
        return (_relation(rng.integers(0, 64, N // 16), 3),
                _relation(rng.integers(0, 64, N // 16), 4), None)
    if name == "extremes":
        rk = np.concatenate([EXTREMES, EXTREMES[:2], rng.integers(-2**40, 2**40, N - 6)])
        sk = np.concatenate([EXTREMES, rng.integers(-2**40, 2**40, N - 4)])
        rng.shuffle(rk)
        rng.shuffle(sk)
        sk[:N // 2] = rk[:N // 2]  # half of S matches
        return _relation(rk, 5), _relation(sk, 6), None
    r, s = (datagen.gen_relation_np(N, N // 2, 1, seed) for seed in (7, 8))
    return r, s, 3


def _placed(cols: dict, mesh, empty) -> tuple[DistTable, dict]:
    """The relation placed on mesh, shard `empty` (if any) holding no
    rows; and the live columns the shards hold, as tensors."""
    t = DistTable.from_columns({k: torch.from_numpy(v) for k, v in cols.items()}, mesh)
    if empty is not None:
        sh = t.shards[empty]
        t.shards[empty] = Table(sh.columns, 0)
    live = [sh.to_numpy() for sh in t.shards]
    return t, {k: torch.from_numpy(np.concatenate([p[k] for p in live])) for k in cols}


def _union(result: DistTable) -> dict:
    parts = result.shards_numpy()
    return {n: torch.from_numpy(np.concatenate([p[n] for p in parts])) for n in parts[0]}


@pytest.mark.parametrize("case", ["uniform", "duplicates", "extremes", "empty_shard"])
def test_planned_join_equals_reference(case):
    r_cols, s_cols, empty = _case(case)
    mesh = make_mesh(SHARDS, "cpu")
    R, r_live = _placed(r_cols, mesh, empty)
    S, s_live = _placed(s_cols, mesh, empty)
    out, ovf = dist_hash_join_planned(R, S, mesh, local_impl="lane")
    assert ovf.tolist() == [0] * SHARDS
    want = ref.join(r_live, s_live)
    names = list(want)
    got = _union(out)
    assert list(got) == names
    assert got[names[0]].shape[0] == want[names[0]].shape[0] > 0
    assert rows_differ(canonical(got, names), canonical(want, names), names) == 0


def _tpq_placement(cols: dict, mesh) -> list:
    """tpq's placement shard by shard: per = ceil(n / shards) rows, shard
    i rows [i*per, (i+1)*per) padded by Table.from_numpy to
    next_pow2(per)."""
    n = len(next(iter(cols.values())))
    per = -(-n // mesh.size)
    return [Table.from_numpy({k: v[i * per:min(n, (i + 1) * per)] for k, v in cols.items()},
                             capacity=next_pow2(per), device=mesh.device)
            for i in mesh.shard_ids]


@pytest.mark.parametrize("rows,shards", [(1000, 3), (N + 5, SHARDS), (12, SHARDS)])
def test_from_columns_places_like_from_numpy(rows, shards):
    """Byte-equal shards, padding and row counts included, from tensors
    and from numpy columns (12 rows on 8 shards leave the last two
    empty)."""
    cols = datagen.gen_relation_np(rows, rows, 2, 9)
    mesh = make_mesh(shards, "cpu")
    want = _tpq_placement(cols, mesh)
    for got in (DistTable.from_columns({k: torch.from_numpy(v) for k, v in cols.items()},
                                       mesh),
                DistTable.from_numpy(cols, mesh)):
        assert len(got.shards) == shards
        for a, b in zip(got.shards, want):
            assert a.names == b.names and a.capacity == b.capacity
            assert int(a.num_rows) == int(b.num_rows)
            assert a.num_rows.dtype == b.num_rows.dtype == torch.int32
            for k in a.names:
                assert a.col(k).dtype == b.col(k).dtype
                assert torch.equal(a.col(k), b.col(k))


@pytest.fixture(scope="module")
def uniform():
    mesh = make_mesh(SHARDS, "cpu")
    r, s, _ = _case("uniform")
    return mesh, DistTable.from_numpy(r, mesh), DistTable.from_numpy(s, mesh)


def _recorded(fn, calls=1):
    before = len(trace.records())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(calls):
            fn()
    names = {e.name for e in prof.events() if e.name.startswith("tpq.")}
    return trace.records()[before:], names


def test_one_record_per_planned_call_with_the_plan(uniform):
    mesh, R, S = uniform
    ex_cap, out_cap = plan_dist_capacities(R, S, mesh)
    reads = plan_dist_capacities.host_reads
    recs, names = _recorded(lambda: dist_hash_join_planned(R, S, mesh, local_impl="lane"),
                            calls=2)
    assert plan_dist_capacities.host_reads - reads == 4
    assert len(recs) == 2
    for rec in recs:
        plan = rec["plan"]
        assert (plan["exchange_capacity"], plan["out_capacity_per_shard"]) == (ex_cap, out_cap)
        assert plan["host_reads"] == 2 and plan["ms"] > 0
    assert {"tpq.dist.plan", "tpq.dist.route", "tpq.dist.exchange", "tpq.dist.merge",
            "tpq.lane.build", "tpq.lane.layout", "tpq.lane.emit"} <= names


def test_observed_counters_count_the_exchange(uniform):
    """Every live row of R and of S is delivered once (no skew split, no
    overflow); the dense exchange fills nchips buckets a shard a side."""
    mesh, R, S = uniform
    recs, _ = _recorded(lambda: dist_hash_join_planned(R, S, mesh, local_impl="lane"))
    obs, plan = recs[-1]["observed"], recs[-1]["plan"]
    live = int(R.shard_rows.sum()) + int(S.shard_rows.sum())
    assert live == 2 * N
    assert obs["tpq.dist.exchange_rows"] == live
    assert obs["tpq.dist.exchange_slots"] == 2 * SHARDS * SHARDS * plan["exchange_capacity"]
    assert obs["tpq.dist.overflow"] == 0


def test_calls_without_a_planner_carry_no_plan(uniform):
    mesh, R, S = uniform
    lane = jit(functools.partial(hash_join, out_capacity=1 << 14, impl="lane"))
    r, s = R.shards[0], S.shards[0]
    recs, _ = _recorded(lambda: (dist_hash_join_planned(R, S, mesh, local_impl="lane"),
                                 lane(r, s),
                                 dist_hash_join(R, S, mesh, 1 << 13, local_impl="lane")))
    assert len(recs) == 3
    assert "plan" in recs[0] and "plan" not in recs[1] and "plan" not in recs[2]


def test_top_level_spans_tile_the_body(uniform, monkeypatch):
    """Under a capture's marks (stamps stood in for on the CPU) the body's
    top-level spans are the dist spans and each shard's lane spans, none
    of the lane spans inside a dist span."""
    mesh, R, S = uniform
    monkeypatch.setattr(trace.Marks, "mark", lambda self: self.stamps.append(None))
    ex_cap, out_cap = plan_dist_capacities(R, S, mesh)
    marks = trace.Marks(torch.device("cpu"))
    with trace.capturing(marks):
        dist_hash_join(R, S, mesh, out_cap, ex_cap, local_impl="lane", eager=True)
        marks.finish()
    want = (["tpq.dist.route", "tpq.dist.exchange"] + ["tpq.lane.build"] * SHARDS
            + ["tpq.dist.exchange"] + ["tpq.lane.layout", "tpq.lane.emit"] * SHARDS
            + ["tpq.dist.merge"])
    assert marks.spans == want
    assert len(marks.stamps) == len(want) + 1 and marks.depth == 0
