"""tpq_torch.jit on the CPU: the bodies it captures on the card (the
lane, sorted and skew joins, the merge join on both sort engines, and
the pipeline) run with the capture flag set (`jit.deferred`) and make no
host read, each cond recording its pred; a false pred, where the jitted
call reruns eagerly, is reported and the eager join equals the C++
oracle; jit(fn) on CPU tensors is fn; the eager lane and skew joins read
the host once. The graphs themselves run on the card only
(tests/test_torch_cuda.py). No tpq call: the lane and skew bodies are
held to tpq in test_torch_lane.py and test_torch_skew.py. Integer data:
every comparison is exact."""

import dataclasses
import functools

import numpy as np
import pytest
import torch
import torch_skew_cases as skew_cases
from torch_host_reads import host_reads

from tpq_torch import Table, colio, datagen
from tpq_torch.columnar import canonicalize
from tpq_torch.jit import (_addresses, _flatten, _Graph, _unflatten, cond, decided,
                           deferred, jit)
from tpq_torch.kernels.lane2 import build_lane2_tables, plan_lane2
from tpq_torch.ops import hash_join, merge_join
from tpq_torch.query import full_pipeline, jit_pipeline

from conftest import assert_tables_equal
import torch_oracle  # noqa: F401  (builds the oracle before any test runs)

torch.set_num_threads(2)

CAP = 1 << 14
# few duplicate keys: every body's pred holds
R_NP = datagen.gen_relation_np(1000, 1000, payloads=2, seed=11)
S_NP = datagen.gen_relation_np(1500, 1000, payloads=1, seed=22)
# about 3.3 build rows a key: the union engine's small tail overflows
DENSE_R = datagen.gen_relation_np(1000, 300, payloads=2, seed=11)
DENSE_S = datagen.gen_relation_np(1500, 300, payloads=1, seed=22)


def _t(cols) -> Table:
    return Table.from_numpy(cols, device="cpu")


BODIES = {
    "lane": lambda r, s: hash_join(r, s, CAP, impl="lane"),
    "sorted": lambda r, s: hash_join(r, s, CAP, impl="sorted"),
    "skew": lambda r, s: hash_join(r, s, CAP, impl="skew"),
    "merge_lax": lambda r, s: merge_join(r, s, CAP),
    "merge_radix": lambda r, s: merge_join(r, s, CAP, sort_engine="radix"),
}
PIPELINES = [("hash", "lane"), ("hash", "sorted"), ("hash", "skew"), ("merge", "sorted")]


def _oracle_join(oracle, tmp_path, r, s, tag):
    pr, ps, po = (tmp_path / f"{tag}_{x}.tpqc" for x in ("r", "s", "out"))
    colio.dump(str(pr), r)
    colio.dump(str(ps), s)
    oracle("join", algo="hash", left=pr, right=ps, out=po)
    return colio.load(str(po))


@pytest.mark.parametrize("name", list(BODIES))
def test_join_body_makes_no_host_read(name):
    """Under the capture flag the body runs through with every host read
    raising; its conds record one pred each (the lane join's `ok`, the
    union engine's small tail, the skew join's `ok`), all true here, and
    its rows are the eager join's."""
    r, s = _t(R_NP), _t(S_NP)
    with deferred() as preds, host_reads("raise"):
        out = BODIES[name](r, s)
    assert len(preds) == 1 and all(bool(p) for p in preds)
    assert int(out.num_rows) > 0
    assert_tables_equal(canonicalize(out), canonicalize(BODIES[name](r, s)), name)


@pytest.mark.parametrize("algo,impl", PIPELINES)
def test_pipeline_body_makes_no_host_read(algo, impl):
    """The pipeline with filter_value as a device scalar (how jit passes
    a traced number): no host read, two preds (the join's, then the
    aggregate's table `ok`), both true, the eager pipeline's rows at the
    Python number."""
    dim = _t(datagen.gen_relation_np(512, 512, payloads=1, seed=7))
    fact = _t(datagen.gen_relation_np(4096, 512, payloads=2, seed=8))
    with deferred() as preds, host_reads("raise"):
        out = full_pipeline(dim, fact, "key", "lt", torch.tensor(200), 1 << 13,
                            algo=algo, join_impl=impl)
    assert len(preds) == 2 and all(bool(p) for p in preds)
    want = full_pipeline(dim, fact, "key", "lt", 200, 1 << 13, algo=algo,
                         join_impl=impl)
    assert int(out.num_rows) == int(want.num_rows) > 0
    assert_tables_equal(canonicalize(out), canonicalize(want), f"{algo}_{impl}")


def _h2_pair():
    k1, k2 = 7302945295039616556, 3449075177175606448  # same (bucket, h2)
    r = {"key": np.array([k1, k2, 5, 6, 7], dtype=np.int64),
         "p0": np.arange(5, dtype=np.int64)}
    s = {"key": np.array([k1, k2, k1, 6], dtype=np.int64),
         "p0": np.arange(4, dtype=np.int64) * 10}
    return r, s, 1 << 8, "lane"


FALSE_CASES = {
    # tests/test_kernels.py:173's pair: the build's h2 hazard clears `ok`
    "lane_h2_collision": _h2_pair,
    # the heavy matches pass the heavy buffer (test_torch_skew.py)
    "skew_heavy_overflow": lambda: (*skew_cases.heavy_case(10, 1000),
                                    skew_cases.OUT_CAPACITY, "skew"),
    # the union engine's small tail overflows its caps
    "sorted_dense": lambda: (DENSE_R, DENSE_S, CAP, "sorted"),
}


@pytest.mark.parametrize("case", list(FALSE_CASES))
def test_false_pred_reported_and_rerun_exact(oracle, tmp_path, case):
    """The body reports its pred false under the capture flag (so a
    replay is discarded) and runs through without a host read; the
    eager call, which the jitted call reruns, equals the C++ oracle."""
    r_np, s_np, cap, impl = FALSE_CASES[case]()
    r, s = _t(r_np), _t(s_np)
    with deferred() as preds, host_reads("raise"):
        hash_join(r, s, cap, impl=impl)
    assert preds and not all(bool(p) for p in preds)
    jitted = jit(functools.partial(hash_join, out_capacity=cap, impl=impl))
    out = jitted(r, s)
    assert jitted.reruns == 0  # on the CPU jit(fn) is fn: nothing to rerun
    assert_tables_equal(canonicalize(out),
                        _oracle_join(oracle, tmp_path, r_np, s_np, case), case)


@pytest.mark.parametrize("name", list(BODIES) + ["pipeline"])
def test_jit_on_cpu_is_the_function(name):
    """jit(fn) on CPU tensors calls fn: the same rows, no graph kept."""
    r, s = _t(DENSE_R), _t(DENSE_S)
    if name == "pipeline":
        jitted = jit_pipeline(CAP, join_impl="lane")
        got, want = jitted(r, s, 150), jitted.__wrapped__(r, s, 150)
    else:
        jitted = jit(BODIES[name])
        got, want = jitted(r, s), BODIES[name](r, s)
    assert int(got.num_rows) == int(want.num_rows) > 0
    for k in want.columns:
        assert torch.equal(got.columns[k], want.columns[k]), k
    assert jitted.reruns == 0 and not jitted._graphs


@pytest.mark.parametrize("impl", ["lane", "skew"])
def test_eager_join_reads_the_host_once(impl):
    """Eager, the lane join's one cond and the skew join's one cond are
    its only host reads (the lane tail no longer reads its size)."""
    r, s = _t(R_NP), _t(S_NP)
    with host_reads("count") as made:
        out = hash_join(r, s, CAP, impl=impl)
    assert made == ["__bool__"]
    assert int(out.num_rows) > 0


def test_cond_eager_and_deferred():
    calls = []
    then_fn = lambda: calls.append("then") or 1  # noqa: E731
    else_fn = lambda: calls.append("else") or 2  # noqa: E731
    assert cond(torch.tensor(False), then_fn, else_fn) == 2
    assert cond(torch.tensor(True), then_fn, else_fn) == 1
    with deferred() as preds:
        assert cond(torch.tensor(False), then_fn, else_fn) == 1
    assert calls == ["else", "then", "then"] and [bool(p) for p in preds] == [False]


def test_signature_traces_numbers_and_keeps_statics():
    """What keys a graph: a Python number passed as an argument is a leaf
    (its value is not in the key); a Table's names, dtypes and capacity,
    a tensor's shape and dtype, and nested plain values (a lane plan's
    ints) are. The structure rebuilds from its leaves."""
    r, s = _t(R_NP), _t(S_NP)
    tables = build_lane2_tables(r, plan_lane2(r.capacity, s.capacity))

    def key(*args):
        leaves = []
        return tuple(_flatten(a, leaves, top=True) for a in args), leaves

    k1, leaves = key(r, tables, 512, "lt")
    k2, _ = key(r, tables, 300, "lt")
    assert k1 == k2
    assert [x for x in leaves if not isinstance(x, torch.Tensor)] == [512]
    assert key(r, tables, 512, "ge")[0] != k1
    assert key(r, tables, 512.0, "lt")[0] != k1
    assert key(_t({**R_NP, "p2": R_NP["p0"]}), tables, 512, "lt")[0] != k1
    assert key(r.with_capacity(2 * r.capacity), tables, 512, "lt")[0] != k1
    it = iter(leaves)
    r2, tables2, v, op = (_unflatten(k, it) for k in k1)
    assert (v, op) == (512, "lt") and r2.columns["key"] is r.columns["key"]
    assert tables2.plan == tables.plan and tables2.key is tables.key
    assert dataclasses.astuple(tables2.plan) == dataclasses.astuple(tables.plan)


@pytest.mark.parametrize("case", list(FALSE_CASES))
def test_body_follows_the_decided_path(case):
    """The path an eager run takes (`decided`: the lane or skew join's
    false `ok`, then the union engine's own cond) traced again under the
    capture flag along that path, as jit captures a rerun's path: each
    cond takes its recorded branch and records a pred that agrees with
    it, no host read is made, and the rows are the eager join's."""
    r_np, s_np, cap, impl = FALSE_CASES[case]()
    r, s = _t(r_np), _t(s_np)
    with decided() as path:
        want = hash_join(r, s, cap, impl=impl)
    assert path and not all(path)
    with deferred(tuple(path)) as preds, host_reads("raise"):
        got = hash_join(r, s, cap, impl=impl)
    assert [bool(p) for p in preds] == path
    assert int(got.num_rows) == int(want.num_rows) > 0
    assert_tables_equal(canonicalize(got), canonicalize(want), case)


def test_cond_follows_a_path_and_decided_records_it():
    """Under a path, the k-th cond takes the path's branch whatever its
    pred and records the pred; a cond past the path raises. Under
    `decided`, cond reads its pred and records the branch it took."""
    then_fn, else_fn = (lambda: 1), (lambda: 2)
    with deferred((False, True)) as preds:
        assert cond(torch.tensor(True), then_fn, else_fn) == 2
        assert cond(torch.tensor(False), then_fn, else_fn) == 1
        with pytest.raises(RuntimeError):
            cond(torch.tensor(True), then_fn, else_fn)
    assert [bool(p) for p in preds] == [True, False]
    with decided() as taken:
        assert cond(torch.tensor(False), then_fn, else_fn) == 2
        assert cond(torch.tensor(True), then_fn, else_fn) == 1
    assert taken == [False, True]


def test_addresses_key_argument_positions():
    """A graph replays over the tensors at the places it was captured
    with: the same tensors in another order form one signature but
    another pointer key, the same call the same key; a view of the same
    data with other strides is another key; a number has none, so a
    graph finds moved only its pinned tensors' positions. Dicts flatten
    by their keys and rebuild from their leaves."""
    a = _t(datagen.gen_relation_np(1000, 1000, payloads=1, seed=1))
    b = _t(datagen.gen_relation_np(1000, 1000, payloads=1, seed=2))

    def key(*args):
        leaves = []
        return tuple(_flatten(x, leaves, top=True) for x in args), _addresses(leaves)

    (spec_ab, at_ab), (spec_ba, at_ba) = key(a, b, 7), key(b, a, 7)
    assert spec_ab == spec_ba and at_ab != at_ba
    assert key(a, b, 9) == (spec_ab, at_ab) and at_ab[-1] is None
    t = torch.zeros(4, 4)
    assert _addresses([t]) != _addresses([t.t()])
    assert _addresses([t]) == _addresses([t.view(4, 4)])
    graph = _Graph.__new__(_Graph)  # its positions: a pinned tensor, a number
    graph.inputs, graph.owned = [t, torch.zeros((), dtype=torch.int64)], frozenset()
    assert graph.moved([t.view(4, 4), 5]) == set()
    assert graph.moved([t.clone(), 6]) == {0}
    graph.owned = frozenset({0})
    assert graph.moved([t.clone(), 6]) == set()
    d = {"x": a.col("key"), "y": [b.col("p0"), 3]}
    leaves = []
    spec = _flatten(d, leaves)
    assert spec != _flatten({"y": d["y"], "x": d["x"]}, [])
    back = _unflatten(spec, iter(leaves))
    assert list(back) == ["x", "y"] and back["x"] is d["x"] and back["y"][1] == 3
