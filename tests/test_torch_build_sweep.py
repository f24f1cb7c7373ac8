"""Config 2's shape (10M ⋈ 100M, four int64 payloads a side) and the
radix merge join at small sizes on the CPU, held as multisets to the
benchmark's plain reference (benchmark/reference/join.py), and the
counters the two observe: the lane join's tail and walk/emit shapes
(tpq.lane.*), the radix union sort's passes, planes and rows
(tpq.radix.*). No tpq call. The cuda-marked case reads the same
counters from a replayed graph's records."""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.harness.compare import canonical, rows_differ
from benchmark.harness.streams import relation
from benchmark.reference.join import join
from tpq_torch import trace
from tpq_torch.columnar import Table
from tpq_torch.jit import _Trace, _traced, jit, observe
from tpq_torch.kernels.lane2 import lane2_path_taken, plan_lane2
from tpq_torch.kernels.radix_sort import digit_passes
from tpq_torch.ops import hash_join, merge_join
from tpq_torch.ops.union_join import union_sort_specs

torch.set_num_threads(2)

UNIFORM = {"dist": "uniform"}
SEED = 5_000_000_321  # past 32 bits, as a benchmark run's seed may be
K = 4  # the v3 plan's inline ranks


def _tables(rows_r, rows_s, nkeys, payloads, device="cpu"):
    """R and S as the benchmark makes them: keys from the preset's key
    seeds (R 1, S 2), row order and payloads from SEED."""
    rels = [relation(rows, nkeys, payloads, key_seed, SEED + key_seed, UNIFORM, device)
            for rows, key_seed in ((rows_r, 1), (rows_s, 2))]
    return rels, [Table(rel.columns, rel.rows) for rel in rels]


def _live(rel) -> dict:
    return {n: rel.live(n) for n in rel.columns}


def _rows_wrong(out: Table, want: dict) -> int:
    names = list(want)
    n = int(out.num_rows)
    assert n == next(iter(want.values())).shape[0]
    got = canonical({c: out.col(c)[:n] for c in names}, names)
    return rows_differ(got, canonical(want, names), names)


def _observed(fn, *args):
    """fn(*args) under a profiler: its result and its record's observed
    values (an eager call reads them only while a profiler records)."""
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn(*args)
    return out, trace.records()[-1]["observed"]


def test_config2_shape_lane_join_is_the_reference():
    """10^4 x 10^5 rows over 10^4 keys, four payloads a side (config 2's
    ratios and widths): the jitted lane join, on its lane path, equals
    the reference as a multiset."""
    (rel_r, rel_s), (r, s) = _tables(10_000, 100_000, 10_000, 4)
    cap = 1 << 17
    assert bool(lane2_path_taken(r, s, cap))
    out = jit(functools.partial(hash_join, out_capacity=cap, impl="lane"))(r, s)
    want = join(_live(rel_r), _live(rel_s))
    assert list(out.names) == list(want) == (
        ["key"] + [f"r_p{i}" for i in range(4)] + [f"s_p{i}" for i in range(4)])
    assert _rows_wrong(out, want) == 0


def test_lane_counters_are_the_tail_arithmetic():
    """R of 10^4 rows over 2,000 keys (five a key on average), so that
    about half of S's rows match more than K R rows: the counters equal
    numpy's bincount arithmetic, and the walk/emit's shapes the plan's."""
    nkeys = 2000
    (rel_r, rel_s), (r, s) = _tables(10_000, 2000, nkeys, 4)
    cap = 1 << 15
    fn = jit(functools.partial(hash_join, out_capacity=cap, impl="lane"))
    out, obs = _observed(fn, r, s)
    cr = np.bincount(rel_r.live("key").numpy(), minlength=nkeys)
    cs = np.bincount(rel_s.live("key").numpy(), minlength=nkeys)
    plan = plan_lane2(r.capacity, s.capacity, out_capacity=cap)
    assert obs["tpq.lane.tail_queries"] == int((cs * (cr > K)).sum()) > 500
    assert obs["tpq.lane.tail_rows"] == int((cs * np.maximum(cr - K, 0)).sum()) > 1000
    assert obs["tpq.lane.inline_rows"] == int((cs * np.minimum(cr, K)).sum())
    assert obs["tpq.lane.tail_cap"] == plan.tail_out_cap >= obs["tpq.lane.tail_rows"]
    assert obs["tpq.lane.probe_slots"] == plan.npart * plan.probe_cap
    assert obs["tpq.lane.table_slots"] == plan.npart * plan.depth * 128
    assert obs["tpq.lane.build_payloads"] == obs["tpq.lane.probe_payloads"] == 4
    assert [c for c in trace.records()[-1]["conds"]] == [["tpq.lane.ok", True]]
    assert _rows_wrong(out, join(_live(rel_r), _live(rel_s))) == 0


def test_radix_merge_join_is_the_reference():
    """join_1m's shape cut to 2^12 rows a side: the jitted merge join on
    the radix engine equals the reference, and its counters are the
    union sort's passes, planes and rows."""
    (rel_r, rel_s), (r, s) = _tables(1 << 12, 1 << 12, 1 << 12, 1)
    fn = jit(functools.partial(merge_join, out_capacity=1 << 14, sort_engine="radix",
                               key_bits=64))
    out, obs = _observed(fn, r, s)
    assert _rows_wrong(out, join(_live(rel_r), _live(rel_s))) == 0
    assert obs["tpq.radix.passes"] == digit_passes(len(union_sort_specs(64))) == 9
    assert obs["tpq.radix.rows"] == r.capacity + s.capacity == 1 << 13
    # invalid, key lo, key hi, side, and an int64 payload a side in two planes
    assert obs["tpq.radix.planes"] == 4 + 2 + 2


def test_observe_keeps_ints_beside_a_capture():
    """Under a capture an observed int is kept as it is (no device work)
    and a tensor joins the flags; eagerly both are read only while a
    profiler records."""
    capture, eager = _Trace(), _Trace(eager=True)
    for run in (capture, eager):
        with _traced(run):
            observe("n", 7)
            observe("t", torch.tensor(3))
    assert capture.observed[0] == ("n", 7) and capture.observed[1][0] == "t"
    assert isinstance(capture.observed[1][1], torch.Tensor)
    assert eager.observed == []


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_replayed_graph_observes_the_same_counters(dev):
    """The lane join's tensor counters come back in the flags of every
    replay and its plan's constants beside the graph, equal to a CPU
    call's on the same relations but for the layout's path: the
    one-level kernel on the card, the sort path on the CPU."""
    body = functools.partial(hash_join, out_capacity=1 << 15, impl="lane")
    _, want = _observed(jit(body), *_tables(10_000, 2000, 2000, 4)[1])
    assert want["tpq.lane.layout_passes"] == 0
    want["tpq.lane.layout_passes"] = 1
    _, (r, s) = _tables(10_000, 2000, 2000, 4, dev)
    fn = jit(body)
    fn(r, s)
    for _ in range(2):
        _, got = _observed(fn, r, s)
        assert trace.records()[-1]["device_ms"] is not None
        assert got == want and fn.replays >= 2
