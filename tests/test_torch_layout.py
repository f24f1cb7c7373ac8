"""The lane join's probe layout on the CPU: its plain version
(`probe_layout_ref`, the sort path and the contract the layout kernels
are held to on the card) against tpq's _probe_layout and against a numpy
statement of the layout (tests/torch_layout_cases.py), the two-level
layout's passes stated in numpy against that statement, and the layout's
entry point (`_probe_layout`) choosing its path by the plan's shape and
observing it. tpq runs once, in a module fixture (interpret-mode Pallas
PAD). Integer data: every comparison is exact."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_layout_cases as cases
from torch.profiler import ProfilerActivity, profile

from tpq import Table as JTable
from tpq.kernels import lane_table as jlane_table
from tpq_torch import Table, trace
from tpq_torch.jit import _Trace, _traced, jit
from tpq_torch.kernels.lane_table import (LAYOUT2_MAX_PARTS, LAYOUT_MAX_PARTS, LanePlan,
                                          _probe_layout, layout_passes, probe_layout,
                                          probe_layout_ref, probe_layout_two_level)
from tpq_torch.ops import hash_join

torch.set_num_threads(2)

# tpq's case: 8 partitions, rows past num_rows, half the rows kept. No
# partition overflows: there tpq's PAD, handed the dropped rows' sentinel
# inside the live prefix, places the rows after them elsewhere than the
# port's PAD does (the join falls back on overflow either way), so the
# overflow cases are held to numpy's statement alone
TPQ_ROWS, TPQ_NUM_ROWS = 4096, 3001


def _i64(lo, hi) -> np.ndarray:
    """tpq's (lo, hi) 32-bit planes -> int64."""
    lo, hi = np.asarray(lo), np.asarray(hi)
    return ((hi.astype(np.uint32).astype(np.uint64) << np.uint64(32))
            | lo.astype(np.uint32).astype(np.uint64)).view(np.int64)


def _tpq_case():
    plan, cols, _, _ = cases.layout_case("keep_none", 8, TPQ_ROWS)
    keep = np.random.default_rng(5).random(TPQ_ROWS) < 0.5
    return plan, {k: v[:TPQ_NUM_ROWS] for k, v in cols.items()}, keep


@pytest.fixture(scope="module")
def tpq_layout():
    """tpq's probe layout of the case, run once."""
    plan, cols, keep = _tpq_case()
    jplan = jlane_table.LanePlan(*dataclasses.astuple(plan))
    qk, pays, lane, qocc, ovf = jlane_table._probe_layout(
        jplan, JTable.from_numpy(cols, capacity=TPQ_ROWS), "key", keep=jnp.asarray(keep))
    return {"qk": _i64(*qk), "pays": [_i64(*pays[i:i + 2]) for i in range(0, len(pays), 2)],
            "lane": np.asarray(lane), "qocc": np.asarray(qocc), "overflow": bool(ovf)}


def _eq(got, want):
    qk, pays, lane, qocc, ovf = got
    wqk, wpays, wlane, wqocc, wovf = want
    assert qk.dtype == torch.int64 and lane.dtype == qocc.dtype == torch.int32
    assert ovf.dtype == torch.bool and ovf.shape == ()
    np.testing.assert_array_equal(qk.numpy(), wqk)
    assert len(pays) == len(wpays)
    for a, b in zip(pays, wpays):
        assert a.dtype == torch.int64
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(lane.numpy(), wlane)
    np.testing.assert_array_equal(qocc.numpy(), wqocc)
    assert bool(ovf) == wovf


def test_probe_layout_ref_matches_tpq(tpq_layout):
    """Over all u slots, dead ones included: tpq's PAD leaves key and
    payloads 0 there and its second hash the lane of key 0."""
    plan, cols, keep = _tpq_case()
    s = Table.from_numpy(cols, capacity=TPQ_ROWS, device="cpu")
    want = (tpq_layout["qk"], tpq_layout["pays"], tpq_layout["lane"],
            tpq_layout["qocc"], tpq_layout["overflow"])
    assert not want[4] and len(want[1]) == 2
    assert want[0].shape == (plan.npart * plan.probe_cap,)
    _eq(probe_layout_ref(plan, s, "key", keep=torch.from_numpy(keep)), want)
    _eq(_probe_layout(plan, s, "key", keep=torch.from_numpy(keep)), want)
    full = {k: np.concatenate([v, np.zeros(TPQ_ROWS - TPQ_NUM_ROWS, v.dtype)])
            for k, v in cols.items()}
    np_want = cases.np_probe_layout(plan, full, TPQ_NUM_ROWS, keep)
    for a, b in zip([np_want[0], *np_want[1], np_want[2], np_want[3]],
                    [want[0], *want[1], want[2], want[3]]):
        np.testing.assert_array_equal(a, b)
    assert np_want[4] == want[4]


@pytest.mark.parametrize("npart,rows", [(8, 3001), (2, 700), (512, 20_000)])
@pytest.mark.parametrize("case", cases.CASES)
def test_probe_layout_ref_matches_numpy(case, npart, rows):
    """The plain layout over all u slots against numpy's statement, with
    garbage in the rows past num_rows; the entry point and the kernel's
    wrapper take it on CPU tensors."""
    plan, cols, num_rows, keep = cases.layout_case(case, npart, rows)
    s = Table({k: torch.from_numpy(v) for k, v in cols.items()}, num_rows)
    keep_t = torch.from_numpy(keep) if keep is not None else None
    want = cases.np_probe_layout(plan, cols, num_rows, keep)
    assert want[4] == (case == "overflow")
    assert want[0].shape == (plan.npart * plan.probe_cap,)
    for fn in (probe_layout_ref, _probe_layout, probe_layout, probe_layout_two_level):
        _eq(fn(plan, s, "key", keep=keep_t), want)


@pytest.mark.parametrize("npart", [2048, 16384])
@pytest.mark.parametrize("case", cases.CASES)
def test_two_level_statement_is_the_layout(case, npart):
    """The two-level layout's passes (a stable compact partition by the
    high half of the partition bits, then a padded one of each group's
    run by the low half), tile by tile, equal the layout's statement over
    all u slots and the overflow flag. Tiles of 256 rows, so that a group
    spans several and the last of each is ragged."""
    plan, cols, num_rows, keep = cases.layout_case(case, npart, 60_001)
    want = cases.np_probe_layout(plan, cols, num_rows, keep)
    got = cases.np_two_level_layout(plan, cols, num_rows, keep, tile=256)
    assert want[4] == (case == "overflow")
    for a, b in zip([got[0], *got[1], got[2], got[3]], [want[0], *want[1], want[2], want[3]]):
        np.testing.assert_array_equal(a, b)
    assert len(got[1]) == len(want[1]) and got[4] == want[4]


CUDA = torch.device("cuda")  # a value only: nothing is placed there


@pytest.mark.parametrize("npart,probe_cap,device,passes", [
    (512, 100, "cpu", 0),
    (1, 1 << 16, CUDA, 0),  # the identity: one partition as wide as the table
    (1, 1000, CUDA, 1),
    (512, 100, CUDA, 1),
    (LAYOUT_MAX_PARTS, 100, CUDA, 1),
    (2 * LAYOUT_MAX_PARTS, 100, CUDA, 2),
    (8192, 24_576, CUDA, 2),
    (LAYOUT2_MAX_PARTS, 1, CUDA, 2),
    (2 * LAYOUT2_MAX_PARTS, 1, CUDA, 0),
])
def test_layout_path_by_shape(npart, probe_cap, device, passes):
    """The layout's path over 2^16 rows by the plan's shape and the
    tensor's device alone: the sort path off the card, for the identity
    and past LAYOUT2_MAX_PARTS partitions; the one-level kernel up to
    LAYOUT_MAX_PARTS; the two-level kernels up to LAYOUT2_MAX_PARTS."""
    plan = LanePlan(pbits=npart.bit_length() - 1, depth=48, probe_cap=probe_cap, inline_k=4,
                    tail_rows_cap=2048, tail_out_cap=4096)
    assert layout_passes(plan, 1 << 16, device) == passes


def test_layout_observes_its_path():
    """_probe_layout observes the path it took as a Python int beside a
    captured graph, `tpq.lane.layout_passes` (0 on the CPU, the sort
    path), and its result is the sort path's; a traced call of a jitted
    lane join holds it among its observed values."""
    plan, cols, num_rows, keep = cases.layout_case("keep_half", 2048, 20_000)
    s = Table({k: torch.from_numpy(v) for k, v in cols.items()}, num_rows)
    run = _Trace()
    with _traced(run):
        got = _probe_layout(plan, s, "key", keep=torch.from_numpy(keep))
    assert run.observed == [("tpq.lane.layout_passes", 0)]
    _eq(got, cases.np_probe_layout(plan, cols, num_rows, keep))

    fn = jit(functools.partial(hash_join, out_capacity=1 << 16, impl="lane"))
    r = Table({"key": torch.from_numpy(cols["key"][:5000]), "p0": torch.arange(5000)}, 5000)
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn(r, s)
    assert trace.records()[-1]["observed"]["tpq.lane.layout_passes"] == 0
    assert int(out.num_rows) == int(hash_join(r, s, 1 << 16, impl="sorted").num_rows) > 5000
