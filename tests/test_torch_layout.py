"""The lane join's probe layout on the CPU: its plain version
(`probe_layout_ref`, the sort path and the contract the layout kernel is
held to on the card) against tpq's _probe_layout and against a numpy
statement of the layout (tests/torch_layout_cases.py), and the layout's
entry point (`_probe_layout`) choosing it for CPU tensors. tpq runs
once, in a module fixture (interpret-mode Pallas PAD). Integer data:
every comparison is exact."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_layout_cases as cases

from tpq import Table as JTable
from tpq.kernels import lane_table as jlane_table
from tpq_torch import Table
from tpq_torch.kernels.lane_table import _probe_layout, probe_layout, probe_layout_ref

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
    for fn in (probe_layout_ref, _probe_layout, probe_layout):
        _eq(fn(plan, s, "key", keep=keep_t), want)
