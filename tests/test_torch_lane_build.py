"""The lane join's build on the CPU, without tpq: a numpy statement of
the build kernel's algorithm (tests/torch_lane_build_cases.py: rows
parked in their bucket in the atomics' order, each bucket sorted by
(h2, row)) against the sort path, `build_lane_tables_ref`, which is the
contract the kernel is held to on the card; the kernel's order bucket
by bucket against the stable composite sort; and the build's entry
point choosing its path. Integer data: every comparison is exact."""

import numpy as np
import pytest
import torch
import torch_lane_build_cases as cases

from tpq_torch import Table
from tpq_torch.kernels.lane_table import (LANE_BUILD_MAX_DEPTH, LanePlan, _build_takes_kernel,
                                          build_lane_tables, build_lane_tables_ref, lane_build)

torch.set_num_threads(2)

# the cases whose tables the joins may not read: a bucket past D, an h2
# collision of two keys
NOT_OK = ("bucket_past_d", "h2_pair")


def _table(cols, num_rows) -> Table:
    return Table({k: torch.from_numpy(v) for k, v in cols.items()}, num_rows)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", cases.CASES)
def test_kernel_statement_matches_the_sort_path(name, seed):
    """The kernel's algorithm in numpy, its rows arriving in two orders,
    against build_lane_tables_ref: `ok` equal, and every byte of key,
    payloads, occ and blen equal where `ok` is true; where it is false,
    blen and every bucket holding fewer than D rows."""
    plan, cols, num_rows = cases.build_case(name)
    want = build_lane_tables_ref(_table(cols, num_rows), plan)
    key, pays, occ, blen, ok, count = cases.np_lane_build(plan, cols, num_rows, seed)
    assert bool(want.ok) == ok == (name not in NOT_OK)
    assert want.key.dtype == torch.int64 and want.occ.dtype == want.blen.dtype == torch.int32
    assert len(want.pays) == len(pays)
    np.testing.assert_array_equal(want.blen.numpy(), blen)
    lanes = slice(None) if ok else (count.reshape(plan.npart, 1, 128) < plan.depth).repeat(
        plan.depth, 1)
    for got, mine in zip([want.key, *want.pays, want.occ], [key, *pays, occ]):
        np.testing.assert_array_equal(got.numpy()[lanes], mine[lanes])


@pytest.mark.parametrize("seed", [3, 4, 5])
@pytest.mark.parametrize("nb,h2_range,rows,depth", [
    (16, 4, 600, 48),       # a few h2 values a bucket: runs of ties
    (128, 1 << 32, 4000, 48),
    (8, 2, 500, 64),        # buckets past D: a sorted D-subset of their rows
])
def test_kernel_order_is_the_stable_composite_sort(nb, h2_range, rows, depth, seed):
    """Each bucket's rows as the kernel orders them (parked in a random
    arrival order, the first D kept, sorted by insertion on (h2 << 32) |
    row) against the stable sort by (bucket << 32) | h2: equal in every
    bucket of at most D rows; in a deeper one, D of its rows in (h2,
    row) order."""
    rng = np.random.default_rng(seed)
    b = rng.integers(0, nb, rows)
    h2 = rng.integers(0, h2_range, rows)
    got = cases.bucket_order(b, h2, depth, seed)
    perm = np.argsort((b << 32) | h2, kind="stable")
    for bucket in range(nb):
        want = perm[b[perm] == bucket]
        mine = np.array(got.get(bucket, []), np.int64)
        if len(want) <= depth:
            np.testing.assert_array_equal(mine, want)
        else:
            assert len(mine) == depth and set(mine) <= set(want)
            np.testing.assert_array_equal(mine, want[np.isin(want, mine)])


@pytest.mark.parametrize("depth,device,kernel", [
    (48, "cuda", True), (162, "cuda", True), (LANE_BUILD_MAX_DEPTH, "cuda", True),
    (LANE_BUILD_MAX_DEPTH + 1, "cuda", False), (243, "cuda", False), (48, "cpu", False)])
def test_build_path_by_depth_and_device(depth, device, kernel):
    """The kernel takes CUDA tensors up to LANE_BUILD_MAX_DEPTH (of the
    depths of growing D by half, 48, 72, 108 and 162); a deeper plan and
    CPU tensors take the sort path."""
    plan = LanePlan(pbits=9, depth=depth, probe_cap=4096, inline_k=4, tail_rows_cap=2048,
                    tail_out_cap=4096)
    assert LANE_BUILD_MAX_DEPTH == 227
    assert _build_takes_kernel(plan, torch.device(device)) is kernel


def test_build_on_cpu_takes_the_sort_path():
    """On CPU tensors build_lane_tables and lane_build return the sort
    path's tables and launch nothing."""
    plan, cols, num_rows = cases.build_case("uniform")
    r = _table(cols, num_rows)
    want = build_lane_tables_ref(r, plan)
    before = lane_build.launches
    for got in (build_lane_tables(r, plan), lane_build(r, plan)):
        for a, b in zip([got.key, *got.pays, got.occ, got.blen, got.ok],
                        [want.key, *want.pays, want.occ, want.blen, want.ok]):
            assert torch.equal(a, b)
    assert lane_build.launches == before
