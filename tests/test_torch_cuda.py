"""tpq_torch's CUDA kernels against their plain torch versions, on the
card. Every test needs an NVIDIA card (marker `cuda`) and skips without
one. The card's machine has no JAX, so this file imports none and needs
no conftest fixture; run it there from the repo root with

    python -m pytest --noconftest -o addopts="" -q tests/test_torch_cuda.py

Integer data: every comparison is exact."""

import dataclasses
import importlib

import numpy as np
import pytest
import torch
import torch_aggregate_cases as agg_cases
import torch_lane_build_cases as build_cases
import torch_layout_cases as layout_cases
import torch_move_cases as cases
import torch_skew_cases as skew_cases
from torch_host_reads import host_reads

from tpq_torch import Table, datagen
from tpq_torch.columnar import canonicalize, tables_equal
from tpq_torch.dist import DistTable, dist_hash_join_planned, make_mesh, run_dryrun
from tpq_torch.dist.mesh import OWNER_SALT, owner_of
from tpq_torch.hashing import hash_keys, hash_keys_ref, np_hash_keys
from tpq_torch.jit import deferred, jit
from tpq_torch.kernels.aggregate import aggregate_runs, aggregate_runs_ref
from tpq_torch.kernels.lane2 import (build_lane2_tables, fused_walk_emit,
                                     fused_walk_emit_ref, lane2_hash_join, lane2_path_taken,
                                     lane2_probe_emit, plan_lane2)
from tpq_torch.kernels import _build, aggregate, group_table, lane_table, move
from tpq_torch.kernels.group_table import (group_insert, group_insert_ref, group_write,
                                           group_write_ref)
from tpq_torch.kernels.lane_table import (LANE_BUILD_MAX_DEPTH, LAYOUT2_MAX_PARTS,
                                          LAYOUT_MAX_PARTS, SALT_H2, SALT_LANE, LanePlan,
                                          _probe_layout, build_lane_tables,
                                          build_lane_tables_ref, lane_build, probe_layout,
                                          probe_layout_ref, probe_layout_two_level, probe_walk,
                                          probe_walk_ref, walk_ref)
from tpq_torch.kernels.move import pack, pack_ref, pad, pad_ref
from tpq_torch.kernels.radix_partition import (MAX_BUCKETS, radix_histogram,
                                               radix_histogram_ref)
from tpq_torch.kernels.radix_sort import (_split1, digit_passes, lsd_radix_sort_bits,
                                          split1_ref, split_digit, split_digit_ref)
from tpq_torch.ops import hash_join, merge_join
from tpq_torch.ops.filter import keep_mask
from tpq_torch.ops.skew_join import skew_path_taken
from tpq_torch.ops.union_join import union_sort_specs
from tpq_torch.query import jit_pipeline

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _eq(a, b):
    torch.cuda.synchronize()
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b)


@pytest.mark.parametrize("n_live,out_len,n_alloc,dtypes", [
    (3000, 4096, 3000, ["i32"]),
    (0, 2048, 2048, ["i32", "i32"]),
    (1000, 4096, 1500, ["i32", "i32"]),          # dead suffix
    (300_000, 700_000, 400_000, ["i64", "i32", "i64"]),
])
def test_pad_kernel_matches_plain(dev, n_live, out_len, n_alloc, dtypes):
    rng = np.random.default_rng(n_live)
    dest = np.full(n_alloc, out_len, np.int32)
    # live prefix strictly increasing; some live dests past out_len drop
    dest[:n_live] = np.sort(rng.choice(out_len + 1000, n_live, replace=False))
    cols = [torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, n_alloc)).to(
        torch.int64 if d == "i64" else torch.int32).to(dev) for d in dtypes]
    dest_t = torch.from_numpy(dest).to(dev)
    n_live_t = torch.tensor(n_live, dtype=torch.int32, device=dev)
    before = pad.launches
    outs, occ = pad(cols, dest_t, n_live_t, out_len)
    assert pad.launches == before + 1
    ref_outs, ref_occ = pad_ref(cols, dest_t, n_live_t, out_len)
    _eq(occ, ref_occ)
    for a, b in zip(outs, ref_outs):
        _eq(a, b)


@pytest.mark.parametrize("n,density", [
    (4096, 0.6), (2048, 1.0), (10_000, 0.0), (1_000_003, 0.37), (1, 1.0)])
def test_pack_kernel_matches_plain(dev, n, density):
    rng = np.random.default_rng(n)
    occ = torch.from_numpy((rng.random(n) < density).astype(np.int32)).to(dev)
    cols = [torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, n)).to(dev),
            torch.arange(n, dtype=torch.int32, device=dev)]
    before = pack.launches
    outs, total = pack(cols, occ)
    assert pack.launches == before + 1
    ref_outs, ref_total = pack_ref(cols, occ)
    _eq(total, ref_total)
    for a, b in zip(outs, ref_outs):
        _eq(a, b)


@pytest.mark.parametrize("name", cases.PAD_CASES)
def test_pad_kernel_contract_cases(dev, name):
    """Interleaved sentinel runs longer than a tile, n_live = 0 over a
    non-monotone dead dest, out_len not a multiple of the tile, 16 mixed
    columns, all slots filled: byte-equal to the plain version, with
    n_live an int and an int64 tensor, and again on a second call."""
    cols, dest, n_live, out_len = cases.pad_case(name, scale=4)
    cols = [torch.from_numpy(c).to(dev) for c in cols]
    dest = torch.from_numpy(dest).to(dev)
    for live in (n_live, torch.tensor(n_live, dtype=torch.int64, device=dev)):
        before = pad.launches
        outs, occ = pad(cols, dest, live, out_len)
        again, occ2 = pad(cols, dest, live, out_len)
        assert pad.launches == before + 2
        ref_outs, ref_occ = pad_ref(cols, dest, live, out_len)
        _eq(occ, ref_occ)
        _eq(occ2, ref_occ)
        for a, b, r in zip(outs, again, ref_outs):
            _eq(a, r)
            _eq(b, r)


@pytest.mark.parametrize("name", cases.PACK_CASES)
def test_pack_kernel_contract_cases(dev, name):
    """Many more tiles than the persistent grid holds (a long look-back
    chain and a long zero fill past `total`), all live, none live, occ
    values other than 0/1, 16 mixed columns: byte-equal to the plain
    version, and the same bytes on a second call."""
    cols, occ = cases.pack_case(name, scale=8 if name == "many_tiles" else 1)
    cols = [torch.from_numpy(c).to(dev) for c in cols]
    occ = torch.from_numpy(occ).to(dev)
    before = pack.launches
    (outs, total), (again, total2) = pack(cols, occ), pack(cols, occ)
    assert pack.launches == before + 2
    ref_outs, ref_total = pack_ref(cols, occ)
    _eq(total, ref_total)
    _eq(total2, ref_total)
    for a, b, r in zip(outs, again, ref_outs):
        _eq(a, r)
        _eq(b, r)


def test_pack_kernel_takes_any_occ(dev):
    """A bool occ, and an int32 occ 4 bytes off 16-byte alignment, which
    the wrapper copies before the kernel's 16-byte loads."""
    cols, occ = cases.pack_case("sixteen_cols")
    cols = [torch.from_numpy(c).to(dev) for c in cols]
    buf = torch.zeros(occ.shape[0] + 1, dtype=torch.int32, device=dev)
    buf[1:] = torch.from_numpy(occ).to(dev)
    for o in (buf[1:] != 0, buf[1:]):
        outs, total = pack(cols, o)
        ref_outs, ref_total = pack_ref(cols, o)
        _eq(total, ref_total)
        for a, r in zip(outs, ref_outs):
            _eq(a, r)


@pytest.mark.parametrize("rows,nkeys,out_capacity", [
    (1000, 300, 1 << 14),       # heavy multiplicities: the tail runs
    (65_536, 65_536, 1 << 18),
    (65_536, 65_536, 20_000),   # inline rows past out_capacity drop
])
def test_fused_walk_emit_matches_plain(dev, rows, nkeys, out_capacity):
    r = datagen.gen_relation(rows, nkeys, payloads=2, seed=11, device=dev)
    s = datagen.gen_relation(rows, nkeys, payloads=1, seed=22, device=dev)
    plan = plan_lane2(r.capacity, s.capacity, out_capacity=out_capacity)
    tables = build_lane2_tables(r, plan)
    qk, spay, lane, qocc, _ = _probe_layout(plan, s, "key")
    before = fused_walk_emit.launches
    outs, cnt, d_first = fused_walk_emit(tables, qk, lane, qocc, spay, out_capacity)
    assert fused_walk_emit.launches == before + 1
    ref_outs, ref_cnt, ref_df = fused_walk_emit_ref(tables, qk, lane, qocc, spay,
                                                     out_capacity)
    _eq(cnt, ref_cnt)
    _eq(d_first, ref_df)
    n = min(int(cnt.clamp_max(plan.inline_k).sum()), out_capacity)
    for a, b in zip(outs, ref_outs):
        _eq(a[:n], b[:n])


def _walk_emit_case(dev, case):
    """(plan, walk/emit arguments) of a contract case; see
    test_fused_walk_emit_contract_cases."""
    shapes = {  # rows, nkeys, npart, depth, K, probe_cap
        "probe_cap past a work item": (12_000, 4_000, 2, 48, 4, 10_240),
        "live queries in the last work item": (12_000, 4_000, 2, 48, 4, 10_240),
        "heavy table": (3_000, 300, 1, 64, 8, 65_536),
        "D 72": (8_000, 2_000, 8, 72, 4, 2_048),
        "out_capacity cuts a work item": (8_000, 2_000, 8, 48, 4, 2_048),
        "out_capacity 0": (8_000, 2_000, 8, 48, 4, 2_048),
        "all queries dead": (8_000, 2_000, 8, 48, 4, 2_048),
    }
    rows, nkeys, npart, depth, k, probe_cap = shapes[case]
    s_rows = 60_000 if case == "heavy table" else rows
    r = datagen.gen_relation(rows, nkeys, payloads=2, seed=3, device=dev)
    s = datagen.gen_relation(s_rows, nkeys, payloads=1, seed=4, device=dev)
    plan = LanePlan(pbits=npart.bit_length() - 1, depth=depth, probe_cap=probe_cap,
                    inline_k=k, tail_rows_cap=2048, tail_out_cap=4096)
    tables = build_lane_tables(r, plan)
    qk, spay, lane, qocc, ovf = _probe_layout(plan, s, "key")
    assert not bool(ovf)
    if case == "live queries in the last work item":
        # the layout packs a partition's queries to its front: reversed,
        # they sit in the last of its three work items
        flip = lambda x: x.reshape(npart, probe_cap).flip(1).reshape(-1).contiguous()
        qk, lane, qocc, spay = flip(qk), flip(lane), flip(qocc), [flip(x) for x in spay]
    if case == "all queries dead":
        qocc = torch.zeros_like(qocc)
    n = int(torch.where(qocc > 0, walk_ref(tables, qk, lane, qocc, 0)[0], 0)
            .clamp_max(k).sum())
    cap = {"out_capacity cuts a work item": n // 2 + 1, "out_capacity 0": 0}.get(
        case, n + 100)
    return plan, (tables, qk, lane, qocc, spay, cap)


@pytest.mark.parametrize("case", [
    "probe_cap past a work item", "live queries in the last work item", "heavy table",
    "D 72", "out_capacity cuts a work item", "out_capacity 0", "all queries dead"])
def test_fused_walk_emit_contract_cases(dev, case):
    """One launch per call; cnt, d_first and every row below out_capacity
    byte-equal to the plain version, and the same bytes on a second call:
    a partition over three work items (4,096 queries at most each) with
    its live queries at the front or all in the last, the one-partition
    heavy table at D 64 and K 8, D 72, out_capacity cutting a work item's
    rows at an odd row and out_capacity 0, every query dead."""
    plan, args = _walk_emit_case(dev, case)
    cap = args[-1]
    before = fused_walk_emit.launches
    first, second = fused_walk_emit(*args), fused_walk_emit(*args)
    assert fused_walk_emit.launches == before + 2
    ref_outs, ref_cnt, ref_df = fused_walk_emit_ref(*args)
    n = min(int(ref_cnt.clamp_max(plan.inline_k).sum()), cap)
    if case == "all queries dead":
        assert n == 0 and int(ref_cnt.abs().sum()) == 0
    elif case != "out_capacity 0":
        assert n > 0
    for outs, cnt, d_first in (first, second):
        _eq(cnt, ref_cnt)
        _eq(d_first, ref_df)
        for a, b in zip(outs, ref_outs):
            _eq(a[:n], b[:n])


# rows of each partition count's layout cases on the card: many 4,096-row
# tiles and a ragged last one; past 1,024 partitions many in each group of
# the two-level layout (32, 64 and 128 groups)
LAYOUT_ROWS = {2: 3 * 4096 + 1234, 8: 50_001, 512: (1 << 20) + 4097,
               2048: (1 << 21) + 4097, 8192: (1 << 22) + 777, 16384: (1 << 22) + 4097}


def _layout_inputs(dev, case, npart, rows=None):
    plan, cols, num_rows, keep = layout_cases.layout_case(case, npart,
                                                          rows or LAYOUT_ROWS[npart])
    s = Table({k: torch.from_numpy(v).to(dev) for k, v in cols.items()}, num_rows)
    return plan, s, torch.from_numpy(keep).to(dev) if keep is not None else None


def _layout_eq(got, want):
    (qk, pays, lane, qocc, ovf), (wqk, wpays, wlane, wqocc, wovf) = got, want
    assert len(pays) == len(wpays)
    for a, b in zip([qk, *pays, lane, qocc, ovf], [wqk, *wpays, wlane, wqocc, wovf]):
        _eq(a, b)


@pytest.mark.parametrize("npart", [2, 8, 512])
@pytest.mark.parametrize("case", layout_cases.CASES)
def test_probe_layout_kernel_matches_plain(dev, case, npart):
    """The layout kernel against its plain version (the sort path), byte
    for byte over all u slots, dead slots included: keep none, half or
    all false, rows past num_rows, num_rows 0, an overflowing partition
    (rows ranked past probe_cap dropped, overflow set), int32 columns,
    0 to 3 payloads; probe_cap 2 x the mean load + 21, so that no tile
    size divides u. One launch a call; a second call writes the same
    bytes; the entry point takes the kernel."""
    plan, s, keep = _layout_inputs(dev, case, npart)
    before = probe_layout.launches
    first = probe_layout(plan, s, "key", keep)
    second = probe_layout(plan, s, "key", keep)
    third = _probe_layout(plan, s, "key", keep)
    assert probe_layout.launches == before + 3
    want = probe_layout_ref(plan, s, "key", keep)
    assert bool(want[4]) == (case == "overflow")
    for got in (first, second, third):
        _layout_eq(got, want)


@pytest.mark.parametrize("npart", [2048, 8192, 16384])
@pytest.mark.parametrize("case", layout_cases.CASES)
def test_probe_layout_two_level_matches_plain(dev, case, npart):
    """The two-level layout against the plain version (the sort path),
    byte for byte over all u slots and the overflow flag, the cases of
    test_probe_layout_kernel_matches_plain over 32, 64 and 128 groups of
    many tiles each. One launch a call; a second call writes the same
    bytes; the entry point takes it, and not the one-level kernel."""
    plan, s, keep = _layout_inputs(dev, case, npart)
    before, one_level = probe_layout_two_level.launches, probe_layout.launches
    first = probe_layout_two_level(plan, s, "key", keep)
    second = probe_layout_two_level(plan, s, "key", keep)
    third = _probe_layout(plan, s, "key", keep)
    assert probe_layout_two_level.launches == before + 3
    assert probe_layout.launches == one_level
    want = probe_layout_ref(plan, s, "key", keep)
    assert bool(want[4]) == (case == "overflow")
    for got in (first, second, third):
        _layout_eq(got, want)


def test_probe_layout_two_level_at_the_sweep_plan(dev):
    """Config 2's plan (8,192 partitions of 24,576 slots, four payloads)
    over 2^24 rows, 12,500,001 live: equal to the plain version over all
    201,326,592 slots, one launch."""
    plan = plan_lane2(10_000_000, 1 << 27, out_capacity=1 << 27)
    assert (plan.npart, plan.probe_cap) == (8192, 24_576)
    n = 1 << 24
    rng = np.random.default_rng(23)
    cols = {"key": rng.integers(-(1 << 62), 1 << 62, n),
            **{f"p{i}": rng.integers(-(1 << 62), 1 << 62, n) for i in range(4)}}
    s = Table({k: torch.from_numpy(v).to(dev) for k, v in cols.items()}, 12_500_001)
    before = probe_layout_two_level.launches
    got = _probe_layout(plan, s, "key")
    assert probe_layout_two_level.launches == before + 1
    _layout_eq(got, probe_layout_ref(plan, s, "key"))


@pytest.mark.parametrize("shape", ["past_the_limit", "identity"])
def test_probe_layout_takes_the_sort_path_by_shape(dev, shape):
    """Past LAYOUT_MAX_PARTS partitions a plan (2,048) takes the two-level
    layout, and past LAYOUT2_MAX_PARTS (2^21) the sort path; the identity
    layout (one partition as wide as the table) takes the sort path. A
    kernel wrapper refuses the plans of another path, launching
    nothing."""
    if shape == "past_the_limit":
        plan, s, keep = _layout_inputs(dev, "keep_half", 2 * LAYOUT_MAX_PARTS, 300_001)
        before = probe_layout_two_level.launches, probe_layout.launches
        _layout_eq(_probe_layout(plan, s, "key", keep), probe_layout_ref(plan, s, "key", keep))
        assert (probe_layout_two_level.launches, probe_layout.launches) == (
            before[0] + 1, before[1])
        with pytest.raises(ValueError):
            probe_layout(plan, s, "key", keep)
        plan = dataclasses.replace(plan, pbits=(2 * LAYOUT2_MAX_PARTS).bit_length() - 1,
                                   probe_cap=1)
    else:
        _, s, keep = _layout_inputs(dev, "keep_half", 8, 1 << 16)
        plan = LanePlan(pbits=0, depth=48, probe_cap=s.capacity, inline_k=4,
                        tail_rows_cap=2048, tail_out_cap=4096)
    before = probe_layout_two_level.launches, probe_layout.launches
    got = _probe_layout(plan, s, "key", keep)
    _layout_eq(got, probe_layout_ref(plan, s, "key", keep))
    for wrapper in (probe_layout, probe_layout_two_level):
        with pytest.raises(ValueError):
            wrapper(plan, s, "key", keep)
    assert (probe_layout_two_level.launches, probe_layout.launches) == before


LAYOUT_KERNELS = ("layout_count_kernel", "layout_scan_kernel", "layout_scatter_kernel")


def _traced_port_kernels(dev, fn, traces=3) -> dict:
    """{kernel of tpq_torch/csrc: launches} of one call of fn(), the most
    over a few traces (a trace can lose a device item, never add one)."""
    from tpq_torch.bench.profile import device_activities, port_launches

    most: dict = {}
    for _ in range(traces):
        torch.cuda.synchronize(dev)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize(dev)
        for k, n in port_launches(device_activities(prof)).items():
            most[k] = max(most.get(k, 0), n)
    return most


def test_probe_layout_launches_each_kernel_once(dev):
    """A call at config 1's plan (512 partitions) launches the count, the
    scan (with the dead slots' fill) and the scatter once each and no
    other kernel of the port."""
    plan, s, keep = _layout_inputs(dev, "keep_half", 512)
    probe_layout(plan, s, "key", keep)
    assert _traced_port_kernels(dev, lambda: probe_layout(plan, s, "key", keep)) == {
        k: 1 for k in LAYOUT_KERNELS}


LAYOUT2_KERNELS = ("layout2_coarse_count_kernel", "layout2_group_scan_kernel",
                   "layout2_groups_kernel", "layout2_coarse_scatter_kernel",
                   "layout2_fine_count_kernel", "layout2_part_scan_kernel",
                   "layout2_fine_scatter_kernel")


def test_probe_layout_two_level_launches_each_kernel_once(dev):
    """A call at config 5's shards' 16,384 partitions launches each of its
    seven kernels once and no other kernel of the port."""
    plan, s, keep = _layout_inputs(dev, "keep_half", 16384)
    probe_layout_two_level(plan, s, "key", keep)
    assert _traced_port_kernels(
        dev, lambda: probe_layout_two_level(plan, s, "key", keep)) == {
            k: 1 for k in LAYOUT2_KERNELS}


def test_jitted_pipeline_launches_the_layout_kernel(dev):
    """jit_pipeline at a 512-partition plan (600,000 dimension rows in a
    2^20 capacity, so that no bucket passes the depth): the graph's
    replay launches each layout kernel once, and two filter values give
    the rows of its eager call (`__wrapped__`), one graph, no rerun."""
    pipe = jit_pipeline(1 << 22, join_impl="lane")
    dim = Table.from_numpy(datagen.gen_relation_np(600_000, 1 << 20, payloads=1, seed=7),
                           capacity=1 << 20, device=dev)
    fact = Table.from_numpy(datagen.gen_relation_np(1 << 21, 1 << 20, payloads=2, seed=8),
                            device=dev)
    assert plan_lane2(dim.capacity, fact.capacity).npart == 512
    for value in (1 << 19, 1 << 18):
        got, want = pipe(dim, fact, value), pipe.__wrapped__(dim, fact, value)
        n = int(want.num_rows)
        assert int(got.num_rows) == n > 0
        for name in want.columns:
            _eq(got.columns[name][:n], want.columns[name][:n])
    launched = _traced_port_kernels(dev, lambda: pipe(dim, fact, 1 << 19))
    assert {k: launched.get(k, 0) for k in LAYOUT_KERNELS} == {k: 1 for k in LAYOUT_KERNELS}
    assert len(pipe._graphs) == 1 and pipe.reruns == 0


def _build_eq(got, want):
    """The build kernel's contract against the sort path: `ok` and blen
    equal; where `ok` is true every byte of key, payloads and occ, where
    it is false every bucket of fewer than D rows."""
    torch.cuda.synchronize()
    _eq(got.ok, want.ok)
    _eq(got.blen, want.blen)
    assert len(got.pays) == len(want.pays)
    lanes = (want.blen < want.plan.depth).unsqueeze(1).expand_as(want.occ)
    for a, b in zip([got.key, *got.pays, got.occ], [want.key, *want.pays, want.occ]):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b) if bool(want.ok) else torch.equal(a[lanes], b[lanes])


BUILD_KERNELS = ("lane_build_count_kernel", "lane_build_finish_kernel")


@pytest.mark.parametrize("name", build_cases.CASES)
def test_lane_build_kernel_matches_the_sort_path(dev, name):
    """The build kernel against its plain version (the sort path), twice,
    directly and through build_lane_tables: the uniform 2^20 join's 512
    partitions, the skew split's one-partition plans at D 48 and 64, a
    16,384-partition plan over rows past num_rows, the renegotiated D 72
    and 108, int32 keys, no payload and the most, num_rows 0, a bucket
    at D rows, one past D (`ok` false) and the h2-colliding pair (`ok`
    false). One launch a call."""
    plan, cols, num_rows = build_cases.build_case(name, card=True)
    r = Table({k: torch.from_numpy(v).to(dev) for k, v in cols.items()}, num_rows)
    before = lane_build.launches
    first, second = lane_build(r, plan), build_lane_tables(r, plan)
    assert lane_build.launches == before + 2
    want = build_lane_tables_ref(r, plan)
    assert bool(want.ok) == (name not in ("bucket_past_d", "h2_pair"))
    for got in (first, second):
        _build_eq(got, want)


def test_lane_build_takes_the_sort_path_past_its_depth(dev):
    """A plan deeper than LANE_BUILD_MAX_DEPTH goes to the sort path with
    no launch; lane_build refuses it."""
    plan, cols, num_rows = build_cases.build_case("d108", card=True)
    plan = LanePlan(pbits=plan.pbits, depth=LANE_BUILD_MAX_DEPTH + 1, probe_cap=plan.probe_cap,
                    inline_k=plan.inline_k, tail_rows_cap=plan.tail_rows_cap,
                    tail_out_cap=plan.tail_out_cap)
    assert plan.depth > LANE_BUILD_MAX_DEPTH
    r = Table({k: torch.from_numpy(v).to(dev) for k, v in cols.items()}, num_rows)
    before = lane_build.launches
    _build_eq(build_lane_tables(r, plan), build_lane_tables_ref(r, plan))
    with pytest.raises(ValueError):
        lane_build(r, plan)
    assert lane_build.launches == before


def test_jitted_lane_join_takes_the_build_kernel(dev):
    """lane2_hash_join jitted: its replays give the bytes of its eager
    call (one build launch a call), each replay launches the count and
    the finish once and no sort of the build; one capture, no rerun."""
    r, s = _lane_join_inputs(dev, 51)
    join = lambda r, s: lane2_hash_join(r, s, 1 << 18)
    assert bool(lane2_path_taken(r, s, 1 << 18))
    before = lane_build.launches
    want = join(r, s)
    assert lane_build.launches == before + 1
    jitted = jit(join)
    n = int(want.num_rows)
    for _ in range(3):
        got = jitted(r, s)
        assert int(got.num_rows) == n > 0
        for name in want.columns:
            _eq(got.columns[name][:n], want.columns[name][:n])
    launched = _traced_port_kernels(dev, lambda: jitted(r, s))
    assert {k: launched.get(k, 0) for k in BUILD_KERNELS} == {k: 1 for k in BUILD_KERNELS}
    assert (jitted.captures, jitted.reruns) == (1, 0)


@pytest.mark.parametrize("impl", ["lane", "sorted"])
def test_join_on_card_matches_cpu(dev, impl):
    r = datagen.gen_relation_np(20_000, 8_000, payloads=2, seed=5)
    s = datagen.gen_relation_np(30_000, 8_000, payloads=1, seed=6)
    on_card = hash_join(Table.from_numpy(r, device=dev),
                        Table.from_numpy(s, device=dev), 1 << 17, impl=impl)
    on_cpu = hash_join(Table.from_numpy(r, device="cpu"),
                       Table.from_numpy(s, device="cpu"), 1 << 17, impl=impl)
    assert int(on_card.num_rows) == int(on_cpu.num_rows)
    assert tables_equal(canonicalize(on_card), canonicalize(on_cpu))
    again = hash_join(Table.from_numpy(r, device=dev),
                      Table.from_numpy(s, device=dev), 1 << 17, impl=impl)
    n = int(on_card.num_rows)
    for k in on_card.columns:  # deterministic rows, order included
        _eq(on_card.columns[k][:n], again.columns[k][:n])


@pytest.mark.parametrize("npart", [1, 8])
@pytest.mark.parametrize("depth", [16, 48, 64])
@pytest.mark.parametrize("k", [1, 4, 8])
def test_probe_walk_matches_plain(dev, k, depth, npart):
    """The walk-only probe over 0-4 build payload columns; one partition
    takes the identity layout, eight the sort + PAD layout. Keys repeat
    up to ~10 times, so cnt passes K."""
    rows = 1500 if npart == 1 else 8000
    for npay in range(5):
        r = datagen.gen_relation(rows, rows // 3, payloads=max(npay, 1),
                                 seed=npay + 1, device=dev)
        if npay == 0:
            r = Table({"key": r.col("key")}, r.num_rows)
        s = datagen.gen_relation(rows, rows // 3, payloads=1, seed=9, device=dev)
        probe_cap = s.capacity if npart == 1 else 2048
        plan = LanePlan(pbits=npart.bit_length() - 1, depth=depth,
                        probe_cap=probe_cap, inline_k=k, tail_rows_cap=2048,
                        tail_out_cap=4096)
        tables = build_lane_tables(r, plan)
        qk, _, lane, qocc, ovf = _probe_layout(plan, s, "key")
        assert not bool(ovf)
        before = probe_walk.launches
        cnt, d_first, pays = probe_walk(tables, qk, lane, qocc)
        assert probe_walk.launches == before + 1
        rcnt, rdf, rpays = probe_walk_ref(tables, qk, lane, qocc)
        _eq(cnt, rcnt)
        _eq(d_first, rdf)
        assert len(pays) == k and all(len(row) == npay for row in pays)
        for row, rrow in zip(pays, rpays):
            for a, b in zip(row, rrow):
                _eq(a, b)
        if depth >= 48:
            assert bool(tables.ok) and int(rcnt.max()) > k


def _membership_case(dev, k, npay):
    """A one-partition list table of 300 keys (D 48, the skew join's list
    table at K 1 without payloads), probed by 2^20 queries of which about
    two in five hold a listed key, some keys listed up to 3 times."""
    rng = np.random.default_rng(k + npay)
    keys = rng.integers(0, 1 << 40, 300)
    keys[:30] = keys[30:60]  # listed twice
    keys[60:70] = keys[:10]  # and three times
    cols = {"key": keys.astype(np.int64)}
    cols.update({f"p{i}": rng.integers(0, 1 << 62, 300) for i in range(npay)})
    r = Table.from_numpy(cols, device=dev)
    q = rng.integers(0, 1 << 40, 1 << 20)
    hit = rng.random(1 << 20) < 0.4
    q[hit] = rng.choice(keys, int(hit.sum()))
    s = Table.from_numpy({"key": q.astype(np.int64)}, device=dev)
    plan = LanePlan(pbits=0, depth=48, probe_cap=1 << 20, inline_k=k,
                    tail_rows_cap=2048, tail_out_cap=4096)
    tables = build_lane_tables(r, plan)
    assert bool(tables.ok)
    qk, _, lane, qocc, ovf = _probe_layout(plan, s, "key")
    assert not bool(ovf)
    return tables, qk, lane, qocc


def _probe_eq(got, want):
    (cnt, d_first, pays), (rcnt, rdf, rpays) = got, want
    _eq(cnt, rcnt)
    _eq(d_first, rdf)
    assert len(pays) == len(rpays)
    for row, rrow in zip(pays, rpays):
        assert len(row) == len(rrow)
        for a, b in zip(row, rrow):
            _eq(a, b)


@pytest.mark.parametrize("chunk", [None, 1024, 2048, 4096, 3000])
@pytest.mark.parametrize("k,npay", [(1, 0), (4, 2)])
def test_probe_walk_one_partition_million_queries(dev, monkeypatch, k, npay, chunk):
    """The config-3 membership shape: one partition, probe_cap 2^20, at
    the work-item size the wrapper picks (None) and at others, one of
    which does not divide probe_cap (3,000)."""
    tables, qk, lane, qocc = _membership_case(dev, k, npay)
    if chunk is not None:
        monkeypatch.setattr(lane_table, "probe_walk_chunk", lambda *_: chunk)
    got = probe_walk(tables, qk, lane, qocc)
    want = probe_walk_ref(tables, qk, lane, qocc)
    _probe_eq(got, want)
    assert int(want[0].max()) == 3 and int((want[0] > 0).sum()) > 400_000
    _probe_eq(probe_walk(tables, qk, lane, qocc), got)


def test_probe_walk_every_query_dead(dev):
    """No live query: cnt 0, d_first -1 and every payload rank 0."""
    tables, qk, lane, qocc = _membership_case(dev, 4, 2)
    dead = torch.zeros_like(qocc)
    cnt, d_first, pays = probe_walk(tables, qk, lane, dead)
    _probe_eq((cnt, d_first, pays), probe_walk_ref(tables, qk, lane, dead))
    assert int(cnt.abs().max()) == 0 and bool((d_first == -1).all())
    assert all(int(p.abs().max()) == 0 for row in pays for p in row)


@pytest.mark.parametrize("r7,s7,taken", [(10, 1000, False), (8, 1024, True)],
                         ids=["past", "full"])
def test_skew_heavy_overflow_on_card(dev, r7, s7, taken):
    """Heavy matches past the heavy buffer send the join to the union
    engine; a full buffer keeps the split. Rows equal numpy's join."""
    r, s = skew_cases.heavy_case(r7, s7)
    R, S = Table.from_numpy(r, device=dev), Table.from_numpy(s, device=dev)
    cap = skew_cases.OUT_CAPACITY
    assert bool(skew_path_taken(R, S, cap)) == taken
    out = hash_join(R, S, cap, impl="skew")
    assert int(out.num_rows) == r7 * s7 + 3000
    assert tables_equal(canonicalize(out), skew_cases.numpy_join(r, s))


@pytest.mark.parametrize("nplanes", [1, 16, 17])
@pytest.mark.parametrize("n,bits", [(100_003, "mixed"), (4096 * 3 + 5, "zeros"),
                                    (5000, "ones"), (1, "mixed"),
                                    (70_001, "any nonzero")])
def test_split1_matches_plain(dev, n, bits, nplanes):
    """n not a multiple of the 4096-row block, n0 = n (all zeros) and
    n0 = 0 (all ones), bit values other than 0 and 1 (every nonzero value
    is a 1); 17 planes take two scatter launches."""
    rng = np.random.default_rng(n)
    bit = {"mixed": rng.integers(0, 2, n), "zeros": np.zeros(n),
           "ones": np.ones(n), "any nonzero": rng.integers(-3, 4, n)}[bits]
    bit = torch.from_numpy(bit.astype(np.int32)).to(dev)
    planes = [torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, n)
                               .astype(np.int32)).to(dev) for _ in range(nplanes)]
    before = _split1.launches
    out = _split1(planes, bit)
    assert _split1.launches == before + 1
    for a, b in zip(out, split1_ref(planes, bit)):
        _eq(a, b)


# digit-pass specs over (full-range, small, carried ids) planes: one
# bit, a full 8-bit digit over three planes with a repeated bit, bits
# of the carried ids, and a sort of 17 specs (8 + 8 + 1)
DIGIT_SPECS = {
    "one bit": [(0, 31)],
    "8 bits over 3 planes": [(0, 3), (0, 31), (1, 0), (0, 17), (0, 17), (2, 1), (1, 2),
                             (0, 0)],
    "7 bits": [(0, b) for b in range(7)],
    "ids": [(2, 0), (2, 1), (2, 12)],
    "one digit for all": [(3, b) for b in range(8)],
}


@pytest.mark.parametrize("specs", list(DIGIT_SPECS))
@pytest.mark.parametrize("n", [2_097_152, 100_003, 4096 * 3 + 5, 1])
def test_split_digit_matches_plain(dev, n, specs):
    """One launch-counted pass per call, byte-equal to the plain version
    (the group's one-bit splits): negative planes, n a multiple of the
    4,096-row tile and not, n = 1, every row of one digit."""
    rng = np.random.default_rng(n + len(specs))
    planes = [rng.integers(-(1 << 31), 1 << 31, n), rng.integers(-4, 4, n),
              np.arange(n), np.full(n, -1)]
    planes += [rng.integers(-(1 << 31), 1 << 31, n) for _ in range(4)]
    planes = [torch.from_numpy(p.astype(np.int32)).to(dev) for p in planes]
    before = split_digit.launches
    out = split_digit(planes, DIGIT_SPECS[specs])
    assert split_digit.launches == before + 1
    for a, b in zip(out, split_digit_ref(planes, DIGIT_SPECS[specs])):
        _eq(a, b)


@pytest.mark.parametrize("length", [1, 7, 8, 9, 17])
def test_lsd_radix_sort_bits_on_card_matches_plain(dev, length):
    """ceil(length / 8) kernel passes, the same planes as one plain split
    per spec, 17 planes (two scatter launches a pass)."""
    rng = np.random.default_rng(length)
    n = 300_001
    planes = [torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32))
              .to(dev) for _ in range(17)]
    specs = [(int(i % 3), int(b)) for i, b in enumerate(rng.integers(0, 32, length))]
    before = split_digit.launches
    got = lsd_radix_sort_bits(planes, specs)
    assert split_digit.launches == before + digit_passes(length)
    want = planes
    for spec in specs:
        want = split1_ref(want, (want[spec[0]] >> spec[1]) & 1)
    for a, b in zip(got, want):
        _eq(a, b)


def test_skew_join_on_card_matches_cpu(dev):
    r = datagen.gen_relation_np(60_000, 65_536, payloads=1, seed=11)
    s = datagen.gen_relation_np(60_000, 65_536, payloads=1, seed=22, kind="zipf")
    before = probe_walk.launches
    on_card = hash_join(Table.from_numpy(r, device=dev),
                        Table.from_numpy(s, device=dev), 1 << 18, impl="skew")
    assert probe_walk.launches == before + 2  # membership of R and of S
    on_cpu = hash_join(Table.from_numpy(r, device="cpu"),
                       Table.from_numpy(s, device="cpu"), 1 << 18, impl="skew")
    assert int(on_card.num_rows) == int(on_cpu.num_rows)
    assert tables_equal(canonicalize(on_card), canonicalize(on_cpu))


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("nbuckets", [1, 9, 4096, 12_288, 12_289, MAX_BUCKETS])
@pytest.mark.parametrize("n", [1, 3, 4, 5, 100_003, 1 << 24])
def test_radix_histogram_matches_plain(dev, n, nbuckets, offset):
    """n below, at and past one 16-byte load and at the planner's 2^24; ids
    starting 4 bytes past a 16-byte boundary (offset 1: ids[1:]); bucket
    counts at and past the 48 KB of shared bins a block gets without
    raising its limit, and MAX_BUCKETS; ids below 0, at the sentinel
    nbuckets and past it are ignored, and one bucket takes a third of the
    ids (the planner's contention). Two runs write the same bytes."""
    rng = np.random.default_rng(n + nbuckets)
    ids = rng.integers(-5, nbuckets + 5, n + offset).astype(np.int32)
    ids[::3] = nbuckets // 2
    ids = torch.from_numpy(ids).to(dev)[offset:]
    assert ids.data_ptr() % 16 == 4 * offset
    before = radix_histogram.launches
    got = radix_histogram(ids, nbuckets)
    assert radix_histogram.launches == before + 1
    _eq(got, radix_histogram_ref(ids, nbuckets))
    _eq(radix_histogram(ids, nbuckets), got)


@pytest.mark.parametrize("nbuckets", [9, 12_289])
def test_radix_histogram_all_out_of_range(dev, nbuckets):
    ids = torch.tensor([-1, nbuckets, nbuckets + 7, -(1 << 31)] * 1001,
                       dtype=torch.int32, device=dev)
    _eq(radix_histogram(ids, nbuckets), torch.zeros(nbuckets, dtype=torch.int32, device=dev))
    _eq(radix_histogram(ids[:1], nbuckets), torch.zeros(nbuckets, dtype=torch.int32,
                                                        device=dev))


def test_dist_join_on_card_matches_cpu(dev):
    """The one-process 8-shard mesh on the card against the same join on
    the CPU, shard by shard: the planned lane join on uniform keys (two
    histogram launches per shard) and the dryrun's skew variants."""
    r = datagen.gen_relation_np(60_000, 60_000, payloads=1, seed=1)
    s = datagen.gen_relation_np(60_000, 60_000, payloads=2, seed=2)
    outs = {}
    for d in (dev, "cpu"):
        mesh = make_mesh(8, d)
        R, S = DistTable.from_numpy(r, mesh), DistTable.from_numpy(s, mesh)
        before = radix_histogram.launches
        out, ovf = dist_hash_join_planned(R, S, mesh, local_impl="lane")
        assert radix_histogram.launches == before + (16 if d == dev else 0)
        assert int(ovf.sum()) == 0
        outs[str(d)] = [out.shards_numpy()] + [
            res.shards_numpy() for res, _ in run_dryrun(mesh).values()]
    for card, cpu in zip(outs[str(dev)], outs["cpu"]):
        for a, b in zip(card, cpu):  # each shard holds the same rows
            a, b = (Table.from_numpy(x, device="cpu") for x in (a, b))
            assert tables_equal(canonicalize(a), canonicalize(b))


def test_radix_merge_on_card_matches_cpu(dev):
    r = datagen.gen_relation_np(20_000, 8_000, payloads=2, seed=5)
    s = datagen.gen_relation_np(30_000, 8_000, payloads=1, seed=6)
    r["key"][:500] -= 1 << 40
    s["key"][:700] -= 1 << 40
    before = split_digit.launches
    on_card = merge_join(Table.from_numpy(r, device=dev),
                         Table.from_numpy(s, device=dev), 1 << 17,
                         sort_engine="radix")
    assert split_digit.launches == before + digit_passes(len(union_sort_specs(64)))
    on_cpu = merge_join(Table.from_numpy(r, device="cpu"),
                        Table.from_numpy(s, device="cpu"), 1 << 17,
                        sort_engine="radix")
    assert int(on_card.num_rows) == int(on_cpu.num_rows)
    assert tables_equal(canonicalize(on_card), canonicalize(on_cpu))


def test_aggregate_pack_on_card_matches_plain(dev, monkeypatch):
    """The sort path's call that PACK made before the run-end kernel took
    it (2^19 rows, about 200,000 of them group ends): one run-end launch
    a call and no PACK launch, its outputs and group count byte-equal to
    the plain version (with the plain PACK and with the PACK kernel);
    the whole sort path equals the CPU's over the whole capacity, twice
    (a two-row group's sum wraps)."""
    from tpq_torch.ops.hash_aggregate import sort_aggregate

    agg_mod = importlib.import_module("tpq_torch.ops.hash_aggregate")
    cols = datagen.gen_relation_np(400_000, 250_000, payloads=3, seed=12)
    calls = []

    def rec(key, values, num_rows, _runs=agg_mod.aggregate_runs):
        calls.append((key, values, num_rows))
        return _runs(key, values, num_rows)

    monkeypatch.setattr(agg_mod, "aggregate_runs", rec)
    packs, runs = pack.launches, aggregate_runs.launches
    on_card = [sort_aggregate(Table.from_numpy(cols, device=dev)) for _ in range(2)]
    assert pack.launches == packs and aggregate_runs.launches == runs + 2
    args = calls[0]
    assert len(calls) == 2 and len(args[1]) == 3 and args[0].shape[0] == 1 << 19
    got = aggregate_runs(*args)
    for want in (aggregate_runs_ref(*args), aggregate_runs_ref(*args, pack=pack)):
        _eq(got[1], want[1])
        for a, b in zip(got[0], want[0]):
            _eq(a, b)
    on_cpu = sort_aggregate(Table.from_numpy(cols, device="cpu"))
    n = int(on_cpu.num_rows)
    assert int(on_card[0].num_rows) == n > 150_000
    for k in on_cpu.columns:
        _eq(on_card[0].columns[k].cpu(), on_cpu.columns[k])
        _eq(on_card[0].columns[k], on_card[1].columns[k])


def _agg_eq(got, want):
    _eq(got[1], want[1])
    assert len(got[0]) == len(want[0])
    for a, b in zip(got[0], want[0]):
        _eq(a, b)


@pytest.mark.parametrize("name", agg_cases.CASES)
def test_aggregate_runs_kernel_contract_cases(dev, name):
    """tests/torch_aggregate_cases.py at 4x the CPU's rows (13 tiles):
    every output slot and the group count byte-equal to the plain version
    and to numpy's, with num_rows an int32 and an int64 tensor, twice
    (the look-back's epoch advances between calls); one launch a call, two
    past 14 value columns."""
    key, values, num_rows = agg_cases.agg_case(name, scale=4)
    want_np, g = agg_cases.np_aggregate(key, values, num_rows)
    k, vs = torch.from_numpy(key).to(dev), [torch.from_numpy(v).to(dev) for v in values]
    per_call = 1 if len(vs) <= 14 else 2
    for dt in (torch.int32, torch.int64):
        nr = torch.tensor(num_rows, dtype=dt, device=dev)
        before = aggregate_runs.launches
        got, again = aggregate_runs(k, vs, nr), aggregate_runs(k, vs, nr)
        assert aggregate_runs.launches == before + 2 * per_call
        want = aggregate_runs_ref(k, vs, nr)
        _agg_eq(got, want)
        _agg_eq(again, want)
        assert int(got[1]) == g
        for a, w in zip(got[0], want_np):
            assert np.array_equal(a.cpu().numpy(), w)


def test_aggregate_runs_kernel_large_random(dev):
    """2^22 rows (1,024 tiles, more than one persistent grid) of zipf
    keys, 3,000,000 valid, int64 and int32 values: byte-equal to the plain
    version over the whole capacity."""
    rng = np.random.default_rng(22)
    n, live = 1 << 22, 3_000_000
    keys = np.sort(rng.zipf(1.3, live).astype(np.int64))
    key = np.full(n, np.iinfo(np.int64).max, np.int64)
    key[:live] = keys
    vals = [rng.integers(0, 1 << 63, n, dtype=np.int64),
            rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32),
            rng.integers(0, 1 << 63, n, dtype=np.int64)]
    args = (torch.from_numpy(key).to(dev), [torch.from_numpy(v).to(dev) for v in vals],
            torch.tensor(live, device=dev))
    got = aggregate_runs(*args)
    _agg_eq(got, aggregate_runs_ref(*args))
    assert 1000 < int(got[1]) < live


def test_jitted_hash_aggregate_replays_same_bytes(dev):
    """hash_aggregate jitted with its outputs handed off (the graph's own
    buffers, the whole capacity): the body makes no host read under the
    capture flag, two replays give the same bytes, the zeros past the
    groups included, and equal the eager call's; both take the group
    table (`tpq.aggregate.ok`), so the graph holds no kernel's per-stream
    state (no run-end pass, no PACK)."""
    from tpq_torch.ops.hash_aggregate import hash_aggregate

    t = Table.from_numpy(datagen.gen_relation_np(300_000, 20_000, payloads=2, seed=9),
                         device=dev)
    with host_reads("raise"), deferred():
        hash_aggregate(t)
    torch.cuda.synchronize()
    eager = hash_aggregate(t)
    jitted = jit(hash_aggregate, hand_off=True)
    first = {k: v.clone() for k, v in jitted(t).columns.items()}
    second = jitted(t)
    assert int(second.num_rows) == int(eager.num_rows) > 10_000
    for k, v in eager.columns.items():
        _eq(first[k], v)
        _eq(second.columns[k], v)
    assert len(jitted._graphs) == 1 and jitted.reruns == 0
    assert jitted.stats()["conds"]["tpq.aggregate.ok"] == {"then": 2, "else": 0}
    assert next(iter(jitted._graphs.values())).states == []


@pytest.mark.parametrize("name", agg_cases.CASES)
def test_group_table_kernels_match_plain(dev, name):
    """tests/torch_aggregate_cases.py's rows in random order at 4x the
    CPU's: the pass (group_insert) and the write (group_write) on the
    card, with num_rows an int32 and an int64 tensor, twice: `ok`, the
    distinct count, the group count and every output slot byte-equal to
    the plain twins' and to numpy's, the two calls' bytes equal; the
    write kernel equal to its twin on the kernel's own table; one launch
    of each a call. Past MAX_VALUES (4) value columns group_insert refuses
    the table, and hash_aggregate launches none and equals numpy (the
    sort path)."""
    from tpq_torch.ops.hash_aggregate import hash_aggregate

    key, values, num_rows = agg_cases.hash_case(name, scale=4)
    want_np, g = agg_cases.np_groups(key, values, num_rows)
    k, vs = torch.from_numpy(key).to(dev), [torch.from_numpy(v).to(dev) for v in values]
    if len(vs) > group_table.MAX_VALUES:
        with pytest.raises(ValueError, match="MAX_VALUES"):
            group_insert(k, vs, num_rows)
        ins = group_insert.launches
        names = [f"v{i}" for i in range(len(vs))]
        got = hash_aggregate(Table(dict(zip(["key", *names], [k, *vs])), num_rows))
        assert group_insert.launches == ins and int(got.num_rows) == g
        for a, w in zip(got.columns.values(), want_np):
            assert np.array_equal(a.cpu().numpy(), w)
        return
    for dt in (torch.int32, torch.int64):
        nr = torch.tensor(num_rows, dtype=dt, device=dev)
        want = group_write_ref(group_insert_ref(k, vs, nr))
        firsts = []
        for _ in range(2):
            ins, wr = group_insert.launches, group_write.launches
            table = group_insert(k, vs, nr)
            got = group_write(table)
            assert group_insert.launches == ins + 1
            assert group_write.launches == wr + 1
            assert bool(table.ok) and int(table.inserted) == g == int(got[1])
            _agg_eq(got, want)
            _agg_eq(group_write_ref(table), got)
            firsts.append(got)
        _agg_eq(firsts[0], firsts[1])
        for a, w in zip(firsts[0][0], want_np):
            assert np.array_equal(a.cpu().numpy(), w)


@pytest.mark.parametrize("extra", [0, 1, 100_000])
def test_group_table_limit_on_card(dev, monkeypatch, extra):
    """MAX_SLOTS 2^12 (limit 2^11) under 2^20 rows of 2^11 distinct keys
    (INT64_MAX among them) and `extra` more: `ok` is distinct keys <=
    2^11 on the card as in the twin; at the limit the kernel counts every
    key and its groups are the twin's; far past it the pass stops early
    (no probe loops on a full table) and the aggregate is the sort
    path's."""
    from tpq_torch.ops.hash_aggregate import hash_aggregate, sort_aggregate

    monkeypatch.setattr(group_table, "MAX_SLOTS", 1 << 12)
    rng = np.random.default_rng(12 + extra)
    domain = np.concatenate([rng.choice(1 << 50, (1 << 11) - 1 + extra, replace=False),
                             np.array([np.iinfo(np.int64).max], np.int64)])
    n = 1 << 20
    key = rng.choice(domain, n)
    key[:len(domain)] = domain
    vals = [rng.integers(0, 1 << 62, n), rng.integers(-9, 9, n).astype(np.int32)]
    args = (torch.from_numpy(key).to(dev), [torch.from_numpy(v).to(dev) for v in vals],
            torch.tensor(n, device=dev))
    table, twin = group_insert(*args), group_insert_ref(*args)
    assert table.slots == 1 << 12 and bool(table.ok) == bool(twin.ok) == (extra == 0)
    if extra == 0:
        assert int(table.inserted) == int(twin.inserted) == 1 << 11
        _agg_eq(group_write(table), group_write_ref(twin))
    t = Table(dict(zip(["key", "a", "b"], [args[0], *args[1]])), n)
    by_hash, by_sort = hash_aggregate(t), sort_aggregate(t)
    for name in by_sort.columns:
        _eq(by_hash.columns[name], by_sort.columns[name])
    _eq(by_hash.num_rows, by_sort.num_rows)


def test_jitted_pipeline_takes_the_group_table(dev):
    """The jitted lane pipeline at a small shape, three calls on new
    seeds and filter values: the cond `tpq.aggregate.ok` takes the table
    on every call, no rerun, one graph, every call's groups (the live
    rows jit copies out) equal to the eager sort path's."""
    from tpq_torch.ops.hash_aggregate import sort_aggregate

    pipe = jit_pipeline(1 << 14, join_impl="lane")
    for seed, value in ((1, 512), (2, 100), (3, 900)):
        dim = Table.from_numpy(datagen.gen_relation_np(1024, 1024, payloads=1,
                                                       seed=seed), device=dev)
        fact = Table.from_numpy(datagen.gen_relation_np(8192, 1024, payloads=2,
                                                        seed=seed + 10), device=dev)
        got = pipe(dim, fact, value)
        keep = keep_mask(fact, "key", "lt", value)
        want = sort_aggregate(hash_join(dim, fact, 1 << 14, impl="lane", probe_keep=keep))
        n = int(want.num_rows)
        assert int(got.num_rows) == n > 0
        for name in want.columns:
            _eq(got.columns[name][:n], want.columns[name][:n])
    assert pipe.stats()["conds"]["tpq.aggregate.ok"] == {"then": 3, "else": 0}
    assert len(pipe._graphs) == 1 and pipe.reruns == 0


def test_jitted_aggregate_fallback_byte_equal(dev, monkeypatch):
    """hash_aggregate jitted over more groups than a 2^10-slot table's
    limit, three calls: the first replay's `ok` is false, so it reruns
    and captures the sort path's graph, which the second and third
    replay with no rerun; every call byte-equal to sort_aggregate over
    the whole capacity. The sort path's graph holds the run-end
    look-back state it was captured with; no eager call shares it."""
    from tpq_torch.ops.hash_aggregate import hash_aggregate, sort_aggregate

    monkeypatch.setattr(group_table, "MAX_SLOTS", 1 << 10)
    t = Table.from_numpy(datagen.gen_relation_np(300_000, 20_000, payloads=2, seed=9),
                         device=dev)
    want = sort_aggregate(t)
    jitted = jit(hash_aggregate, hand_off=True)
    for _ in range(3):
        got = jitted(t)
        _eq(got.num_rows, want.num_rows)
        for name in want.columns:
            _eq(got.columns[name], want.columns[name])
    assert jitted.reruns == 1 and jitted.captures == 2
    assert jitted.stats()["conds"]["tpq.aggregate.ok"] == {"then": 0, "else": 3}
    held = [s for g in jitted._graphs.values() if g.path == (False,) for s in g.states]
    kept = list(_build._stream_states.values())
    assert held and not any(h is k for h in held for k in kept)


def test_chunked_agg_core_captures_the_sort_path(dev):
    """The chunked config-4 bench jitted (staged) at 600,000 fact rows in
    chunks of 2^18: agg_core, a body that updates its accumulator in place
    and may hold no cond, runs the sort path; it is captured once and
    never reruns, nothing is captured in the loop, and every group is
    exact."""
    from tpq_torch.bench import scale_bench

    rep = scale_bench.bench_pipeline(n_dim=1 << 18, n_fact=600_000, chunk_rows=1 << 18,
                                     filter_value=1 << 17, device=dev, log=lambda _: None)
    assert rep["groups_exact"] and rep["lane_path_taken_all_chunks"]
    agg = rep["jit"]["agg_core"]
    assert (agg["graphs"], agg["captures"], agg["reruns"]) == (1, 1, 0)
    assert rep["loop_captures"] == 0


def test_accumulator_pad_on_card_matches_plain(dev, monkeypatch):
    """The chunked config-4 bench on the card, eager, at 600,000 fact
    rows in chunks of 2^18: each chunk's groups PADded into the dense
    accumulator (196,608 aggregate rows into 131,072 slots) byte-equal to
    the plain version, every group exact against numpy, every chunk on
    the lane path."""
    from tpq_torch.bench import scale_bench

    calls = []

    def rec(planes, dest, n_live, out_len, _pad=scale_bench.pad):
        calls.append((planes, dest, n_live, out_len))
        return _pad(planes, dest, n_live, out_len)

    monkeypatch.setattr(scale_bench, "pad", rec)
    rep = scale_bench.bench_pipeline(n_dim=1 << 18, n_fact=600_000, chunk_rows=1 << 18,
                                     filter_value=1 << 17, device=dev, eager=True,
                                     log=lambda _: None)
    assert rep["groups_exact"] and rep["lane_path_taken_all_chunks"]
    # the warm-up's chunks, then each chunk of the loop
    assert len(calls) == min(2, rep["nchunks"]) + rep["nchunks"]
    for args in calls:
        assert args[1].shape[0] == 196_608 and args[3] == 1 << 17
        got, want = pad(*args), pad_ref(*args)
        _eq(got[1], want[1])
        for a, b in zip(got[0], want[0]):
            _eq(a, b)


def test_gen_relation_device_on_card_equals_numpy(dev):
    """The on-device streams on the card, byte-equal to numpy's at a
    2^24-row offset and a key domain that is not a power of two."""
    off, rows = 1 << 24, 300_000
    t = datagen.gen_relation_device(rows, 10_000_000, 4, seed=2, row_offset=off,
                                    device=dev)
    want = datagen.gen_relation_np(off + rows, 10_000_000, 4, seed=2)
    for k, v in t.columns.items():
        assert v.device.type == "cuda"
        assert np.array_equal(v[:rows].cpu().numpy(), want[k][off:]), k


@pytest.fixture(scope="module")
def hash_input():
    """2^24 + 4 keys over the whole int64 range with INT64_MIN, INT64_MAX,
    -1 and 0 mixed in, on the card from a 16-byte boundary."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    rng = np.random.default_rng(8)
    k = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, (1 << 24) + 4,
                     dtype=np.int64, endpoint=True)
    edge = np.array([np.iinfo(np.int64).min, np.iinfo(np.int64).max, -1, 0], np.int64)
    k[:8] = np.tile(edge, 2)
    k[rng.integers(0, k.size, 4096)] = np.tile(edge, 1024)
    t = torch.from_numpy(k).cuda()
    assert t.data_ptr() % 16 == 0
    return t


@pytest.mark.parametrize("salt", [0, SALT_LANE, SALT_H2, OWNER_SALT])
@pytest.mark.parametrize("bits", [1, 7, 16, 19, 31, 32])
def test_hash_kernel_matches_plain(hash_input, bits, salt):
    """n 0, 1, 3, 5, 100,003 and 2^24 + 3, from a 16-byte boundary and 8
    bytes past it (the head and the tail one key at a time); one launch
    each, none at n 0."""
    for offset in (0, 1):
        for n in (0, 1, 3, 5, 100_003, (1 << 24) + 3):
            keys = hash_input[offset:offset + n]
            assert n == 0 or keys.data_ptr() % 16 == 8 * offset  # empty: no pointer
            before = hash_keys.launches
            got = hash_keys(keys, bits, salt)
            assert hash_keys.launches == before + (n > 0)
            _eq(got, hash_keys_ref(keys, bits, salt))
            if n and n < 200_000:
                np.testing.assert_array_equal(
                    got.cpu().numpy(), np_hash_keys(keys.cpu().numpy(), bits, salt))
            if bits == 32 and n > 1000:
                assert (got < 0).any()


def test_hash_kernel_takes_int32_keys_and_shapes(hash_input):
    """int32 keys widen as tpq widens them; a 2-D input keeps its shape."""
    k32 = hash_input[:100_000].to(torch.int32)
    _eq(hash_keys(k32, 12, SALT_LANE), hash_keys_ref(k32, 12, SALT_LANE))
    k2 = hash_input[:4096].view(64, 64)
    _eq(hash_keys(k2, 20, OWNER_SALT), hash_keys_ref(k2, 20, OWNER_SALT))
    with pytest.raises(ValueError):
        hash_keys(hash_input[:10], 33)


@pytest.mark.parametrize("nchips", [8, 6])
def test_owner_of_matches_numpy(hash_input, nchips):
    keys = hash_input[1:1_000_001]
    want = (np_hash_keys(keys.cpu().numpy(), 32, OWNER_SALT).view(np.uint32)
            % np.uint32(nchips)).astype(np.int32)
    np.testing.assert_array_equal(owner_of(keys, nchips).cpu().numpy(), want)


# ---------------------------------------------------------------------------
# jit: the joins and the pipeline as CUDA graphs, and the look-back epoch
# on the card
# ---------------------------------------------------------------------------

# body, probe-side key distribution; R and S 60,000 rows over 65,536 keys
JIT_JOINS = {
    "lane": (lambda r, s: hash_join(r, s, 1 << 18, impl="lane"), "uniform"),
    "sorted": (lambda r, s: hash_join(r, s, 1 << 18, impl="sorted"), "zipf"),
    "skew": (lambda r, s: hash_join(r, s, 1 << 18, impl="skew"), "zipf"),
    "merge_radix": (lambda r, s: merge_join(r, s, 1 << 18, sort_engine="radix"),
                    "zipf"),
}


@pytest.mark.parametrize("name", list(JIT_JOINS))
def test_jitted_join_replays_equal_eager(dev, name):
    """One graph, captured at the first call and replayed on three more
    seeds: every call's rows equal the eager join's, no call reruns."""
    body, kind = JIT_JOINS[name]
    jitted = jit(body)
    for seed in (5, 6, 7, 8):
        r = Table.from_numpy(datagen.gen_relation_np(60_000, 65_536, payloads=1,
                                                     seed=seed), device=dev)
        s = Table.from_numpy(datagen.gen_relation_np(60_000, 65_536, payloads=1,
                                                     seed=seed + 100, kind=kind),
                             device=dev)
        got, want = jitted(r, s), body(r, s)
        assert int(got.num_rows) == int(want.num_rows) > 0
        assert tables_equal(canonicalize(got), canonicalize(want))
    assert len(jitted._graphs) == 1 and jitted.reruns == 0


@pytest.mark.parametrize("algo,impl", [("hash", "lane"), ("hash", "sorted"),
                                       ("merge", "sorted")])
def test_jitted_pipeline_replays_equal_eager(dev, algo, impl):
    """One pipeline graph serves three seeds and three filter values (a
    graph that baked the first value in would answer with its rows)."""
    pipe = jit_pipeline(1 << 14, algo=algo, join_impl=impl)
    rows = []
    for seed, value in ((1, 512), (2, 100), (3, 900)):
        dim = Table.from_numpy(datagen.gen_relation_np(1024, 1024, payloads=1,
                                                       seed=seed), device=dev)
        fact = Table.from_numpy(datagen.gen_relation_np(8192, 1024, payloads=2,
                                                        seed=seed + 10), device=dev)
        got, want = pipe(dim, fact, value), pipe.__wrapped__(dim, fact, value)
        assert int(got.num_rows) == int(want.num_rows) > 0
        assert tables_equal(canonicalize(got), canonicalize(want))
        rows.append(int(got.num_rows))
    assert len(set(rows)) == 3
    assert len(pipe._graphs) == 1 and pipe.reruns == 0


def test_jitted_fallback_reruns_exact(dev):
    """tests/test_kernels.py:173's h2-colliding pair, three calls: the
    first replay's `ok` is false, so the first call reruns eagerly and
    captures the graph of the path it took (the fallback); the second
    and third replay that graph alone (no kernel wrapper runs, no rerun).
    Every call answers with the sorted join's rows."""
    k1, k2 = 7302945295039616556, 3449075177175606448
    r = Table.from_numpy({"key": np.array([k1, k2, 5, 6, 7], dtype=np.int64),
                          "p0": np.arange(5, dtype=np.int64)}, device=dev)
    s = Table.from_numpy({"key": np.array([k1, k2, k1, 6], dtype=np.int64),
                          "p0": np.arange(4, dtype=np.int64) * 10}, device=dev)
    jitted = jit(lambda r, s: hash_join(r, s, 1 << 8, impl="lane"))
    want = canonicalize(hash_join(r, s, 1 << 8, impl="sorted"))
    wrappers = (pad, pack, fused_walk_emit, hash_keys, lane_build)
    for call in (1, 2, 3):
        if call == 2:
            launched = [w.launches for w in wrappers]
        got = jitted(r, s)
        assert jitted.reruns == 1 and int(got.num_rows) == 4
        assert tables_equal(canonicalize(got), want)
    assert [w.launches for w in wrappers] == launched
    assert len(jitted._graphs) == 2 and jitted.captures == 2 and jitted.copies == 0


def _lane_join_inputs(dev, seed):
    r = Table.from_numpy(datagen.gen_relation_np(60_000, 65_536, payloads=1, seed=seed),
                         device=dev)
    s = Table.from_numpy(datagen.gen_relation_np(60_000, 65_536, payloads=1,
                                                 seed=seed + 100), device=dev)
    return r, s


def _lane(r, s):
    return hash_join(r, s, 1 << 18, impl="lane")


def test_jit_repeated_call_copies_nothing(dev):
    """Calls on the same tensors replay one graph over the caller's
    tensors: no copy in, one capture, the eager rows every time, also
    with a traced number that changes from call to call."""
    r, s = _lane_join_inputs(dev, 31)
    jitted = jit(_lane)
    want = canonicalize(_lane(r, s))
    for _ in range(3):
        assert tables_equal(canonicalize(jitted(r, s)), want)
    assert (jitted.copies, jitted.captures, jitted.reruns) == (0, 1, 0)
    # a traced number fills the graph's own scalar: no copy, no capture
    pipe = jit_pipeline(1 << 18, join_impl="lane")
    for value in (30_000, 10_000, 50_000):
        got, want = pipe(r, s, value), pipe.__wrapped__(r, s, value)
        assert tables_equal(canonicalize(got), canonicalize(want))
    assert (pipe.copies, pipe.captures, pipe.reruns) == (0, 1, 0)


def test_jit_reads_a_tensor_changed_in_place(dev):
    """The graph reads its inputs in place: after the caller overwrites
    the probe keys and a build payload in place, the next call gives the
    eager rows of the new contents, with no copy and no new capture."""
    r, s = _lane_join_inputs(dev, 32)
    r2, s2 = _lane_join_inputs(dev, 33)
    jitted = jit(_lane)
    first = jitted(r, s)
    s.columns["key"].copy_(s2.columns["key"])
    r.columns["p0"].copy_(r2.columns["p0"])
    got, want = jitted(r, s), _lane(r, s)
    assert tables_equal(canonicalize(got), canonicalize(want))
    assert not tables_equal(canonicalize(first), canonicalize(want))
    assert (jitted.copies, jitted.captures) == (0, 1)


def test_jit_new_addresses_exact_and_callers_unchanged(dev):
    """Calls at new addresses, and the same tensors in the other order,
    give the eager rows; the graph is captured again with the moved
    positions in buffers of its own, so later calls copy in, and no
    caller's tensor is written."""
    r, s = _lane_join_inputs(dev, 34)
    r2, s2 = _lane_join_inputs(dev, 35)
    before = [c.clone() for t in (r, s, r2, s2) for c in (*t.columns.values(), t.num_rows)]
    jitted = jit(_lane)
    for a, b in ((r, s), (r2, s2), (r, s), (s, r), (s2, r2)):
        assert tables_equal(canonicalize(jitted(a, b)), canonicalize(_lane(a, b)))
    after = [c for t in (r, s, r2, s2) for c in (*t.columns.values(), t.num_rows)]
    assert all(torch.equal(x, y) for x, y in zip(before, after))
    assert len(jitted._graphs) == 1 and jitted.captures == 2 and jitted.copies > 0


def test_graph_of_pack_and_walk_emit_replays_exact(dev):
    """A graph that launches PACK twice and the fused walk/emit twice,
    replayed on four sets of inputs: every output byte-equal to the plain
    versions at every replay, and every launch of every replay takes the
    next look-back epoch on the card (4 after the warm-up, 4 more a
    replay; the second inputs' new capture starts anew). An epoch fixed
    at capture would let a replay's look-back read the last replay's
    statuses as its own wherever a predecessor has not yet published."""
    cap = 1 << 17

    def body(cols, occ_a, occ_b, tables, qk, lane, qocc_a, qocc_b, spay):
        return (pack(cols, occ_a), pack(cols, occ_b),
                fused_walk_emit(tables, qk, lane, qocc_a, spay, cap),
                fused_walk_emit(tables, qk, lane, qocc_b, spay, cap))

    jitted = jit(body)
    epochs = []
    for seed in range(4):
        rng = np.random.default_rng(seed)
        r = datagen.gen_relation(60_000, 65_536, payloads=2, seed=seed, device=dev)
        s = datagen.gen_relation(60_000, 65_536, payloads=1, seed=seed + 50, device=dev)
        plan = plan_lane2(r.capacity, s.capacity, out_capacity=cap)
        tables = build_lane2_tables(r, plan)
        qk, spay, lane, qocc, _ = _probe_layout(plan, s, "key")
        half = torch.from_numpy(rng.random(qocc.shape[0]) < 0.5).to(dev, torch.int32)
        qocc_b = qocc * half
        n = 300_000
        cols = [torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, n)).to(dev),
                torch.from_numpy(rng.integers(0, 1 << 30, n).astype(np.int32)).to(dev)]
        occ_a, occ_b = (torch.from_numpy((rng.random(n) < d).astype(np.int32)).to(dev)
                        for d in (rng.random(), rng.random()))
        got = jitted(cols, occ_a, occ_b, tables, qk, lane, qocc, qocc_b, spay)
        for (outs, total), occ in zip(got[:2], (occ_a, occ_b)):
            want_outs, want_total = pack_ref(cols, occ)
            _eq(total, want_total)
            for a, b in zip(outs, want_outs):
                _eq(a, b)
        for (outs, cnt, d_first), q in zip(got[2:], (qocc, qocc_b)):
            want_outs, want_cnt, want_df = fused_walk_emit_ref(tables, qk, lane, q, spay,
                                                               cap)
            _eq(cnt, want_cnt)
            _eq(d_first, want_df)
            m = min(int(want_cnt.clamp_max(plan.inline_k).sum()), cap)
            assert m > 0
            for a, b in zip(outs, want_outs):
                _eq(a[:m], b[:m])
        (graph,) = jitted._graphs.values()
        (state,) = graph.states  # PACK's and the walk/emit's, one owner
        epochs.append((int(state[0]) >> 32) & 0xFFFFFFFF)
    # the second inputs lie elsewhere: the graph is captured again (its
    # warm-up and its new state start the epochs anew), and from then on
    # the inputs are copied into its own buffers
    assert epochs == [8, 8, 12, 16]
    assert len(jitted._graphs) == 1 and jitted.reruns == 0 and jitted.captures == 2


def _card(dev) -> torch.device:
    """dev with its index, as a kernel's tensors carry it."""
    return torch.device("cuda", torch.device(dev).index or 0)


def _state_of(owner, card: torch.device, stream) -> torch.Tensor:
    """The int64 buffer `owner`'s kernels keep for `stream` (the one their
    launches made: asking for 0 words replaces none)."""
    return _build.stream_state(owner, card, stream.cuda_stream, 0, torch.int64)


@pytest.mark.parametrize("kernel", ["pack", "walk_emit"])
def test_look_back_epoch_advances_on_the_card_and_wraps(dev, kernel):
    """Each launch advances the state's epoch word by one, on the card.
    The launch of the last epoch (2^32 - 1) zeroes the status words and
    the epoch, so the launch after the wrap takes epoch 1 on clean words:
    statuses planted with epoch 1 before the wrap, inclusive and with a
    wrong count, reach no output."""
    if kernel == "pack":
        cols, occ = cases.pack_case("sixteen_cols")
        args = ([torch.from_numpy(c).to(dev) for c in cols], torch.from_numpy(occ).to(dev))
        call, want = (lambda: pack(*args)), pack_ref(*args)

        def check(got):
            _eq(got[1], want[1])
            for a, b in zip(got[0], want[0]):
                _eq(a, b)
    else:
        plan, args = _walk_emit_case(dev, "D 72")
        call, want = (lambda: fused_walk_emit(*args)), fused_walk_emit_ref(*args)
        n = min(int(want[1].clamp_max(plan.inline_k).sum()), args[-1])

        def check(got):
            _eq(got[1], want[1])
            _eq(got[2], want[2])
            for a, b in zip(got[0], want[0]):
                _eq(a[:n], b[:n])

    stream = torch.cuda.Stream(dev)
    card = _card(dev)
    _build.take_stream_state(card, stream.cuda_stream)

    def epoch(state):  # state[0] is the last epoch << 32 | the tickets drawn
        return (int(state[0]) >> 32) & 0xFFFFFFFF

    try:
        with torch.cuda.stream(stream):
            epochs = []
            for _ in range(2):
                check(call())
                epochs.append(epoch(_state_of(move.PACK_OWNER, card, stream)))
            assert epochs == [1, 2]
            state = _state_of(move.PACK_OWNER, card, stream)
            state[0] = ((2**32 - 2) << 32) - 2**64  # last epoch 2^32 - 2, as int64
            state[move.STATE_HEADER:] = (1 << 32) | (1 << 31) | 777
            check(call())  # epoch 2^32 - 1
            assert int(state[0]) == 0 and int(state[1]) == 0
            assert not state[move.STATE_HEADER:].any()
            check(call())  # epoch 1 again
            assert int(state[0]) == 1 << 32
        torch.cuda.synchronize(dev)
    finally:
        _build.take_stream_state(card, stream.cuda_stream)


def test_aggregate_state_leaves_pack_and_walk_emit_statuses(dev):
    """The run-end pass's records carry raw sums. An aggregate whose
    tiles' open-run sums hold the next epoch of PACK's state in their high
    words runs between PACK launches on one stream: its records land in a
    buffer of its own, no word past the header of PACK's state carries an
    epoch later than PACK's last launch, and PACK and the walk/emit that
    follow on the stream give their plain versions' bytes."""
    cols, occ = cases.pack_case("sixteen_cols")
    pargs = ([torch.from_numpy(c).to(dev) for c in cols], torch.from_numpy(occ).to(dev))
    pwant = pack_ref(*pargs)
    plan, wargs = _walk_emit_case(dev, "D 72")
    wwant = fused_walk_emit_ref(*wargs)
    nw = min(int(wwant[1].clamp_max(plan.inline_k).sum()), wargs[-1])
    stream = torch.cuda.Stream(dev)
    card = _card(dev)
    _build.take_stream_state(card, stream.cuda_stream)

    def check_pack():
        outs, total = pack(*pargs)
        _eq(total, pwant[1])
        for a, b in zip(outs, pwant[0]):
            _eq(a, b)

    try:
        with torch.cuda.stream(stream):
            check_pack()
            pstate = _state_of(move.PACK_OWNER, card, stream)
            nxt = ((int(pstate[0]) >> 32) & 0xFFFFFFFF) + 1
            n = 8 * aggregate.AGG_TILE  # one run over 8 tiles
            key = torch.zeros(n, dtype=torch.int64, device=dev)
            vals = torch.zeros(n, dtype=torch.int64, device=dev)
            vals[aggregate.AGG_TILE - 1::aggregate.AGG_TILE] = nxt << 32
            got = aggregate_runs(key, [vals], torch.tensor(n, device=dev))
            _agg_eq(got, aggregate_runs_ref(key, [vals], torch.tensor(n, device=dev)))
            assert int(got[0][2][0]) == (8 * nxt) << 32
            astate = _state_of(aggregate.state_owner(1), card, stream)
            assert astate.data_ptr() != pstate.data_ptr()
            last = (int(pstate[0]) >> 32) & 0xFFFFFFFF
            assert last == nxt - 1
            assert bool((((pstate[move.STATE_HEADER:] >> 32) & 0xFFFFFFFF) <= last).all())
            check_pack()
            wgot = fused_walk_emit(*wargs)
            _eq(wgot[1], wwant[1])
            _eq(wgot[2], wwant[2])
            for a, b in zip(wgot[0], wwant[0]):
                _eq(a[:nw], b[:nw])
        torch.cuda.synchronize(dev)
    finally:
        _build.take_stream_state(card, stream.cuda_stream)


# ---------------------------------------------------------------------------
# jit's hand-off and in-place state, the sorts under a graph, and the
# distributed join's jitted body
# ---------------------------------------------------------------------------

def test_jit_hand_off_feeds_the_next_program_without_a_copy(dev):
    """A generator handing its chunk over (hand_off) to a probe that
    hands its counts over: the probe's graph reads the generator's own
    outputs in place, so 5 chunks copy nothing in, and each chunk's
    count equals the eager bodies'."""
    r = datagen.gen_relation(60_000, 65_536, payloads=1, seed=3, device=dev)
    plan = plan_lane2(r.capacity, 1 << 16, out_capacity=1 << 17)
    tables = build_lane2_tables(r, plan)

    def gen_body(d, off):
        return datagen.gen_relation_device(1 << 16, 65_536, 1, seed=4, capacity=1 << 16,
                                           row_offset=off, device=d).columns

    def probe_body(tables, cols, rows):
        out, ok = lane2_probe_emit(tables, Table(cols, rows), 1 << 17)
        return out.num_rows, ok

    gen_j, probe_j = jit(gen_body, hand_off=True), jit(probe_body, hand_off=True)
    for ci in range(5):
        rows = 60_000 - 1000 * ci
        got_n, got_ok = probe_j(tables, gen_j(dev, ci << 16), rows)
        want_n, want_ok = probe_body(tables, gen_body(dev, ci << 16), rows)
        assert int(got_n) == int(want_n) > 0 and bool(got_ok) and bool(want_ok)
    assert (gen_j.copies, probe_j.copies) == (0, 0)
    assert (gen_j.captures, probe_j.captures) == (1, 1)
    assert probe_j.reruns == 0


def test_jit_default_result_survives_the_next_call(dev):
    """jit(fn) without hand_off returns fresh tensors: a result kept
    across the callable's next call (on other inputs) is unchanged."""
    jitted = jit(_lane)
    r, s = _lane_join_inputs(dev, 36)
    r2, s2 = _lane_join_inputs(dev, 37)
    first = jitted(r, s)
    kept = {k: c[:int(first.num_rows)].clone() for k, c in first.columns.items()}
    second = jitted(r2, s2)
    assert tables_equal(canonicalize(second), canonicalize(_lane(r2, s2)))
    for k, c in kept.items():
        assert torch.equal(first.columns[k][:int(first.num_rows)], c), k
    assert tables_equal(canonicalize(first), canonicalize(_lane(r, s)))


def test_jit_carried_state_updated_in_place_is_exact(dev):
    """A state carried across chunks and updated in place by the body
    (jit's `updates`), as config 4's accumulator: over 5 chunks, the
    first call's capture included, the jitted state equals the eager
    loop's (the warm-up updates a copy), and no call copies the state."""
    n = 1 << 20

    def step(state, x):
        for a, b in zip(state, (x, x * 3)):
            a.add_(b)
        return state

    jitted = jit(step, hand_off=True, updates=(0,))
    got = [torch.zeros(n, dtype=torch.int64, device=dev) for _ in range(2)]
    want = [torch.zeros(n, dtype=torch.int64, device=dev) for _ in range(2)]
    x = torch.empty(n, dtype=torch.int64, device=dev)  # each chunk lands here
    for c in range(5):
        x.copy_(torch.arange(n, dtype=torch.int64, device=dev) * (c + 1))
        assert all(a is b for a, b in zip(jitted(got, x), got))
        step(want, x)
        for a, b in zip(got, want):
            _eq(a, b)
    assert (jitted.copies, jitted.captures, jitted.reruns) == (0, 1, 0)


@pytest.mark.parametrize("site", ["build", "probe_layout", "sort_rows"])
def test_sort_sites_under_a_graph_equal_eager(dev, site):
    """The three sorts whose device copies a graph runs as memcpy nodes
    (the build's composite sort on its sort path, build_lane_tables_ref,
    which plans past LANE_BUILD_MAX_DEPTH take, the probe layout's
    partition sort on its sort path, probe_layout_ref, which plans past
    LAYOUT2_MAX_PARTS partitions take, sort_rows under the aggregate), captured and
    replayed on new inputs: every output byte-equal to the eager
    call's."""
    from tpq_torch.kernels.radix_sort import sort_rows

    plan = plan_lane2(1 << 20, 1 << 20, out_capacity=1 << 21)
    body = {"build": lambda t: build_lane_tables_ref(t, plan),
            "probe_layout": lambda t: probe_layout_ref(plan, t, "key"),
            "sort_rows": lambda t: sort_rows(t)}[site]
    jitted = jit(body)
    for seed in (40, 41):
        t = datagen.gen_relation(1_000_000, 1 << 20, payloads=1, seed=seed, device=dev)
        got, want = jitted(t), body(t)
        flat_got, flat_want = [], []
        for out, flat in ((got, flat_got), (want, flat_want)):
            if isinstance(out, Table):
                flat += [out.num_rows, *(c[:int(out.num_rows)] for c in out.columns.values())]
            elif isinstance(out, tuple):
                for x in out:
                    flat += x if isinstance(x, list) else [x]
            else:
                flat += [out.key, *out.pays, out.occ, out.blen, out.ok]
        assert len(flat_got) == len(flat_want)
        for a, b in zip(flat_got, flat_want):
            _eq(a, b)
    assert jitted.reruns == 0


@pytest.mark.parametrize("impl", ["dense", "ring"])
def test_jitted_dist_join_equals_its_eager_body(dev, impl):
    """The 8-shard join at 2^16 rows a shard through its jitted body (one
    CUDA graph, results handed over) on two calls, each shard's rows
    equal to the eager body's; the graph captured once, no rerun."""
    from tpq_torch.dist import dist_hash_join, jitted_join

    mesh = make_mesh(8, dev)
    n = 8 << 16
    R = DistTable.from_numpy(datagen.gen_relation_np(n, n, payloads=1, seed=5), mesh)
    S = DistTable.from_numpy(datagen.gen_relation_np(n, n, payloads=1, seed=6), mesh)
    kw = {"out_capacity_per_shard": 1 << 18, "exchange_impl": impl}
    want, want_ovf = dist_hash_join(R, S, mesh, eager=True, **kw)
    want = [Table.from_numpy(x, device="cpu") for x in want.shards_numpy()]
    for _ in range(2):
        got, ovf = dist_hash_join(R, S, mesh, **kw)
        assert torch.equal(ovf, want_ovf) and int(ovf.sum()) == 0
        for a, b in zip(got.shards_numpy(), want):
            assert tables_equal(canonicalize(Table.from_numpy(a, device="cpu")),
                                canonicalize(b))
    prog = jitted_join(mesh, **{**dict(exchange_capacity=None, algo="hash", key="key",
                                       skew=None, n_chunks=1, local_impl="sorted",
                                       lane_depth=48), **kw})
    assert (prog.captures, prog.reruns, prog.copies) == (1, 0, 0)
    mesh.clear()
