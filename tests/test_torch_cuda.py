"""tpq_torch's CUDA kernels against their plain torch versions, on the
card. Every test needs an NVIDIA card (marker `cuda`) and skips without
one. The card's machine has no JAX, so this file imports none and needs
no conftest fixture; run it there from the repo root with

    python -m pytest --noconftest -o addopts="" -q tests/test_torch_cuda.py

Integer data: every comparison is exact."""

import numpy as np
import pytest
import torch

from tpq_torch import Table, datagen
from tpq_torch.columnar import canonicalize, tables_equal
from tpq_torch.kernels.lane2 import (build_lane2_tables, fused_walk_emit,
                                     fused_walk_emit_ref, plan_lane2)
from tpq_torch.kernels.lane_table import _probe_layout
from tpq_torch.kernels.move import pack, pack_ref, pad, pad_ref
from tpq_torch.ops import hash_join

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


@pytest.mark.parametrize("impl", ["lane", "sorted"])
def test_join_on_card_matches_cpu(dev, impl):
    r = datagen.gen_relation_np(20_000, 8_000, payloads=2, seed=5)
    s = datagen.gen_relation_np(30_000, 8_000, payloads=1, seed=6)
    on_card = hash_join(Table.from_numpy(r, device=dev),
                        Table.from_numpy(s, device=dev), 1 << 17, impl=impl)
    on_cpu = hash_join(Table.from_numpy(r), Table.from_numpy(s), 1 << 17, impl=impl)
    assert int(on_card.num_rows) == int(on_cpu.num_rows)
    assert tables_equal(canonicalize(on_card), canonicalize(on_cpu))
    again = hash_join(Table.from_numpy(r, device=dev),
                      Table.from_numpy(s, device=dev), 1 << 17, impl=impl)
    n = int(on_card.num_rows)
    for k in on_card.columns:  # deterministic rows, order included
        _eq(on_card.columns[k][:n], again.columns[k][:n])
