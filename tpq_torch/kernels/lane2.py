"""Lane hash join, v3 plan and the fused walk+emit kernel (port of
tpq/kernels/lane2.py).

The plan is tpq's, integer for integer (occupancy 16, probe_cap = 1.5x
the mean partition load on the 1024-query grain, tail caps just above
the Poisson expectation), so both packages build the same tables and
take the same path. Build, probe layout, tail and the fallback contract
live in lane_table.py; this module holds the plan, the kernel and the
operator.

`fused_walk_emit` runs tpq_torch/csrc/lane2.cu on CUDA tensors and
`fused_walk_emit_ref`, its plain torch version, on CPU tensors. The
kernel emits rows in (padded query, j) order where tpq's emits
(4096-query tile, j, position); the oracle contract compares rows after
canonical ordering, and the plain version fixes the port's order
exactly.
"""

from __future__ import annotations

import torch

from tpq_torch.columnar import Table, next_pow2
from tpq_torch.kernels import _build
from tpq_torch.kernels.lane_table import (L, LanePlan, LaneTables, _probe_layout,
                                          _probe_emit_common, build_lane_tables)
from tpq_torch.kernels.move import MAX_COLS

I32 = torch.int32
I64 = torch.int64
QROWS = 32  # tpq's query tile rows; the plan keeps its sizing rule
CHUNK = 1024  # queries per CTA of the CUDA kernel (kChunk in lane2.cu)
SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may use


def plan_lane2(r_capacity: int, s_capacity: int, depth: int = 48,
               mean_occupancy: int = 16, inline_k: int = 4,
               out_capacity: int | None = None) -> LanePlan:
    """tpq's v3 plan: occupancy 16, probe_cap = mean partition load * 1.5
    rounded up to the 1024-query grain."""
    npart = next_pow2(max(1, r_capacity // (L * mean_occupancy)))
    pbits = npart.bit_length() - 1
    per_part = max(1, s_capacity // npart)
    probe_cap = ((per_part * 3 // 2) + 1023) // 1024 * 1024
    probe_cap = max(1024, probe_cap)
    while npart * probe_cap < QROWS * L:  # tiny relations: one full tile
        probe_cap += 1024
    u = npart * probe_cap
    return LanePlan(pbits=pbits, depth=depth, probe_cap=probe_cap,
                    inline_k=inline_k,
                    tail_rows_cap=max(2048, u >> 7),
                    tail_out_cap=max(4096, min(out_capacity or u, u) >> 8))


# ---------------------------------------------------------------------------
# the fused walk + emit kernel
# ---------------------------------------------------------------------------

def fused_walk_emit_ref(tables: LaneTables, qk, lane, qocc, spays,
                        out_capacity: int):
    """Plain torch walk+emit: defines the contract the kernel is held to.

    Each live padded query q of partition p = q // probe_cap walks depths
    d < blen[p, lane[q]] of its bucket and counts key matches. Returns
    (out_cols [key, *build pays, *probe pays] of int64[out_capacity],
    cnt int32[u], d_first int32[u]); row order is (q, j) for
    j < min(cnt, K), rows at or past out_capacity are dropped and the
    unwritten slots are 0."""
    plan = tables.plan
    D, K, dev = plan.depth, plan.inline_k, qk.device
    u = plan.npart * plan.probe_cap
    p = torch.arange(u, device=dev) // plan.probe_cap
    live = qocc > 0
    lane = lane.to(I64)
    blen = tables.blen[p, lane]
    base = p * (D * L) + lane          # flat slot of depth 0
    key_flat = tables.key.reshape(-1)
    cnt = torch.zeros(u, dtype=I32, device=dev)
    d_first = torch.full((u,), -1, dtype=I32, device=dev)
    d_sel = [torch.zeros(u, dtype=I64, device=dev) for _ in range(K)]
    for d in range(D):
        m = live & (d < blen) & (key_flat[base + d * L] == qk)
        for j in range(K):
            d_sel[j] = torch.where(m & (cnt == j), d, d_sel[j])
        d_first = torch.where(m & (cnt == 0), d, d_first)
        cnt += m.to(I32)

    n_emit = cnt.clamp_max(K).to(I64)
    offs = torch.cumsum(n_emit, 0) - n_emit
    srcs = ([key_flat] + [t.reshape(-1) for t in tables.pays]
            + list(spays))
    outs = [torch.zeros(out_capacity, dtype=I64, device=dev) for _ in srcs]
    for j in range(K):
        w = (n_emit > j) & (offs + j < out_capacity)
        rows = (offs + j)[w]
        slot = (base + d_sel[j] * L)[w]
        outs[0][rows] = qk[w]
        for o, t in zip(outs[1:1 + len(tables.pays)], srcs[1:]):
            o[rows] = t[slot]
        for o, x in zip(outs[1 + len(tables.pays):], spays):
            o[rows] = x[w]
    return outs, cnt, d_first


def fused_walk_emit(tables: LaneTables, qk, lane, qocc, spays,
                    out_capacity: int):
    """The fused walk+emit on the padded probe layout; see
    fused_walk_emit_ref for the contract. Launches counted in
    `.launches`."""
    if qk.device.type == "cpu":
        return fused_walk_emit_ref(tables, qk, lane, qocc, spays, out_capacity)
    if qk.device.type != "cuda":
        raise RuntimeError(f"fused_walk_emit: no kernel for device {qk.device}")
    plan = tables.plan
    D, K, npart, probe_cap = plan.depth, plan.inline_k, plan.npart, plan.probe_cap
    u = npart * probe_cap
    dev = qk.device
    if D * L * 8 + 1024 > SMEM_LIMIT:
        raise ValueError(f"fused_walk_emit: depth {D} does not fit shared memory")
    if len(tables.pays) > MAX_COLS or len(spays) > MAX_COLS:
        raise ValueError(f"fused_walk_emit: at most {MAX_COLS} payload columns")
    if u * K >= 2**31:
        raise ValueError("fused_walk_emit: int32 row offsets need u*K < 2^31")

    def need(t, shape, dtype, what):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"fused_walk_emit: {what} must be {dtype}{shape} "
                             f"on {dev}, got {t.dtype}{tuple(t.shape)} on {t.device}")
        return t.contiguous()

    tshape = (npart, D, L)
    t_key = need(tables.key, tshape, I64, "table key")
    t_pays = [need(t, tshape, I64, "table payload") for t in tables.pays]
    blen = need(tables.blen, (npart, L), I32, "blen")
    qk = need(qk, (u,), I64, "query key")
    lane = need(lane, (u,), I32, "lane")
    qocc = need(qocc, (u,), I32, "qocc")
    spays = [need(x, (u,), I64, "probe payload") for x in spays]

    cnt = torch.empty(u, dtype=I32, device=dev)
    d_first = torch.empty(u, dtype=I32, device=dev)
    outs = [torch.empty(out_capacity, dtype=I64, device=dev)
            for _ in range(1 + len(t_pays) + len(spays))]
    nblocks = npart * -(-probe_cap // CHUNK)
    block_rows = torch.empty(nblocks, dtype=I32, device=dev)
    block_offsets = torch.empty(nblocks, dtype=I32, device=dev)
    total_inline = torch.empty((), dtype=I32, device=dev)
    with torch.cuda.device(dev):
        code = _build.lib().tpq_walk_emit(
            t_key.data_ptr(), _build.ptr_array(t_pays), len(t_pays),
            blen.data_ptr(), npart, D, K, probe_cap,
            qk.data_ptr(), lane.data_ptr(), qocc.data_ptr(),
            _build.ptr_array(spays), len(spays),
            cnt.data_ptr(), d_first.data_ptr(), outs[0].data_ptr(),
            _build.ptr_array(outs[1:1 + len(t_pays)]),
            _build.ptr_array(outs[1 + len(t_pays):]), out_capacity,
            block_rows.data_ptr(), block_offsets.data_ptr(),
            total_inline.data_ptr(), _build.stream_of(qk))
    _build.check(code, "fused_walk_emit")
    fused_walk_emit.launches += 1
    return outs, cnt, d_first


fused_walk_emit.launches = 0


def fused_probe_emit2(tables: LaneTables, s: Table, out_capacity: int,
                      key: str = "key", keep=None):
    """Probe layout + fused walk/emit. Returns (out_cols, cnt, d_first,
    qk_p, spay_p, qocc, lane_p, overflow), all in the padded
    [npart * probe_cap] probe order."""
    qk_p, spay_p, lane_p, qocc, overflow = _probe_layout(
        tables.plan, s, key, keep=keep)
    outs, cnt, d_first = fused_walk_emit(tables, qk_p, lane_p, qocc, spay_p,
                                         out_capacity)
    return outs, cnt, d_first, qk_p, spay_p, qocc, lane_p, overflow


# ---------------------------------------------------------------------------
# the operator
# ---------------------------------------------------------------------------

def build_lane2_tables(r: Table, plan: LanePlan, key: str = "key") -> LaneTables:
    """v3 build = the lane_table build at the v3 plan's occupancy/depth."""
    return build_lane_tables(r, plan, key)


def lane2_probe_emit(tables: LaneTables, s: Table, out_capacity: int,
                     key: str = "key", r_names: list[str] | None = None,
                     r_dtypes: list | None = None,
                     keep=None) -> tuple[Table, torch.Tensor]:
    return _probe_emit_common(fused_probe_emit2, tables, s, out_capacity,
                              key, r_names, r_dtypes, keep=keep)


def lane2_path_taken(r: Table, s: Table, out_capacity: int, key: str = "key",
                     plan: LanePlan | None = None) -> torch.Tensor:
    """The `ok` flag lane2_hash_join branches on (bench honesty guard)."""
    if plan is None:
        plan = plan_lane2(r.capacity, s.capacity, out_capacity=out_capacity)
    r_names = [n for n in r.names if n != key]
    _, ok = lane2_probe_emit(build_lane2_tables(r, plan, key), s, out_capacity,
                             key=key, r_names=r_names,
                             r_dtypes=[r.col(n).dtype for n in r_names])
    return ok


def lane2_hash_join(r: Table, s: Table, out_capacity: int, key: str = "key",
                    plan: LanePlan | None = None, probe_keep=None) -> Table:
    """Lane join with the union-sort engine as the fallback on any
    static-capacity violation."""
    from tpq_torch.ops.union_join import union_join

    if probe_keep is not None:
        raise NotImplementedError(
            "probe_keep needs the filter operator's compact for the fallback, "
            "not yet ported (ROADMAP.md Queue 1 item 6)")
    if plan is None:
        plan = plan_lane2(r.capacity, s.capacity, out_capacity=out_capacity)
    r_names = [n for n in r.names if n != key]
    tables = build_lane2_tables(r, plan, key)
    out, ok = lane2_probe_emit(tables, s, out_capacity, key=key,
                               r_names=r_names,
                               r_dtypes=[r.col(n).dtype for n in r_names])
    # tpq's lax.cond(ok, ...) is a host branch here (one device sync)
    if bool(ok):
        return out
    return union_join(r, s, out_capacity, key=key)
