"""Lane-bucket hash table: build, probe layout, tail and the `ok` flag
(port of tpq/kernels/lane_table.py).

The layout is tpq's, so that the same inputs give the same tables:

  * hash(key) -> (partition p = top pbits, lane l = low 7 bits). A
    partition's table is a [D, 128] tile per column: lane l's bucket is
    the column (0..D-1, l).
  * build: one stable sort by the composite (bucket << 32) | h2, where h2
    is a second 32-bit hash; equal keys share h2, so their runs are
    contiguous in d. Two distinct keys that collide on (bucket, h2) clear
    `ok` and the join falls back. Rows are ranked within their bucket and
    PADded lane-major, then transposed to [npart, D, 128].
  * probe layout: queries grouped by partition with one stable sort and
    PADded to [npart, probe_cap].
  * tail: queries with more than K matches are PACKed, their extra
    matches expanded and PADded into a window spliced after the inline
    rows.

Any static-capacity violation (bucket depth > D, probe partition
overflow, tail caps, output overflow) clears `ok`, and lane2_hash_join
then answers with the union-sort engine.

The port keeps int64 keys and payloads whole: tpq's 32-bit planes exist
because the TPU has no 64-bit vector ALU. int32 columns are widened to
int64 inside the join and narrowed back at its output.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tpq_torch.columnar import Table
from tpq_torch.hashing import hash_keys
from tpq_torch.kernels.move import pack, pad
from tpq_torch.ops._expand import expand_segments, last_start
from tpq_torch.ops.union_join import planes_col

I32 = torch.int32
I64 = torch.int64
L = 128
SALT_LANE = 0x1A9E0001
SALT_H2 = 0x1A9E0002


@dataclass(frozen=True)
class LanePlan:
    pbits: int          # partitions = 2^pbits
    depth: int          # D: table rows (bucket capacity per lane)
    probe_cap: int      # padded probe rows per partition
    inline_k: int       # match ranks emitted inline
    tail_rows_cap: int  # compacted queries with cnt > K
    tail_out_cap: int   # tail output rows

    @property
    def npart(self) -> int:
        return 1 << self.pbits

    @property
    def nbuckets(self) -> int:
        return self.npart * L


@dataclass
class LaneTables:
    plan: LanePlan
    key: torch.Tensor         # int64 [npart, D, 128]
    pays: list[torch.Tensor]  # int64 [npart, D, 128] each
    occ: torch.Tensor         # int32 [npart, D, 128], 0/1
    blen: torch.Tensor        # int32 [npart, 128]: bucket lengths
    ok: torch.Tensor          # 0-d bool: no depth overflow, no h2 hazard


def _as_i64(col: torch.Tensor) -> torch.Tensor:
    if col.dtype not in (I32, I64):
        raise TypeError(f"lane join: int32 or int64 columns, got {col.dtype}")
    return col.to(I64)


def _tiles(x: torch.Tensor, plan: LanePlan) -> torch.Tensor:
    """lane-major [p*128+l, D] -> [p, D, 128]."""
    return x.reshape(plan.npart, L, plan.depth).transpose(1, 2).contiguous()


def lane_tables_from_numpy(plan: LanePlan, key_planes, pay_planes, occ, ok,
                           device="cpu") -> LaneTables:
    """The port's tables from tpq's LaneTables fields as numpy arrays:
    key planes (1 for int32 keys, (lo, hi) for int64), payload planes in
    (lo, hi) pairs (tpq's int64 payloads), occ [npart, D, 128], ok."""
    def col(planes):
        ts = [torch.from_numpy(np.array(p)).to(device) for p in planes]
        return planes_col(tuple(ts), I64) if len(ts) == 2 else ts[0].to(I64)

    occ_t = torch.from_numpy(np.array(occ)).to(device=device, dtype=I32)
    return LaneTables(
        plan=plan, key=col(key_planes),
        pays=[col(pay_planes[i:i + 2]) for i in range(0, len(pay_planes), 2)],
        occ=occ_t, blen=occ_t.sum(1, dtype=I32),
        ok=torch.tensor(bool(np.asarray(ok)), device=device))


def _rank_in_group(group: torch.Tensor) -> torch.Tensor:
    """group: sorted [N]. Returns i - first_index_of(group[i]) as int64."""
    i = torch.arange(group.shape[0], dtype=I64, device=group.device)
    new = torch.ones_like(group, dtype=torch.bool)
    new[1:] = group[1:] != group[:-1]
    return i - last_start(new)


def build_lane_tables(r: Table, plan: LanePlan, key: str = "key") -> LaneTables:
    D, nb = plan.depth, plan.nbuckets
    rk = _as_i64(r.col(key))
    valid = r.valid_mask()
    h = hash_keys(rk, plan.pbits + 7, SALT_LANE)
    bucket = torch.where(valid, h, nb).to(I64)
    h2 = hash_keys(rk, 32, SALT_H2).to(I64) & 0xFFFFFFFF
    comp_s, perm = torch.sort((bucket << 32) | h2, stable=True)
    bucket_s = comp_s >> 32
    key_s = rk[perm]
    pays_s = [_as_i64(r.col(n))[perm] for n in r.names if n != key]

    # h2 hazard: two distinct live keys with one (bucket, h2) would break
    # the contiguity of a key's run in d, which the tail relies on
    hazard = ((comp_s[1:] == comp_s[:-1]) & (key_s[1:] != key_s[:-1])
              & (comp_s[1:] < (nb << 32))).any()

    rank = _rank_in_group(bucket_s)
    live = bucket_s < nb
    overflow = (live & (rank >= D)).any()
    dest = torch.where(live & (rank < D), bucket_s * D + rank, nb * D).to(I32)
    padded, occ = pad([key_s, *pays_s], dest, valid.sum(dtype=I32), nb * D)
    tiles = [_tiles(x, plan) for x in padded]
    return LaneTables(plan=plan, key=tiles[0], pays=tiles[1:],
                      occ=_tiles(occ, plan),
                      blen=occ.reshape(nb, D).sum(1, dtype=I32).reshape(plan.npart, L),
                      ok=~overflow & ~hazard)


def _probe_layout(plan: LanePlan, s: Table, key: str, keep=None):
    """Group the queries by partition (one stable sort) and PAD them to
    the [npart * probe_cap] layout. `keep` (bool[capacity], optional) is
    a pushed-down filter: dropped rows go to the dead partition like
    padding.

    Returns (qk_p int64[u], spay_p [int64[u]], lane_p int32[u],
    qocc int32[u], overflow 0-d bool)."""
    npart, probe_cap = plan.npart, plan.probe_cap
    sk = _as_i64(s.col(key))
    spays = [_as_i64(s.col(n)) for n in s.names if n != key]
    valid = s.valid_mask()
    if keep is not None:
        valid = valid & keep
    h = hash_keys(sk, plan.pbits + 7, SALT_LANE)
    bucket_p = torch.where(valid, h >> 7, npart)
    bp_s, perm = torch.sort(bucket_p, stable=True)

    rank = _rank_in_group(bp_s)
    live = bp_s < npart
    overflow = (live & (rank >= probe_cap)).any()
    dest = torch.where(live & (rank < probe_cap),
                       bp_s * probe_cap + rank, npart * probe_cap).to(I32)
    padded, qocc = pad([sk[perm], *[x[perm] for x in spays]], dest,
                       valid.sum(dtype=I32), npart * probe_cap)
    qk_p = padded[0]
    # lane from the padded keys (dead slots get a garbage lane that the
    # kernels mask with qocc)
    lane_p = (hash_keys(qk_p, plan.pbits + 7, SALT_LANE) & (L - 1)).to(I32)
    return qk_p, padded[1:], lane_p, qocc, overflow


def _splice_tail(cols, tables: LaneTables, cnt_eff, d_first, qk_p, spay_p,
                 lane_p, total_inline, out_capacity: int) -> None:
    """Append the matches past the K-th of every query after the inline
    rows, in place. PACK carries only the padded row ids; the rest is
    gathered at tail size. The tail rows are PADded into a small window
    at total_inline and added into the output."""
    plan = tables.plan
    K, D, dev = plan.inline_k, plan.depth, cnt_eff.device
    u = plan.npart * plan.probe_cap
    tcap = plan.tail_rows_cap
    window = min(plan.tail_out_cap + 2048, out_capacity)

    (tq,), n_t = pack([torch.arange(u, dtype=I32, device=dev)],
                      (cnt_eff > K).to(I32))
    tq = tq[:tcap].clamp_max(u - 1).to(I64)
    t_live = torch.arange(tcap, device=dev) < n_t
    counts_t = torch.where(t_live, cnt_eff[tq] - K, 0)
    seg, rnk, _, vout = expand_segments(counts_t, plan.tail_out_cap)
    qsrc = tq[seg]
    # the matched run is contiguous in d (same h2, checked at build):
    # extra match m sits at d_first + K + m in the same bucket
    d_pick = (d_first[qsrc] + K + rnk).clamp_max(D - 1)
    slot = (((qsrc // plan.probe_cap) * D + d_pick) * L
            + lane_p[qsrc]).clamp(0, plan.npart * D * L - 1)
    tail_cols = ([torch.where(vout, qk_p[qsrc], 0)]
                 + [torch.where(vout, t.reshape(-1)[slot], 0) for t in tables.pays]
                 + [torch.where(vout, x[qsrc], 0) for x in spay_p])

    tail_n = torch.minimum(vout.sum(dtype=I32),
                           (out_capacity - total_inline).clamp_min(0))
    w0 = ((total_inline // 1024) * 1024).clamp(0, max(out_capacity - window, 0))
    # rows whose window-relative dest >= window are dropped by pad; that
    # only happens when the output overflows, which num_rows reports
    wdest = (total_inline - w0) + torch.arange(plan.tail_out_cap, dtype=I32,
                                               device=dev)
    wcols, _ = pad(tail_cols, wdest, tail_n, window)
    # slots at/after total_inline hold unwritten rows: clear, then add
    widx = w0.to(I64) + torch.arange(window, device=dev)
    in_tail = widx >= total_inline
    for c, wq in zip(cols, wcols):
        c[widx] = torch.where(in_tail, 0, c[widx]) + wq


def _probe_emit_common(fused_fn, tables: LaneTables, s: Table,
                       out_capacity: int, key: str,
                       r_names: list[str] | None, r_dtypes: list | None,
                       keep=None) -> tuple[Table, torch.Tensor]:
    """Emit, tail and regroup around the fused walk+emit
    (tpq_torch.kernels.lane2.fused_probe_emit2). Returns (table, ok)."""
    plan = tables.plan
    K = plan.inline_k
    if r_names is None:
        r_names = [f"p{i}" for i in range(len(tables.pays))]
        r_dtypes = [I64] * len(tables.pays)
    s_names = [n for n in s.names if n != key]

    (out_cols, cnt, d_first, qk_p, spay_p, qocc, lane_p,
     probe_ovf) = fused_fn(tables, s, out_capacity, key, keep=keep)

    cnt_eff = torch.where(qocc > 0, cnt, 0)
    # int64 sums are native on the card, so tpq's i32 branch for
    # u * D < 2^31 collapses into its i64 form
    total64 = cnt_eff.sum(dtype=I64)
    inline64 = cnt_eff.clamp_max(K).sum(dtype=I64)
    total = total64.clamp_max(2**31 - 1).to(I32)
    total_inline = inline64.clamp_max(2**31 - 1).to(I32)
    tail_out64 = total64 - inline64
    caps_ok = (((cnt_eff > K).sum() <= plan.tail_rows_cap)
               & (tail_out64 <= plan.tail_out_cap)
               & (total_inline <= out_capacity))
    ok = tables.ok & ~probe_ovf & caps_ok

    # the Table contract leaves rows >= num_rows unspecified: the emit
    # buffer's unwritten slots stay as they are
    cols = list(out_cols)
    # tpq's lax.cond(tail_out > 0, ...) is a host branch (one device sync)
    if bool(tail_out64 > 0):
        _splice_tail(cols, tables, cnt_eff, d_first, qk_p, spay_p, lane_p,
                     total_inline, out_capacity)

    names = [key] + [f"r_{n}" for n in r_names] + [f"s_{n}" for n in s_names]
    dtypes = ([s.col(key).dtype] + list(r_dtypes)
              + [s.col(n).dtype for n in s_names])
    return Table({n: c.to(dt) for n, c, dt in zip(names, cols, dtypes)},
                 total), ok
