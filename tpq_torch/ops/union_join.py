"""Union-sort equi-join (port of tpq/ops/union_join.py): the engine of
hash_join(impl="sorted") and the lane join's fallback.

  1. UNION SORT — the concatenated relations ordered stably by
     (invalid, key, side). sort_engine="lax": torch has no multi-key
     sort, so this is three stable sorts, least-significant key first,
     composed into one permutation that then gathers every column.
     sort_engine="radix": tpq's LSD radix engine, one stable 1-bit split
     (the split kernel, tpq_torch/kernels/radix_sort.py) per bit of
     side, key and invalid, carrying every column as 32-bit planes;
     it observes its passes, planes and rows (jit.observe).
  2. RUN STRUCTURE — equal keys form runs; R rows precede S rows within
     a run. Scans give the run-start index rs and the number m of R
     rows before each position of its run.
  3. INLINE EMISSION (matches with R-multiplicity <= dmax) — the d-th R
     row of a run sits at rs + d. tpq fills it forward with an
     associative scan to avoid XLA:TPU's serial gathers; here it is the
     run start followed by one gather.
  4. TAIL (m > dmax) — tail S rows are compacted into a small static
     buffer (stable sort by flag), then expanded with small gathers.
  5. COMPACTION — one stable sort by validity brings the matches to the
     front of the static out_capacity buffer.
  6. FALLBACK — if the tail exceeds its static caps, full expand+gather.
     tpq's lax.cond(small_ok, inline, full expand) is jit.cond: one host
     read eager, none under a graph, where the inline path runs whatever
     small_ok is (its gathers are clamped) and is discarded when it is
     false.

Semantics are the oracle's (oracle/main.cc hash_join): inner equi-join
on `key`, per-key cross product, output columns key, r_<R payloads>,
s_<S payloads>, overflow surfaced as num_rows > out_capacity. Padding is
ordered by an explicit invalid key, so INT64_MIN/MAX are ordinary keys.
"""

from __future__ import annotations

import torch

from tpq_torch.columnar import Table
from tpq_torch.jit import cond, observe
from tpq_torch.ops._expand import expand_segments, last_start
from tpq_torch.trace import span

I32 = torch.int32
I64 = torch.int64
M32 = 0xFFFFFFFF
SIGN32 = 0x80000000
DMAX = 2  # match ranks emitted inline; deeper runs go to the tail


# ---------------------------------------------------------------------------
# 32-bit planes: the port moves int64 columns whole; these convert to and
# from tpq's (lo, hi) u32 plane form where a caller holds that form
# ---------------------------------------------------------------------------

def col_planes(col: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Column -> tuple of int32 planes with tpq's bit patterns."""
    if col.dtype == I64:
        return ((col & M32).to(I32), ((col >> 32) & M32).to(I32))
    if col.dtype == I32:
        return (col,)
    if col.dtype == torch.bool:
        return (col.to(I32),)
    raise TypeError(f"unsupported column dtype {col.dtype}")


def planes_col(planes: tuple[torch.Tensor, ...], dtype) -> torch.Tensor:
    """Inverse of col_planes; planes may hold int32 or uint32 bit patterns."""
    if dtype == I64:
        lo, hi = (p.to(I64) & M32 for p in planes)
        return (hi << 32) | lo
    (p,) = planes
    if dtype == torch.bool:
        return p != 0
    return p.to(dtype)


def _stable_lexsort(keys: list[torch.Tensor]) -> torch.Tensor:
    """Permutation ordering rows by `keys` (primary first), stable: one
    stable sort per key, least-significant key first."""
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in reversed(keys):
        _, idx = torch.sort(k[perm], stable=True)
        perm = perm[idx]
    return perm


def union_sort_specs(key_bits: int = 64) -> list[tuple[int, int]]:
    """The radix engine's bit specs over the planes (invalid, key lo,
    biased key hi, side, ...): side, key bits low to high, invalid."""
    nb = min(key_bits, 64)
    specs = [(3, 0)]
    specs += [(1, b) for b in range(min(nb, 32))]
    specs += [(2, b) for b in range(max(0, nb - 32))]
    specs.append((0, 0))
    return specs


def _radix_union_sort(inv, k, side, vals: dict, key_bits: int):
    """The radix engine's union sort: LSD bit order side, key bits low
    to high (the high plane sign-biased so unsigned bit order is signed
    int64 order), invalid last; `key_bits` < 64 narrows the key passes
    when the key domain is bounded. Returns (inv_s, k_s, side_s,
    vals_s)."""
    from tpq_torch.kernels.radix_sort import digit_passes, lsd_radix_sort_bits

    k64 = k.to(I64)
    # the bias in int64, masked: torch on the CPU has no uint32 xor
    khi_b = (((k64 >> 32) & M32) ^ SIGN32).to(I32)
    val_planes = {n: col_planes(v) for n, v in vals.items()}
    planes = [inv, (k64 & M32).to(I32), khi_b, side,
              *[p for ps in val_planes.values() for p in ps]]
    specs = union_sort_specs(key_bits)
    out = lsd_radix_sort_bits(planes, specs)
    # the sort's shape: the benchmark's split roofline counts its bytes
    observe("tpq.radix.passes", digit_passes(len(specs)))
    observe("tpq.radix.planes", len(planes))
    observe("tpq.radix.rows", planes[0].shape[0])
    khi = (out[2].to(I64) & M32) ^ SIGN32
    k_s = planes_col((out[1], khi), I64).to(k.dtype)
    vals_s, pos = {}, 4
    for n, ps in val_planes.items():
        vals_s[n] = planes_col(tuple(out[pos:pos + len(ps)]), vals[n].dtype)
        pos += len(ps)
    return out[0], k_s, out[3], vals_s


@span("tpq.union_join")
def union_join(r: Table, s: Table, out_capacity: int, key: str = "key",
               sort_engine: str = "lax", key_bits: int = 64) -> Table:
    """Inner equi-join R ⋈ S on `key` (see module docstring). tpq's
    dmax and tail-cap arguments are fixed at their defaults: no caller
    sets them."""
    if sort_engine not in ("lax", "radix"):
        raise ValueError(f"unknown sort_engine {sort_engine!r}")
    dev = r.device
    cr, cs = r.capacity, s.capacity
    u = cr + cs
    dmax = DMAX
    tail_rows_cap = min(max(1024, u >> 4), u)
    tail_out_cap = max(2048, min(out_capacity, u >> 3))

    r_names = [n for n in r.names if n != key]
    s_names = [n for n in s.names if n != key]
    out_names = [key] + [f"r_{n}" for n in r_names] + [f"s_{n}" for n in s_names]

    # ---- union sort on (invalid, key, side); payload columns gathered ----
    inv = torch.cat([~r.valid_mask(), ~s.valid_mask()]).to(I32)
    k = torch.cat([r.col(key), s.col(key)])
    side = torch.cat([torch.zeros(cr, dtype=I32, device=dev),
                      torch.ones(cs, dtype=I32, device=dev)])
    vals = {}
    for n in r_names:
        c = r.col(n)
        vals[f"r_{n}"] = torch.cat([c, torch.zeros(cs, dtype=c.dtype, device=dev)])
    for n in s_names:
        c = s.col(n)
        vals[f"s_{n}"] = torch.cat([torch.zeros(cr, dtype=c.dtype, device=dev), c])

    if sort_engine == "radix":
        inv_s, k_s, side_s, vals_s = _radix_union_sort(inv, k, side, vals,
                                                       key_bits)
    else:
        perm = _stable_lexsort([inv, k, side])
        inv_s, k_s, side_s = inv[perm], k[perm], side[perm]
        vals_s = {n: v[perm] for n, v in vals.items()}
        del perm
    # the unsorted union is dead: free it before the run structure (XLA
    # frees by liveness; here each is a full-length column)
    del inv, k, side, vals

    valid = inv_s == 0
    is_r = (side_s == 0) & valid
    is_s = (side_s == 1) & valid
    del inv_s, side_s

    # ---- run structure: torch scans replace tpq's tiled scans ----
    nr = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                    k_s[1:] != k_s[:-1]]) | ~valid
    is_r64 = is_r.to(I64)
    cr_ex = torch.cumsum(is_r64, 0) - is_r64
    rs = last_start(nr)                   # run start of position i
    m = cr_ex - cr_ex[rs]                 # R rows before position i in its run
    m_s = torch.where(is_s, m, 0)         # per-S-row match count
    del valid, is_r, is_r64, cr_ex, nr

    total64 = m_s.sum()
    total = total64.clamp_max(2**31 - 1).to(I32)
    covered = m_s.clamp_max(dmax).sum()
    tail_rows = (m_s > dmax).sum()
    small_ok = (tail_rows <= tail_rows_cap) & (total64 - covered <= tail_out_cap)

    def full_expand():
        # ---- fallback: full expand + gather (adversarial duplicates) ----
        seg, rank, _, vout = expand_segments(m_s.to(I32), out_capacity)
        r_pos = (rs[seg] + rank).clamp_max(u - 1)
        cols = {key: torch.where(vout, k_s[seg], 0)}
        for n in out_names[1:]:
            src = r_pos if n.startswith("r_") else seg
            cols[n] = torch.where(vout, vals_s[n][src], 0)
        return Table(cols, total)

    def inline():
        # ---- inline: candidate (S row, d) for d < dmax, valid iff d < m ----
        cand_valid = [is_s & (m > d) for d in range(dmax)]
        # the d-th R row of a run sits at rs + d (< u wherever m > d)
        r_at = [(rs + d).clamp_max(u - 1) for d in range(dmax)]

        # ---- small tail: S rows with m > dmax, compacted then expanded. It
        # runs unconditionally (tpq conds on tail_out > 0): with no tail rows
        # every slot is invalid and the result is the same ----
        flag = torch.where(is_s & (m > dmax), 0, 1).to(I32)
        _, idx_t = torch.sort(flag, stable=True)
        idx_t = idx_t[:tail_rows_cap]
        t_valid = torch.arange(tail_rows_cap, device=dev) < tail_rows
        counts_t = torch.where(t_valid, m[idx_t] - dmax, 0)
        seg, rank, _, t_vout = expand_segments(counts_t.to(I32), tail_out_cap)
        t_src = idx_t[seg]
        t_rpos = (rs[idx_t][seg] + dmax + rank).clamp_max(u - 1)

        # ---- assemble dmax*u inline candidates + tail_out_cap tail rows ----
        valid_all = torch.cat(cand_valid + [t_vout])
        planes = {key: torch.cat([k_s] * dmax + [k_s[t_src]])}
        for n in out_names[1:]:
            if n.startswith("r_"):
                planes[n] = torch.cat([vals_s[n][r_at[d]] for d in range(dmax)]
                                      + [vals_s[n][t_rpos]])
            else:
                planes[n] = torch.cat([vals_s[n]] * dmax + [vals_s[n][t_src]])

        # ---- compact: one stable sort by validity ----
        length = dmax * u + tail_out_cap
        if length < out_capacity:
            extra = out_capacity - length
            valid_all = torch.cat([valid_all,
                                   torch.zeros(extra, dtype=torch.bool, device=dev)])
            planes = {n: torch.cat([p, torch.zeros(extra, dtype=p.dtype, device=dev)])
                      for n, p in planes.items()}
        _, order = torch.sort(torch.where(valid_all, 0, 1).to(I32), stable=True)
        order = order[:out_capacity]
        # zero the padding region (rows >= total) for determinism
        live = torch.arange(out_capacity, device=dev) < total.clamp_max(out_capacity)
        cols = {n: torch.where(live, planes[n][order], 0) for n in out_names}
        return Table(cols, total)

    # tpq's lax.cond(small_ok, inline, full expand) (tpq/ops/union_join.py:323)
    return cond(small_ok, inline, full_expand, name="tpq.union.small_ok")
