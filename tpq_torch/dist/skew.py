"""Heavy-hitter detection and key-splitting (port of tpq/dist/skew.py).

  * DETECT: each shard nominates the top-H keys of its locally sorted
    keys, the candidates are all-gathered, counted exactly on every
    shard (searchsorted over the sorted keys, no scatter) and psummed to
    global counts. Sample-free and deterministic.
  * SPLIT: rows whose key is heavy leave the hash exchange. Heavy BUILD
    rows are replicated to every shard (all_gather); heavy PROBE rows
    stay on their shard and join against the replica. Every pair comes
    out once: heavy pairs on the probe row's shard, light pairs on the
    key's owner.

As in exchange.py, the functions take the list of the shards this
process holds and the mesh in the place of tpq's axis name.
"""

from __future__ import annotations

import torch

from tpq_torch.columnar import Table
from tpq_torch.dist.exchange import _slot_valid
from tpq_torch.ops.filter import compact

I32 = torch.int32
I64 = torch.int64
I64_MAX = torch.iinfo(I64).max


def _count_keys_in(sorted_keys: torch.Tensor, n_valid,
                   queries: torch.Tensor) -> torch.Tensor:
    """Exact occurrence count (int32) of each query key in a locally
    sorted column (padding sorted to the end as I64_MAX and clamped
    out)."""
    lo = torch.searchsorted(sorted_keys, queries).to(I32)
    hi = torch.searchsorted(sorted_keys, queries, right=True).to(I32)
    return torch.minimum(hi, n_valid) - torch.minimum(lo, n_valid)


def _nominate(k: torch.Tensor, n, h: int) -> torch.Tensor:
    """Run-length top-h of locally sorted keys, I64_MAX where a shard has
    fewer than h distinct keys. The sort on the negated score is stable,
    as jnp.argsort is: a tie at the h-th candidate otherwise changes
    which keys are heavy."""
    cap = k.shape[0]
    is_start = torch.ones(cap, dtype=torch.bool, device=k.device)
    is_start[1:] = k[1:] != k[:-1]
    run_len = _count_keys_in(k, n, k)  # count of each row's own key
    live = torch.arange(cap, device=k.device) < n
    score = torch.where(is_start & live, run_len, -1)
    top = torch.argsort(-score, stable=True)[:h]
    return torch.where(score[top] > 0, k[top], I64_MAX)


def detect_heavy_keys(r_keys_sorted, r_n, s_keys_sorted, s_n, mesh,
                      candidates_per_shard: int, threshold: int):
    """Per shard: (heavy_keys int64[nchips*2*candidates_per_shard] —
    sorted, padded with I64_MAX, deduplicated; mask of real entries). A
    key is heavy if its GLOBAL count on either side exceeds
    `threshold`."""
    local = [torch.cat([_nominate(rk, rn, candidates_per_shard),
                        _nominate(sk, sn, candidates_per_shard)])
             for rk, rn, sk, sn in zip(r_keys_sorted, r_n, s_keys_sorted, s_n)]
    cands, counts = [], []
    for all_cand, rk, rn, sk, sn in zip(mesh.all_gather(local), r_keys_sorted,
                                        r_n, s_keys_sorted, s_n):
        # dedup: keep the first occurrence only (sorted)
        all_cand = torch.sort(all_cand).values
        dup = torch.zeros_like(all_cand, dtype=torch.bool)
        dup[1:] = all_cand[1:] == all_cand[:-1]
        all_cand = torch.where(dup, I64_MAX, all_cand)
        cands.append(all_cand)
        counts.append(_count_keys_in(rk, rn, all_cand) + _count_keys_in(sk, sn, all_cand))
    keys, masks = [], []
    for all_cand, cnt in zip(cands, mesh.psum(counts)):
        heavy = (cnt > threshold) & (all_cand != I64_MAX)
        # re-sort: masking non-heavy entries breaks monotonicity, and
        # is_key_in binary-searches this set
        keys.append(torch.sort(torch.where(heavy, all_cand, I64_MAX)).values)
        masks.append(heavy)
    return keys, masks


def is_key_in(keys: torch.Tensor, heavy_keys_sorted: torch.Tensor) -> torch.Tensor:
    """Membership mask via binary search (heavy set sorted, I64_MAX-padded)."""
    keys = keys.to(I64)
    idx = torch.searchsorted(heavy_keys_sorted, keys)
    idx = idx.clamp_max(heavy_keys_sorted.shape[0] - 1)
    return heavy_keys_sorted[idx] == keys


def replicate_rows(tables, masks, mesh, per_shard_capacity: int):
    """All-gather the masked rows of every shard: per shard, a replicated
    Table of capacity nchips*per_shard_capacity and the overflow count."""
    psc = per_shard_capacity
    picked = [compact(t, m) for t, m in zip(tables, masks)]
    overflow = [(p.num_rows - psc).clamp_min(0) for p in picked]
    picked = [p.with_capacity(psc) for p in picked]  # pad or trim to the wire size
    names = tables[0].names
    cols = {n: mesh.all_gather([p.col(n) for p in picked]) for n in names}
    counts = mesh.all_gather([p.num_rows.clamp_max(psc).reshape(1) for p in picked])
    out = [compact(Table({n: cols[n][i] for n in names}, cnt.shape[0] * psc),
                   _slot_valid(cnt, psc))
           for i, cnt in enumerate(counts)]
    return out, overflow
