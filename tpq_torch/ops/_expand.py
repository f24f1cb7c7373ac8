"""Segment expansion (port of tpq/ops/_expand.py).

Given per-source-row match counts, build gather indices for an output
of static capacity: out slot t belongs to source row seg(t), with
within-segment rank rank(t) = t - offset[seg(t)].

tpq's `barrier` (optimization_barrier) and `searchsorted(method="sort")`
are not ported: both work around XLA:TPU, and torch runs eagerly with a
native `torch.searchsorted`.
"""

from __future__ import annotations

import torch


def exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    # torch.cumsum replaces tpq's tiled scan (tpq/ops/scan.py)
    return torch.cumsum(x, 0, dtype=x.dtype) - x


def last_start(is_start: torch.Tensor) -> torch.Tensor:
    """int64 index of the last True of `is_start` at or before each
    position (is_start[0] must be True): tpq's cummax of run-start
    indices. torch.cummax also computes arg-indices and took 2.8 ms at
    1M rows on an H100 80GB HBM3 (PERF.md); a run id from cumsum and a
    scatter-max of the starts (order-free, so deterministic) replace it."""
    run = torch.cumsum(is_start, 0) - 1
    i = torch.arange(is_start.shape[0], device=is_start.device)
    starts = torch.full_like(i, -1).scatter_reduce_(
        0, run, torch.where(is_start, i, -1), "amax")
    return starts[run]


def expand_segments(counts: torch.Tensor, capacity: int):
    """counts: int32[n] — matches per source row (0 for invalid rows).

    Returns (seg_id, rank, total, valid):
      seg_id: int64[capacity] — source row of each output slot (>= 0)
      rank:   int32[capacity] — within-segment position
      total:  int32 0-d — true number of output rows (may exceed
              capacity: overflow, which the caller checks)
      valid:  bool[capacity] — slot < total
    """
    counts = counts.to(torch.int32)
    offsets = exclusive_cumsum(counts)
    total = offsets[-1] + counts[-1]
    slot = torch.arange(capacity, dtype=torch.int32, device=counts.device)
    # slot t belongs to the last source row j with offsets[j] <= t (an
    # empty j shares its offset with j+1, so ties resolve to the
    # non-empty row)
    seg_id = (torch.searchsorted(offsets, slot, right=True) - 1).clamp_min(0)
    rank = slot - offsets[seg_id]
    valid = slot < total
    return seg_id, rank, total, valid
