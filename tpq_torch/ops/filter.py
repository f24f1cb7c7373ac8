"""Stable compaction (port of tpq/ops/filter.py compact_indices and
compact). The predicate front end (filter_table, _OPS) comes with the
pipeline.

tpq compacts with a multi-operand stable sort by the keep flag because
XLA:TPU runs general scatters serially. The card scatters natively, so
`compact` moves the kept rows with PACK (one stable compaction of up to
MAX_COLS columns per launch); rows past num_rows are zero where tpq
holds the dropped rows, and the Table contract leaves them unspecified.
"""

from __future__ import annotations

import torch

from tpq_torch.columnar import Table
from tpq_torch.kernels.move import MAX_COLS, pack

I32 = torch.int32


def compact_indices(keep: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather indices that bring the kept rows to the front, stable; the
    dropped rows follow in their order. Returns (perm int64, n_kept
    int32)."""
    _, perm = torch.sort(torch.where(keep, 0, 1).to(torch.uint8), stable=True)
    return perm, keep.sum(dtype=I32)


def compact(t: Table, keep: torch.Tensor) -> Table:
    """Keep the live rows where `keep` (bool[capacity]), order kept;
    num_rows is the kept count."""
    occ = (keep & t.valid_mask()).to(I32)
    names = list(t.names)
    cols, n_out = {}, None
    for i in range(0, len(names), MAX_COLS):
        group = names[i:i + MAX_COLS]
        packed, n_out = pack([t.col(n) for n in group], occ)
        cols.update(zip(group, packed))
    return Table({n: cols[n] for n in names}, n_out)
