"""Filter: predicate -> keep mask -> stable compaction (port of
tpq/ops/filter.py: _OPS, filter_table, compact_indices and compact).

tpq compacts with a multi-operand stable sort by the keep flag because
XLA:TPU runs general scatters serially. The card scatters natively, so
`compact` moves the kept rows with PACK (one stable compaction of up to
MAX_COLS columns per launch); rows past num_rows are zero where tpq
holds the dropped rows, and the Table contract leaves them unspecified.
"""

from __future__ import annotations

from typing import Callable

import torch

from tpq_torch.columnar import Table
from tpq_torch.kernels.move import MAX_COLS, pack
from tpq_torch.trace import span

I32 = torch.int32

_OPS: dict[str, Callable] = {
    "lt": lambda a, b: a < b,
    "le": lambda a, b: a <= b,
    "gt": lambda a, b: a > b,
    "ge": lambda a, b: a >= b,
    "eq": lambda a, b: a == b,
    "ne": lambda a, b: a != b,
}


def compact_indices(keep: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather indices that bring the kept rows to the front, stable; the
    dropped rows follow in their order. Returns (perm int64, n_kept
    int32)."""
    _, perm = torch.sort(torch.where(keep, 0, 1).to(torch.uint8), stable=True)
    return perm, keep.sum(dtype=I32)


def pack_columns(cols: dict[str, torch.Tensor], occ: torch.Tensor) -> Table:
    """The rows with occ != 0 (int32) of equal-length columns, order
    kept, by PACK (one launch per MAX_COLS columns); num_rows is their
    count."""
    names = list(cols)
    packed, n_out = {}, None
    for i in range(0, len(names), MAX_COLS):
        group = names[i:i + MAX_COLS]
        outs, n_out = pack([cols[n] for n in group], occ)
        packed.update(zip(group, outs))
    return Table({n: packed[n] for n in names}, n_out)


def compact(t: Table, keep: torch.Tensor) -> Table:
    """Keep the live rows where `keep` (bool[capacity]), order kept;
    num_rows is the kept count."""
    return pack_columns(t.columns, (keep & t.valid_mask()).to(I32))


@span("tpq.filter.keep")
def keep_mask(t: Table, col: str, op: str, value) -> torch.Tensor:
    """bool[capacity]: `col <op> value`, the value taken in the column's
    dtype (tpq's jnp.asarray(value, c.dtype)). `value` is a number or a
    0-d tensor (jit passes a traced number as a device scalar); neither
    is copied from the host to the card: a number becomes a CPU scalar,
    which the comparison takes as a kernel argument."""
    c = t.col(col)
    v = value.to(c.dtype) if isinstance(value, torch.Tensor) else \
        torch.as_tensor(value, dtype=c.dtype)
    return _OPS[op](c, v)


def filter_table(t: Table, col: str, op: str, value) -> Table:
    """Rows of t where `col <op> value`; op in lt/le/gt/ge/eq/ne."""
    return compact(t, keep_mask(t, col, op, value))
