"""Columnar SoA Table (port of tpq/columnar.py).

A `Table` is a dict of equal-capacity 1-D tensors plus a 0-d int32
`num_rows` tensor on the same device. Capacities are static powers of
two; rows at index >= num_rows are padding with unspecified contents.
Operators mask by num_rows, never by sentinel values. `num_rows` may
exceed the capacity: that is how an operator reports overflow.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def next_pow2(n: int) -> int:
    """Smallest power of two >= max(n, 8)."""
    n = max(int(n), 8)
    return 1 << (n - 1).bit_length()


class Table:
    """SoA columnar batch: named 1-D columns + a row-count scalar.

    Invariants:
      * all columns share one capacity and one device;
      * `num_rows` is a 0-d int32 tensor on that device;
      * column insertion order defines the canonical lexicographic order
        used for oracle comparison.
    """

    __slots__ = ("columns", "num_rows")

    def __init__(self, columns: Mapping[str, torch.Tensor], num_rows):
        columns = dict(columns)
        if not columns:
            raise ValueError("Table needs at least one column")
        caps = {v.shape[0] for v in columns.values()}
        if len(caps) != 1:
            raise ValueError(f"column capacities differ: "
                             f"{ {k: tuple(v.shape) for k, v in columns.items()} }")
        devices = {v.device for v in columns.values()}
        if len(devices) != 1:
            raise ValueError(f"columns on several devices: {devices}")
        self.columns = columns
        self.num_rows = torch.as_tensor(num_rows, dtype=torch.int32,
                                        device=devices.pop())

    @property
    def capacity(self) -> int:
        return next(iter(self.columns.values())).shape[0]

    @property
    def device(self) -> torch.device:
        return self.num_rows.device

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(self.columns.keys())

    def col(self, name: str) -> torch.Tensor:
        return self.columns[name]

    def __repr__(self):
        cols = ", ".join(f"{k}:{v.dtype}" for k, v in self.columns.items())
        return (f"Table(cap={self.capacity}, num_rows={int(self.num_rows)}, "
                f"device={self.device}, [{cols}])")

    @classmethod
    def from_numpy(cls, columns: Mapping[str, np.ndarray],
                   capacity: int | None = None, device="cpu") -> "Table":
        """Host import: pads every column to a shared pow2 capacity and
        places it on `device`."""
        columns = dict(columns)
        n = len(next(iter(columns.values())))
        cap = capacity if capacity is not None else next_pow2(n)
        if cap < n:
            raise ValueError(f"capacity {cap} < rows {n}")
        out = {}
        for k, v in columns.items():
            v = np.asarray(v)
            if v.ndim != 1 or len(v) != n:
                raise ValueError(f"column {k}: want 1-D of len {n}, got {v.shape}")
            buf = np.zeros(cap, dtype=v.dtype)
            buf[:n] = v
            out[k] = torch.from_numpy(buf).to(device)
        return cls(out, n)

    def to_numpy(self) -> dict[str, np.ndarray]:
        """Host export, trimmed to num_rows (a device sync)."""
        n = min(int(self.num_rows), self.capacity)
        return {k: v[:n].cpu().numpy() for k, v in self.columns.items()}

    def valid_mask(self) -> torch.Tensor:
        """bool[capacity], True for live rows."""
        return torch.arange(self.capacity, dtype=torch.int32,
                            device=self.device) < self.num_rows


def canonicalize(table: Table) -> dict[str, np.ndarray]:
    """Host-side canonical form: rows lexicographically sorted by columns
    in insertion order (first column = primary). Byte equality of this
    form is the exactness contract against the C++ oracle."""
    cols = table.to_numpy()
    names = list(cols.keys())
    if names:
        # np.lexsort: last key is primary -> reverse
        order = np.lexsort(tuple(cols[n] for n in reversed(names)))
        cols = {n: cols[n][order] for n in names}
    return cols


def tables_equal(a: dict[str, np.ndarray], b: dict[str, np.ndarray]) -> bool:
    if list(a.keys()) != list(b.keys()):
        return False
    return all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        and np.array_equal(a[k], b[k])
        for k in a
    )
