"""Scale-proportional verification (port of tpq/verify.py).

Past the sizes at which the C++ oracle joins whole relations in seconds,
a join is checked two ways:

  1. key-range slicing: the inner join commutes with key-range
     restriction, so the oracle joins a few narrow slices of both inputs
     and the engine's output restricted to each range must equal it,
     byte for byte;
  2. an order-invariant multiset checksum: a wrapping sum over per-row
     mixes, computable per shard and summed, so two engine runs (say the
     distributed join and the single-card join) must agree exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from tpq_torch.columnar import Table

_MIX = np.uint64(0x9E3779B97F4A7C15)
M64 = (1 << 64) - 1


def _s64(x: int) -> int:
    """A u64 constant as the int64 with the same bits."""
    x &= M64
    return x - (1 << 64) if x >= 1 << 63 else x


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of u64 bits held in int64 (torch on the CPU has
    no uint64 shift): the arithmetic shift, masked."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64-style finalizer on u64 bits held in int64: int64
    multiplies wrap to the same low 64 bits."""
    x = (x ^ _shr(x, 30)) * _s64(0xBF58476D1CE4E5B9)
    x = (x ^ _shr(x, 27)) * _s64(0x94D049BB133111EB)
    return x ^ _shr(x, 31)


def multiset_checksum(t: Table) -> torch.Tensor:
    """Order-invariant checksum of the live rows: the wrapping sum over
    rows of mix(row-hash), where the row-hash folds every column (name
    order is part of the contract). A 0-d int64 tensor holding tpq's u64
    bits (`int(x) & M64` is multiset_checksum_np's value); per-shard
    partials add up, wrapping, to the whole table's."""
    acc = torch.zeros(t.capacity, dtype=torch.int64, device=t.device)
    for i, name in enumerate(t.names):
        acc = _mix64(acc + t.columns[name].to(torch.int64) + _s64((i + 1) * int(_MIX)))
    return torch.where(t.valid_mask(), acc, 0).sum()


def multiset_checksum_np(cols: dict[str, np.ndarray]) -> int:
    """Numpy twin of multiset_checksum (host-side / oracle-output side)."""
    names = list(cols.keys())
    n = len(cols[names[0]]) if names else 0
    acc = np.zeros(n, np.uint64)

    def mix(x):
        x = x.astype(np.uint64)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))

    with np.errstate(over="ignore"):
        for i, name in enumerate(names):
            acc = mix(acc + cols[name].astype(np.uint64) + np.uint64(i + 1) * _MIX)
        return int(acc.sum(dtype=np.uint64))


def slice_by_key(cols: dict[str, np.ndarray], lo: int, hi: int,
                 key: str = "key") -> dict[str, np.ndarray]:
    """Host-side key-range restriction sigma_[lo,hi)."""
    m = (cols[key] >= lo) & (cols[key] < hi)
    return {n: c[m] for n, c in cols.items()}


def sample_key_ranges(keys: np.ndarray, n_ranges: int = 4,
                      target_rows: int = 2048, seed: int = 0):
    """Pick n_ranges [lo, hi) key windows that each cover ~target_rows of
    `keys` (sampled quantile estimate, no full sort of the relation)."""
    rng = np.random.default_rng(seed)
    sample = rng.choice(keys, size=min(len(keys), 1 << 16), replace=False)
    sample.sort()
    frac = target_rows / max(1, len(keys))
    step = max(1, int(len(sample) * frac))
    ranges = []
    for _ in range(n_ranges):
        i = int(rng.integers(0, max(1, len(sample) - step)))
        lo, hi = int(sample[i]), int(sample[min(len(sample) - 1, i + step)]) + 1
        if lo < hi:
            ranges.append((lo, hi))
    return ranges
