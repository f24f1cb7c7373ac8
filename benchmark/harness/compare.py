"""The comparisons that decide `correct`. Each returns a count that an
exact result holds at 0."""

from __future__ import annotations

import torch


def lexsort(columns: list) -> torch.Tensor:
    """The permutation that orders rows by the columns, the first column
    primary (stable sorts from the last column to the first)."""
    n = columns[0].shape[0]
    perm = torch.arange(n, device=columns[0].device)
    for c in reversed(columns):
        perm = perm[torch.sort(c[perm], stable=True).indices]
    return perm


def canonical(cols: dict, names) -> dict:
    """The rows in lexicographic order of the named columns: a multiset
    in one form."""
    perm = lexsort([cols[n] for n in names])
    return {n: cols[n][perm] for n in names}


def rows_differ(a: dict, b: dict, names) -> int:
    """Positions at which two row lists differ in any named column, plus
    the rows one has beyond the other."""
    na, nb = a[names[0]].shape[0], b[names[0]].shape[0]
    m = min(na, nb)
    diff = torch.zeros(m, dtype=torch.bool, device=a[names[0]].device)
    for n in names:
        diff |= a[n][:m] != b[n][:m].to(a[n].device)
    return int(diff.sum()) + abs(na - nb)


def count_wrong(counts, expected: int, capacity: int) -> int:
    """Queries whose num_rows breaks the contract: the exact count when it
    fits the capacity, a count past the capacity (overflow reported,
    never truncated) when it does not."""
    if expected <= capacity:
        return sum(1 for n in counts if n != expected)
    return sum(1 for n in counts if n <= capacity)


def nonzero_past(columns: dict, n: int) -> int:
    """Elements past the first n rows that are not 0."""
    return sum(int(torch.count_nonzero(c[max(n, 0):])) for c in columns.values())
