"""Sort-merge equi-join (port of tpq/ops/merge_join.py).

The union sort is the merge: both relations co-sorted by key in one
union sort, runs found by neighbour compares and scans, the per-key
cross product emitted by the union-sort engine (ops/union_join.py).
sort_engine="radix" runs that sort on the LSD radix engine (one split
kernel launch per bit), sort_engine="lax" (default) on stable torch
sorts. Semantics are the oracle's: inner equi-join on `key`, the full
cross product per key, output columns key, r_<R payloads>,
s_<S payloads>, overflow visible as num_rows > out_capacity.
"""

from __future__ import annotations

from tpq_torch.columnar import Table
from tpq_torch.kernels.radix_sort import sort_rows


def sort_table_by_key(t: Table, key: str = "key") -> Table:
    """Stable co-sort of all columns by `key`, padding last. Padding rows
    are a suffix with their keys set to the dtype's max, so every valid
    row sorts before them, at a real max-key tie by stability; the
    padding keys are not preserved (padding contents are unspecified).
    tpq's twin of radix_sort.sort_rows, which it is here."""
    return sort_rows(t, key)


def merge_join(r: Table, s: Table, out_capacity: int, key: str = "key",
               sort_engine: str = "lax", key_bits: int = 64) -> Table:
    """Inner equi-join R ⋈ S on `key`; num_rows is the true match count
    (check it against out_capacity). `key_bits` narrows the radix
    engine's key passes when the key domain is bounded."""
    from tpq_torch.ops.union_join import union_join

    return union_join(r, s, out_capacity, key=key, sort_engine=sort_engine,
                      key_bits=key_bits)
