"""Hash aggregate: group by key -> count + per-column sum (port of
tpq/ops/hash_aggregate.py).

Hash path, the port's: one pass over the live rows groups them in a
table by key, then only the table's slots are ordered and written out
(kernels/group_table.py, csrc/group_table.cu on the card). The table has
twice the capacity's power of two slots, at most MAX_SLOTS; past half
of them (more distinct keys than that) its `ok` is false and the cond
`tpq.aggregate.ok` takes the sort path instead, which is tpq's. A table
of more than MAX_VALUES value columns takes the sort path directly.

Sort path (`sort_aggregate`, also the chunked config-4 bench's, whose
body may hold no cond): co-sort by key (radix_sort.sort_rows, stable,
the padding last), then every group from its run-end row in one pass,
kernels/aggregate.aggregate_runs (csrc/aggregate.cu on the card): a
row ends a run when it is valid and the next row is padding or holds
another key (a real INT64_MAX group must not merge with the padding,
whose keys are INT64_MAX); a group's count and sums are those of its run.

What differs from tpq: tpq finds each row's run start with a cummax,
keeps u64 cumsums as u32 plane pairs, fill-forwards the cumsum before
each run start and compacts the run ends with PACK, all XLA fusions but
the PACK call; the port's sort path does the whole chain in one kernel,
whose decoupled look-back carries the run-end count and the open run
across its tiles. Sums wrap in int64, as the oracle's do, and integer
adds give the same bytes in any order, so two runs give the same bytes
on either path. Output columns: key, count (int64), sum_<name>... in
input column order; groups in ascending key order; capacity = the
input's, num_rows = the group count; every row from the group count on
is 0, as tpq's.
"""

from __future__ import annotations

from tpq_torch import trace
from tpq_torch.columnar import Table
from tpq_torch.jit import cond
from tpq_torch.kernels.aggregate import aggregate_runs
from tpq_torch.kernels.group_table import MAX_VALUES, group_insert, group_write
from tpq_torch.ops.merge_join import sort_table_by_key
from tpq_torch.trace import span


def _names(t: Table, key: str):
    """The value columns, and the output's column names."""
    names = [n for n in t.names if n != key]
    return names, [key, "count"] + [f"sum_{n}" for n in names]


def sort_aggregate(t: Table, key: str = "key") -> Table:
    """The sort path (module docstring): the same output as
    hash_aggregate's, for any number of groups."""
    with span("tpq.aggregate.sort"):
        ts = sort_table_by_key(t, key)
    names, out = _names(ts, key)
    with span("tpq.aggregate.runs"):
        cols, groups = aggregate_runs(ts.col(key), [ts.col(n) for n in names],
                                      ts.num_rows)
    return Table(dict(zip(out, cols)), groups)


def hash_aggregate(t: Table, key: str = "key") -> Table:
    """Group t by `key`; count + sum every other column (wrapping int64).
    Output capacity = input capacity (groups <= rows)."""
    names, out = _names(t, key)
    if len(names) > MAX_VALUES:  # wider than the group table's slots
        return sort_aggregate(t, key)
    attempt = trace.marker()
    with span("tpq.aggregate.hash"):
        table = group_insert(t.col(key), [t.col(n) for n in names], t.num_rows)
        ok = table.ok

    def groups() -> Table:
        with span("tpq.aggregate.groups"):
            cols, g = group_write(table)
        return Table(dict(zip(out, cols)), g)

    return cond(ok, groups, lambda: sort_aggregate(t, key),
                name="tpq.aggregate.ok", attempt=attempt)
