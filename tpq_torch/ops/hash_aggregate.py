"""Hash aggregate: group by key -> count + per-column sum (port of
tpq/ops/hash_aggregate.py).

Sort path, as tpq's: co-sort by key (radix_sort.sort_rows, stable, the
padding last), then every group from its run-end row in one pass,
kernels/aggregate.aggregate_runs (csrc/aggregate.cu on the card): a
row ends a run when it is valid and the next row is padding or holds
another key (a real INT64_MAX group must not merge with the padding,
whose keys are INT64_MAX); a group's count and sums are those of its run.

What differs from tpq: tpq finds each row's run start with a cummax,
keeps u64 cumsums as u32 plane pairs, fill-forwards the cumsum before
each run start and compacts the run ends with PACK, all XLA fusions but
the PACK call; the port does the whole chain in one kernel, whose
decoupled look-back carries the run-end count and the open run across
its tiles. Sums wrap in int64, as the oracle's do, and no atomics are
involved, so two runs give the same bytes. Output columns: key, count
(int64), sum_<name>... in input column order; groups in ascending key
order; capacity = the input's, num_rows = the group count; every row
from the group count on is 0, as tpq's.
"""

from __future__ import annotations

from tpq_torch.columnar import Table
from tpq_torch.kernels.aggregate import aggregate_runs
from tpq_torch.ops.merge_join import sort_table_by_key
from tpq_torch.trace import span


def hash_aggregate(t: Table, key: str = "key") -> Table:
    """Group t by `key`; count + sum every other column (wrapping int64).
    Output capacity = input capacity (groups <= rows)."""
    with span("tpq.aggregate.sort"):
        ts = sort_table_by_key(t, key)
    names = [n for n in ts.names if n != key]
    with span("tpq.aggregate.runs"):
        cols, groups = aggregate_runs(ts.col(key), [ts.col(n) for n in names],
                                      ts.num_rows)
    return Table(dict(zip([key, "count"] + [f"sum_{n}" for n in names], cols)), groups)
