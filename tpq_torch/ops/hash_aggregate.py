"""Hash aggregate: group by key -> count + per-column sum (port of
tpq/ops/hash_aggregate.py).

Sort path, as tpq's: co-sort by key (radix_sort.sort_rows, stable, the
padding last), then every per-group statistic from run-end positions:

  * run ends by neighbour compares, masked by the valid rows (a real
    INT64_MAX group must not merge with the padding, whose keys are
    INT64_MAX);
  * PACK (kernel 2) compacts the run-end rows to the front, carrying the
    row index and the inclusive cumsum of every column;
  * the valid rows are a prefix and each run starts just after the one
    before it ends, so a group's count is its end index minus the
    previous group's, and its sum the cumsum at its end minus the cumsum
    at the previous group's end (the value just before its start).

tpq finds each row's run start with a cummax and fill-forwards the
cumsum before it; at run ends the previous end gives both, and
torch.cummax alone took 394 of the 536 device ms of a pipeline_100m
pipeline on an H100 (PERF.md §6), so neither is ported. Sums wrap in
int64, as the oracle's do, and no atomics are involved, so two runs give
the same bytes.
Output columns: key, count (int64), sum_<name>... in input column
order; groups in ascending key order; capacity = the input's, num_rows
= the group count.
"""

from __future__ import annotations

import torch

from tpq_torch.columnar import Table
from tpq_torch.ops.filter import pack_columns
from tpq_torch.ops.merge_join import sort_table_by_key

I64 = torch.int64


def hash_aggregate(t: Table, key: str = "key") -> Table:
    """Group t by `key`; count + sum every other column (wrapping int64).
    Output capacity = input capacity (groups <= rows)."""
    cap, dev = t.capacity, t.device
    ts = sort_table_by_key(t, key)
    k = ts.col(key)
    valid = ts.valid_mask()
    # a run ends where the next row has another key or is padding, or at cap-1
    nxt_new = torch.ones(cap, dtype=torch.bool, device=dev)
    torch.bitwise_or(k[1:] != k[:-1], ~valid[1:], out=nxt_new[:-1])  # in place, no copy
    is_end = valid & nxt_new

    # native int64 cumsums, which wrap, replace tpq's u32 plane carry
    # chains (32-bit planes exist for the TPU's lack of a 64-bit vector
    # ALU; ROADMAP.md "What does not carry over")
    names = [n for n in ts.names if n != key]
    cols = {key: k, "count": torch.arange(cap, dtype=I64, device=dev)}
    for n in names:
        cols[f"sum_{n}"] = torch.cumsum(torch.where(valid, ts.col(n).to(I64), 0), 0)
    ends = pack_columns(cols, is_end.to(torch.int32))
    out = {key: ends.col(key)}
    for n, before_first in [("count", -1)] + [(f"sum_{n}", 0) for n in names]:
        c = ends.col(n)
        out[n] = torch.diff(c, prepend=c.new_full((1,), before_first))
    return Table(out, ends.num_rows)
