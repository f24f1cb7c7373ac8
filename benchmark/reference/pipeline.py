"""Plain reference of the pipeline query, in torch alone: nothing of the
program is imported, and everything is worked out again from the
relations the benchmark made.

Semantics (tpq's filter -> hash join -> hash aggregate): keep the fact
rows whose filter column passes (lt, le, gt, ge, eq, ne against the
value in the column's dtype); join them to the dimension table on "key";
group the joined rows by key. One output row a key present on both
sides, in ascending key order: key, count, sum_r_<dim payloads>,
sum_s_<fact payloads>, the sums wrapping in int64. Every row past the
groups, up to the capacity, is 0.

The joined rows are not materialised: a key with a rows in the
dimension table and b kept fact rows has a * b joined rows, so its count
is a * b, a dimension payload's sum is b times the key's dimension sum
and a fact payload's is a times its fact sum (mod 2^64, as the wrapping
sums of the rows are). The groups are compared in order.

The control is this reference put in the program's place in the next
lower precision, int32 for the configuration's int64: every column is
cut to 32 bits, and the counts and sums computed and wrapped in int32.
"""

from __future__ import annotations

from dataclasses import dataclass
import torch

from benchmark.harness.compare import rows_differ
from benchmark.harness.query import Prepared, padded_result

TAIL_ZEROS = True  # the aggregate's rows past the groups are 0

OPS = {"lt": torch.lt, "le": torch.le, "gt": torch.gt, "ge": torch.ge,
       "eq": torch.eq, "ne": torch.ne}


@dataclass
class Expected:
    columns: dict  # ascending key order
    count: int


def pipeline(dim: dict, fact: dict, col: str, op: str, value: int,
             key: str = "key") -> dict:
    """The groups of filter -> join -> aggregate over live columns."""
    c = fact[col]
    keep = OPS[op](c, torch.tensor(value, dtype=c.dtype, device=c.device))
    fact = {n: v[keep] for n, v in fact.items()}
    dk, fk = dim[key], fact[key]
    keys = torch.unique(torch.cat([dk, fk]))  # sorted
    di = torch.searchsorted(keys, dk)
    fi = torch.searchsorted(keys, fk)

    def per_key(idx, values):
        return torch.zeros(keys.shape[0], dtype=values.dtype,
                           device=keys.device).index_add_(0, idx, values)

    a = per_key(di, torch.ones_like(dk))
    b = per_key(fi, torch.ones_like(fk))
    both = (a > 0) & (b > 0)
    out = {key: keys[both], "count": (a * b)[both]}
    out.update({f"sum_r_{n}": (per_key(di, v) * b)[both]
                for n, v in dim.items() if n != key})
    out.update({f"sum_s_{n}": (per_key(fi, v) * a)[both]
                for n, v in fact.items() if n != key})
    return out


def _live(rel) -> dict:
    return {n: rel.live(n) for n in rel.columns}


def _filter(traffic: dict):
    f = traffic["filter"]
    return f["col"], f["op"], int(f["value"])


def expected(config: dict, traffic: dict, inputs: dict) -> Expected:
    cols = pipeline(_live(inputs["build"]), _live(inputs["probe"]), *_filter(traffic))
    return Expected(cols, next(iter(cols.values())).shape[0])


def wrong_rows(exp: Expected, columns: dict) -> int:
    """Groups of one result (its live columns) that differ from the
    reference's at the same position."""
    names = list(exp.columns)
    if list(columns) != names:
        return max(exp.count, 1)
    return rows_differ(exp.columns, columns, names)


def least_bytes(inputs: dict, exp: Expected, capacity: int) -> int:
    """Each input byte present read once, each byte of the result
    written once: the whole output table (the groups and the zeros past
    them, which the contract makes part of it) and num_rows."""
    read = sum(rel.rows * c.element_size() for rel in inputs.values()
               for c in rel.columns.values())
    row = sum(c.element_size() for c in exp.columns.values())
    return read + capacity * row + 4


def control(config: dict, traffic: dict, inputs: dict, device, capacity: int) -> Prepared:
    """The reference in int32, in the program's place."""
    d32 = {n: c.to(torch.int32) for n, c in _live(inputs["build"]).items()}
    f32 = {n: c.to(torch.int32) for n, c in _live(inputs["probe"]).items()}
    col, op, value = _filter(traffic)

    def call():
        return padded_result(pipeline(d32, f32, col, op, value), capacity, device)

    return Prepared(call=call, probe_rows=inputs["probe"].rows)
