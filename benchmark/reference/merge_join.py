"""Plain reference of the sort-merge join query, in torch alone: nothing
of the program is imported, and everything is worked out again from the
relations the benchmark made.

Semantics (the port's merge join, whatever its sort engine): the inner
equi-join on "key"; each pair of an R row and an S row with equal keys
is one output row (key, r_<R payloads>, s_<S payloads>), so duplicate
keys give their full cross product; rows come in no particular order,
so results are compared as multisets. The output holds at most its
capacity: past it the program reports overflow as num_rows > capacity
and its rows are not compared.

The reference merges as the query does: both sides sorted by key, each
S row paired with the run of R rows that holds its key. The control is
this reference put in the program's place in the next lower precision,
int32 for the configuration's int64: keys and payloads are cut to 32
bits before the join and widened after it.
"""

from __future__ import annotations

from dataclasses import dataclass
import torch

from benchmark.harness.compare import canonical, rows_differ
from benchmark.harness.query import Prepared, padded_result

TAIL_ZEROS = False  # rows past num_rows are unspecified in the join's result


@dataclass
class Expected:
    columns: dict  # canonical order
    count: int


def merge(build: dict, probe: dict, key: str = "key") -> dict:
    """R ⋈ S of live columns by a merge of the key-sorted sides: key,
    r_<...>, s_<...>, one row a match."""
    r_order = torch.sort(build[key], stable=True).indices
    s_order = torch.sort(probe[key], stable=True).indices
    rk, sk = build[key][r_order], probe[key][s_order]
    first = torch.searchsorted(rk, sk)                 # the run of R rows with S's key
    run = torch.searchsorted(rk, sk, right=True) - first
    s_pos = torch.repeat_interleave(torch.arange(sk.shape[0], device=sk.device), run)
    offset = torch.arange(s_pos.shape[0], device=sk.device) - (torch.cumsum(run, 0) - run)[s_pos]
    r_idx, s_idx = r_order[first[s_pos] + offset], s_order[s_pos]
    out = {key: probe[key][s_idx]}
    out.update({f"r_{n}": c[r_idx] for n, c in build.items() if n != key})
    out.update({f"s_{n}": c[s_idx] for n, c in probe.items() if n != key})
    return out


def _live(rel) -> dict:
    return {n: rel.live(n) for n in rel.columns}


def expected(config: dict, traffic: dict, inputs: dict) -> Expected:
    cols = merge(_live(inputs["build"]), _live(inputs["probe"]))
    return Expected(canonical(cols, list(cols)), next(iter(cols.values())).shape[0])


def wrong_rows(exp: Expected, columns: dict) -> int:
    """Rows of one result (its live columns) that the reference does not
    hold, as multisets."""
    names = list(exp.columns)
    if list(columns) != names:
        return max(exp.count, 1)
    dev = exp.columns[names[0]].device
    got = canonical({n: c.to(dev) for n, c in columns.items()}, names)
    return rows_differ(got, exp.columns, names)


def least_bytes(inputs: dict, exp: Expected, capacity: int) -> int:
    """Each input byte present read once, each output byte of the
    result (its live rows, at most the capacity, and num_rows) written
    once."""
    read = sum(rel.rows * c.element_size() for rel in inputs.values()
               for c in rel.columns.values())
    row = sum(c.element_size() for c in exp.columns.values())
    return read + min(exp.count, capacity) * row + 4


def control(config: dict, traffic: dict, inputs: dict, device, capacity: int) -> Prepared:
    """The reference in int32, in the program's place."""
    b32 = {n: c.to(torch.int32) for n, c in _live(inputs["build"]).items()}
    p32 = {n: c.to(torch.int32) for n, c in _live(inputs["probe"]).items()}

    def call():
        return padded_result(merge(b32, p32), capacity, device)

    return Prepared(call=call, probe_rows=inputs["probe"].rows)
