"""The sort-merge join query: R ⋈ S on "key" through the port's jitted
merge join, `jit(partial(merge_join, out_capacity=..., sort_engine=...,
key_bits=...))`, as a user runs it over resident tables: one union sort
of both relations by key, then the runs' cross products. The result is
the jit's: fresh tensors holding the live rows (rows past num_rows
unspecified).

Traffic keys read here: "sort_engine" (lax or radix), "key_bits".
"""

from __future__ import annotations

import functools

from benchmark.harness.query import Prepared
from benchmark.harness.spec import out_capacity

SMALL_OK = "tpq.union.small_ok"  # the union join's cond: inline emission, not full expand


def prepare(config: dict, traffic: dict, inputs: dict, device) -> Prepared:
    from tpq_torch.columnar import Table
    from tpq_torch.jit import jit
    from tpq_torch.ops import merge_join

    build, probe = inputs["build"], inputs["probe"]
    r = Table(build.columns, build.rows)
    s = Table(probe.columns, probe.rows)
    engine, bits = traffic["sort_engine"], int(traffic["key_bits"])
    fn = jit(functools.partial(merge_join, out_capacity=out_capacity(config),
                               sort_engine=engine, key_bits=bits))

    def path() -> dict:
        """The branches the union join's cond took over every call: the
        inline path is `taken` when no call ran the full expand."""
        b = fn.branches.get(SMALL_OK, {"then": 0, "else": 0})
        return {"sort_engine": engine, "key_bits": bits,
                "taken": b["then"] > 0 and b["else"] == 0}

    return Prepared(
        call=lambda: fn(r, s), probe_rows=probe.rows,
        counters=lambda: {"reruns": fn.reruns, "copies": fn.copies,
                          "captures": fn.captures},
        path=path, close=fn.clear)
