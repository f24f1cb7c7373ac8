"""The pipeline query: filter the fact table, hash-join it to the
dimension table, aggregate by key (count and wrapping sums), through the
port's `jit_pipeline` body jitted as one CUDA graph.

The body is `jit_pipeline(...).__wrapped__` jitted with `hand_off=True`:
the result is the graph's own output table, the aggregate's zeros past
the groups included (tpq's contract makes them part of the user's
table; jit's default copy-out keeps only the live rows). It holds until
the next query, which is all a closed loop needs.

Traffic keys read here: "algo" (hash or merge), "join_impl" (lane,
sorted or skew), "filter" ({"col", "op", "value"}).
"""

from __future__ import annotations

from benchmark.harness.query import Prepared
from benchmark.harness.spec import out_capacity


def prepare(config: dict, traffic: dict, inputs: dict, device) -> Prepared:
    from tpq_torch.columnar import Table
    from tpq_torch.jit import jit
    from tpq_torch.query import jit_pipeline

    dim = Table(inputs["build"].columns, inputs["build"].rows)
    fact = Table(inputs["probe"].columns, inputs["probe"].rows)
    cap = out_capacity(config)
    f = traffic["filter"]
    algo, impl = traffic["algo"], traffic["join_impl"]
    body = jit_pipeline(cap, filter_col=f["col"], filter_op=f["op"], algo=algo,
                        join_impl=impl).__wrapped__
    fn = jit(body, hand_off=True)
    value = int(f["value"])

    def path() -> dict:
        from tpq_torch.ops.filter import compact, keep_mask

        if algo != "hash" or impl not in ("lane", "skew"):
            return {"algo": algo, "impl": impl}
        keep = keep_mask(fact, f["col"], f["op"], value)
        if impl == "lane":
            from tpq_torch.kernels.lane2 import lane2_path_taken

            taken = lane2_path_taken(dim, fact, cap, probe_keep=keep)
        else:
            from tpq_torch.ops.skew_join import skew_path_taken

            taken = skew_path_taken(dim, compact(fact, keep), cap)
        return {"algo": algo, "impl": impl, "taken": bool(taken)}

    return Prepared(
        call=lambda: fn(dim, fact, value), probe_rows=inputs["probe"].rows,
        counters=lambda: {"reruns": fn.reruns, "copies": fn.copies,
                          "captures": fn.captures},
        path=path, close=fn.clear)
