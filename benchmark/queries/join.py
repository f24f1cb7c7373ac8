"""The join query: R ⋈ S on "key" through the port's jitted hash join,
`jit(partial(hash_join, out_capacity=..., impl=...))`, as a user runs
it over resident tables. The result is the jit's: fresh tensors holding
the live rows (rows past num_rows unspecified).

Traffic keys read here: "impl" (lane, sorted or skew).
"""

from __future__ import annotations

import functools

from benchmark.harness.query import Prepared
from benchmark.harness.spec import out_capacity


def prepare(config: dict, traffic: dict, inputs: dict, device) -> Prepared:
    from tpq_torch.columnar import Table
    from tpq_torch.jit import jit
    from tpq_torch.ops import hash_join

    build, probe = inputs["build"], inputs["probe"]
    r = Table(build.columns, build.rows)
    s = Table(probe.columns, probe.rows)
    cap = out_capacity(config)
    impl = traffic["impl"]
    fn = jit(functools.partial(hash_join, out_capacity=cap, impl=impl))

    def path() -> dict:
        if impl == "lane":
            from tpq_torch.kernels.lane2 import lane2_path_taken

            return {"impl": impl, "taken": bool(lane2_path_taken(r, s, cap))}
        if impl == "skew":
            from tpq_torch.ops.skew_join import skew_path_taken

            return {"impl": impl, "taken": bool(skew_path_taken(r, s, cap))}
        return {"impl": impl}

    return Prepared(
        call=lambda: fn(r, s), probe_rows=probe.rows,
        counters=lambda: {"reruns": fn.reruns, "copies": fn.copies,
                          "captures": fn.captures},
        path=path, close=fn.clear)
