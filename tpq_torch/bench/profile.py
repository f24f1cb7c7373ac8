"""Where a join's time goes on the card.

torch.profiler traces JOINS joins after a warm-up; the device activities
of the trace (kernels, memsets, copies) are merged into busy intervals.
The end-to-end time per join is taken apart from the trace, with CUDA
events around unprofiled joins, so the profiler's own host cost does not
stretch it.

A single-card join or pipeline runs jitted (the bench runner's join_fn:
one CUDA graph replayed a call), and so does a mesh preset's
distributed join after its plan (dist_hash_join's jitted body; the
planner stays eager); `--eager` runs the same bodies eagerly, one host
read a cond.

CLI (needs a card), with the bench runner's preset and join options:
  python -m tpq_torch.bench.profile --config=zipf_skew [--eager]
  python -m tpq_torch.bench.profile --config=single_chip_1m --algo=merge \\
      --sort-engine=radix
  python -m tpq_torch.bench.profile --config=dist_125m_8shard
  python -m tpq_torch.bench.profile --config=pipeline_100m
(a pipeline preset runs its filter -> join -> aggregate pipeline; a
preset with a mesh shape runs dist_hash_join_planned(local_impl=
"lane") on a one-process mesh of that many shards on the card, and also
times its planning and its body apart: `plan_ms` and `body_ms`, end to
end being plan + body)
prints one JSON object: end-to-end ms per join, device busy ms per join,
the device's idle share of the join (1 - busy / end to end), device
activities per join, the TOP largest device items by name and every
kernel of tpq_torch/csrc that ran (`port_kernels`), each with the card's
name and power limit.
"""

from __future__ import annotations

import json
import sys

import torch

from tpq_torch.bench.runner import (add_join_args, card_info, config_from_args,
                                    cuda_time, gen, gen_np, join_fn,
                                    out_capacity_for)

JOINS = 10
TOP = 12
# the __global__ kernels of tpq_torch/csrc (the histogram's is
# hist_shared_bins), as the trace names them
PORT_KERNELS = ("pad_kernel", "pack_kernel", "walk_emit_kernel", "probe_walk_kernel",
                "digit_count_kernel", "digit_scan_kernel", "digit_scatter_kernel",
                "hist_shared_bins", "hash_keys_kernel", "agg_runs_kernel", "group_insert_kernel",
                "group_write_kernel", "layout_count_kernel", "layout_scan_kernel",
                "layout_scatter_kernel", "layout2_coarse_count_kernel",
                "layout2_group_scan_kernel", "layout2_groups_kernel",
                "layout2_coarse_scatter_kernel", "layout2_fine_count_kernel",
                "layout2_part_scan_kernel", "layout2_fine_scatter_kernel",
                "lane_build_count_kernel", "lane_build_finish_kernel")


def device_activities(prof) -> list[tuple[float, float, str]]:
    """(start us, end us, name) of every device activity in a trace."""
    return [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def port_kernel(name: str):
    """The kernel of tpq_torch/csrc a trace's activity name is, or None."""
    return next((k for k in PORT_KERNELS if f"::{k}(" in name), None)


def port_launches(acts) -> dict:
    """{kernel of tpq_torch/csrc: launches} among the activities."""
    counts: dict = {}
    for _, _, name in acts:
        k = port_kernel(name)
        if k is not None:
            counts[k] = counts.get(k, 0) + 1
    return counts


def busy_us(acts) -> float:
    """Total length of the union of the activity intervals."""
    total, end = 0.0, float("-inf")
    for s, e, _ in sorted(acts):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def profile_join(fn, device, joins: int = JOINS, warmup: int = 3) -> dict:
    """End to end over `joins` calls after `warmup` calls, then the trace
    of `joins` more (the keys of the report main prints)."""
    e2e_s, _ = cuda_time(fn, device, joins, warmup=warmup)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(joins):
            fn()
        torch.cuda.synchronize(device)
    acts = device_activities(prof)
    if not acts:
        raise RuntimeError("the trace holds no device activity: device time not measured")
    by_name: dict[str, list] = {}
    for s, e, name in acts:
        rec = by_name.setdefault(name, [0, 0.0])
        rec[0] += 1
        rec[1] += e - s
    busy_ms = busy_us(acts) / 1e3 / joins
    e2e_ms = e2e_s * 1e3
    items = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    port = {}
    for name, (c, t) in items:
        k = port_kernel(name)
        if k is not None:
            rec = port.setdefault(k, {"launches_per_join": 0.0, "ms_per_join": 0.0})
            rec["launches_per_join"] += c / joins
            rec["ms_per_join"] += t / 1e3 / joins
    return {
        "end_to_end_ms": e2e_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / e2e_ms,
        "device_activities_per_join": len(acts) / joins,
        "top": [{"name": n[:120], "launches_per_join": c / joins,
                 "ms_per_join": t / 1e3 / joins} for n, (c, t) in items[:TOP]],
        "port_kernels": port,
    }


def dist_join_fn(cfg, device, eager: bool = False):
    """The planned lane dist join of a mesh preset, on a one-process mesh
    of cfg.mesh_shape[0] shards on `device`, its body jitted unless
    `eager`. Returns (the planned join, what it is, {"plan": the planner
    alone, "body": the body alone at the planned capacities}); the body
    is the planned join's own jitted callable."""
    from tpq_torch.dist import (DistTable, dist_hash_join, dist_hash_join_planned,
                                make_mesh, plan_dist_capacities)

    mesh = make_mesh(cfg.mesh_shape[0], device)
    R, S = (DistTable.from_numpy(gen_np(x), mesh) for x in (cfg.r, cfg.s))
    ex_cap, out_cap = plan_dist_capacities(R, S, mesh)
    parts = {"plan": lambda: plan_dist_capacities(R, S, mesh),
             "body": lambda: dist_hash_join(R, S, mesh, out_capacity_per_shard=out_cap,
                                            exchange_capacity=ex_cap, local_impl="lane",
                                            eager=eager)}
    return (lambda: dist_hash_join_planned(R, S, mesh, local_impl="lane", eager=eager),
            f"dist_hash_join_planned(local_impl='lane') on {mesh}, "
            + ("eager" if eager else "its body jitted"), parts)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    add_join_args(p)
    p.add_argument("--eager", action="store_true",
                   help="run the join or pipeline eagerly, not as its CUDA graph")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("tpq_torch.bench.profile traces a CUDA card; none is visible")

    cfg = config_from_args(args)
    dev = torch.device("cuda")
    parts = {}
    if cfg.mesh_shape:
        fn, what, parts = dist_join_fn(cfg, dev, eager=args.eager)
    else:
        r, s = gen(cfg.r, dev), gen(cfg.s, dev)
        j = cfg.join
        what = (f"hash_join(impl={j.impl!r})" if j.algo == "hash"
                else f"merge_join(sort_engine={j.sort_engine!r})")
        if cfg.pipeline:
            what = f"pipeline (filter key < {cfg.filter_value}, {what}, hash_aggregate)"
        fn = join_fn(cfg, r, s, out_capacity_for(cfg))
        if args.eager:
            fn = fn.eager
        what += ", eager" if args.eager else ", jitted"
    report = {"config": cfg.name, "join": what, "card": card_info(),
              **profile_join(fn, dev)}
    for name, part in parts.items():
        report[f"{name}_ms"] = cuda_time(part, dev, 3)[0] * 1e3
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
