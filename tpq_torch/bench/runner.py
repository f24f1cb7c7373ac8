"""Config-driven benchmark runner (port of tpq/bench/runner.py): the
joins (hash with the lane, sorted and skew impls; merge) and, for a
`pipeline` preset, the filter -> hash join -> hash aggregate pipeline
(config 4, tpq_torch/query.py).

Generates the seed-stable relations of a preset on the card (uniform
ones by the on-device streams), times the join or pipeline jitted
(tpq_torch/jit.py: one CUDA graph replayed per call, as tpq's runner
jits every timed call) with CUDA events after the capture and the
preset's warm-up calls, accounts it
against the measured bandwidth roofline, and labels the row honestly
when the lane or skew path fell back to the sorted engine, and with the
jitted calls that reran eagerly (`reruns`). Times exist only for a run
on a card: on the CPU, run_config runs the operator once, eagerly, and
reports no time.

CLI:  python -m tpq_torch.bench.runner --config=single_chip_1m [--phases]
      [--algo hash|merge] [--impl lane|sorted|skew] [--sort-engine lax|radix]
      [--iters N] [--trace-dir DIR] [--json-out FILE]
      [--check BASELINE_JSON [--tolerance 0.25]] [--device cuda|cpu]
      python -m tpq_torch.bench.runner --config=pipeline_100m
      python -m tpq_torch.bench.runner --scaling 1,2,4,8
      [--rows-per-chip N] [--exchange dense|ragged|ring] [--n-chunks N] [--eager]
prints the bench.py one-line JSON as its last line: probe rows/s under
the metric hash_join_probe_rows_per_sec_1chip_torch, fact rows/s of the
pipeline under pipeline_fact_rows_per_sec_1chip_torch, or the weak
scaling's rows/s per shard at its largest size under
weak_scaling_rows_per_sec_per_chip_torch (with its records). Reports
and markdown tables go to stderr. `--check` (tpq's regression mode)
exits 1 when an op's rows/s fell below (1 - tolerance) times the
baseline report's. `--device cpu` runs without times (values null).
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import time
from dataclasses import replace

import torch

from tpq_torch import datagen
from tpq_torch.bench import roofline
from tpq_torch.bench.report import emit_json, markdown_table
from tpq_torch.columnar import Table, next_pow2
from tpq_torch.config import PRESETS, BenchConfig, RelationSpec
from tpq_torch.jit import jit
from tpq_torch.ops import hash_join, merge_join
from tpq_torch.ops.filter import compact, keep_mask
from tpq_torch.query import jit_pipeline
from tpq_torch.trace import span, trace_if

METRIC = "hash_join_probe_rows_per_sec_1chip_torch"
PIPELINE_METRIC = "pipeline_fact_rows_per_sec_1chip_torch"
SCALING_METRIC = "weak_scaling_rows_per_sec_per_chip_torch"


def gen_np(spec: RelationSpec) -> dict:
    """The relation a spec names, as host columns."""
    return datagen.gen_relation_np(spec.rows, spec.nkeys, spec.payloads, spec.seed,
                                   spec.kind, spec.theta)


def gen(spec: RelationSpec, device) -> Table:
    """The relation a spec names, on `device`: a uniform one made there by
    the on-device streams (byte-equal to gen_np's), a zipf one from the
    host."""
    if spec.kind == "uniform":
        return datagen.gen_relation_device(spec.rows, spec.nkeys, spec.payloads,
                                           spec.seed, device=device)
    return Table.from_numpy(gen_np(spec), device=device)


def out_capacity_for(cfg: BenchConfig) -> int:
    return next_pow2(int(max(cfg.r.rows, cfg.s.rows) * cfg.join.out_capacity_factor))


def card_info() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (FileNotFoundError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return res.stdout.strip().splitlines()[0] if res.stdout.strip() else res.stderr.strip()


def cuda_time(fn, device, iters: int, warmup: int = 1) -> tuple[float, object]:
    """Mean seconds per call of fn() on the card: CUDA events around
    `iters` calls after `warmup` calls, then a synchronize."""
    out = None
    for _ in range(max(1, warmup)):
        out = fn()
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        out = fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / 1e3 / iters, out


def device_time(fn, device, n: int) -> tuple[float, float]:
    """(card seconds, host seconds) per call of fn(): n calls queued behind
    a spin of the stream (torch.cuda._sleep), so that the host is ahead of
    the card and the events time the card alone, while the host's clock
    times the calls from entry to return. The spin grows until the start
    event is still pending once the host has queued all n calls. n stays
    below the card's launch queue (about a thousand launches), which would
    stop the host."""
    fn()
    torch.cuda.synchronize(device)
    cycles = 1 << 21
    while True:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        host = (time.perf_counter() - t0) / n
        end.record()
        ahead = not start.query()
        torch.cuda.synchronize(device)
        if ahead:
            return start.elapsed_time(end) / 1e3 / n, host
        cycles *= 4
        if cycles >= 1 << 36:
            raise RuntimeError("device_time: the host never got ahead of the card")


def phase_report(cfg: BenchConfig, device="cuda", iters: int = 10) -> list[dict]:
    """Per-phase ms of the lane join on the card, each phase jitted (one
    graph replayed per call, as tpq's phases are jitted), timed as the
    runner times a join (the capture and one replay first). Each phase's
    graph reads its inputs in place and returns its outputs in fresh
    tensors, so a phase's ms holds its kernels, its copy-out and its one
    read of the flags. `tail+glue` is probe_emit minus layout and kernel.
    End to end is not split further: each phase pays its own copy-out
    and flag read, so end to end minus the phases is no time of the
    join's own."""
    from tpq_torch.kernels.lane2 import (build_lane2_tables, fused_walk_emit,
                                         lane2_hash_join, lane2_probe_emit,
                                         plan_lane2)
    from tpq_torch.kernels.lane_table import _probe_layout

    dev = torch.device(device)
    r, s = gen(cfg.r, dev), gen(cfg.s, dev)
    out_cap = out_capacity_for(cfg)
    plan = plan_lane2(r.capacity, s.capacity, out_capacity=out_cap)

    def ms(fn, *args):
        jitted = jit(fn)
        return cuda_time(lambda: jitted(*args), dev, iters, warmup=2)[0] * 1e3

    tables = build_lane2_tables(r, plan)
    qk, spay, lane, qocc, _ = _probe_layout(plan, s, "key")
    t_build = ms(lambda r: build_lane2_tables(r, plan), r)
    t_layout = ms(lambda s: _probe_layout(plan, s, "key"), s)
    t_kernel = ms(lambda *a: fused_walk_emit(*a, out_cap), tables, qk, lane, qocc, spay)
    t_pe = ms(lambda t, s: lane2_probe_emit(t, s, out_cap), tables, s)
    t_e2e = ms(lambda r, s: lane2_hash_join(r, s, out_cap), r, s)
    return [
        {"phase": "build(sort+pad)", "ms": t_build},
        {"phase": "probe_layout", "ms": t_layout},
        {"phase": "walk_emit(kernel)", "ms": t_kernel},
        {"phase": "tail+glue", "ms": t_pe - t_layout - t_kernel},
        {"phase": "end_to_end", "ms": t_e2e},
    ]


def join_fn(cfg: BenchConfig, r: Table, s: Table, out_cap: int):
    """The join a preset names, or its pipeline for a `pipeline` preset
    (filter key < filter_value, the value traced), jitted as tpq's runner
    jits fn (tpq/bench/runner.py:126), as a call with no arguments. The
    call's `.eager` runs the same body without the graph (where kernel
    launches can be counted) and `.jitted` is the jitted callable (its
    `reruns`, `clear()`)."""
    j = cfg.join
    if cfg.pipeline:
        fn = jit_pipeline(out_cap, algo=j.algo, join_impl=j.impl)
        args = (r, s, cfg.filter_value)
    elif j.algo == "hash":
        fn = jit(functools.partial(hash_join, out_capacity=out_cap, impl=j.impl))
        args = (r, s)
    elif j.algo == "merge":
        fn = jit(functools.partial(merge_join, out_capacity=out_cap,
                                   sort_engine=j.sort_engine))
        args = (r, s)
    else:
        raise ValueError(f"unknown algo {j.algo!r}")
    call = functools.partial(fn, *args)
    call.eager = functools.partial(fn.__wrapped__, *args)
    call.jitted = fn
    return call


def add_join_args(p) -> None:
    """The preset and join overrides that every bench CLI takes."""
    p.add_argument("--config", default="single_chip_1m", choices=sorted(PRESETS))
    p.add_argument("--algo", default=None, choices=[None, "hash", "merge"])
    p.add_argument("--impl", default=None, choices=[None, "lane", "sorted", "skew"])
    p.add_argument("--sort-engine", default=None, choices=[None, "lax", "radix"])


def config_from_args(args) -> BenchConfig:
    cfg = PRESETS[args.config]
    over = {k: v for k, v in (("algo", args.algo), ("impl", args.impl),
                              ("sort_engine", args.sort_engine)) if v}
    return replace(cfg, join=replace(cfg.join, **over)) if over else cfg


def run_config(cfg: BenchConfig, hbm_bw: float | None = None,
               device="cuda", trace_dir: str | None = None) -> dict:
    """Runs a join or pipeline preset on `device`. The report's "output"
    is the Table of the last timed call. `trace_dir` traces the timed
    calls (trace.trace_if), under tpq's span name with the port's prefix
    ("tpq.pipeline" or "tpq.join_<algo>")."""
    dev = torch.device(device)
    r, s = gen(cfg.r, dev), gen(cfg.s, dev)
    out_cap = out_capacity_for(cfg)
    fn = join_fn(cfg, r, s, out_cap)
    algo, impl = cfg.join.algo, cfg.join.impl
    if cfg.pipeline:
        bytes_model, op = roofline.pipeline_bytes, "pipeline"
    elif algo == "hash":
        bytes_model, op = roofline.hash_join_bytes, f"join_hash_{impl}"
    else:
        bytes_model, op = roofline.merge_join_bytes, f"join_merge_{cfg.join.sort_engine}"
    if algo == "hash" and impl in ("lane", "skew"):
        # honesty guard: the row says when the sorted fallback was measured
        # (of the pipeline's join: the lane impl takes the filter as a
        # mask, the skew impl the compacted relation)
        keep = keep_mask(s, "key", "lt", cfg.filter_value) if cfg.pipeline else None
        if impl == "lane":
            from tpq_torch.kernels.lane2 import lane2_path_taken

            ok = lane2_path_taken(r, s, out_cap, probe_keep=keep)
        else:
            from tpq_torch.ops.skew_join import skew_path_taken

            ok = skew_path_taken(r, s if keep is None else compact(s, keep), out_cap)
        if not bool(ok):
            op += "_FELL_BACK_TO_SORTED"

    name = "tpq.pipeline" if cfg.pipeline else f"tpq.join_{algo}"
    if dev.type == "cuda":
        if hbm_bw is None:
            hbm_bw = roofline.measure_hbm_bw(device=dev)
        # the capture is tpq's compile call (slope_time's untimed first
        # call), so cfg.warmup replays follow it: the first replay's fresh
        # result finds the capture's result still held and grows the
        # allocator by cudaMalloc calls, which no later call repeats
        with trace_if(trace_dir), span(name):
            sec, out = cuda_time(fn, dev, cfg.iters, 1 + cfg.warmup)
        fn.jitted.clear()  # the graph's memory pool goes before the caller's next step
        model = bytes_model(r.capacity, len(r.columns), s.capacity,
                            len(s.columns), out_cap)
        row = roofline.RooflineResult(op, sec, sum(b.total for b in model.values()),
                                      hbm_bw, cfg.s.rows).row()
        row["reruns"] = fn.jitted.reruns
        name = torch.cuda.get_device_name(dev)
    else:
        with trace_if(trace_dir), span(name):
            out = fn()
        # not measured
        row = {"op": op, "elapsed_ms": None, "rows": cfg.s.rows, "rows_per_sec": None}
        name = str(dev)
    return {"config": cfg.name, "device": name, "hbm_bw_gbps": hbm_bw,
            "out_capacity": out_cap, "out_rows": int(out.num_rows),
            "ops": [row], "output": out}


def check_regression(report: dict, baseline: dict, tolerance: float):
    """tpq's regression check: each op of `report` that the baseline
    report also has must reach (1 - tolerance) of its rows/s. Returns
    (one line per op compared, the ops that fell below)."""
    base_ops = {op["op"]: op for op in baseline.get("ops", [])}
    lines, failed = [], []
    for op in report["ops"]:
        ref = base_ops.get(op["op"])
        if ref is None:
            continue
        if op.get("rows_per_sec") is None:
            raise ValueError(f"check {op['op']}: no rows/s measured (a run on the CPU)")
        floor = ref["rows_per_sec"] * (1.0 - tolerance)
        status = "OK" if op["rows_per_sec"] >= floor else "REGRESSED"
        lines.append(f"check {op['op']}: {op['rows_per_sec']:.3e} rows/s vs baseline "
                     f"{ref['rows_per_sec']:.3e} (floor {floor:.3e}) {status}")
        if status != "OK":
            failed.append(op["op"])
    return lines, failed


def scaling_main(args, dev: torch.device) -> dict:
    """--scaling: run_weak_scaling at the sizes asked (with a process
    group from the TPQ_* environment, at the group's own size only)."""
    from tpq_torch.bench.scaling import run_weak_scaling
    from tpq_torch.dist import multihost

    grouped = multihost.init(device=dev)
    try:
        rows = run_weak_scaling(rows_per_chip=args.rows_per_chip,
                                mesh_sizes=tuple(int(x) for x in args.scaling.split(",")),
                                exchange_impl=args.exchange, n_chunks=args.n_chunks,
                                device=dev, process_group=grouped, eager=args.eager)
    finally:
        if grouped:
            torch.distributed.destroy_process_group()
    print(markdown_table(rows, ["n_chips", "rows_total", "elapsed_ms",
                                "rows_per_sec_per_chip", "efficiency", "mesh", "cards",
                                "device", "jitted"]), file=sys.stderr)
    report = {"scaling": rows, "card": card_info() if dev.type == "cuda" else None}
    if args.json_out:
        emit_json(args.json_out, report)
    print(json.dumps({"metric": SCALING_METRIC,
                      "value": rows[-1]["rows_per_sec_per_chip"] if rows else None,
                      "unit": "rows/s", "scaling": rows}))
    return report


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    add_join_args(p)
    p.add_argument("--iters", type=int, default=None)
    p.add_argument("--phases", action="store_true",
                   help="also report the per-phase ms of the lane join")
    p.add_argument("--json-out", default=None)
    p.add_argument("--trace-dir", default=None,
                   help="write a torch.profiler Chrome trace of the timed calls here")
    p.add_argument("--scaling", default=None, metavar="N1,N2,...",
                   help="weak-scaling mode: the distributed join at these mesh sizes "
                        "(rows per shard fixed); other config flags are ignored")
    p.add_argument("--rows-per-chip", type=int, default=1 << 16)
    p.add_argument("--exchange", default="dense", choices=["dense", "ragged", "ring"])
    p.add_argument("--n-chunks", type=int, default=1)
    p.add_argument("--check", default=None, metavar="BASELINE_JSON",
                   help="regression mode: compare rows/s per op against a stored "
                        "report; exit 1 on a fall beyond --tolerance")
    p.add_argument("--tolerance", type=float, default=0.25,
                   help="allowed fractional slowdown in --check mode")
    p.add_argument("--device", default="cuda",
                   help="cpu runs without times (the metric's value is null)")
    p.add_argument("--eager", action="store_true",
                   help="with --scaling: run the distributed join's body eagerly, "
                        "not as its CUDA graph")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        sys.exit("tpq_torch.bench.runner measures on a CUDA card; none is visible")
    if args.phases and dev.type != "cuda":
        p.error("--phases times the lane join's phases on a card")
    if args.eager and not args.scaling:
        p.error("--eager goes with --scaling (bench.profile --eager times a preset's "
                "body eagerly)")
    if args.scaling:
        return scaling_main(args, dev)

    cfg = config_from_args(args)
    if args.iters:
        cfg = replace(cfg, iters=args.iters)
    report = run_config(cfg, device=dev, trace_dir=args.trace_dir)
    report.pop("output")
    report["card"] = card_info() if dev.type == "cuda" else None
    if args.phases:
        report["phases"] = phase_report(cfg, device=dev)
    print(json.dumps(report, indent=2), file=sys.stderr)
    print(markdown_table(report["ops"], ["op", "elapsed_ms", "sol_ms", "roofline_pct",
                                         "rows_per_sec"]), file=sys.stderr)
    if args.json_out:
        emit_json(args.json_out, report)

    op = report["ops"][0]
    value = vs_baseline = None
    if op["rows_per_sec"] is not None:
        # vs_baseline as bench.py defines it: against 80% of the byte-model
        # speed of light at the measured bandwidth
        sol_rows_per_sec = op["rows"] / (op["sol_ms"] / 1e3)
        value = round(op["rows_per_sec"])
        vs_baseline = round(op["rows_per_sec"] / (0.8 * sol_rows_per_sec), 4)
    print(json.dumps({
        "metric": PIPELINE_METRIC if cfg.pipeline else METRIC,
        "value": value,
        "unit": "rows/s",
        "vs_baseline": vs_baseline,
    }))
    if args.check:
        with open(args.check) as f:
            lines, failed = check_regression(report, json.load(f), args.tolerance)
        for line in lines:
            print(line, file=sys.stderr)
        if failed:
            print(f"perf regression in: {', '.join(failed)}", file=sys.stderr)
            sys.exit(1)
    return report


if __name__ == "__main__":
    main()
