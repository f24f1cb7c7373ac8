"""Config-driven benchmark runner (port of tpq/bench/runner.py), for the
hash join so far.

Generates the seed-stable relations of a preset on the card, times the
join with CUDA events after a warm-up, accounts it against the measured
bandwidth roofline, and labels the row honestly when the lane path fell
back to the sorted engine. Times exist only for a run on a card: on the
CPU, run_config runs the join once and reports no time.

CLI:  python -m tpq_torch.bench.runner --config=single_chip_1m [--phases]
prints the bench.py one-line JSON under the metric
hash_join_probe_rows_per_sec_1chip_torch as its last line.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from tpq_torch import datagen
from tpq_torch.bench import roofline
from tpq_torch.columnar import Table, next_pow2
from tpq_torch.config import PRESETS, BenchConfig, RelationSpec
from tpq_torch.ops import hash_join

METRIC = "hash_join_probe_rows_per_sec_1chip_torch"


def gen(spec: RelationSpec, device) -> Table:
    return datagen.gen_relation(spec.rows, spec.nkeys, spec.payloads, spec.seed,
                                spec.kind, spec.theta, device=device)


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


def phase_report(cfg: BenchConfig, device="cuda", iters: int = 10) -> list[dict]:
    """Per-phase ms of the lane join on the card. `tail+glue` is
    probe_emit minus layout and kernel; `other` is end to end minus build
    and probe_emit (the `ok` branch and its sync)."""
    from tpq_torch.kernels.lane2 import (build_lane2_tables, fused_walk_emit,
                                         lane2_hash_join, lane2_probe_emit,
                                         plan_lane2)
    from tpq_torch.kernels.lane_table import _probe_layout

    dev = torch.device(device)
    r, s = gen(cfg.r, dev), gen(cfg.s, dev)
    out_cap = out_capacity_for(cfg)
    plan = plan_lane2(r.capacity, s.capacity, out_capacity=out_cap)

    def ms(fn):
        return cuda_time(fn, dev, iters)[0] * 1e3

    tables = build_lane2_tables(r, plan)
    qk, spay, lane, qocc, _ = _probe_layout(plan, s, "key")
    t_build = ms(lambda: build_lane2_tables(r, plan))
    t_layout = ms(lambda: _probe_layout(plan, s, "key"))
    t_kernel = ms(lambda: fused_walk_emit(tables, qk, lane, qocc, spay, out_cap))
    t_pe = ms(lambda: lane2_probe_emit(tables, s, out_cap))
    t_e2e = ms(lambda: lane2_hash_join(r, s, out_cap))
    return [
        {"phase": "build(sort+pad)", "ms": t_build},
        {"phase": "probe_layout(sort+pad)", "ms": t_layout},
        {"phase": "walk_emit(kernel)", "ms": t_kernel},
        {"phase": "tail+glue", "ms": t_pe - t_layout - t_kernel},
        {"phase": "other(ok branch)", "ms": t_e2e - t_build - t_pe},
        {"phase": "end_to_end", "ms": t_e2e},
    ]


def run_config(cfg: BenchConfig, hbm_bw: float | None = None,
               device="cuda") -> dict:
    """Runs a hash-join preset on `device`. The report's "output" is the
    join's Table from the last timed call."""
    if cfg.pipeline:
        raise NotImplementedError(
            "the filter->join->aggregate pipeline is not yet ported "
            "(ROADMAP.md Queue 1 item 6)")
    if cfg.join.algo != "hash":
        raise NotImplementedError(
            "merge join is not yet ported (ROADMAP.md Queue 1 item 8)")
    dev = torch.device(device)
    r, s = gen(cfg.r, dev), gen(cfg.s, dev)
    out_cap = out_capacity_for(cfg)
    impl = cfg.join.impl

    def fn():
        return hash_join(r, s, out_cap, impl=impl)

    op = f"join_hash_{impl}"
    if impl == "lane":
        from tpq_torch.kernels.lane2 import lane2_path_taken

        # honesty guard: the row says when the sorted fallback was measured
        if not bool(lane2_path_taken(r, s, out_cap)):
            op += "_FELL_BACK_TO_SORTED"

    if dev.type == "cuda":
        if hbm_bw is None:
            hbm_bw = roofline.measure_hbm_bw(device=dev)
        sec, out = cuda_time(fn, dev, cfg.iters, cfg.warmup)
        model = roofline.hash_join_bytes(r.capacity, len(r.columns), s.capacity,
                                         len(s.columns), out_cap)
        row = roofline.RooflineResult(op, sec, sum(b.total for b in model.values()),
                                      hbm_bw, cfg.s.rows).row()
        name = torch.cuda.get_device_name(dev)
    else:
        out = fn()
        row = {"op": op, "elapsed_ms": None, "rows": cfg.s.rows}  # not measured
        name = str(dev)
    return {"config": cfg.name, "device": name, "hbm_bw_gbps": hbm_bw,
            "out_capacity": out_cap, "out_rows": int(out.num_rows),
            "ops": [row], "output": out}


def main(argv=None):
    import argparse
    from dataclasses import replace

    p = argparse.ArgumentParser()
    p.add_argument("--config", default="single_chip_1m", choices=sorted(PRESETS))
    p.add_argument("--impl", default=None, choices=[None, "lane", "sorted"])
    p.add_argument("--iters", type=int, default=None)
    p.add_argument("--phases", action="store_true",
                   help="also report the per-phase ms of the lane join")
    p.add_argument("--json-out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("tpq_torch.bench.runner measures on a CUDA card; none is visible")

    cfg = PRESETS[args.config]
    if args.impl:
        cfg = replace(cfg, join=replace(cfg.join, impl=args.impl))
    if args.iters:
        cfg = replace(cfg, iters=args.iters)
    report = run_config(cfg)
    report.pop("output")
    report["card"] = card_info()
    if args.phases:
        report["phases"] = phase_report(cfg)
    print(json.dumps(report, indent=2), file=sys.stderr)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(report, f, indent=2)

    op = report["ops"][0]
    # vs_baseline as bench.py defines it: against 80% of the byte-model
    # speed of light at the measured bandwidth
    sol_rows_per_sec = op["rows"] / (op["sol_ms"] / 1e3)
    print(json.dumps({
        "metric": METRIC,
        "value": round(op["rows_per_sec"]),
        "unit": "rows/s",
        "vs_baseline": round(op["rows_per_sec"] / (0.8 * sol_rows_per_sec), 4),
    }))
    return report


if __name__ == "__main__":
    main()
