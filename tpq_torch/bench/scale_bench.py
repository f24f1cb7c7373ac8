"""Configs 2 and 4 at full scale, chunked (port of
tpq/bench/scale_bench.py bench_build_sweep and bench_pipeline).

Both benches:
  * make their relations on the device (datagen.gen_relation_device,
    byte-equal to the numpy streams and the oracle's);
  * build the lane tables once, then stream the probe side through the
    lane probe and emit (lane2_probe_emit) in chunks of `chunk_rows`,
    with tpq's chunk sizes and capacity rules, so that both compute what
    tpq's compute;
  * run each of tpq's jax.jit programs through tpq_torch.jit (a CUDA
    graph on the card; `eager=True` runs the same bodies without one):
    one generator graph and one chunk graph serve every chunk, the
    chunk's row offset and row count traced (the short last chunk's count
    goes in as its Table's num_rows, as tpq passes it);
  * hand each program's outputs to the next program as they lie (jit's
    `hand_off`: the build's tables and the generator's chunk to the
    probe, the probe's rows to config 4's aggregate), so that no program
    copies a chunk in or out; config 4's dense accumulator is one set of
    buffers that the aggregate updates in place (jit's `updates`, tpq's
    donated state), zeroed when a loop starts;
  * warm every program up off the clock on two chunks, so that the timed
    loop captures nothing (`loop_captures`);
  * check the result against numpy ground truth from the same streams,
    outside the timed window: the join's count for config 2, every
    group's count and sums for config 4;
  * report whether every chunk took the lane path
    (`lane_path_taken_all_chunks`) and, jitted, each program's graphs,
    captures, reruns and copies, and the tensors copied into the chunk
    programs' graphs per chunk of the timed loop (`copies_per_chunk`).

Times exist only for a run on a card (host clock around work that ends
in a synchronize; the chunks' generation on the card is inside it, the
ground truth is not); on the CPU the benches run and check, and report
no time. `profile=True` runs the timed chunk loop once more under
torch.profiler: the card's busy ms over the loop, its idle share against
the unprofiled loop's ms, and the port kernels launched.

CLI (needs a card):
  python -m tpq_torch.bench.scale_bench pipeline   # config 4, 100M fact rows
  python -m tpq_torch.bench.scale_bench sweep      # config 2, 10M x 100M
      [--fused] [--eager] [--json-out=FILE]
(`--fused`: config 4's probe and aggregate as one chunk program, tpq's
`--fused`; `--eager`: the programs without graphs)
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from tpq_torch import datagen
from tpq_torch.bench import roofline
from tpq_torch.columnar import Table, next_pow2
from tpq_torch.jit import Jitted, jit
from tpq_torch.kernels.lane2 import build_lane2_tables, lane2_probe_emit, plan_lane2
from tpq_torch.kernels.move import pad
from tpq_torch.ops.filter import compact, keep_mask
from tpq_torch.ops.hash_aggregate import sort_aggregate

I64 = torch.int64


def _now(dev: torch.device):
    """Host seconds once the card's queued work is done (a synchronize);
    None on the CPU, where no device time is measured."""
    if dev.type != "cuda":
        return None
    torch.cuda.synchronize(dev)
    return time.perf_counter()


def _since(t0, dev: torch.device):
    return None if t0 is None else _now(dev) - t0


def _speed(report: dict, rows: int, rows_key: str, model_bytes: int, hbm_bw) -> None:
    """Adds the rates of a timed run to its report (nothing on the CPU)."""
    ms = report["elapsed_ms"]
    if ms is None:
        return
    report[rows_key] = rows / (ms / 1e3)
    sol_ms = model_bytes / (hbm_bw * 1e9) * 1e3
    report["sol_ms"] = sol_ms
    report["roofline_pct"] = 100.0 * sol_ms / ms


def _consume(t: Table) -> torch.Tensor:
    """A reduction over every output column's live rows, so that each
    column is read: an int64 xor of the wrapping sums. (tpq sums i32
    planes by bitcast because v5e has no fast i64 vector ALU; the card
    sums int64 natively.)"""
    mask = t.valid_mask()
    acc = t.num_rows.to(I64)
    for c in t.columns.values():
        acc = acc ^ torch.where(mask, c.to(I64), 0).sum()
    return acc


def _program(fn, eager: bool, **options):
    """One of tpq's jitted programs: jit(fn, **options), or fn itself
    when eager."""
    return fn if eager else jit(fn, **options)


def _timed_loop(loop, dev: torch.device, programs: dict, chunk_programs,
                nchunks: int, profile: bool):
    """Runs loop() (the chunks, ending in a host read) on the clock, with
    the copies its chunk programs made (_jit_stats); with `profile`, once
    more under torch.profiler on the card. Returns its result and the
    loop's ms, busy ms, idle share and port kernels, and, jitted, the
    graphs captured in the loop's runs (`loop_captures`)."""
    before = _counters(programs)
    t0 = _now(dev)
    res = loop()
    t = _since(t0, dev)
    stats = {"loop_ms": None if t is None else t * 1e3,
             **_jit_stats(programs, chunk_programs, before, nchunks)}
    if profile and t is not None:
        from tpq_torch.bench.profile import busy_us, device_activities, port_launches

        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            loop()
            torch.cuda.synchronize(dev)
        acts = device_activities(prof)
        if not acts:
            raise RuntimeError("the loop's trace holds no device activity")
        busy = busy_us(acts) / 1e3
        stats.update(loop_busy_ms=busy, loop_idle_share=1.0 - busy / stats["loop_ms"],
                     loop_device_activities=len(acts), port_kernels=port_launches(acts))
    if stats["jit"] is not None:
        stats["loop_captures"] = sum(p.captures - before[n][2] for n, p in programs.items()
                                     if n in before)
    return res, stats


def _jit_stats(programs: dict, chunk_programs, before: dict, nchunks: int) -> dict:
    """Per jitted program: its graphs kept, captures, reruns and copies;
    and the tensors (bytes) the chunk programs copied into their graphs
    per chunk of the timed loop."""
    jitted = {n: p for n, p in programs.items() if isinstance(p, Jitted)}
    if not jitted:
        return {"jit": None}
    delta = {n: [a - b for a, b in zip(_counters(jitted)[n], before[n])] for n in jitted}
    return {"jit": {n: {"graphs": len(p._graphs), "captures": p.captures,
                        "reruns": p.reruns, "copies": p.copies,
                        "copied_bytes": p.copied_bytes} for n, p in jitted.items()},
            "copies_per_chunk": sum(delta[n][0] for n in chunk_programs) / nchunks,
            "copied_bytes_per_chunk": sum(delta[n][1] for n in chunk_programs) / nchunks}


def _counters(programs: dict) -> dict:
    return {n: (p.copies, p.copied_bytes, p.captures) for n, p in programs.items()
            if isinstance(p, Jitted)}


def bench_build_sweep(n_build: int = 10_000_000, n_probe: int = 100_000_000,
                      payloads: int = 4, chunk_rows: int = 1 << 24,
                      device="cuda", eager: bool = False, profile: bool = False,
                      log=print) -> dict:
    """Config 2: 10M x 100M, 4 payload columns, the probe side streamed in
    chunks against tables built once; tpq's programs gen_r, build,
    gen_chunk and probe_chunk (tpq/bench/scale_bench.py:65-95) jitted."""
    dev = torch.device(device)
    hbm_bw = roofline.measure_hbm_bw(device=dev) if dev.type == "cuda" else None
    r_cap = next_pow2(n_build)
    gen_r = _program(lambda d: datagen.gen_relation_device(
        n_build, n_build, payloads, seed=1, capacity=r_cap, device=d).columns, eager)
    R = Table(gen_r(dev), n_build)
    # ~1 match per probe row at these key domains, 1.25x slack
    out_cap = chunk_rows + chunk_rows // 4
    plan = plan_lane2(r_cap, chunk_rows, out_capacity=out_cap)
    # handed off too: the timed build rewrites the warm-up's tables with
    # the same rows, and times the build, not a fresh copy's allocation
    build = _program(lambda t: build_lane2_tables(t, plan), eager, hand_off=True)
    r_names = [n for n in R.names if n != "key"]
    r_dtypes = [R.col(n).dtype for n in r_names]
    nchunks = -(-n_probe // chunk_rows)

    # one generator serves every chunk: its row offset is traced
    gen_chunk = _program(lambda d, off: datagen.gen_relation_device(
        chunk_rows, n_build, payloads, seed=2, capacity=chunk_rows, row_offset=off,
        device=d).columns, eager, hand_off=True)

    def probe_body(tables, s_cols, s_rows):
        out, ok = lane2_probe_emit(tables, Table(s_cols, s_rows), out_cap,
                                   r_names=r_names, r_dtypes=r_dtypes)
        return out.num_rows.to(I64), _consume(out), ok

    probe_chunk = _program(probe_body, eager, hand_off=True)
    programs = {"gen_r": gen_r, "build": build, "gen_chunk": gen_chunk,
                "probe_chunk": probe_chunk}

    def chunk(tables, ci):
        # the short last chunk's row count is its Table's num_rows, traced
        rows = min(chunk_rows, n_probe - ci * chunk_rows)
        return probe_chunk(tables, gen_chunk(dev, ci * chunk_rows), rows)

    # warm-up off the clock, on two chunks: a program whose argument moved
    # between them is captured again (with its copy-in) before the clock
    tables = build(R)
    for ci in range(min(2, nchunks)):
        chunk(tables, ci)

    t0 = _now(dev)
    tables2 = build(R)  # the build timed on its own, one fresh run
    t_build = _since(t0, dev)
    del tables2

    def loop():
        # a chunk's outputs hold until its programs' next call: each is
        # folded into the loop's own tensors at once
        total = torch.zeros((), dtype=I64, device=dev)
        acc = torch.zeros((), dtype=I64, device=dev)
        oks = torch.ones((), dtype=torch.bool, device=dev)
        for ci in range(nchunks):
            rows_c, acc_c, ok = chunk(tables, ci)
            total, acc, oks = total + rows_c, acc ^ acc_c, oks & ok
        return int(total), bool(oks)

    (total, oks), loop_stats = _timed_loop(loop, dev, programs,
                                          ("gen_chunk", "probe_chunk"), nchunks, profile)
    t_probe = loop_stats["loop_ms"]
    elapsed = None if t_probe is None else t_probe / 1e3 + t_build

    report = {
        "config": "build_sweep_10m_100m", "device": _device_name(dev),
        "n_build": n_build, "n_probe": n_probe, "payloads": payloads,
        "nchunks": nchunks, "chunk_rows": chunk_rows, "eager": eager,
        "elapsed_ms": None if elapsed is None else elapsed * 1e3,
        "build_ms": None if t_build is None else t_build * 1e3,
        **loop_stats,
        "out_rows": total,
        "lane_path_taken_all_chunks": oks,
        "hbm_bw_gbps": hbm_bw,
    }
    ncols = payloads + 1
    bm = roofline.hash_join_bytes(r_cap, ncols, nchunks * chunk_rows, ncols,
                                  nchunks * out_cap)
    _speed(report, n_probe, "probe_rows_per_sec", sum(b.total for b in bm.values()),
           hbm_bw)

    cr = np.bincount(datagen.uniform_keys(n_build, n_build, seed=1),
                     minlength=n_build).astype(np.int64)
    cs = np.bincount(datagen.uniform_keys(n_probe, n_build, seed=2),
                     minlength=n_build).astype(np.int64)
    expected = int((cr * cs).sum())
    report["expected_rows"] = expected
    report["count_exact"] = expected == total
    if not report["count_exact"]:
        raise RuntimeError(f"config 2: {total} join rows, numpy counts {expected}")
    log(report)
    return report


@functools.lru_cache(maxsize=2)
def pipeline_truth(n_dim: int, n_fact: int, fact_payloads: int,
                   filter_value: int) -> dict[str, np.ndarray]:
    """Config 4's groups from the numpy streams (dim seed 1 with one
    payload, fact seed 2, both keyed over n_dim): filter key <
    filter_value, join, aggregate, as tpq's bench checks them. Columns
    key, count, sum_r_p0, sum_s_p<j>, in ascending key order; sums wrap
    in int64."""
    fk = datagen.uniform_keys(n_fact, n_dim, seed=2)
    pays = datagen.payload_cols(n_fact, fact_payloads, seed=2)
    dk = datagen.uniform_keys(n_dim, n_dim, seed=1)
    dp = datagen.payload_cols(n_dim, 1, seed=1)
    keep = fk < filter_value
    fk2 = fk[keep]
    dmult = np.bincount(dk, minlength=n_dim).astype(np.int64)
    dsum = np.zeros(n_dim, np.int64)
    np.add.at(dsum, dk, dp["p0"])
    cnt = np.zeros(n_dim, np.int64)
    np.add.at(cnt, fk2, dmult[fk2])
    sum_r = np.zeros(n_dim, np.int64)
    np.add.at(sum_r, fk2, dsum[fk2])
    live = cnt > 0
    out = {"key": np.nonzero(live)[0].astype(np.int64), "count": cnt[live],
           "sum_r_p0": sum_r[live]}
    for j in range(fact_payloads):
        v = np.zeros(n_dim, np.int64)
        with np.errstate(over="ignore"):
            np.add.at(v, fk2, pays[f"p{j}"][keep] * dmult[fk2])
        out[f"sum_s_p{j}"] = v[live]
    return out


def groups_equal(got: dict[str, np.ndarray], want: dict[str, np.ndarray]) -> bool:
    """Host group columns equal, by name, after ordering `got` by key."""
    order = np.argsort(got["key"], kind="stable")
    return all(np.array_equal(got[n][order], want[n]) for n in want)


def bench_pipeline(n_dim: int = 1 << 20, n_fact: int = 100_000_000,
                   fact_payloads: int = 2, chunk_rows: int = 1 << 22,
                   filter_value: int = 1 << 19, device="cuda", staged: bool = True,
                   eager: bool = False, profile: bool = False, log=print) -> dict:
    """Config 4 chunked: filter -> hash join -> hash aggregate over the
    fact table, a chunk at a time, as tpq's programs (the dim generator,
    build, gen_chunk, probe_core and agg_core, finalize;
    tpq/bench/scale_bench.py:195-270) jitted:

      * the filter is pushed down into the probe layout
        (lane2_probe_emit(keep=...), query.py's fusion);
      * each chunk's groups land in a dense [next_pow2(filter_value)]
        accumulator: after `key < filter_value` every group key is a slot,
        and a chunk's aggregate emits ascending unique keys, so PAD places
        them at their slots and int64 adds fold them in (tpq's u32
        carry-chain adds become native int64 adds, which wrap);
      * `staged` jits the probe and the aggregate as two programs, else
        one fused chunk program (tpq's staged and `--fused`);
      * finalize compacts the accumulator's groups with PACK.
    """
    dev = torch.device(device)
    hbm_bw = roofline.measure_hbm_bw(device=dev) if dev.type == "cuda" else None
    dim_cap = next_pow2(n_dim)
    gen_dim = _program(lambda d: datagen.gen_relation_device(
        n_dim, n_dim, 1, seed=1, capacity=dim_cap, device=d).columns, eager)
    dim = Table(gen_dim(dev), n_dim)
    # ~live_frac of the fact rows pass the filter: the probe layout is
    # sized for the filtered mass (25% margin before plan_lane2's own
    # 1.5x), the emit buffer for ~1 match per passing row (1.5x slack)
    live_frac = min(1.0, filter_value / n_dim)
    out_cap = max(1 << 13, int(chunk_rows * live_frac * 3 // 2))
    eff_s_cap = max(1 << 12, int(chunk_rows * min(1.0, live_frac * 1.25)))
    plan = plan_lane2(dim_cap, eff_s_cap, out_capacity=out_cap)
    r_names = [n for n in dim.names if n != "key"]
    r_dtypes = [dim.col(n).dtype for n in r_names]
    build = _program(lambda t: build_lane2_tables(t, plan), eager, hand_off=True)
    gen_chunk = _program(lambda d, off: datagen.gen_relation_device(
        chunk_rows, n_dim, fact_payloads, seed=2, capacity=chunk_rows, row_offset=off,
        device=d).columns, eager, hand_off=True)
    n_state = next_pow2(min(filter_value, n_dim))
    vnames = (["count"] + [f"sum_r_{n}" for n in r_names]
              + [f"sum_s_p{j}" for j in range(fact_payloads)])
    nchunks = -(-n_fact // chunk_rows)

    def probe_core(tables, f_cols, f_rows):
        fact = Table(f_cols, f_rows)
        keep = keep_mask(fact, "key", "lt", filter_value)
        out, ok = lane2_probe_emit(tables, fact, out_cap, r_names=r_names,
                                   r_dtypes=r_dtypes, keep=keep)
        return dict(out.columns), out.num_rows.clamp_max(out_cap), ok

    def agg_core(state, out_cols, out_rows):
        # the state is updated in place (tpq's agg_core returns a new one
        # into the donated buffers): one elementwise add a column. The
        # sort path: a body that updates its arguments may hold no cond
        agg = sort_aggregate(Table(out_cols, out_rows))
        dest = agg.col("key").clamp(0, n_state - 1).to(torch.int32)
        padded, _ = pad([agg.col(n) for n in vnames], dest, agg.num_rows, n_state)
        for a, b in zip(state, padded):
            a.add_(b)
        return state

    def finalize_body(state):
        cols = {"key": torch.arange(n_state, dtype=I64, device=state[0].device),
                **dict(zip(vnames, state))}
        return compact(Table(cols, n_state), state[0] > 0)

    finalize = _program(finalize_body, eager)
    if staged:
        probe_j = _program(probe_core, eager, hand_off=True)
        agg_j = _program(agg_core, eager, hand_off=True, updates=(0,))
        chunk_programs = {"probe_core": probe_j, "agg_core": agg_j}

        def chunk_step(tables, state, f_cols, f_rows):
            out_cols, n_out, ok = probe_j(tables, f_cols, f_rows)
            return agg_j(state, out_cols, n_out), ok
    else:
        def step_body(tables, state, f_cols, f_rows):
            out_cols, n_out, ok = probe_core(tables, f_cols, f_rows)
            return agg_core(state, out_cols, n_out), ok

        chunk_step = _program(step_body, eager, hand_off=True, updates=(1,))
        chunk_programs = {"chunk_step": chunk_step}
    programs = {"gen_dim": gen_dim, "build": build, "gen_chunk": gen_chunk,
                **chunk_programs, "finalize": finalize}

    def chunk(tables, state, ci):
        # the short last chunk's row count is its Table's num_rows, traced
        rows = min(chunk_rows, n_fact - ci * chunk_rows)
        return chunk_step(tables, state, gen_chunk(dev, ci * chunk_rows), rows)

    state = [torch.zeros(n_state, dtype=I64, device=dev) for _ in vnames]
    # warm-up off the clock, on two chunks and finalize
    tables = build(dim)
    for ci in range(min(2, nchunks)):
        chunk(tables, state, ci)
    finalize(state)

    t0 = _now(dev)
    tables2 = build(dim)  # the build timed on its own, one fresh run
    t_build = _since(t0, dev)
    del tables2

    def loop():
        for x in state:
            x.zero_()
        oks = torch.ones((), dtype=torch.bool, device=dev)
        for ci in range(nchunks):
            _, ok = chunk(tables, state, ci)
            oks = oks & ok  # held only until the probe's next call
        final = finalize(state)
        return final, int(final.num_rows), bool(oks)

    (final, groups, oks), loop_stats = _timed_loop(
        loop, dev, programs, ("gen_chunk", *chunk_programs), nchunks, profile)
    t_run = loop_stats["loop_ms"]
    elapsed = None if t_run is None else t_run / 1e3 + t_build

    report = {
        "config": "pipeline_100m", "device": _device_name(dev),
        "n_dim": n_dim, "n_fact": n_fact, "nchunks": nchunks,
        "chunk_rows": chunk_rows, "staged": staged, "eager": eager,
        "elapsed_ms": None if elapsed is None else elapsed * 1e3,
        "build_ms": None if t_build is None else t_build * 1e3,
        **loop_stats,
        "groups": groups,
        "join_rows": int(final.col("count")[:groups].sum()),
        "lane_path_taken_all_chunks": oks,
        "hbm_bw_gbps": hbm_bw,
    }
    nf = fact_payloads + 1
    model = (roofline.filter_bytes(nchunks * chunk_rows, nf).total
             + sum(b.total for b in roofline.hash_join_bytes(
                 dim_cap, 2, nchunks * chunk_rows, nf, nchunks * out_cap).values())
             + roofline.aggregate_bytes(nchunks * out_cap, 4).total)
    _speed(report, n_fact, "fact_rows_per_sec", model, hbm_bw)

    got = {n: c[:groups].cpu().numpy() for n, c in final.columns.items()}
    want = pipeline_truth(n_dim, n_fact, fact_payloads, filter_value)
    report["groups_exact"] = groups == len(want["key"]) and groups_equal(got, want)
    if not report["groups_exact"]:
        raise RuntimeError(f"config 4: {groups} groups differ from numpy's "
                           f"{len(want['key'])}")
    log(report)
    return report


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)


def main(argv=None):
    import argparse
    import json
    import sys

    p = argparse.ArgumentParser()
    p.add_argument("which", choices=["sweep", "pipeline"])
    p.add_argument("--json-out", default=None)
    p.add_argument("--fused", action="store_true",
                   help="pipeline: one jitted chunk program in place of the staged "
                        "probe and aggregate programs")
    p.add_argument("--eager", action="store_true",
                   help="run the programs eagerly, without CUDA graphs")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("tpq_torch.bench.scale_bench measures on a CUDA card; none is visible")
    from tpq_torch.bench.runner import card_info

    if args.which == "sweep":
        rep = bench_build_sweep(eager=args.eager, log=lambda _: None)
    else:
        rep = bench_pipeline(staged=not args.fused, eager=args.eager,
                             log=lambda _: None)
    rep["card"] = card_info()
    print(json.dumps(rep))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rep, f, indent=2)
    return rep


if __name__ == "__main__":
    main()
