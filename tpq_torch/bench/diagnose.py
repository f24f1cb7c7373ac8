"""Four measurements behind PERF.md's findings, on the card.

  calls — a preset's jitted join or pipeline, call by call after its
          capture: each call's ms on CUDA events around it alone and
          its host ms, with the caching allocator's counters (segments,
          cudaMalloc calls, reserved bytes) read before each call; beside
          them, in the same process, the runner's figure (run_config)
          and bench.profile's end to end (3 warm-ups, then 10 calls).
  items — a preset's join or pipeline eager and jitted, each traced over
          10 calls after 3 warm-ups: every device item by name (launches
          and ms a call) in both forms, largest difference first, with
          the ops (and their tpq_torch lines) that launched it eagerly.
  peak  — the peak device memory of one eager 8-shard join of the
          scaling bench and one of the overlap matrix's dense_4chunks
          join, with the allocator's history recorded: the blocks live at
          the peak, summed by the innermost tpq_torch frame that
          allocated them.
  copy  — one device-to-device copy of 2^27 int64 (config 4's sort
          width), eager and as the one node of a CUDA graph, and an
          elementwise kernel that copies the same bytes inside a graph:
          each one's device ms, in turns, and the device item it runs.
  sort  — one stable sort of 2^27 int64 keys (the probe layout's and
          sort_rows' width at config 4) in each torch call pattern that
          computes it (torch.sort, into given buffers, in place, argsort):
          the device copies each makes eagerly, with the ops that made
          them, and as a CUDA graph, with every device item's ms.

CLI (needs a card):
  python -m tpq_torch.bench.diagnose calls --config=single_chip_1m
  python -m tpq_torch.bench.diagnose items --config=pipeline_100m
  python -m tpq_torch.bench.diagnose peak
  python -m tpq_torch.bench.diagnose copy
  python -m tpq_torch.bench.diagnose sort
each prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import json
import sys
import time

import torch

from tpq_torch.bench.runner import (add_join_args, card_info, config_from_args,
                                    cuda_time, device_time, gen, join_fn,
                                    out_capacity_for, run_config)

CALLS = 20          # the jitted calls timed one by one after the capture
TRACED_CALLS = 10   # the calls a trace of `items` and `copy` spans
SHARDS, ROWS_PER_SHARD = 8, 1 << 24  # the 8-shard joins of `peak`
COPY_ELEMENTS = 1 << 27

ALLOC_STATS = ("segment.all.current", "num_device_alloc", "num_device_free",
               "num_alloc_retries", "reserved_bytes.all.current",
               "allocated_bytes.all.current")


def alloc_stats(dev) -> dict:
    stats = torch.cuda.memory_stats(dev)
    return {k: stats.get(k) for k in ALLOC_STATS}


def per_call(fn, dev) -> list[dict]:
    """Each of CALLS calls of fn() timed alone (CUDA events, then a
    synchronize), with the allocator's counters read before it."""
    rows, out = [], None
    for i in range(CALLS):
        torch.cuda.synchronize(dev)
        before = alloc_stats(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = fn()
        end.record()
        host = time.perf_counter() - t0
        torch.cuda.synchronize(dev)
        rows.append({"call": i, "ms": start.elapsed_time(end), "host_ms": host * 1e3,
                     **before})
    del out
    return rows


def calls_main(args) -> dict:
    cfg = config_from_args(args)
    dev = torch.device("cuda")
    runner = run_config(cfg, device=dev)["ops"][0]
    r, s = gen(cfg.r, dev), gen(cfg.s, dev)
    fn = join_fn(cfg, r, s, out_capacity_for(cfg))
    t0 = time.perf_counter()
    fn()  # the capture
    torch.cuda.synchronize(dev)
    capture_ms = (time.perf_counter() - t0) * 1e3
    rows = per_call(fn, dev)
    fn.jitted.clear()
    prof = join_fn(cfg, r, s, out_capacity_for(cfg))
    profile_ms = cuda_time(prof, dev, 10, warmup=3)[0] * 1e3
    prof.jitted.clear()
    return {"config": cfg.name, "card": card_info(),
            "runner_ms": runner["elapsed_ms"], "runner_iters": cfg.iters,
            "runner_warmup": cfg.warmup, "profile_protocol_ms": profile_ms,
            "capture_ms": capture_ms, "calls": rows}


def launchers(prof) -> dict:
    """{device item name: {the ops that launched it (innermost first,
    with the first one's input shapes) and the innermost tpq_torch frame:
    launches}} of a trace taken with stacks and shapes."""
    out: dict = {}
    for e in prof.events():
        if not getattr(e, "kernels", None):
            continue
        chain, op, where = [], e, ""
        while op is not None:
            chain.append(op.name)
            where = where or next((f for f in (op.stack or []) if "tpq_torch" in f), "")
            op = op.cpu_parent
        who = (f"{' < '.join(chain[:4])} {e.input_shapes} @ "
               f"{where.split('tpq_torch/')[-1]}")
        for k in e.kernels:
            rec = out.setdefault(k.name[:160], {})
            rec[who] = rec.get(who, 0) + 1
    return out


def device_items(fn, dev, stacks: bool = False):
    """({device item name: [launches, ms]} a call of fn(), traced over
    TRACED_CALLS calls after 3 warm-ups; with `stacks`, launchers() of the
    trace, else None)."""
    from tpq_torch.bench.profile import device_activities

    for _ in range(3):
        fn()
    torch.cuda.synchronize(dev)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA],
                                with_stack=stacks, record_shapes=stacks) as prof:
        for _ in range(TRACED_CALLS):
            fn()
        torch.cuda.synchronize(dev)
    items: dict = {}
    for s, e, name in device_activities(prof):
        rec = items.setdefault(name[:160], [0.0, 0.0])
        rec[0] += 1 / TRACED_CALLS
        rec[1] += (e - s) / 1e3 / TRACED_CALLS
    return items, launchers(prof) if stacks else None


def items_main(args) -> dict:
    cfg = config_from_args(args)
    dev = torch.device("cuda")
    r, s = gen(cfg.r, dev), gen(cfg.s, dev)
    fn = join_fn(cfg, r, s, out_capacity_for(cfg))
    (eager, by), (jitted, _) = device_items(fn.eager, dev, stacks=True), device_items(fn, dev)
    fn.jitted.clear()
    rows = [{"name": n, "eager": eager.get(n, [0, 0]), "jitted": jitted.get(n, [0, 0]),
             "delta_ms": jitted.get(n, [0, 0])[1] - eager.get(n, [0, 0])[1],
             "eager_launched_by": by.get(n, {})}
            for n in set(eager) | set(jitted)]
    rows.sort(key=lambda r: -abs(r["delta_ms"]))
    return {"config": cfg.name, "card": card_info(),
            "eager_ms": sum(v[1] for v in eager.values()),
            "jitted_ms": sum(v[1] for v in jitted.values()), "items": rows[:40]}


def peak_of(run, dev) -> dict:
    """Runs run() with the allocator's history recorded; the peak of the
    allocated bytes and the blocks live at it by allocating frame."""
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.memory._record_memory_history(enabled="all", stacks="python",
                                             max_entries=2_000_000)
    try:
        out = run()
        torch.cuda.synchronize(dev)
        snap = torch.cuda.memory._snapshot(dev)
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    del out
    peak_stat = torch.cuda.max_memory_allocated(dev)
    live, cur, best, at_peak = {}, 0, 0, {}
    for ev in snap["device_traces"][dev.index or 0]:
        act = ev["action"]
        if act == "alloc":
            live[ev["addr"]] = (ev["size"], ev.get("frames", []))
            cur += ev["size"]
            if cur > best:
                best, at_peak = cur, dict(live)
        elif act in ("free_requested", "free_completed") and ev["addr"] in live:
            cur -= live.pop(ev["addr"])[0]
    by_frame: dict[str, list] = {}
    for size, frames in at_peak.values():
        own = [f for f in frames if "tpq_torch" in f["filename"]]
        where = " < ".join(f"{f['filename'].split('tpq_torch/')[-1]}:{f['line']} "
                           f"{f['name']}" for f in own[:3]) or "outside tpq_torch"
        rec = by_frame.setdefault(where, [0, 0])
        rec[0] += size
        rec[1] += 1
    top = sorted(by_frame.items(), key=lambda kv: -kv[1][0])
    return {"peak_bytes": peak_stat, "before_bytes": base,
            "traced_peak_bytes": base + best,
            "at_peak": [{"where": w, "bytes": b, "blocks": n} for w, (b, n) in top[:20]]}


def peak_main(args) -> dict:
    from tpq_torch.bench.scaling import place_uniform
    from tpq_torch.dist import dist_hash_join, make_mesh

    dev = torch.device("cuda:0")
    per, n = ROWS_PER_SHARD, SHARDS
    mesh = make_mesh(n, dev)
    report = {"card": card_info(), "rows_per_shard": per, "shards": n}
    for label, seeds, kw in (("scaling", (77, 78), {}),
                             ("overlap_dense_4chunks", (71, 72), {"n_chunks": 4})):
        R = place_uniform(per * n, per * n, 1, seeds[0], mesh)
        S = place_uniform(per * n, per * n, 1, seeds[1], mesh)
        report[label] = peak_of(
            lambda: dist_hash_join(R, S, mesh, out_capacity_per_shard=4 * per, eager=True,
                                   **kw), dev)
        del R, S
        torch.cuda.empty_cache()
    return report


def graphed(fn, dev):
    """fn() captured as a CUDA graph (after one warm-up on the capture's
    stream); returns the graph's replay."""
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream(dev).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        fn()
    torch.cuda.synchronize(dev)
    return graph.replay


def copy_main(args) -> dict:
    dev = torch.device("cuda")
    src = torch.arange(COPY_ELEMENTS, dtype=torch.int64, device=dev)
    dst = torch.empty_like(src)
    forms = {"eager_copy": lambda: dst.copy_(src),
             "graph_copy": graphed(lambda: dst.copy_(src), dev),
             "graph_kernel_copy": graphed(lambda: torch.bitwise_or(src, 0, out=dst), dev)}
    turns = {n: [] for n in forms}
    for name in [*forms, *reversed(forms)]:
        dst.zero_()
        turns[name].append(device_time(forms[name], dev, TRACED_CALLS)[0] * 1e3)
        if not torch.equal(dst, src):
            raise RuntimeError(f"{name} did not copy")
    return {"card": card_info(), "elements": COPY_ELEMENTS,
            "bytes_moved": 2 * src.numel() * src.element_size(),
            "ms_in_turns": turns,
            "items": {n: device_items(f, dev)[0] for n, f in forms.items()}}


def is_copy(name: str) -> bool:
    """Whether a device item is a memcpy (a graph's memcpy node or an
    eager cudaMemcpyAsync), by the name the trace gives it."""
    return name.startswith("Memcpy")


def sort_main(args) -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    keys = torch.randint(0, 513, (COPY_ELEMENTS,), dtype=torch.int64, device=dev,
                         generator=gen)
    vals, idx, work = torch.empty_like(keys), torch.empty_like(keys), keys.clone()
    forms = {"sort": lambda: torch.sort(keys, stable=True),
             "sort_out": lambda: torch.sort(keys, stable=True, out=(vals, idx)),
             "sort_in_place": lambda: torch.sort(work, stable=True, out=(work, idx)),
             "argsort": lambda: torch.argsort(keys, stable=True)}
    report = {"card": card_info(), "elements": COPY_ELEMENTS, "forms": {}}
    for name, fn in forms.items():
        eager, by = device_items(fn, dev, stacks=True)
        graph, _ = device_items(graphed(fn, dev), dev)
        report["forms"][name] = {
            "eager_copies": {n: v for n, v in eager.items() if is_copy(n)},
            "eager_copies_launched_by": {n: by.get(n, {}) for n in eager if is_copy(n)},
            "graph_copies": {n: v for n, v in graph.items() if is_copy(n)},
            "eager_items": eager, "graph_items": graph}
        torch.cuda.empty_cache()
    return report


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="what", required=True)
    add_join_args(sub.add_parser("calls"))
    add_join_args(sub.add_parser("items"))
    sub.add_parser("peak")
    sub.add_parser("copy")
    sub.add_parser("sort")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("tpq_torch.bench.diagnose measures on a CUDA card; none is visible")
    report = {"calls": calls_main, "items": items_main, "peak": peak_main,
              "copy": copy_main, "sort": sort_main}[args.what](args)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
