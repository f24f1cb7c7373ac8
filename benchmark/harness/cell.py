"""One run of one cell: set-up, the closed loop (or, traced, a stretch
of it), then the comparison with the plain reference and the result.

The loop is closed, one client, one query in flight: a query is one call
of the program's entry over tables made on the device from the seed and
resident there; it ends when its result is the user's (num_rows read on
the host, the stream synchronised), and the next query is sent then.

`correct` compares what the timed path produced: every query's num_rows,
and the rows of SAMPLES queries drawn from the seed plus the last one,
against the reference run once the window has closed, the memory peak
read and the program's state freed. A sampled result's live rows are
copied to the host between two queries (outside both latencies, inside
the window); a traced run compares the last query alone, so that no copy
of the harness's sits in the trace.
"""

from __future__ import annotations

import contextlib
import gc
import random
import subprocess
import time
from dataclasses import dataclass

import torch

from benchmark.harness import roofline, spec, streams, tracing
from benchmark.harness.compare import count_wrong, nonzero_past

WARMUP_QUERIES = 3      # after the capture; the last one sizes the sample
SAMPLES = 4             # results compared from the window, besides the last
TRACE_MAX_QUERIES = 256
TRACE_MAX_SECONDS = 3.0
UNIFORM = {"dist": "uniform"}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_inputs(cell: spec.Cell, seed: int, device) -> dict:
    """The build and probe relations of a cell for a seed: sizes from the
    configuration, key distributions from the traffic (uniform where it
    names none), key seeds from the configuration unless the traffic's
    distribution names one of its own, row order and payloads from the
    seed."""
    out = {}
    for k, side in enumerate(("build", "probe"), start=1):
        c = cell.config[side]
        keys = cell.traffic.get(f"{side}_keys", UNIFORM)
        out[side] = streams.relation(c["rows"], c["nkeys"], c["payloads"],
                                     int(keys.get("key_seed", c["key_seed"])),
                                     streams.derive_seed(seed, k), keys, device)
    return out


@dataclass
class Window:
    start: float
    end: float
    latencies: list
    counts: list
    last: object


def closed_loop(call, seconds: float, device, max_queries: int = 0,
                sample_at=frozenset(), take=None, span=None) -> Window:
    """Queries back to back until `seconds` have passed (the last one
    started before then) or `max_queries` ran. `take(i, result, n)` is
    called after query i ends when i is in `sample_at`; `span()` wraps
    each query in a context (the traced run's host span)."""
    lat, counts = [], []
    out = None
    i = 0
    start = end = time.perf_counter()
    while True:
        with span() if span else contextlib.nullcontext():
            t0 = time.perf_counter()
            out = call()
            n = int(out.num_rows)
            sync(device)
            end = time.perf_counter()
        lat.append(end - t0)
        counts.append(n)
        if i in sample_at:
            take(i, out, n)
        i += 1
        if end - start >= seconds or (max_queries and i >= max_queries):
            return Window(start, end, lat, counts, out)


class Snapshots:
    """Host buffers (pinned on a card) for the live rows of `slots`
    results of up to `rows` rows, made in set-up; `taken` holds (query,
    num_rows, {column: rows}) of each result copied."""

    def __init__(self, template, rows: int, slots: int, device):
        pin = device.type == "cuda"
        self.device, self.rows = device, max(rows, 1)
        self.slots = [{n: torch.empty(self.rows, dtype=c.dtype, pin_memory=pin)
                       for n, c in template.columns.items()} for _ in range(slots)]
        self.taken: list = []

    def take(self, index: int, result, n: int) -> None:
        bufs = self.slots[len(self.taken)]
        capacity = next(iter(result.columns.values())).shape[0]
        m = max(0, min(n, self.rows, capacity))  # past the capacity: overflow
        cols = {}
        for name, c in result.columns.items():
            cols[name] = bufs[name][:m]
            cols[name].copy_(c[:m], non_blocking=True)
        sync(self.device)
        self.taken.append((index, n, cols))


def card_info() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (FileNotFoundError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return res.stdout.strip().splitlines()[0] if res.stdout.strip() else res.stderr.strip()


def _traced(prepared, seconds: float, device) -> tuple[Window, dict]:
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(tracing.WINDOW):
            window = closed_loop(prepared.call, min(seconds, TRACE_MAX_SECONDS), device,
                                 TRACE_MAX_QUERIES,
                                 span=lambda: record_function(tracing.QUERY))
    names = tracing.port_kernel_names()
    return window, tracing.summarise(prof.events(), tracing.kernel_matcher(names))


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
        started: float, control: bool = False) -> tuple[dict, dict]:
    """One run. Returns (the result line, what goes on the line before
    it: the program's counters over the window, its path, the card).
    `started` is the process's start on the host clock; `control` puts
    the reference in int32 in the program's place."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    ref = spec.reference_module(cell.query)
    capacity = spec.out_capacity(cell.config)
    inputs = make_inputs(cell, seed, device)
    sync(device)
    if cuda:  # from the resident tables on: the generator's scratch is not the program's
        torch.cuda.reset_peak_memory_stats(device)
    if control:
        prepared = ref.control(cell.config, cell.traffic, inputs, device, capacity)
    else:
        prepared = spec.query_module(cell.query).prepare(cell.config, cell.traffic,
                                                         inputs, device)
    for _ in range(WARMUP_QUERIES):
        t0 = time.perf_counter()
        out = prepared.call()
        n = int(out.num_rows)
        sync(device)
        warm = time.perf_counter() - t0
    snaps = Snapshots(out, n, SAMPLES + 1, device)
    snaps.take(-1, out, n)  # warms the copy path
    snaps.taken.clear()
    del out
    before = prepared.counters()
    est = max(1, int(seconds / max(warm, 1e-6)))
    sample_at = (frozenset() if trace else
                 frozenset(random.Random(seed).sample(range(est), min(SAMPLES, est))))
    gc.collect()
    gc.disable()
    try:
        if trace:
            window, summary = _traced(prepared, seconds, device)
        else:
            window = closed_loop(prepared.call, seconds, device, sample_at=sample_at,
                                 take=snaps.take)
            summary = {}
    finally:
        gc.enable()
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    after = prepared.counters()
    counts, last = window.counts, window.last
    window.last = None
    snaps.take(len(counts) - 1, last, counts[-1])
    tail = nonzero_past(last.columns, counts[-1]) if ref.TAIL_ZEROS else None
    del last
    prepared.close()
    path = prepared.path()
    probe_rows = prepared.probe_rows
    del prepared
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    exp = ref.expected(cell.config, cell.traffic, inputs)
    bad = {i for i, n in enumerate(counts)
           if count_wrong([n], exp.count, capacity)}
    checks = {"count_wrong": {"value": len(bad), "limit": 0}}
    if exp.count <= capacity:  # past it, the rows are not compared
        wrong = [(i, ref.wrong_rows(exp, cols)) for i, _, cols in snaps.taken]
        bad |= {i for i, w in wrong if w}
        checks["rows_wrong"] = {"value": max(w for _, w in wrong), "limit": 0}
    if tail is not None:
        checks["nonzero_past_rows"] = {"value": tail, "limit": 0}
    correct = bool(snaps.taken) and all(c["value"] <= c["limit"] for c in checks.values())

    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    if trace:
        summary.update(trace=True, least_bytes=ref.least_bytes(inputs, exp, capacity),
                       hbm_peak=roofline.hbm_peak(kind))
        metrics = cell.per_layer
    else:
        summary = {"trace": False, "queries": len(counts), "probe_rows": probe_rows,
                   "window_s": window.end - window.start, "latencies_s": window.latencies,
                   "setup_s": window.start - started, "peak_alloc_bytes": peak}
        metrics = cell.end_to_end
    values = {}
    for m in metrics:
        v = spec.metric_reader(m["name"])(summary)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": cell.chips,
           "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(counts), "failed": len(bad),
              "metrics": values, "device": dev}
    if trace:
        dev["busy_s"] = summary["busy_us"] / 1e6
        dev["window_s"] = summary["window_us"] / 1e6
        result["breakdown"] = summary["breakdown"]
    result["checks"] = checks
    lat_ms = sorted(x * 1e3 for x in window.latencies)
    info = {"workload": cell.name, "seed": seed, "trace": trace, "control": control,
            "counters": {k: after[k] - before.get(k, 0) for k in after},
            "path": path, "compared": [i for i, _, _ in snaps.taken],
            "expected_rows": exp.count, "capacity": capacity,
            "median_ms": lat_ms[len(lat_ms) // 2], "max_ms": lat_ms[-1],
            "card": card_info() if cuda else "cpu"}
    if trace:
        info.update(device_activities=summary["device_activities"],
                    least_bytes=summary["least_bytes"], hbm_peak=summary["hbm_peak"])
    return result, info
