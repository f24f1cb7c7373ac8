"""The traced run's reading: one torch.profiler trace of a stretch of the
closed loop, reduced to what the per-layer metrics read.

The loop runs inside a host span "window", each query inside a span
"query". From the same trace come the window (the span's start and end)
and the device activities (kernels, copies, memsets): busy time is the
length of their union inside the window, and each activity is the
port's kernel when its name is a `__global__` function of the port's
CUDA sources (read from tpq_torch/csrc/*.cu at run time, so a kernel a
later change adds is counted without an edit), a library op otherwise
(torch's sorts, gathers, elementwise ops, copies and memsets). The
spans' own images on the device's timeline (user annotations) are not
activities.

The breakdown names the device operations that took most time and the
idle stretches of the window by the innermost host operation of the
loop's thread that spanned them, under the profiler's names.
"""

from __future__ import annotations

import heapq
import importlib.util
import re
from pathlib import Path

from benchmark.harness import intervals

WINDOW, QUERY = "window", "query"
SPANS = (WINDOW, QUERY)
TOP = 10
NAME_CHARS = 160

_GLOBAL = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\s*\([^)]*\)\s*)?"
                     r"(?:void\s+)?([A-Za-z_]\w*)\s*\(")


def port_kernel_names(package: str = "tpq_torch") -> frozenset:
    """The `__global__` functions of the program's CUDA sources."""
    found = importlib.util.find_spec(package)
    csrc = Path(found.origin).parent / "csrc"
    names = set()
    for src in sorted(csrc.glob("*.cu")):
        names.update(_GLOBAL.findall(src.read_text()))
    return frozenset(names)


def kernel_matcher(names):
    """A predicate: is a trace's activity name one of these kernels (its
    namespace, return type and template arguments aside)?"""
    if not names:
        return lambda name: False
    pat = re.compile(r"(?:^|[\s:])(?:" + "|".join(map(re.escape, sorted(names)))
                     + r")\s*[<(]")
    return lambda name: pat.search(name) is not None


def _innermost(host, points):
    """For each point (in ascending order), the name of the host event
    with the latest start among those that contain it (the innermost of
    nested spans), or None. `host` is [(start, end, name)]."""
    host = sorted(host)
    heap: list = []
    out, k = [], 0
    for p in points:
        while k < len(host) and host[k][0] <= p:
            s, e, name = host[k]
            heapq.heappush(heap, (-s, e, name))
            k += 1
        while heap and heap[0][1] < p:  # ended before p, so before every later point
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else None)
    return out


def summarise(events, is_port) -> dict:
    """The reading of a trace's events (torch.profiler's `events()`).
    Raises if the trace holds no "window" span."""
    from torch.autograd import DeviceType

    device, host = [], []
    window = None
    n_queries = 0
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # the host spans' images on the device's timeline are no work
            if not getattr(e, "is_user_annotation", False) and e.name not in SPANS:
                device.append((s, t, e.name))
        else:
            host.append((s, t, e.name, e.thread))
            if e.name == WINDOW:
                window = (s, t, e.thread)
            elif e.name == QUERY:
                n_queries += 1
    if window is None:
        raise RuntimeError("the trace holds no window span")
    lo, hi, thread = window
    inside = [(max(s, lo), min(t, hi), n) for s, t, n in device if t > lo and s < hi]
    busy_us = intervals.busy((s, t) for s, t, _ in inside)
    by_name: dict = {}
    port_us = library_us = 0.0
    for s, t, n in inside:
        by_name[n] = by_name.get(n, 0.0) + (t - s)
        if is_port(n):
            port_us += t - s
        else:
            library_us += t - s
    gaps = intervals.gaps([(s, t) for s, t, _ in inside], lo, hi)
    loop_host = [(s, t, n) for s, t, n, th in host if th == thread and n != WINDOW]
    names = _innermost(loop_host, [(a + b) / 2 for a, b in gaps])
    idle: dict = {}
    for (a, b), n in zip(gaps, names):
        n = n or "(no host op)"
        idle[n] = idle.get(n, 0.0) + (b - a)

    def top(d):
        return [[n[:NAME_CHARS], us / 1e6]
                for n, us in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {"queries": n_queries, "window_us": hi - lo, "busy_us": busy_us,
            "port_us": port_us, "library_us": library_us,
            "device_activities": len(inside),
            "breakdown": {"device_ops": top(by_name), "idle_gaps": top(idle)}}
