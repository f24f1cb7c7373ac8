"""Profiler trace capture (port of tpq/trace.py).

`with trace_if(dir):` records a torch.profiler trace (the CPU, and the
card's kernels where one is present) and writes it into `dir` as a
Chrome trace; `annotate(name)` names a span of host dispatch (one
operator or phase) so that it stands apart in the trace. Both wrap whole
runs, never a kernel wrapper.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace_if(trace_dir: str | None):
    """Traces the block into `trace_dir`/trace_<pid>_<ns>.json; with no
    directory, does nothing."""
    if not trace_dir:
        yield
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the card's last kernels into the trace
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    return record_function(name)
