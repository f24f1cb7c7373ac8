"""Spans, per-call records and the profiler context (port of tpq/trace.py,
grown into the port's one tracing module).

  * `span(name)` names a stretch of the port's work; every name starts
    with "tpq.". While no profiler records it costs one flag check. While
    one records it is a `record_function`, on the profiler's clock with
    the card's activities, so a trace's idle gaps and device work fall
    under the phase or operator that spans them. While jit captures a
    body into a CUDA graph, its top-level spans (those opened inside no
    other span) tile the body, timed on the card at every replay by
    stamps: a one-thread kernel (csrc/trace.cu) writes the card's
    nanosecond timer into a 0-d tensor where each top-level span opens
    and where the body ends, and jit reads the stamps in the flags copy
    it makes after every replay anyway. The stamps are in the graph
    whatever the profiler's state (a graph cannot gain them later); one
    costs the card about 1 us a replay (a timing-event node cost the
    uniform join 5 % end to end on an H100, PERF.md), so spans inside
    another place none, and a graph with no span holds none.
  * `records()` returns the records of the jitted calls made while a
    profiler recorded, the newest last, at most RING of them; calls made
    with the profiler off, and eager calls outside a jitted callable,
    append nothing. One record (jit.py) holds:
      "rerun": whether the replay was discarded and the body rerun;
      "host_ms": {phase: host ms} of the jit's phases (signature, load,
        launch, read, result, rerun, capture) the call went through;
      "device_ms": the replay's whole device ms, from timing events
        recorded on the stream around it (None: no graph ran);
      "spans": [{"name", "ms" (device ms), "discarded" (its output
        thrown away by a cond, or the whole replay by a rerun)}], the
        top-level spans in order, tiling the body;
      "conds": [[name, branch taken (True: then)]] of the named conds;
      "observed": {name: value} of the values `jit.observe` recorded;
      and the entries `attached` gives the calls made inside it (the
      distributed join's eager planner: "plan").
    The replay's device ms is read with `elapsed_time` once the call's
    flags read has synchronised the stream.
  * `attached(name=entry)` adds an eager step's figures to the records
    of the jitted calls made inside it, so that a query of an eager
    step and a jitted body still makes one record.
  * `trace_if(dir)` records a torch.profiler trace of a block (the CPU,
    and the card's kernels where one is present) into `dir` as a Chrome
    trace.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import functools
import os
import time

import torch
from torch.autograd import profiler as _profiler
from torch.profiler import ProfilerActivity, profile, record_function

RING = 4096  # records kept, the oldest dropped first

_RECORDS: collections.deque = collections.deque(maxlen=RING)
# the marks of the graph being captured; None outside a capture
_MARKS: contextvars.ContextVar = contextvars.ContextVar("tpq_torch_trace_marks",
                                                        default=None)
# the entries `attached` adds to the records made inside it
_ATTACHED: contextvars.ContextVar = contextvars.ContextVar("tpq_torch_trace_attached",
                                                          default=None)


def recording() -> bool:
    """Whether a profiler records (torch's own flag: a module global)."""
    return _profiler._is_profiler_enabled


def records() -> list:
    """The per-call records (module docstring), the newest last."""
    return list(_RECORDS)


def last_calls(n: int):
    """The records of the last n calls, if there are n and each replayed
    a graph on a card (a device_ms); else None. The benchmark's readers
    take a traced window's calls so."""
    calls = list(_RECORDS)[-n:] if n > 0 else []
    if len(calls) < n or not calls or any(c["device_ms"] is None for c in calls):
        return None
    return calls


def append(record: dict) -> None:
    extra = _ATTACHED.get()
    if extra:
        record.update(extra)
    _RECORDS.append(record)


@contextlib.contextmanager
def attached(**entries):
    """The records of the jitted calls made inside carry `entries` too."""
    token = _ATTACHED.set({**(_ATTACHED.get() or {}), **entries})
    try:
        yield
    finally:
        _ATTACHED.reset(token)


class Marks:
    """A graph's top-level spans (`spans`, their names in order) and the
    stamps written while it is captured (`stamps`, 0-d int64 tensors on
    `device`: stamps[i] where spans[i] opens, the last where the body
    ends)."""

    def __init__(self, device):
        self.device = device
        self.stamps: list = []
        self.spans: list = []
        self.depth = 0  # spans open

    def mark(self) -> None:
        """Stamps the card's timer on the capturing stream."""
        from tpq_torch.kernels import _build

        slot = torch.empty((), dtype=torch.int64, device=self.device)
        with _build.on_device(slot):
            code = _build.lib().tpq_stamp(slot.data_ptr(), _build.stream_of(slot))
        _build.check(code, "trace stamp")
        self.stamps.append(slot)

    def open(self, name: str) -> None:
        if self.depth == 0:
            self.mark()
            self.spans.append(name)
        self.depth += 1

    def close(self) -> None:
        self.depth -= 1

    def finish(self) -> None:
        """The body's end: the last span's end stamp."""
        if self.spans:
            self.mark()

    def read(self, stamps: list) -> list:
        """Each top-level span's device ms from the stamps' values (ns)."""
        return [(stamps[i + 1] - stamps[i]) / 1e6 for i in range(len(self.spans))]


@contextlib.contextmanager
def capturing(marks: Marks):
    """Spans opened inside place their marks in `marks` (jit's capture)."""
    token = _MARKS.set(marks)
    try:
        yield marks
    finally:
        _MARKS.reset(token)


def marker():
    """The count of top-level spans the capture in progress has opened
    (None outside a capture): a cond's `attempt` (jit.cond)."""
    marks = _MARKS.get()
    return None if marks is None else len(marks.spans)


class span:
    """`with span("tpq.<layer>.<part>"):` (module docstring); also a
    decorator of a function whose every call it spans."""

    __slots__ = ("name", "_fn", "_marks")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._marks = _MARKS.get()
        if self._marks is not None:
            self._marks.open(self.name)
        self._fn = None
        if _profiler._is_profiler_enabled:
            self._fn = record_function(self.name)
            self._fn.__enter__()
        return self

    def __exit__(self, *exc):
        if self._fn is not None:
            self._fn.__exit__(*exc)
        if self._marks is not None:
            self._marks.close()
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return spanned


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
