"""The port of jax.jit for what tpq jits (the single-card joins, the
pipeline and the scale benches' programs), and of lax.cond.

tpq runs each join and the pipeline as one jitted XLA program: one
dispatch, with its branches decided on the device by lax.cond
(tpq/kernels/lane2.py:349, tpq/kernels/lane_table.py:448,
tpq/ops/skew_join.py:182, tpq/ops/union_join.py:261,323). On the card
the counterpart of that dispatch is a CUDA graph, captured once and
replayed in one launch:

  * cond(pred, then_fn, else_fn): eager (and on the CPU)
    `then_fn() if bool(pred) else else_fn()`, one host read. While a
    body is traced for a graph (`deferred`), the k-th cond runs the
    branch of a recorded path (then_fn where no path is given) and
    records pred, with no host read; each branch must therefore be safe
    to run whatever pred is. Under `decided` it runs eagerly and records
    the branch each cond took: the path a graph of that run follows.
  * jit(fn): on CPU arguments it calls fn. On the card it keeps graphs
    per signature: each Table's column names, dtypes and capacity, each
    tensor's shape and dtype, dicts' keys, the device, and the other
    Python values, which are static and must be hashable (a torch.device
    passed as an argument places a call that has no tensor). Python numbers
    passed directly as arguments are traced, as jax.jit traces them: they
    reach the graph as device scalars that the graph owns, filled at
    every call. A signature's first call runs fn once eagerly on a side
    stream under `deferred` (the kernels build, the caches and the
    look-back state fill, and a host read raises), then captures it.
  * What a graph reads, and what it pins. A graph is captured over the
    caller's own tensors and reads them in place at every replay (a
    tensor changed in place is read with its new contents), so a call
    whose tensors sit at the addresses (data pointer and strides) of the
    capture copies nothing. The graph keeps those tensors alive (it holds
    their pointers) until it is dropped. Where a call brings a tensor at
    another address, the graph is captured again with that argument
    position in a buffer of its own, into which each later call copies
    its tensor (`.copies` counts the tensors so copied, `.copied_bytes`
    their bytes); a caller's tensor is never written. So a signature's
    graphs pin at most the tensors of one call each.
  * Branches. Every call replays the graph of the branch path its
    signature took last (at first the then-branches), and reads every
    recorded pred and (without hand_off, for their copy-out) each output
    Table's num_rows in one device-to-host copy: one sync, as tpq's
    result transfer (a graph with neither makes no sync). If a pred
    disagrees with the path, the replay is discarded
    (counted in `.reruns`) and fn runs eagerly on the same arguments
    under `decided`, as lax.cond's taken branches; the graph of the path
    it took is then captured, and later calls replay it first. At most
    MAX_PATHS graphs a signature are kept, the least recently used going
    first.
  * Outputs. By default output Tables come back as fresh tensors of
    the same capacity holding the live prefix (rows past num_rows are
    unspecified, as the Table contract says) and other output tensors
    are cloned, so no later replay overwrites a returned result.
    `jit(fn, hand_off=True)` hands back the graph's own output tensors
    instead, with no copy, as XLA hands its outputs over. Their lifetime
    rule: they hold the call's result until that callable's next call,
    which may overwrite them; a caller keeps what it needs past that by
    copying it. Fed to the next program as arguments, they lie at the
    same addresses at every call, so that program's graph reads them in
    place and copies nothing (a chain of programs passing a chunk along).
  * State updated in place. `jit(fn, updates=(i, ...))` names the
    argument positions whose tensors fn updates in place (a state carried
    across calls, tpq's donated buffers): the warm-up before a capture
    runs on copies of them, so that every call, the first included,
    updates them once, by the body's own kernels inside the graph; they
    are never copied into buffers of the graph's own (a call that brings
    them elsewhere captures the graph again over them). Such a body may
    have no cond: a rerun after its replay would update them twice.
  * Named conds and observed values. `cond(..., name=...)` records the
    branch a named cond takes (`tpq.lane.ok`, `tpq.skew.ok`,
    `tpq.union.small_ok`); `observe(name, scalar)` inside a body stacks a
    0-d device integer into the same flags copy (eagerly it reads the
    scalar only while a profiler records), and keeps a Python int (a
    constant of the body's shapes) beside the graph, with no device work.
    Both cost no sync of their own.
  * Phases and records. Every call adds its host ns, phase by phase
    (signature: the arguments flattened, the graph looked up and its
    addresses checked; load: the copy-in and the numbers filled; launch:
    the replay; read: the flags' device-to-host copy, a wait; result: the
    copy-out; rerun; capture), into the callable's totals; `stats()`
    returns them with the counters, each named cond's branches and the
    last observed values. While a profiler records, each phase is a span
    `tpq.jit.<phase>` and each call appends a record (trace.py) with the
    replay's device ms and its operator spans' (trace.span's stamps inside
    the graph, read in the same flags copy).
  * A capture that fails, or a host read inside it, raises: the call
    never runs eagerly in its place. `clear()` frees the graphs, their
    memory pools, their buffers and the tensors they pin, as dropping the
    callable does.

Launch counts (`.launches` on the kernel wrappers) are Python counters:
a replay runs no Python, so count and hold kernels on eager calls of
the same body (`Jitted.__wrapped__`), and count a replay's kernels in a
profiler trace.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
from time import perf_counter_ns

import torch

from tpq_torch import trace
from tpq_torch.columnar import Table
from tpq_torch.kernels import _build

# graphs kept a signature: one a branch path, the least recently used
# dropped first
MAX_PATHS = 2
# a call's phases, in the order a call goes through them (module docstring)
PHASES = ("signature", "capture", "load", "launch", "read", "result", "rerun")


class _Trace:
    """What cond and observe do in a run. Under a capture (`eager` False)
    the k-th cond takes the branch path[k] (then_fn where path is None)
    and appends its pred, unread; eagerly (`eager` True) it reads pred and
    appends the branch taken (True: then_fn). Each cond also appends its
    name to `names` and to `attempts` the spans its else branch discards
    (a range of the capture's top-level spans, or None); `observed` holds
    (name, 0-d int64 tensor) under a capture, (name, int) eagerly."""

    __slots__ = ("path", "eager", "preds", "names", "attempts", "observed")

    def __init__(self, path=None, eager=False):
        self.path, self.eager, self.preds = path, eager, []
        self.names, self.attempts, self.observed = [], [], []


# the trace of the run in progress; None when cond reads its pred on the
# host and records nothing
_TRACE: contextvars.ContextVar = contextvars.ContextVar("tpq_torch_jit_trace",
                                                        default=None)


@contextlib.contextmanager
def _traced(run: _Trace):
    token = _TRACE.set(run)
    try:
        yield run.preds
    finally:
        _TRACE.reset(token)


def deferred(path=None):
    """The capture flag: while it is set, the k-th cond runs the branch
    path[k] (then_fn where path is None) and appends its pred, unread, to
    the list this yields."""
    return _traced(_Trace(path))


def decided():
    """An eager run whose conds read their preds and append the branch
    each took (True for then_fn) to the list this yields."""
    return _traced(_Trace(eager=True))


def cond(pred, then_fn, else_fn, name: str | None = None, attempt=None):
    """tpq's lax.cond(pred, then_fn, else_fn): eager, one host read of
    pred; under `deferred`, the recorded path's branch with pred recorded;
    under `decided`, eager with the branch recorded. `name` names it in
    the records and `stats()`; `attempt` is trace.marker() taken before
    the work whose result then_fn returns, so the spans opened since are
    discarded where the else branch is taken."""
    run = _TRACE.get()
    if run is None:
        return then_fn() if bool(pred) else else_fn()
    if run.eager:
        take = bool(pred)
        run.preds.append(take)
    else:
        k = len(run.preds)
        if run.path is not None and k >= len(run.path):
            raise RuntimeError(f"jit: cond {k} of a body recorded with "
                               f"{len(run.path)} conds")
        take = True if run.path is None else run.path[k]
        run.preds.append(pred)
    run.names.append(name)
    run.attempts.append(None if attempt is None else range(attempt, trace.marker()))
    return then_fn() if take else else_fn()


def observe(name: str, value) -> None:
    """Records a 0-d integer tensor or a Python int of a body under
    `name`: under a capture a tensor joins the flags read after each
    replay (no sync of its own) and an int is kept beside the graph; in
    an eager run of a jitted call either is read only while a profiler
    records; elsewhere nothing is done."""
    run = _TRACE.get()
    if run is None:
        return
    if not run.eager and not isinstance(value, int):
        run.observed.append((name, value.reshape(()).to(torch.int64)))
    elif not run.eager or trace.recording():
        run.observed.append((name, int(value)))


def jit(fn, hand_off: bool = False, updates: tuple[int, ...] = ()) -> "Jitted":
    """fn compiled as tpq's jax.jit compiles it: CUDA graphs per signature
    on the card, fn itself on the CPU (module docstring). `hand_off`:
    return the graph's own outputs, valid until the callable's next call;
    `updates`: the argument positions fn updates in place."""
    return Jitted(fn, hand_off=hand_off, updates=updates)


# ---------------------------------------------------------------------------
# argument and result structure
# ---------------------------------------------------------------------------

def _flatten(x, leaves: list, top: bool = False):
    """The hashable structure of x; its tensors, and the Python numbers
    passed directly as arguments (`top`), are appended to leaves."""
    if isinstance(x, Table):
        leaves.extend(x.columns.values())
        leaves.append(x.num_rows)
        return ("table", tuple((n, c.dtype) for n, c in x.columns.items()),
                x.capacity)
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return ("tensor", tuple(x.shape), x.dtype, x.device)
    if top and isinstance(x, (int, float)) and not isinstance(x, bool):
        leaves.append(x)
        return ("number", type(x))
    if isinstance(x, (list, tuple)):
        return (type(x), tuple(_flatten(v, leaves) for v in x))
    if isinstance(x, dict):
        return (dict, tuple((k, _flatten(v, leaves)) for k, v in x.items()))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x), tuple((f.name, _flatten(getattr(x, f.name), leaves))
                               for f in dataclasses.fields(x)))
    hash(x)  # a static value keys the graph
    return ("static", x)


def _unflatten(spec, leaves):
    """x of `spec` with its leaves taken from the iterator `leaves`."""
    kind = spec[0]
    if kind == "table":
        cols = {n: next(leaves) for n, _ in spec[1]}
        return Table(cols, next(leaves))
    if kind in ("tensor", "number"):
        return next(leaves)
    if kind == "static":
        return spec[1]
    if kind in (list, tuple):
        return kind(_unflatten(s, leaves) for s in spec[1])
    if kind is dict:
        return {k: _unflatten(s, leaves) for k, s in spec[1]}
    return kind(**{name: _unflatten(s, leaves) for name, s in spec[1]})


def _map(x, on_table, on_tensor):
    """x with each Table and tensor in it replaced, in a fixed order."""
    if isinstance(x, Table):
        return on_table(x)
    if isinstance(x, torch.Tensor):
        return on_tensor(x)
    if isinstance(x, (list, tuple)):
        return type(x)(_map(v, on_table, on_tensor) for v in x)
    if isinstance(x, dict):
        return {k: _map(v, on_table, on_tensor) for k, v in x.items()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: _map(getattr(x, f.name), on_table,
                                                      on_tensor)
                                         for f in dataclasses.fields(x) if f.init})
    return x


def _addresses(leaves) -> tuple:
    """Where each leaf lies: a tensor's (data pointer, strides), None for
    a Python number. A graph replays over the tensors at these places."""
    return tuple((x.data_ptr(), x.stride()) if isinstance(x, torch.Tensor) else None
                 for x in leaves)


def _placed(device: torch.device) -> torch.device:
    """A device argument with its index: the current card's for "cuda"."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


@contextlib.contextmanager
def _host_reads_raise():
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


# ---------------------------------------------------------------------------
# one signature's graph of one branch path
# ---------------------------------------------------------------------------

class _Graph:
    """The graph of one signature along one branch path: its inputs (the
    caller's tensors, pinned, except at the positions in `owned` and for
    Python numbers, where they are buffers of its own), the captured
    graph, its outputs as captured, the flags read after each replay (the
    recorded preds, then the observed tensors, then, without hand_off,
    each output Table's num_rows, then the spans' stamps), the observed
    ints (`constants`), the path it
    follows, the kernels' per-stream buffers it was captured with
    (`states`, _build.take_stream_state), and its
    top-level spans with their stamps (`marks`; `discarded`: the spans
    whose output a cond of this path throws away)."""

    def __init__(self, fn, spec, leaves, device: torch.device, path, owned,
                 hand_off: bool, updated: frozenset):
        self.device, self.owned, self.hand_off = device, frozenset(owned), hand_off
        self.inputs = [
            x if isinstance(x, torch.Tensor) and i not in self.owned
            else torch.empty_like(x, memory_format=torch.contiguous_format)
            if isinstance(x, torch.Tensor)
            else torch.empty((), dtype=torch.int64 if isinstance(x, int)
                             else torch.float64, device=device)
            for i, x in enumerate(leaves)]
        self.load(leaves)
        # the tensors the body updates in place are copies in the warm-up
        it = iter([x.clone() if i in updated else x for i, x in enumerate(self.inputs)])
        stream = torch.cuda.Stream(device)
        _build.take_stream_state(device, stream.cuda_stream)
        stream.wait_stream(torch.cuda.current_stream(device))
        # warm-up: the kernels build, the work-item caches and this
        # stream's look-back state fill, the path the graph takes runs
        with torch.cuda.stream(stream), deferred(path), _host_reads_raise():
            fn(*[_unflatten(a, it) for a in spec])
        it = iter(self.inputs)
        args = [_unflatten(a, it) for a in spec]
        self.graph = torch.cuda.CUDAGraph()
        run, self.marks = _Trace(path), trace.Marks(device)
        # relaxed: the wrappers' own CUDA queries (occupancy, shared
        # memory limits) are no stream work; a sync on the capturing
        # stream still fails the capture. torch.cuda.graph empties the
        # cache first: the warm-up's blocks go back to the card before the
        # capture allocates the graph's pool (an 8-shard join's body does
        # not fit twice)
        with torch.cuda.graph(self.graph, stream=stream,
                              capture_error_mode="relaxed"), _traced(run), \
                trace.capturing(self.marks):
            self.out = fn(*args)
            self.marks.finish()
            tables = []
            if not hand_off:  # each Table's num_rows bounds its copy-out
                _map(self.out, tables.append, lambda t: t)
            observed = [(n, v) for n, v in run.observed if isinstance(v, torch.Tensor)]
            flags = ([p.reshape(()).to(torch.int64) for p in run.preds]
                     + [v for _, v in observed]
                     + [t.num_rows.reshape(()).to(torch.int64) for t in tables]
                     + self.marks.stamps)
            self.flags = torch.stack(flags) if flags else None
        self.npreds, self.nobserved = len(run.preds), len(observed)
        self.nstamps = len(self.marks.stamps)
        if self.npreds and updated:
            raise ValueError("jit: a body that updates its arguments in place has "
                             f"{self.npreds} conds; a rerun would update them twice")
        self.path = tuple(path) if path is not None else (True,) * self.npreds
        self.names, self.observed = run.names, [n for n, _ in observed]
        self.constants = [(n, v) for n, v in run.observed if isinstance(v, int)]
        self.discarded = frozenset(i for take, spans in zip(self.path, run.attempts)
                                   if not take and spans is not None for i in spans)
        self.states = _build.take_stream_state(device, stream.cuda_stream)
        torch.cuda.current_stream(device).wait_stream(stream)
        self.bounds = None  # timing events about a replay, made when first timed

    def moved(self, leaves) -> set:
        """The pinned positions whose tensor in `leaves` lies elsewhere (a
        number's position holds a scalar of the graph's own)."""
        return {i for i, (a, b) in enumerate(zip(_addresses(self.inputs),
                                                 _addresses(leaves)))
                if b is not None and i not in self.owned and a != b}

    def load(self, leaves) -> tuple[int, int]:
        """Copies the tensors of the owned positions in and fills the
        numbers; returns (tensors copied, bytes copied)."""
        copies = nbytes = 0
        for i, (buf, x) in enumerate(zip(self.inputs, leaves)):
            if not isinstance(x, torch.Tensor):
                buf.fill_(x)
            elif i in self.owned:
                buf.copy_(x)
                copies += 1
                nbytes += x.numel() * x.element_size()
        return copies, nbytes

    def read(self) -> list:
        """The flags of the last replay (the one device-to-host copy)."""
        return self.flags.tolist() if self.flags is not None else []

    def follows(self, flags) -> bool:
        """Whether every recorded pred agrees with the path replayed."""
        return all(bool(f) == p for f, p in zip(flags[:self.npreds], self.path))

    def result(self, num_rows: list):
        """The outputs in fresh tensors: each Table's live prefix (its
        num_rows from the flags), each other tensor whole; with
        `hand_off`, the graph's own output tensors in new containers."""
        if self.hand_off:
            return _map(self.out, lambda t: Table(dict(t.columns), t.num_rows),
                        lambda x: x)
        rows = iter(num_rows)

        def table(t: Table) -> Table:
            n = max(0, min(next(rows), t.capacity))
            cols = {}
            for name, c in t.columns.items():
                fresh = torch.empty_like(c)
                fresh[:n].copy_(c[:n])
                cols[name] = fresh
            return Table(cols, t.num_rows.clone())

        return _map(self.out, table, torch.clone)

    def launch(self, timed: bool) -> None:
        """Replays; `timed` (a profiler records) between two timing events
        recorded on the stream, outside the graph."""
        if not timed:
            self.graph.replay()
            return
        if self.bounds is None:
            self.bounds = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        self.bounds[0].record()
        self.graph.replay()
        self.bounds[1].record()

    def timed(self, flags: list, rerun: bool) -> tuple[float, list]:
        """The last (timed) replay's device ms and its spans' (the records'
        form) from its flags, once its work has finished: all of them
        discarded by a rerun."""
        start, end = self.bounds
        end.synchronize()  # a graph with no flags made no sync
        stamps = flags[len(flags) - self.nstamps:]
        return start.elapsed_time(end), [
            {"name": name, "ms": t, "discarded": rerun or i in self.discarded}
            for i, (name, t) in enumerate(zip(self.marks.spans,
                                              self.marks.read(stamps)))]


class _Phases:
    """The clock of one call's phases: `next(phase)` ends the phase in
    progress (its host ns into `totals`, and, while a profiler records,
    into `ms` and its span `tpq.jit.<phase>`) and starts `phase` (None:
    none)."""

    __slots__ = ("totals", "ms", "phase", "t", "span")

    def __init__(self, totals: dict, on: bool):
        self.totals, self.ms = totals, {} if on else None
        self.phase = self.span = None
        self.t = 0

    def next(self, phase) -> None:
        t = perf_counter_ns()
        if self.phase is not None:
            self.totals[self.phase] += t - self.t
            if self.ms is not None:
                self.ms[self.phase] = self.ms.get(self.phase, 0.0) + (t - self.t) / 1e6
                self.span.__exit__(None, None, None)
        self.phase, self.t = phase, t
        if phase is not None and self.ms is not None:
            self.span = trace.span("tpq.jit." + phase).__enter__()


class Jitted:
    """A jitted callable (see `jit`). `__wrapped__` is fn, the eager body;
    `reruns` counts the calls whose replay was discarded for a pred that
    disagreed with its path and ran fn eagerly; `copies` and
    `copied_bytes` count the tensors (and their bytes) copied into a
    graph's own buffers because they lay elsewhere than at its capture;
    `captures` counts the graphs captured; `hand_off` and `updates` are
    jit's options; `stats()` returns these with the rest of what the
    calls counted."""

    def __init__(self, fn, hand_off: bool = False, updates: tuple[int, ...] = ()):
        functools.update_wrapper(self, fn)
        self.hand_off, self.updates = hand_off, frozenset(updates)
        self.calls = self.replays = 0
        self.reruns = self.copies = self.copied_bytes = self.captures = 0
        self.phase_ns = dict.fromkeys(PHASES, 0)
        self.branches: dict = {}  # cond name -> {"then": calls, "else": calls}
        self.observed: dict = {}  # name -> the last value observed
        self._graphs: dict = {}  # (signature, path) -> _Graph, least recent first
        self._last: dict = {}    # signature -> the path of its last call
        self._owned: dict = {}   # signature -> positions whose tensors moved

    def clear(self) -> None:
        """Frees every graph, its memory pool, its buffers and the tensors
        it pins (after the card has finished with them)."""
        for dev in {g.device for g in self._graphs.values()}:
            torch.cuda.synchronize(dev)
        self._graphs.clear()
        self._last.clear()
        self._owned.clear()

    def stats(self) -> dict:
        """The calls' counters: calls, replays, reruns, copies,
        copied_bytes, captures; the host ns each phase took over all calls
        (`phase_ns`); each named cond's branches taken (`conds`); the last
        value of each observed name (`observed`)."""
        return {"calls": self.calls, "replays": self.replays, "reruns": self.reruns,
                "copies": self.copies, "copied_bytes": self.copied_bytes,
                "captures": self.captures, "phase_ns": dict(self.phase_ns),
                "conds": {n: dict(b) for n, b in self.branches.items()},
                "observed": dict(self.observed)}

    def _count(self, names, taken) -> list:
        """Counts each named cond's branch; returns [[name, branch]]."""
        conds = []
        for name, take in zip(names, taken):
            if name is not None:
                take = bool(take)
                b = self.branches.setdefault(name, {"then": 0, "else": 0})
                b["then" if take else "else"] += 1
                conds.append([name, take])
        return conds

    def _capture(self, spec, path, leaves, device, updated) -> _Graph:
        """Captures the graph of `spec` along `path` (None: the
        then-branches) over `leaves`, keeping at most MAX_PATHS a
        signature."""
        same = [k for k in self._graphs if k[0] == spec]
        if len(same) >= MAX_PATHS:
            torch.cuda.synchronize(device)
            del self._graphs[same[0]]
        graph = _Graph(self.__wrapped__, spec, leaves, device, path,
                       self._owned.setdefault(spec, set()), self.hand_off, updated)
        self.captures += 1
        self._graphs[(spec, graph.path)] = graph
        self._last[spec] = graph.path
        return graph

    def __call__(self, *args):
        fn = self.__wrapped__
        if _TRACE.get() is not None:  # traced or decided inside another body
            return fn(*args)
        self.calls += 1
        clock = _Phases(self.phase_ns, trace.recording())
        try:
            clock.next("signature")
            out, record = self._call(fn, args, clock)
        finally:
            clock.next(None)
        if record is not None:
            record["host_ms"] = clock.ms
            trace.append(record)
        return out

    def _call(self, fn, args, clock: _Phases):
        """The call; returns (its result, its record or None)."""
        on = clock.ms is not None
        leaves: list = []
        spec, updated = [], set()
        for i, a in enumerate(args):
            start = len(leaves)
            spec.append(_flatten(a, leaves, top=True))
            if i in self.updates:
                updated.update(range(start, len(leaves)))
        spec, updated = tuple(spec), frozenset(updated)
        devices = ({x.device for x in leaves if isinstance(x, torch.Tensor)}
                   | {_placed(a) for a in args if isinstance(a, torch.device)})
        if not any(d.type == "cuda" for d in devices):
            clock.next(None)
            run = _Trace(eager=True)
            with _traced(run):
                out = fn(*args)
            conds = self._count(run.names, run.preds)
            self.observed.update(run.observed)
            return out, (_record(False, None, [], conds, run.observed) if on else None)
        if len(devices) != 1:
            raise ValueError(f"jit: arguments on several devices "
                             f"{sorted(map(str, devices))}")
        device = devices.pop()
        path = self._last.get(spec)
        graph = self._graphs.pop((spec, path), None)
        if graph is not None:
            moved = graph.moved(leaves)
            if moved:  # captured again with those positions in its own buffers
                # (a position the body updates in place: over its new tensors)
                self._owned[spec] |= moved - updated
                torch.cuda.synchronize(device)
                graph = None
            else:
                self._graphs[(spec, path)] = graph  # the most recently used
        if graph is None:
            clock.next("capture")
            graph = self._capture(spec, path, leaves, device, updated)
        clock.next("load")
        copies, nbytes = graph.load(leaves)
        self.copies += copies
        self.copied_bytes += nbytes
        clock.next("launch")
        graph.launch(on)
        clock.next("read")
        flags = graph.read()
        self.replays += 1
        npreds, nobs = graph.npreds, graph.nobserved
        observed = list(zip(graph.observed, flags[npreds:npreds + nobs])) + graph.constants
        self.observed.update(observed)
        if graph.follows(flags):
            conds = self._count(graph.names, flags[:npreds])
            clock.next("result")
            out = graph.result(flags[npreds + nobs:])
            if not on:
                return out, None
            clock.next(None)
            return out, _record(False, *graph.timed(flags, False), conds, observed)
        self.reruns += 1
        timed = graph.timed(flags, True) if on else None
        clock.next("rerun")
        run = _Trace(eager=True)
        with _traced(run):
            out = fn(*args)
        path = tuple(run.preds)
        if (spec, path) in self._graphs:
            self._last[spec] = path
        else:  # the next call replays this path's graph
            clock.next("capture")
            self._capture(spec, path, leaves, device, updated)
        conds = self._count(run.names, run.preds)
        self.observed.update(run.observed)
        return out, (_record(True, *timed, conds, run.observed or observed) if on else None)


def _record(rerun: bool, device_ms, spans: list, conds: list, observed) -> dict:
    """A call's record (trace.py), its host ms added by the caller."""
    return {"rerun": rerun, "host_ms": None, "device_ms": device_ms, "spans": spans,
            "conds": conds, "observed": dict(observed)}
