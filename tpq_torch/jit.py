"""The port of jax.jit for what tpq jits (the single-card joins and the
pipeline), and of lax.cond.

tpq runs each join and the pipeline as one jitted XLA program: one
dispatch, with its branches decided on the device by lax.cond
(tpq/kernels/lane2.py:349, tpq/kernels/lane_table.py:448,
tpq/ops/skew_join.py:182, tpq/ops/union_join.py:261,323). On the card
the counterpart of that dispatch is a CUDA graph, captured once and
replayed in one launch:

  * cond(pred, then_fn, else_fn): eager (and on the CPU)
    `then_fn() if bool(pred) else else_fn()`, one host read. While a
    body is traced for a graph (`deferred`), it runs then_fn and records
    pred, with no host read; then_fn must therefore be safe to run
    whatever pred is.
  * jit(fn): on CPU arguments it calls fn. On the card it keeps one
    graph per signature: each Table's column names, dtypes and capacity,
    each tensor's shape and dtype, the device, and the other Python
    values, which are static and must be hashable. Python numbers passed
    directly as arguments are traced, as jax.jit traces them: they reach
    the graph as device scalars filled at every call. A signature's first
    call runs fn once eagerly on a side stream under `deferred` (the
    kernels build, the caches and the look-back state fill, and a host
    read raises), then captures it into a graph over buffers the graph
    owns. Every call copies the arguments into those buffers, replays,
    and reads every recorded pred and each output Table's num_rows in
    one device-to-host copy: one sync, as tpq's result transfer. If a
    pred is false the replay is discarded and fn runs eagerly on the same
    arguments, where every cond takes its else branch (lax.cond's
    meaning, counted in `.reruns`). Output Tables come back as fresh
    tensors of the same capacity holding the live prefix (rows past
    num_rows are unspecified, as the Table contract says); other output
    tensors are cloned, so no later replay overwrites a returned result.
    A capture that fails, or a host read inside it, raises: the call
    never runs eagerly in its place. `clear()` frees the graphs and their
    memory pools, as dropping the callable does.

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

import torch

from tpq_torch.columnar import Table

# the preds recorded by cond while a body is traced for a graph; None
# when cond reads its pred on the host
_PREDS: contextvars.ContextVar = contextvars.ContextVar("tpq_torch_jit_preds",
                                                        default=None)


@contextlib.contextmanager
def deferred():
    """The capture flag: while it is set, cond runs then_fn and appends
    its pred to the list this yields instead of reading it."""
    preds: list = []
    token = _PREDS.set(preds)
    try:
        yield preds
    finally:
        _PREDS.reset(token)


def cond(pred, then_fn, else_fn):
    """tpq's lax.cond(pred, then_fn, else_fn): eager, one host read of
    pred; under `deferred`, then_fn with pred recorded."""
    preds = _PREDS.get()
    if preds is None:
        return then_fn() if bool(pred) else else_fn()
    preds.append(pred)
    return then_fn()


def jit(fn) -> "Jitted":
    """fn compiled as tpq's jax.jit compiles it: one CUDA graph per
    signature on the card, fn itself on the CPU (module docstring)."""
    return Jitted(fn)


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
    return kind(**{name: _unflatten(s, leaves) for name, s in spec[1]})


def _map(x, on_table, on_tensor):
    """x with each Table and tensor in it replaced, in a fixed order."""
    if isinstance(x, Table):
        return on_table(x)
    if isinstance(x, torch.Tensor):
        return on_tensor(x)
    if isinstance(x, (list, tuple)):
        return type(x)(_map(v, on_table, on_tensor) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: _map(getattr(x, f.name), on_table,
                                                      on_tensor)
                                         for f in dataclasses.fields(x) if f.init})
    return x


def _take_stream_state(device: torch.device, stream: int):
    """Removes the look-back state PACK and the walk/emit keep for
    `stream` (move._pack_state) and returns it (None if there is none): a
    graph keeps the buffer its kernels were captured with, and the next
    graph captured on a stream of the same handle starts from a new one."""
    from tpq_torch.kernels import move

    return move._PACK_STATE.pop((device.index, stream), None)


@contextlib.contextmanager
def _host_reads_raise():
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


# ---------------------------------------------------------------------------
# one signature's graph
# ---------------------------------------------------------------------------

class _Graph:
    """The graph of one signature: its input buffers, the captured graph,
    its outputs as captured, the flags read after each replay (the
    recorded preds, then each output Table's num_rows) and the kernel
    state it was captured with."""

    def __init__(self, fn, spec, leaves, device: torch.device):
        self.inputs = [
            torch.empty_like(x, memory_format=torch.contiguous_format)
            if isinstance(x, torch.Tensor)
            else torch.empty((), dtype=torch.int64 if isinstance(x, int)
                             else torch.float64, device=device)
            for x in leaves]
        self.load(leaves)
        it = iter(self.inputs)
        args = [_unflatten(a, it) for a in spec]
        stream = torch.cuda.Stream(device)
        _take_stream_state(device, stream.cuda_stream)
        stream.wait_stream(torch.cuda.current_stream(device))
        # warm-up: the kernels build, the work-item caches and this
        # stream's look-back state fill, the path the graph takes runs
        with torch.cuda.stream(stream), deferred(), _host_reads_raise():
            fn(*args)
        self.graph = torch.cuda.CUDAGraph()
        # relaxed: the wrappers' own CUDA queries (occupancy, shared
        # memory limits) are no stream work; a sync on the capturing
        # stream still fails the capture
        with torch.cuda.graph(self.graph, stream=stream,
                              capture_error_mode="relaxed"), deferred() as preds:
            self.out = fn(*args)
            tables = []
            _map(self.out, tables.append, lambda t: t)
            flags = ([p.reshape(()).to(torch.int64) for p in preds]
                     + [t.num_rows.reshape(()).to(torch.int64) for t in tables])
            self.flags = torch.stack(flags) if flags else None
        self.npreds = len(preds)
        self.state = _take_stream_state(device, stream.cuda_stream)
        torch.cuda.current_stream(device).wait_stream(stream)

    def load(self, leaves) -> None:
        for buf, x in zip(self.inputs, leaves):
            if isinstance(x, torch.Tensor):
                buf.copy_(x)
            else:
                buf.fill_(x)

    def replay(self) -> list:
        """Replays; returns the flags (the one device-to-host copy)."""
        self.graph.replay()
        return self.flags.tolist() if self.flags is not None else []

    def result(self, num_rows: list):
        """The outputs in fresh tensors: each Table's live prefix (its
        num_rows from the flags), each other tensor whole."""
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


class Jitted:
    """A jitted callable (see `jit`). `__wrapped__` is fn, the eager body;
    `reruns` counts the calls whose replay was discarded for a false
    pred and ran fn eagerly."""

    def __init__(self, fn):
        functools.update_wrapper(self, fn)
        self.reruns = 0
        self._graphs: dict = {}

    def clear(self) -> None:
        """Frees every graph, its memory pool and its buffers (after the
        card has finished with them)."""
        for dev in {g.inputs[0].device for g in self._graphs.values() if g.inputs}:
            torch.cuda.synchronize(dev)
        self._graphs.clear()

    def __call__(self, *args):
        fn = self.__wrapped__
        if _PREDS.get() is not None:  # traced inside another jitted body
            return fn(*args)
        leaves: list = []
        spec = tuple(_flatten(a, leaves, top=True) for a in args)
        devices = {x.device for x in leaves if isinstance(x, torch.Tensor)}
        if not any(d.type == "cuda" for d in devices):
            return fn(*args)
        if len(devices) != 1:
            raise ValueError(f"jit: arguments on several devices "
                             f"{sorted(map(str, devices))}")
        graph = self._graphs.get(spec)
        if graph is None:
            graph = self._graphs[spec] = _Graph(fn, spec, leaves, devices.pop())
        else:
            graph.load(leaves)
        flags = graph.replay()
        if not all(flags[:graph.npreds]):
            self.reruns += 1
            return fn(*args)
        return graph.result(flags[graph.npreds:])
