"""The hash aggregate's run-end pass (port of tpq/ops/hash_aggregate.py:59-110).

  * aggregate_runs(key, values, num_rows): `key` int32 or int64 [N],
    ascending over the valid rows [0, min(num_rows, N)) (sort_rows'
    output); `values` int32 or int64 [N] columns; `num_rows` a 0-d int32
    or int64 tensor, read on the device (it may exceed N: an overflowed
    join's count). Row i ends a run when it is valid and the next row is
    padding or holds another key. Returns ([key', count, sum_0, ...],
    G): for the g-th run end (g < G) its key (the key's dtype), its row
    count and each column's wrapping int64 sum over its rows (int32
    values widened first), every row from G on 0 (tpq's PACK zeroes
    them; the aggregate's output is the user's table); G int32 0-d.

tpq computes this with XLA-fused scans and one PACK call
(tpq/kernels/move.py `pack`, called at tpq/ops/hash_aggregate.py:103);
on a CUDA tensor the wrapper launches one kernel for it
(tpq_torch/csrc/aggregate.cu), up to MAX_VALUES value columns a launch,
and counts its launches in `.launches`. On a CPU tensor it runs the
plain version, `aggregate_runs_ref`; on any other device it raises.
Its look-back state is a buffer of its own (`state_owner`), apart from
PACK's and the walk/emit's.
"""

from __future__ import annotations

import torch

from tpq_torch.kernels import _build
from tpq_torch.kernels.move import MAX_COLS, STATE_HEADER, pack_ref

I32, I64 = torch.int32, torch.int64
AGG_TILE = 4096  # kAggTile in csrc/aggregate.cu
MAX_VALUES = MAX_COLS - 2  # kAggMaxVals: the key and count columns take two


def state_words(n: int, nvals: int) -> int:
    """The look-back words a launch needs past the state's header: one
    record of 1 + 2 * (nvals + 1) words a tile (agg_state_words in
    csrc/aggregate.cu)."""
    return -(-n // AGG_TILE) * (1 + 2 * (nvals + 1))


def state_owner(nvals: int):
    """The stream-state owner (_build.stream_state) of the run-end pass at
    `nvals` value columns. Its int64 words are laid out as PACK's
    (csrc/common.cuh: epoch and ticket word, wrap count, then the
    records) and kept across calls the same way, but in a buffer of their
    own for each record width: PACK and the walk/emit read every word past
    the header as a status, and a record's payloads (open-run counts and
    sums) may hold any 64 bits, so they must never lie where another
    launch looks for a flag word: not PACK's, not the walk/emit's, and
    not a run-end launch's of another width."""
    return ("aggregate", nvals)


def aggregate_runs_ref(key: torch.Tensor, values, num_rows, pack=pack_ref):
    """Plain torch run-end pass: defines the contract the kernel is held
    to. Run ends by neighbour compares masked by the valid rows (a real
    max-key group must not merge with the padding, whose keys are the
    max); then `pack` compacts the run-end rows with their row index and
    the inclusive int64 cumsum of every column (which wrap), and a
    group's count and sums are the differences to the group before it.
    Rows from G on are zeroed. `pack=move.pack` on CUDA tensors is the
    aggregate's sequence before the kernel."""
    cap, dev = key.shape[0], key.device
    i = torch.arange(cap, dtype=I64, device=dev)
    valid = i < num_rows
    nxt_new = torch.ones(cap, dtype=torch.bool, device=dev)
    torch.bitwise_or(key[1:] != key[:-1], ~valid[1:], out=nxt_new[:-1])  # in place, no copy
    is_end = valid & nxt_new
    cols = [key, i] + [torch.cumsum(torch.where(valid, v.to(I64), 0), 0) for v in values]
    ends, groups = pack(cols, is_end.to(I32))
    live = i < groups
    outs = [ends[0]]
    for c, before_first in zip(ends[1:], [-1] + [0] * len(values)):
        d = torch.diff(c, prepend=c.new_full((1,), before_first))
        outs.append(torch.where(live, d, 0))
    return outs, groups


def _check(key: torch.Tensor, values) -> None:
    n = key.shape[0]
    for c in (key, *values):
        if c.dim() != 1 or c.shape[0] != n:
            raise ValueError(f"aggregate_runs: columns must be 1-D of length {n}, "
                             f"got {tuple(c.shape)}")
        if c.dtype not in (I32, I64):
            raise TypeError(f"aggregate_runs: int32 or int64 columns, got {c.dtype}")
        if c.device != key.device:
            raise ValueError(f"aggregate_runs: columns on {key.device} and {c.device}")


def aggregate_runs(key: torch.Tensor, values, num_rows):
    """The groups of a key-sorted table (module docstring): ([key',
    count, sum_0, ...], G int32)."""
    values = list(values)
    _check(key, values)
    dev = key.device
    if dev.type == "cpu":
        num_rows = torch.as_tensor(num_rows, device=dev).reshape(())
        return aggregate_runs_ref(key, values, num_rows)
    if dev.type != "cuda":
        raise RuntimeError(f"aggregate_runs: no kernel for device {dev}")
    n = key.shape[0]
    if n >= 2**31:
        raise ValueError("aggregate_runs: 31-bit run-end counts need N < 2^31")
    if not isinstance(num_rows, torch.Tensor) or num_rows.device != dev:
        num_rows = torch.as_tensor(num_rows, device=dev)  # a host value
    if num_rows.numel() != 1:
        raise ValueError("aggregate_runs: num_rows must be one value")
    if num_rows.dtype not in (I32, I64):
        num_rows = num_rows.to(I64)
    key = key.contiguous()
    values = [v.contiguous() for v in values]
    lib = _build.lib()
    stream = _build.stream_of(key)
    key_out = torch.empty_like(key)
    count = torch.empty(n, dtype=I64, device=dev)
    sums = [torch.empty(n, dtype=I64, device=dev) for _ in values]
    groups = torch.empty((), dtype=I32, device=dev)
    # past MAX_VALUES columns, a launch per group of them: each writes the
    # same key', count and G
    for lo in range(0, max(1, len(values)), MAX_VALUES):
        vals, outs = values[lo:lo + MAX_VALUES], sums[lo:lo + MAX_VALUES]
        state = _build.stream_state(state_owner(len(vals)), dev, stream,
                                    state_words(n, len(vals)) + STATE_HEADER, I64)
        with _build.on_device(key):
            code = lib.tpq_aggregate_runs(
                key.data_ptr(), key.element_size(), _build.ptr_array(vals),
                _build.int_array([v.element_size() for v in vals]), len(vals),
                num_rows.data_ptr(), num_rows.element_size(), n, key_out.data_ptr(),
                count.data_ptr(), _build.ptr_array(outs), state.data_ptr(),
                state.numel(), groups.data_ptr(), stream)
        _build.check(code, "aggregate_runs")
        aggregate_runs.launches += 1
    return [key_out, count, *sums], groups


aggregate_runs.launches = 0
