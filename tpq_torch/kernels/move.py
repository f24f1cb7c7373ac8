"""PAD and PACK (port of tpq/kernels/move.py).

  * pad(planes, dest, n_live, out_len): row k < n_live of compact columns
    goes to slot dest[k] (dest strictly increasing over the live rows
    that land in [0, out_len)); rows with dest outside [0, out_len) or
    k >= n_live are dropped.
    Returns the [out_len] columns and a 0/1 int32 occ; unwritten slots
    are 0.
  * pack(planes, occ): stable compaction of the rows with occ != 0 to
    the front. Returns the [N] columns, zero past the live prefix, and
    the int32 total.

Columns are int32 (tpq's 32-bit planes, so the JAX wrapper's inputs are
taken as they are) or int64 (the port moves 64-bit keys and payloads as
one column). A wrapper runs its CUDA kernel (tpq_torch/csrc/move.cu) on
CUDA tensors and its plain torch version on CPU tensors; on any other
device it raises. Each wrapper counts its kernel launches in `.launches`:
one launch per call.
"""

from __future__ import annotations

import torch

from tpq_torch.kernels import _build

I32 = torch.int32
MAX_COLS = 16  # TPQ_MAX_COLS in csrc/common.cuh
PACK_TILE = 4096  # kPackTile in csrc/move.cu (the kernel checks the state size)
STATE_HEADER = 2  # kStateHeader in csrc/common.cuh: epoch and ticket, wrap count


def _check_cols(planes, n: int, what: str) -> list[torch.Tensor]:
    if not 1 <= len(planes) <= MAX_COLS:
        raise ValueError(f"{what}: 1..{MAX_COLS} columns, got {len(planes)}")
    for p in planes:
        if p.dim() != 1 or p.shape[0] != n:
            raise ValueError(f"{what}: columns must be 1-D of length {n}, "
                             f"got {tuple(p.shape)}")
        if p.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"{what}: int32 or int64 columns, got {p.dtype}")
    return [p.contiguous() for p in planes]


def _device_of(t: torch.Tensor, what: str) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{what}: no kernel for device {t.device}")
    return t.device.type


# ---------------------------------------------------------------------------
# PAD
# ---------------------------------------------------------------------------

def pad_ref(planes, dest: torch.Tensor, n_live, out_len: int):
    """Plain torch PAD: defines the contract the kernel is held to."""
    n = dest.shape[0]
    k = torch.arange(n, device=dest.device)
    d = dest.to(torch.int64)
    keep = (k < n_live) & (d >= 0) & (d < out_len)
    slots = d[keep]
    outs = []
    for p in planes:
        o = torch.zeros(out_len, dtype=p.dtype, device=p.device)
        o[slots] = p[keep]
        outs.append(o)
    occ = torch.zeros(out_len, dtype=I32, device=dest.device)
    occ[slots] = 1
    return outs, occ


def pad(planes, dest: torch.Tensor, n_live, out_len: int):
    """Place row k (k < n_live) of each compact column at slot dest[k].

    dest: int32[N], strictly increasing over the live rows that land in
    [0, out_len) (caller's contract; live rows that overflow carry a dest
    >= out_len anywhere in the live prefix and are counted as overflow
    upstream). n_live: int or 0-d int32/int64 tensor, read on the device."""
    n = dest.shape[0]
    planes = _check_cols(planes, n, "pad")
    if _device_of(dest, "pad") == "cpu":
        n_live = torch.as_tensor(n_live, dtype=I32, device=dest.device).reshape(())
        return pad_ref(planes, dest, n_live, out_len)
    if n >= 2**31 or out_len >= 2**31:
        raise ValueError("pad: int32 row indices need N, out_len < 2^31")
    if dest.dtype != I32 or not dest.is_contiguous():
        dest = dest.to(I32).contiguous()
    if not isinstance(n_live, torch.Tensor) or n_live.device != dest.device:
        n_live = torch.as_tensor(n_live, device=dest.device)  # a host value
    if n_live.numel() != 1:
        raise ValueError("pad: n_live must be one value")
    if n_live.dtype not in (torch.int32, torch.int64):
        n_live = n_live.to(torch.int64)
    outs = [torch.empty(out_len, dtype=p.dtype, device=p.device) for p in planes]
    occ = torch.empty(out_len, dtype=I32, device=dest.device)
    with _build.on_device(dest):
        code = _build.lib().tpq_pad(
            _build.ptr_array(planes), _build.ptr_array(outs),
            _build.int_array([p.element_size() for p in planes]), len(planes),
            dest.data_ptr(), n_live.data_ptr(), n_live.element_size(), n, out_len,
            occ.data_ptr(), _build.stream_of(dest))
    _build.check(code, "pad")
    pad.launches += 1
    return outs, occ


pad.launches = 0


# ---------------------------------------------------------------------------
# PACK
# ---------------------------------------------------------------------------

def pack_ref(planes, occ: torch.Tensor):
    """Plain torch PACK: defines the contract the kernel is held to."""
    keep = occ != 0
    total = keep.sum().to(I32)
    outs = []
    for p in planes:
        o = torch.zeros_like(p)
        live = p[keep]
        o[:live.shape[0]] = live
        outs.append(o)
    return outs, total


# The stream-state owner (_build.stream_state) of PACK's and the fused
# walk/emit's look-back state: int64 words, epoch and ticket counter,
# wrap count, then the work items' statuses (csrc/common.cuh). Each
# launch takes the next epoch from the buffer itself, so the words of
# earlier calls read as not yet written, nothing is reset between calls,
# and a CUDA graph that replays a launch takes a new epoch at every replay.
PACK_OWNER = "pack"


def pack(planes, occ: torch.Tensor):
    """Compact the rows with occ != 0 of each column to the front, order
    kept. Returns ([N] columns zero after the live prefix, total int32)."""
    n = occ.shape[0]
    planes = _check_cols(planes, n, "pack")
    if _device_of(occ, "pack") == "cpu":
        return pack_ref(planes, occ)
    if n >= 2**31:
        raise ValueError("pack: int32 row indices need N < 2^31")
    if occ.dtype != I32 or not occ.is_contiguous() or occ.data_ptr() % 16:
        # the kernel reads occ in 16-byte loads
        occ = occ.to(I32, memory_format=torch.contiguous_format, copy=True)
    lib = _build.lib()
    stream = _build.stream_of(occ)
    state = _build.stream_state(PACK_OWNER, occ.device, stream,
                                -(-n // PACK_TILE) + STATE_HEADER, torch.int64)
    outs = [torch.empty_like(p) for p in planes]
    total = torch.empty((), dtype=I32, device=occ.device)
    with _build.on_device(occ):
        code = lib.tpq_pack(
            _build.ptr_array(planes), _build.ptr_array(outs),
            _build.int_array([p.element_size() for p in planes]), len(planes),
            occ.data_ptr(), n, state.data_ptr(), state.numel(),
            total.data_ptr(), stream)
    _build.check(code, "pack")
    pack.launches += 1
    return outs, total


pack.launches = 0
