"""PAD and PACK (port of tpq/kernels/move.py).

  * pad(planes, dest, n_live, out_len): row k < n_live of compact columns
    goes to slot dest[k] (dest strictly increasing over the live prefix);
    rows with dest outside [0, out_len) or k >= n_live are dropped.
    Returns the [out_len] columns and a 0/1 int32 occ; unwritten slots
    are 0.
  * pack(planes, occ): stable compaction of the rows with occ != 0 to
    the front. Returns the [N] columns, zero past the live prefix, and
    the int32 total.

Columns are int32 (tpq's 32-bit planes, so the JAX wrapper's inputs are
taken as they are) or int64 (the port moves 64-bit keys and payloads as
one column). A wrapper runs its CUDA kernel (tpq_torch/csrc/move.cu) on
CUDA tensors and its plain torch version on CPU tensors; on any other
device it raises. Each wrapper counts its kernel launches in `.launches`.
"""

from __future__ import annotations

import torch

from tpq_torch.kernels import _build

I32 = torch.int32
MAX_COLS = 16  # TPQ_MAX_COLS in csrc/common.cuh


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

    dest: int32[N], strictly increasing over the live prefix (caller's
    contract; live rows that overflow carry a dest >= out_len and are
    counted as overflow upstream). n_live: int or 0-d tensor."""
    n = dest.shape[0]
    planes = _check_cols(planes, n, "pad")
    n_live = torch.as_tensor(n_live, dtype=I32, device=dest.device).reshape(())
    if _device_of(dest, "pad") == "cpu":
        return pad_ref(planes, dest, n_live, out_len)
    if n >= 2**31 or out_len >= 2**31:
        raise ValueError("pad: int32 row indices need N, out_len < 2^31")
    dest = dest.to(I32).contiguous()
    outs = [torch.empty(out_len, dtype=p.dtype, device=p.device) for p in planes]
    occ = torch.empty(out_len, dtype=I32, device=dest.device)
    with torch.cuda.device(dest.device):
        code = _build.lib().tpq_pad(
            _build.ptr_array(planes), _build.ptr_array(outs),
            _build.int_array([p.element_size() for p in planes]), len(planes),
            dest.data_ptr(), n_live.data_ptr(), n, out_len, occ.data_ptr(),
            _build.stream_of(dest))
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


def pack(planes, occ: torch.Tensor):
    """Compact the rows with occ != 0 of each column to the front, order
    kept. Returns ([N] columns zero after the live prefix, total int32)."""
    n = occ.shape[0]
    planes = _check_cols(planes, n, "pack")
    if _device_of(occ, "pack") == "cpu":
        return pack_ref(planes, occ)
    if n >= 2**31:
        raise ValueError("pack: int32 row indices need N < 2^31")
    occ = occ.to(I32).contiguous()
    lib = _build.lib()
    blocks = max(1, -(-n // lib.tpq_pack_tile()))
    outs = [torch.empty_like(p) for p in planes]
    block_counts = torch.empty(blocks, dtype=I32, device=occ.device)
    block_offsets = torch.empty(blocks, dtype=I32, device=occ.device)
    total = torch.empty((), dtype=I32, device=occ.device)
    with torch.cuda.device(occ.device):
        code = lib.tpq_pack(
            _build.ptr_array(planes), _build.ptr_array(outs),
            _build.int_array([p.element_size() for p in planes]), len(planes),
            occ.data_ptr(), n, block_counts.data_ptr(), block_offsets.data_ptr(),
            total.data_ptr(), _build.stream_of(occ))
    _build.check(code, "pack")
    pack.launches += 1
    return outs, total


pack.launches = 0
