"""Multiplicative hashing (port of tpq/hashing.py), bit-identical to it.

The 32-bit mixer works on u32 values held in int64 tensors: torch on
the CPU implements neither `>>`, `+` nor `<` on uint32, so every
multiply is taken in int64 (which wraps, keeping the low 32 bits
exact) and masked back to 32 bits.
"""

from __future__ import annotations

import numpy as np
import torch

# Knuth's multiplier: 2^64 / phi, odd.
PHI64 = 0x9E3779B97F4A7C15
# 32-bit golden-ratio multipliers (odd), distinct per lane.
PHI32_A = 0x9E3779B9
PHI32_B = 0x85EBCA6B
PHI32_C = 0xC2B2AE35

M32 = 0xFFFFFFFF


def _signed64(x: int) -> int:
    """A u64 constant as the int64 with the same bits."""
    return x - (1 << 64) if x >= 1 << 63 else x


def _to_i32(h: torch.Tensor) -> torch.Tensor:
    """u32 values held in int64 -> the int32 with the same bits."""
    return (h - ((h >> 31) << 32)).to(torch.int32)


def hash_u64(keys: torch.Tensor, bits: int, salt: int = 0) -> torch.Tensor:
    """Full 64-bit Fibonacci hash -> top `bits` bits, as int32."""
    k = keys.to(torch.int64) ^ _signed64(salt & (2**64 - 1))
    h = k * _signed64(PHI64)
    return _to_i32((h >> (64 - bits)) & ((1 << bits) - 1))


def hash32_pair(lo: torch.Tensor, hi: torch.Tensor, salt: int = 0) -> torch.Tensor:
    """Mix the (lo, hi) u32 halves of an i64 key into one u32 hash.

    Inputs and output are u32 values held in int64 tensors."""
    lo = lo.to(torch.int64) & M32
    hi = hi.to(torch.int64) & M32
    h = ((lo ^ (salt & M32)) * PHI32_A) & M32
    h = h ^ ((hi * PHI32_B) & M32)
    h = h ^ (h >> 16)
    h = (h * PHI32_B) & M32
    h = h ^ (h >> 13)
    h = (h * PHI32_C) & M32
    h = h ^ (h >> 16)
    return h


def split_i64(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """i64 -> (lo_u32, hi_u32), each held in an int64 tensor."""
    k = keys.to(torch.int64)
    return k & M32, (k >> 32) & M32


def hash_keys(keys: torch.Tensor, bits: int, salt: int = 0) -> torch.Tensor:
    """Hash i64 keys -> int32 bucket ids in [0, 2^bits). At bits=32 the
    result keeps all 32 bits, so half of it is negative, as in tpq."""
    lo, hi = split_i64(keys)
    h = hash32_pair(lo, hi, salt)
    if bits < 32:
        return (h >> (32 - bits)).to(torch.int32)
    return _to_i32(h)


def np_hash_keys(keys: np.ndarray, bits: int, salt: int = 0) -> np.ndarray:
    """NumPy twin of hash_keys for host-side checks."""
    with np.errstate(over="ignore"):
        k = keys.astype(np.uint64)
        lo = (k & np.uint64(M32)).astype(np.uint32)
        hi = (k >> np.uint64(32)).astype(np.uint32)
        h = (lo ^ np.uint32(salt & M32)) * np.uint32(PHI32_A)
        h = h ^ (hi * np.uint32(PHI32_B))
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(PHI32_B)
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(PHI32_C)
        h = h ^ (h >> np.uint32(16))
    if bits < 32:
        return (h >> np.uint32(32 - bits)).astype(np.int32)
    return h.astype(np.int32)
