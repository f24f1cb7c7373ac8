"""Benchmark relation generation (port of tpq/datagen.py, numpy streams).

Seed-stable contract: for identical (seed, rows, nkeys, payloads, theta)
this module, tpq.datagen and the C++ oracle (oracle/datagen.h) produce
byte-identical column streams. The shared primitive is splitmix64 applied
to a counter, so no random generator state is involved.

  * uniform: keys = splitmix64(seed, i) % nkeys
  * zipf(theta): rank sampled by inverse CDF over 1/rank^theta (float64,
    summed in index order), key value = rank.
  * payload col j: splitmix64(seed ^ PAYLOAD_SALT, i * ncols + j), masked
    to non-negative int64.

Columns are named "key", "p0".."p{P-1}". tpq's threaded native
generator (tpq/native.py, used from 4M rows) is not carried over: the
numpy stream it shortcuts is byte-identical.

gen_relation_device makes a uniform relation on the device, byte-equal
to gen_relation_np(kind="uniform"), so that the scale benches' 100M-row
relations never cross from the host. Its uint64 arithmetic runs on the
int64 bits: torch's int64 add and multiply wrap, its `>>` is arithmetic
(so each right shift is masked), and `%` is a floor modulo of the signed
value (so the key's unsigned modulo is rebuilt).
"""

from __future__ import annotations

import numpy as np
import torch

from tpq_torch.columnar import Table

PAYLOAD_SALT = 0xA5A5A5A5DEADBEEF
GOLDEN = 0x9E3779B97F4A7C15


def splitmix64(x: np.ndarray) -> np.ndarray:
    """Counter-based splitmix64; x is a uint64 array."""
    with np.errstate(over="ignore"):
        z = (x + np.uint64(GOLDEN)).astype(np.uint64)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
    return z


def _stream(seed: int, idx: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        return splitmix64(np.uint64(seed)
                          ^ (idx.astype(np.uint64) * np.uint64(0xD1342543DE82EF95)))


def uniform_keys(rows: int, nkeys: int, seed: int) -> np.ndarray:
    idx = np.arange(rows, dtype=np.uint64)
    return (_stream(seed, idx) % np.uint64(nkeys)).astype(np.int64)


def zipf_cdf(nkeys: int, theta: float) -> np.ndarray:
    """Cumulative weights of 1/rank^theta, rank=1..nkeys, float64, summed
    in index order (the oracle runs exactly this loop order)."""
    ranks = np.arange(1, nkeys + 1, dtype=np.float64)
    return np.cumsum(ranks ** (-np.float64(theta)))


def zipf_keys(rows: int, nkeys: int, theta: float, seed: int) -> np.ndarray:
    cdf = zipf_cdf(nkeys, theta)
    idx = np.arange(rows, dtype=np.uint64)
    r = _stream(seed, idx)
    # 53-bit uniform double in [0, 1)
    u = (r >> np.uint64(11)).astype(np.float64) * (1.0 / 9007199254740992.0)
    # first index where cdf[k] > target (C++: std::upper_bound)
    k = np.searchsorted(cdf, u * cdf[-1], side="right")
    return np.minimum(k, nkeys - 1).astype(np.int64)


def payload_cols(rows: int, ncols: int, seed: int) -> dict[str, np.ndarray]:
    idx = np.arange(rows, dtype=np.uint64)
    out = {}
    for j in range(ncols):
        with np.errstate(over="ignore"):
            r = _stream(seed ^ PAYLOAD_SALT, idx * np.uint64(ncols) + np.uint64(j))
        out[f"p{j}"] = (r >> np.uint64(1)).astype(np.int64)  # non-negative
    return out


def gen_relation_np(rows: int, nkeys: int, payloads: int = 1, seed: int = 0,
                    kind: str = "uniform", theta: float = 1.0) -> dict[str, np.ndarray]:
    if kind == "uniform":
        keys = uniform_keys(rows, nkeys, seed)
    elif kind == "zipf":
        keys = zipf_keys(rows, nkeys, theta, seed)
    else:
        raise ValueError(f"unknown kind {kind!r}")
    cols = {"key": keys}
    cols.update(payload_cols(rows, payloads, seed))
    return cols


def gen_relation(rows: int, nkeys: int, payloads: int = 1, seed: int = 0,
                 kind: str = "uniform", theta: float = 1.0,
                 capacity: int | None = None, device="cuda") -> Table:
    return Table.from_numpy(
        gen_relation_np(rows, nkeys, payloads, seed, kind, theta), capacity,
        device=device)


# ---------------------------------------------------------------------------
# the on-device streams (port of tpq/datagen.py _splitmix64_dev,
# _stream_dev and gen_relation_device)
# ---------------------------------------------------------------------------

def _i64(x: int) -> int:
    """A u64 constant as the int64 with the same bits."""
    x &= (1 << 64) - 1
    return x - (1 << 64) if x >= 1 << 63 else x


def _srl(z: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of the u64 bits in an int64 tensor."""
    return (z >> k) & ((1 << (64 - k)) - 1)


def _splitmix64_dev(x: torch.Tensor) -> torch.Tensor:
    z = x + _i64(GOLDEN)
    z = (z ^ _srl(z, 30)) * _i64(0xBF58476D1CE4E5B9)
    z = (z ^ _srl(z, 27)) * _i64(0x94D049BB133111EB)
    return z ^ _srl(z, 31)


def _stream_dev(seed: int, idx: torch.Tensor) -> torch.Tensor:
    return _splitmix64_dev(_i64(seed) ^ (idx * _i64(0xD1342543DE82EF95)))


def _umod(x: torch.Tensor, n: int) -> torch.Tensor:
    """The u64 bits of x modulo n: x + 2^64 for the negative ones."""
    m = torch.remainder(x, n)
    return torch.where(x < 0, torch.remainder(m + (2**64 % n), n), m)


def gen_relation_device(rows: int, nkeys: int, payloads: int = 1, seed: int = 0,
                        capacity: int | None = None, row_offset: int = 0,
                        device="cuda") -> Table:
    """Uniform relation made on `device`, byte-equal to
    gen_relation_np(kind="uniform"). `row_offset` gives the global rows
    [row_offset, row_offset + rows) of the stream, as the chunked benches
    make each probe chunk; rows up to the capacity continue the stream."""
    from tpq_torch.columnar import next_pow2

    cap = capacity or next_pow2(rows)
    idx = torch.arange(cap, dtype=torch.int64, device=device) + row_offset
    cols = {"key": _umod(_stream_dev(seed, idx), nkeys)}
    for j in range(payloads):
        r = _stream_dev(seed ^ PAYLOAD_SALT, idx * payloads + j)
        cols[f"p{j}"] = _srl(r, 1)  # non-negative
    return Table(cols, rows)
