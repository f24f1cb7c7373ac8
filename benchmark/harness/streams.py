"""The benchmark's relations, made on the device from the run's seed.

A frozen copy of the port's seed-stable streams (splitmix64 over a
counter, no generator state), in plain torch so that the yardstick does
not move when the program's generator does:

  * uniform keys: splitmix64(seed ^ i * M) mod nkeys (unsigned modulo);
  * zipf(theta) keys: the rank whose cumulative weight 1/rank^theta
    (float64, summed in index order on the host) first exceeds a 53-bit
    uniform draw times the total; the key value is the rank;
  * payload column j: splitmix64((seed ^ SALT) ^ (i * ncols + j) * M) >> 1,
    a non-negative int64.

The same (seed, rows, nkeys, payloads, theta) gives the bytes of the
C++ oracle's generator. uint64 arithmetic runs on int64 bits: torch's
int64 add and multiply wrap, `>>` is arithmetic (so each right shift is
masked) and `%` is a floor modulo of the signed value (so the unsigned
modulo is rebuilt).

A run's seed orders the rows and draws the payloads; the keys' multiset
is the configuration's own (drawn from its `key_seed`), so that every
seed gives the program the same work: the lane join's static capacities
(partitions, bucket depth) hold or overflow by the keys' multiset alone,
and on some uniform draws they overflow and the join runs its
union-sort fallback, at more than twice the time. Rows from `rows`
up to the capacity (the next power of two) continue the key stream
unpermuted; the tables' contract leaves them unspecified.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

PAYLOAD_SALT = 0xA5A5A5A5DEADBEEF
GOLDEN = 0x9E3779B97F4A7C15
STREAM_MUL = 0xD1342543DE82EF95
MASK64 = (1 << 64) - 1


def next_pow2(n: int) -> int:
    """Smallest power of two >= max(n, 8): every static capacity."""
    n = max(int(n), 8)
    return 1 << (n - 1).bit_length()


def _i64(x: int) -> int:
    """A u64 constant as the int64 with the same bits."""
    x &= MASK64
    return x - (1 << 64) if x >= 1 << 63 else x


def _srl(z: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of the u64 bits of an int64 tensor."""
    return (z >> k) & ((1 << (64 - k)) - 1)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    z = x + _i64(GOLDEN)
    z = (z ^ _srl(z, 30)) * _i64(0xBF58476D1CE4E5B9)
    z = (z ^ _srl(z, 27)) * _i64(0x94D049BB133111EB)
    return z ^ _srl(z, 31)


def stream(seed: int, idx: torch.Tensor) -> torch.Tensor:
    return splitmix64(_i64(seed) ^ (idx * _i64(STREAM_MUL)))


def umod(x: torch.Tensor, n: int) -> torch.Tensor:
    """The u64 bits of x modulo n: x + 2^64 for the negative ones."""
    m = torch.remainder(x, n)
    return torch.where(x < 0, torch.remainder(m + (2**64 % n), n), m)


def splitmix64_int(x: int) -> int:
    """splitmix64 of one Python int (for deriving seeds)."""
    z = (x + GOLDEN) & MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
    return z ^ (z >> 31)


def derive_seed(seed: int, relation: int) -> int:
    """The stream seed of relation `relation` (1: build side, 2: probe
    side) of a run's --seed, any whole number."""
    return splitmix64_int((seed + relation * GOLDEN) & MASK64)


def zipf_cdf(nkeys: int, theta: float) -> np.ndarray:
    """Cumulative weights of 1/rank^theta, rank = 1..nkeys, float64,
    summed in index order (the oracle's loop order)."""
    ranks = np.arange(1, nkeys + 1, dtype=np.float64)
    return np.cumsum(ranks ** (-np.float64(theta)))


def uniform_keys(idx: torch.Tensor, nkeys: int, seed: int) -> torch.Tensor:
    return umod(stream(seed, idx), nkeys)


def zipf_keys(idx: torch.Tensor, nkeys: int, theta: float, seed: int) -> torch.Tensor:
    cdf = torch.from_numpy(zipf_cdf(nkeys, theta)).to(idx.device)
    u = _srl(stream(seed, idx), 11).to(torch.float64) * (1.0 / 9007199254740992.0)
    k = torch.searchsorted(cdf, u * cdf[-1], right=True)
    return k.clamp_max(nkeys - 1).to(torch.int64)


def payload(idx: torch.Tensor, ncols: int, j: int, seed: int) -> torch.Tensor:
    return _srl(stream(seed ^ PAYLOAD_SALT, idx * ncols + j), 1)


@dataclass
class Relation:
    """Columns "key", "p0".."p{P-1}" of one capacity on one device; rows
    past `rows` are padding."""

    columns: dict
    rows: int

    @property
    def capacity(self) -> int:
        return next(iter(self.columns.values())).shape[0]

    def live(self, name: str) -> torch.Tensor:
        return self.columns[name][:self.rows]


def relation(rows: int, nkeys: int, payloads: int, key_seed: int, seed: int,
             keys: dict, device) -> Relation:
    """A relation of `rows` rows at capacity next_pow2(rows): the keys of
    the stream `key_seed` under the traffic's distribution `keys`
    ({"dist": "uniform"} or {"dist": "zipf", "theta": t}), in an order
    drawn from `seed` (a stable sort by the stream `seed`), and payloads
    from `seed`."""
    idx = torch.arange(next_pow2(rows), dtype=torch.int64, device=device)
    dist = keys["dist"]
    if dist == "uniform":
        key = uniform_keys(idx, nkeys, key_seed)
    elif dist == "zipf":
        key = zipf_keys(idx, nkeys, float(keys["theta"]), key_seed)
    else:
        raise ValueError(f"unknown key distribution {dist!r}")
    order = torch.sort(stream(seed, idx[:rows]), stable=True).indices
    key[:rows] = key[:rows][order]
    cols = {"key": key}
    for j in range(payloads):
        cols[f"p{j}"] = payload(idx, payloads, j, seed)
    return Relation(cols, rows)
