"""Hash ownership and the one-process mesh (port of tpq/dist/mesh.py).

Row ownership is owner(key) = hash(key) mod nchips with tpq's salt, bit
for bit, so both packages place every row on the same shard.

tpq's mesh is a jax Mesh, and its collectives are XLA's, reached inside
a shard_map body. The port has two meshes with one interface, and the
distributed join calls nothing else, so it never asks which one it runs
on:

  * LocalMesh (`make_mesh`): n shards held by one process on one device,
    each collective a tensor operation. It is the counterpart of tpq's
    simulated CPU devices, and the form one card runs (NCCL refuses two
    ranks on one GPU).
  * ProcessGroupMesh (multihost.py): one shard per torch.distributed
    rank, each collective a torch.distributed call.

A collective takes the list of per-shard tensors this process holds (n
on a LocalMesh, one on a process group), shard i of the list being
`mesh.shard_ids[i]`, and returns such a list. Every shard's tensor has
the same shape and dtype, as under shard_map.
"""

from __future__ import annotations

import torch

from tpq_torch.hashing import M32, hash_keys

OWNER_SALT = 0xC41C0DE5


def owner_of(keys: torch.Tensor, nchips: int) -> torch.Tensor:
    """Destination shard per row (int32): the salted 32-bit hash reduced
    mod nchips; a pow2 nchips uses a mask. tpq reduces a uint32, and
    torch on the CPU has no uint32 remainder, so the hash's bits are
    held in int64, masked to 32 bits."""
    h = hash_keys(keys, 32, salt=OWNER_SALT)
    if nchips & (nchips - 1) == 0:
        return h & (nchips - 1)
    return ((h.to(torch.int64) & M32) % nchips).to(torch.int32)


class LocalMesh:
    """`size` shards held by this process on one device. `programs`
    holds the distributed join's jitted bodies on this mesh, one per
    static set (dist_join.jitted_join), with their CUDA graphs and the
    tensors they pin, until `clear()`."""

    def __init__(self, n_shards: int, device="cuda"):
        if n_shards < 1:
            raise ValueError(f"a mesh needs at least one shard, got {n_shards}")
        self.size = n_shards
        self.device = torch.device(device)
        self.shard_ids = list(range(n_shards))
        self.programs: dict = {}

    def __repr__(self):
        return f"LocalMesh({self.size} shards on {self.device})"

    def clear(self) -> None:
        """Frees the jitted joins' graphs, their memory pools and the
        tensors they pin."""
        for p in self.programs.values():
            p.clear()
        self.programs.clear()

    def all_to_all(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        """Dense tiled all_to_all on axis 0: each [size * m] tensor is
        `size` blocks of m, and receiver j gets block j of every sender,
        in sender order. On one device it is the transpose of the
        [sender, receiver] blocks: one copy of the data, not size^2."""
        n = self.size
        m = xs[0].shape[0] // n
        out = xs[0].new_empty(n, n, m)  # [receiver, sender, m]
        for i, x in enumerate(xs):
            out[:, i] = x.view(n, m)
        return list(out.view(n, n * m).unbind(0))

    def ragged_all_to_all(self, cols: list[list[torch.Tensor]],
                          send_counts: list[torch.Tensor], m: int,
                          out_len: int) -> list[list[torch.Tensor]]:
        """cols[i] are sender i's columns in the [size * m] layout of
        all_to_all, block j holding send_counts[i][j] live rows at its
        start. Receiver j gets, per column, the live rows of every sender
        in sender order, zero after, in an [out_len] buffer. Only live
        rows move; the counts come to the host once (one sync)."""
        n = self.size
        counts = torch.stack(send_counts).tolist()  # [sender][receiver]
        out = []
        for j in range(n):
            total = sum(counts[i][j] for i in range(n))
            recv = []
            for c in range(len(cols[0])):
                buf = cols[0][c].new_zeros(out_len)
                torch.cat([cols[i][c][j * m:j * m + counts[i][j]] for i in range(n)],
                          out=buf[:total])
                recv.append(buf)
            out.append(recv)
        return out

    def all_gather(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        """Tiled all_gather: every shard gets the concatenation in shard
        order (one tensor, shared by all shards: callers do not write
        into it)."""
        g = torch.cat(xs)
        return [g] * self.size

    def psum(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        s = torch.stack(xs).sum(0, dtype=xs[0].dtype)
        return [s] * self.size

    def pmax(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        s = torch.stack(xs).amax(0)
        return [s] * self.size

    def ring_shift(self, xs: list[torch.Tensor], t: int) -> list[torch.Tensor]:
        """Hop t of the ring: shard j's tensor goes to shard (j - t) mod
        size (tpq's ppermute with perm [(j, j - t)]); no copy on one
        device."""
        n = self.size
        return [xs[(i + t) % n] for i in range(n)]


def make_mesh(n_shards: int, device="cuda") -> LocalMesh:
    """A one-process mesh of n_shards shards on `device` (the card
    unless the caller names another)."""
    return LocalMesh(n_shards, device)
