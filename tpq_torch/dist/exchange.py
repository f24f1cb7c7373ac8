"""Distributed shuffle exchange (port of tpq/dist/exchange.py).

tpq's fallback ladder, all semantically identical, on the port's mesh
interface (mesh.py):
  1. ragged all-to-all: exact row counts on the wire;
  2. dense all-to-all with per-destination padding (the default);
  3. the ring: one hop per ring step, the overlap-friendly variant.

Where tpq's functions run inside a shard_map body on the local shard and
take the mesh axis name, the port's take the list of the shards this
process holds (`tables`, `dests`) and the mesh in the axis's place, and
return lists.
"""

from __future__ import annotations

import torch

from tpq_torch.columnar import Table
from tpq_torch.ops.filter import compact

I32 = torch.int32
I64 = torch.int64


def bucket_by_dest(table: Table, dest: torch.Tensor, nbuckets: int,
                   bucket_capacity: int):
    """Scatter local rows into a [nbuckets * bucket_capacity] send layout,
    rows of bucket d contiguous at d*bucket_capacity, stable within a
    bucket. Returns (bucketed_cols, counts int32[nbuckets], overflow
    int32). tpq's optimization_barrier keeps XLA's producers out of its
    sort; eager torch has none to fence."""
    cap, dev = table.capacity, table.device
    dest = torch.where(table.valid_mask(), dest.to(I32), nbuckets)  # pads to sentinel
    dest_sorted, order = torch.sort(dest, stable=True)
    d64 = dest_sorted.to(I64)
    live = dest_sorted < nbuckets
    # tpq's segment_sum of the live flags: on the sorted ids, bucket b
    # starts where a searchsorted puts b (a scatter-add into nbuckets + 1
    # bins serializes on a few addresses: 12 ms per 2^24-row shard on an
    # H100 80GB HBM3, PERF.md); starts[nbuckets] is the end of the live rows
    starts = torch.searchsorted(
        dest_sorted, torch.arange(nbuckets + 1, dtype=I32, device=dev))
    pos = torch.arange(cap, dtype=I64, device=dev) - starts[d64]
    in_range = live & (pos < bucket_capacity)
    overflow = (live & ~in_range).sum(dtype=I32)
    slots = nbuckets * bucket_capacity
    # torch has no scatter drop mode: dropped rows go to one extra slot
    # past the layout, cut off after
    flat = torch.where(in_range, d64 * bucket_capacity + pos, slots)
    out_cols = {}
    for name, col in table.columns.items():
        buf = col.new_zeros(slots + 1)
        buf[flat] = col[order]
        out_cols[name] = buf[:slots]
    counts = torch.diff(starts).clamp_max(bucket_capacity).to(I32)
    return out_cols, counts, overflow


def _bucket_all(tables, dests, nchips, bucket_capacity):
    return [bucket_by_dest(t, d, nchips, bucket_capacity)
            for t, d in zip(tables, dests)]


def _slot_valid(counts: torch.Tensor, bucket_capacity: int) -> torch.Tensor:
    """bool[len(counts) * bucket_capacity]: slot s of block b is live iff
    s < counts[b]."""
    s = torch.arange(bucket_capacity, dtype=I32, device=counts.device)
    return (s[None, :] < counts[:, None]).reshape(-1)


def exchange_dense(tables, dests, mesh, nchips: int, bucket_capacity: int):
    """Dense all_to_all exchange. Returns (per shard, the Table of received
    rows with capacity nchips*bucket_capacity; per shard, the send
    overflow)."""
    parts = _bucket_all(tables, dests, nchips, bucket_capacity)
    names = tables[0].names
    recv_counts = mesh.all_to_all([c for _, c, _ in parts])
    recv = {n: mesh.all_to_all([cols[n] for cols, _, _ in parts]) for n in names}
    overflow = [o for _, _, o in parts]
    del parts
    out = []
    for i, rc in enumerate(recv_counts):
        received = Table({n: recv[n][i] for n in names}, nchips * bucket_capacity)
        out.append(compact(received, _slot_valid(rc, bucket_capacity)))
    return out, overflow


def exchange_ragged(tables, dests, mesh, nchips: int, bucket_capacity: int):
    """Ragged exchange: only live rows move, received rows packed in
    sender order with num_rows their total. tpq ships 32-bit planes (XLA
    has no 64-bit ragged all-to-all); the port moves int64 columns
    whole."""
    parts = _bucket_all(tables, dests, nchips, bucket_capacity)
    names = tables[0].names
    send_counts = [c for _, c, _ in parts]
    recv_sizes = mesh.all_to_all(send_counts)
    moved = mesh.ragged_all_to_all([[cols[n] for n in names] for cols, _, _ in parts],
                                   send_counts, bucket_capacity,
                                   nchips * bucket_capacity)
    out = [Table(dict(zip(names, cols)), rs.sum(dtype=I32))
           for cols, rs in zip(moved, recv_sizes)]
    return out, [o for _, _, o in parts]


def ring_hops(tables, dests, mesh, nchips: int, bucket_capacity: int):
    """The ring exchange, hop by hop: hop t moves exactly the rows that
    are t ring steps from home, so a consumer can join hop t-1's rows
    while hop t moves. Returns nchips (per-shard bucket Tables, per-shard
    overflow) pairs: hop 0 is the local bucket, hop t > 0 arrives from
    ring predecessor i + t."""
    bc = bucket_capacity
    parts = _bucket_all(tables, dests, nchips, bc)
    names = tables[0].names

    def bucket_for(offset: int):
        """Each shard's bucket destined for shard (me + offset) % nchips."""
        cols, cnts = [], []
        for me, (b, counts, _) in zip(mesh.shard_ids, parts):
            j = (me + offset) % nchips
            cols.append({n: c[j * bc:(j + 1) * bc] for n, c in b.items()})
            cnts.append(counts[j])
        return cols, cnts

    local_cols, local_cnt = bucket_for(0)
    hops = [([Table(c, n) for c, n in zip(local_cols, local_cnt)],
             [o for _, _, o in parts])]
    zero = [torch.zeros((), dtype=I32, device=o.device) for _, _, o in parts]
    for t in range(1, nchips):
        # receiver i's hop-t bucket lives on shard i + t: every shard sends
        # its bucket destined for its t-step ring predecessor me - t
        send_cols, send_cnt = bucket_for((nchips - t) % nchips)
        recv = {n: mesh.ring_shift([c[n] for c in send_cols], t) for n in names}
        recv_cnt = mesh.ring_shift(send_cnt, t)
        hops.append(([Table({n: recv[n][i] for n in names}, recv_cnt[i])
                      for i in range(len(parts))], zero))
    return hops


def exchange_ring(tables, dests, mesh, nchips: int, bucket_capacity: int):
    """Ring exchange materialized to one received Table per shard (same
    contract as exchange_dense); the hop-level `ring_hops` is what the
    overlapped join consumes."""
    hops = ring_hops(tables, dests, mesh, nchips, bucket_capacity)
    out = []
    for i in range(len(tables)):
        hop_tables = [h[i] for h, _ in hops]
        cols = {n: torch.cat([h.columns[n] for h in hop_tables])
                for n in hop_tables[0].names}
        cnts = torch.stack([h.num_rows for h in hop_tables])
        received = Table(cols, nchips * bucket_capacity)
        out.append(compact(received, _slot_valid(cnts, bucket_capacity)))
    return out, hops[0][1]


def exchange(tables, dests, mesh, nchips: int, bucket_capacity: int,
             impl: str = "dense"):
    if impl == "dense":
        return exchange_dense(tables, dests, mesh, nchips, bucket_capacity)
    if impl == "ragged":
        return exchange_ragged(tables, dests, mesh, nchips, bucket_capacity)
    if impl == "ring":
        return exchange_ring(tables, dests, mesh, nchips, bucket_capacity)
    raise ValueError(f"unknown exchange impl {impl!r}")
