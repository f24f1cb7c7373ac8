"""End-to-end distributed hash join (port of tpq/dist/dist_join.py).

partition by owner -> (skew split) -> shuffle exchange (chunked) ->
local join, the body written once over the mesh interface of mesh.py:
every local step runs on each shard this process holds, every
collective goes through the mesh. tpq's body is one shard_map; here it
is a loop over the held shards between collectives, so the same code
runs n shards on one card (LocalMesh) or one shard per rank
(ProcessGroupMesh). Results stay row-sharded on the producing shard.

DistTable is the sharded twin of Table: the list of the shards this
process holds, in mesh order.

Compiled form. tpq runs the body as one shard_map program, compiled for
each static set (tpq/dist/dist_join.py:136-137). On a LocalMesh the port
runs it through tpq_torch.jit: one jitted callable per static set (the
capacities, algo, exchange and local impl, chunks, skew config, lane
depth, key), all closed over, never passed as traced numbers, kept by
the mesh until `mesh.clear()` (a CUDA graph on the card, the body itself
on the CPU). Its results are handed over (jit's `hand_off`): they hold
until the next call of the same static set on the mesh. The planner
reads the host twice (tpq's :298, :324), so it stays an eager step
before the jitted body. `eager=True` runs the body without a graph: the
form whose kernel launches can be counted and held, as a replay runs no
Python wrapper. On a ProcessGroupMesh the body always runs eagerly (its
ragged exchange reads split sizes on the host, multihost.py), chosen by
the mesh type before any capture.

Spans and counters (tpq_torch.trace). The body's top-level spans tile
it: tpq.dist.skew (the split, with its heavy joins), tpq.dist.route (the
owners and destination columns), tpq.dist.exchange (bucketing and the
collective, once for R and once for each chunk of S or for all of the
ring's hops), each shard's own lane spans (tpq.lane.build, .layout,
.emit; the sorted local join's tpq.union_join), and tpq.dist.merge
(each shard's concat and compact, the overflow all_gather). It observes
tpq.dist.exchange_rows (the live rows its exchanges deliver),
tpq.dist.exchange_slots (the slots of the tables they fill) and
tpq.dist.overflow (the overflow vector's sum). The eager planner is the
span tpq.dist.plan, its figures in the body's record
(dist_hash_join_planned).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from time import perf_counter_ns

import numpy as np
import torch

from tpq_torch.columnar import Table, next_pow2
from tpq_torch.dist.exchange import exchange, ring_hops
from tpq_torch.dist.mesh import owner_of
from tpq_torch.dist.overlap import chunk_table, concat_tables
from tpq_torch.dist.skew import (I64_MAX, _count_keys_in, detect_heavy_keys,
                                 is_key_in, replicate_rows)
from tpq_torch.jit import Jitted, jit, observe
from tpq_torch.kernels import radix_partition
from tpq_torch.kernels.lane2 import (build_lane2_tables, lane2_probe_emit,
                                     plan_lane2)
from tpq_torch.ops import hash_join, merge_join
from tpq_torch.ops.filter import compact
from tpq_torch.trace import attached, span

I32 = torch.int32
I64 = torch.int64


@dataclass(frozen=True)
class SkewConfig:
    """Skew knobs: candidate nomination width, global heaviness threshold
    (rows across both sides), replica capacity per shard."""

    candidates_per_shard: int = 16
    threshold: int = 1 << 12
    replica_capacity_per_shard: int = 1 << 12


@dataclass
class DistTable:
    """Row-sharded table: the shards this process holds (all of them on a
    LocalMesh, its own on a process group), each of local_capacity
    rows."""

    shards: list[Table]

    @property
    def local_capacity(self) -> int:
        return self.shards[0].capacity

    @property
    def shard_rows(self) -> torch.Tensor:
        """int32[held shards]: live rows per shard."""
        return torch.stack([t.num_rows for t in self.shards])

    @classmethod
    def from_numpy(cls, cols: dict[str, np.ndarray], mesh) -> "DistTable":
        """tpq's placement of host columns (from_columns)."""
        return cls.from_columns({k: torch.from_numpy(np.asarray(v)) for k, v in cols.items()},
                                mesh)

    @classmethod
    def from_columns(cls, cols: dict[str, torch.Tensor], mesh) -> "DistTable":
        """tpq's placement of live columns: per = ceil(n / nchips) rows per
        shard, local_capacity = next_pow2(per), shard i holds rows
        [i*per, (i+1)*per), zero past them; this process places the
        shards it holds on mesh.device, wherever the columns are."""
        nchips = mesh.size
        n = next(iter(cols.values())).shape[0]
        per = (n + nchips - 1) // nchips
        local_cap = next_pow2(per)
        shards = []
        for i in mesh.shard_ids:
            cnt = max(0, min(per, n - i * per))
            part = {}
            for k, v in cols.items():
                buf = torch.zeros(local_cap, dtype=v.dtype, device=mesh.device)
                buf[:cnt] = v[i * per:i * per + cnt]
                part[k] = buf
            shards.append(Table(part, cnt))
        return cls(shards)

    def shards_numpy(self) -> list[dict[str, np.ndarray]]:
        """The live rows of each held shard (a device sync)."""
        return [t.to_numpy() for t in self.shards]

    def to_numpy(self) -> dict[str, np.ndarray]:
        """Concatenate the live rows of the held shards in shard order."""
        parts = self.shards_numpy()
        return {n: np.concatenate([p[n] for p in parts]) for n in parts[0]}


def _local_join(algo: str, r: Table, s: Table, cap: int, key: str) -> Table:
    if algo == "hash":
        return hash_join(r, s, cap, key=key, impl="sorted")
    return merge_join(r, s, cap, key=key)


def _sorted_keys(t: Table, key: str) -> torch.Tensor:
    return torch.sort(torch.where(t.valid_mask(), t.col(key).to(I64), I64_MAX)).values


def dist_hash_join(
    r: DistTable,
    s: DistTable,
    mesh,
    out_capacity_per_shard: int,
    exchange_capacity: int | None = None,
    algo: str = "hash",
    exchange_impl: str = "dense",
    key: str = "key",
    skew: SkewConfig | None = None,
    n_chunks: int = 1,
    local_impl: str = "sorted",
    lane_depth: int = 48,
    eager: bool = False,
) -> tuple[DistTable, torch.Tensor]:
    """Distributed inner equi-join. Returns (row-sharded result, overflow
    counts int32[nchips] of every shard, the same on every process —
    nonzero means a shard's exchange bucket, skew replica, or join output
    overflowed and capacities must be renegotiated).

    local_impl="lane" builds R's lane table once per shard after its
    exchange and probes it per ring hop / chunk; lane static-capacity
    violations count as overflow. Requires algo="hash".

    On a LocalMesh the body runs jitted (jitted_join; module docstring),
    unless `eager`."""
    statics = dict(out_capacity_per_shard=out_capacity_per_shard,
                   exchange_capacity=exchange_capacity, algo=algo,
                   exchange_impl=exchange_impl, key=key, skew=skew, n_chunks=n_chunks,
                   local_impl=local_impl, lane_depth=lane_depth)
    if eager or mesh.programs is None:
        return _join_body(r, s, mesh, **statics)
    return jitted_join(mesh, **statics)(r, s)


def jitted_join(mesh, **statics) -> Jitted:
    """The jitted body of one static set on a LocalMesh (dist_hash_join's
    keyword arguments but `eager`), made at its first use and kept by
    the mesh until mesh.clear(): tpq's shard_map program."""
    k = tuple(sorted(statics.items()))
    if k not in mesh.programs:
        mesh.programs[k] = jit(functools.partial(_join_body, mesh=mesh, **statics),
                               hand_off=True)
    return mesh.programs[k]


def _join_body(r: DistTable, s: DistTable, mesh, out_capacity_per_shard: int,
               exchange_capacity: int | None, algo: str, exchange_impl: str, key: str,
               skew: SkewConfig | None, n_chunks: int, local_impl: str,
               lane_depth: int) -> tuple[DistTable, torch.Tensor]:
    """dist_hash_join's body, eager: makes no host read, so that a CUDA
    graph holds it."""
    nchips = mesh.size
    out_cap = out_capacity_per_shard
    ex_cap = exchange_capacity or max(128, next_pow2(2 * r.local_capacity // max(1, nchips) * 2))
    assert out_cap % n_chunks == 0
    use_lane = algo == "hash" and local_impl == "lane"
    if local_impl not in ("sorted", "lane"):
        raise ValueError(f"unknown local_impl {local_impl!r}")

    R, S = r.shards, s.shards
    held = range(len(R))
    dev = R[0].device
    # what the exchanges deliver: live rows (0-d tensors) and bucket slots
    delivered, slots = [], 0

    def exchanged(tables):
        nonlocal slots
        delivered.append(torch.stack([t.num_rows for t in tables]).sum(dtype=I64))
        slots += sum(t.capacity for t in tables)

    r_heavy = s_heavy = heavy_out = None
    overflow = [torch.zeros((), dtype=I32, device=dev) for _ in held]
    if skew is not None:
        with span("tpq.dist.skew"):
            heavy_keys, _ = detect_heavy_keys(
                [_sorted_keys(t, key) for t in R], [t.num_rows for t in R],
                [_sorted_keys(t, key) for t in S], [t.num_rows for t in S], mesh,
                skew.candidates_per_shard, skew.threshold)
            r_heavy = [is_key_in(t.col(key), h) & t.valid_mask()
                       for t, h in zip(R, heavy_keys)]
            s_heavy = [is_key_in(t.col(key), h) & t.valid_mask()
                       for t, h in zip(S, heavy_keys)]
            # heavy build rows -> replicated everywhere; heavy probe rows
            # stay local; the pair is emitted on the probe row's home shard
            R_rep, rep_ovf = replicate_rows(R, r_heavy, mesh,
                                            skew.replica_capacity_per_shard)
            heavy_out = [_local_join(algo, rr, compact(t, m), out_cap, key)
                         for rr, t, m in zip(R_rep, S, s_heavy)]
            overflow = [o + ro + (h.num_rows > out_cap).to(I32)
                        for o, ro, h in zip(overflow, rep_ovf, heavy_out)]

    def dests(tables, heavy):
        """Each row's owner; the heavy rows' the sentinel nchips, which
        keeps them out of the buckets (so does bucket_by_dest for the
        padding rows)."""
        own = [owner_of(t.col(key), nchips) for t in tables]
        return own if heavy is None else [torch.where(h, nchips, d)
                                          for d, h in zip(own, heavy)]

    # light path: hash exchange (heavy rows diverted out of the buckets)
    with span("tpq.dist.route"):
        dest_r, dest_s = dests(R, r_heavy), dests(S, s_heavy)
        if exchange_impl != "ring":
            s_chunks = [chunk_table(t, n_chunks) for t in S]
            d_chunks = [chunk_table(Table({"d": d}, t.num_rows), n_chunks)
                        for t, d in zip(S, dest_s)]
    with span("tpq.dist.exchange"):
        R2, r_ovf = exchange(R, dest_r, mesh, nchips, ex_cap,
                             impl="dense" if exchange_impl == "ring" else exchange_impl)
        overflow = [o + x for o, x in zip(overflow, r_ovf)]
        exchanged(R2)

    if use_lane:
        # build ONCE per shard; every hop/chunk below only probes. lane_depth
        # is a renegotiable static capacity: un-split heavy build keys
        # overflow bucket depth, which no output capacity can absorb
        probe_cap_in = ex_cap if exchange_impl == "ring" else nchips * ex_cap
        lane_plan = plan_lane2(R2[0].capacity, probe_cap_in, depth=lane_depth,
                               out_capacity=out_cap)
        lane_tables = [build_lane2_tables(t, lane_plan, key) for t in R2]
        lane_rnames = [n for n in R2[0].names if n != key]
        lane_rdtypes = [R2[0].col(n).dtype for n in lane_rnames]
        R2 = None  # the tables hold R's rows now

    def light_join(i: int, S2: Table, cap: int):
        """Per-hop/chunk local join of shard i; lane violations count as
        overflow (num_rows stays the true total, so the overflow
        arithmetic below keeps working)."""
        if use_lane:
            out_c, ok = lane2_probe_emit(lane_tables[i], S2, cap, key,
                                         lane_rnames, lane_rdtypes)
            return out_c, (~ok).to(I32)
        return _local_join(algo, R2[i], S2, cap, key), torch.zeros((), dtype=I32, device=dev)

    outs = [[] for _ in held]
    out_shards = [None for _ in held]

    def add_light(i: int, S2: Table, cap: int):
        out_c, lane_ovf = light_join(i, S2, cap)
        overflow[i] = overflow[i] + lane_ovf + (out_c.num_rows > out_c.capacity).to(I32)
        outs[i].append(Table(out_c.columns, out_c.num_rows.clamp_max(out_c.capacity)))

    def merge(i: int):
        """Shard i's result: its chunks' or hops' rows, then its heavy
        rows, compacted into one Table of out_cap rows."""
        if heavy_out is not None:
            h = heavy_out[i]
            outs[i].append(Table(h.columns, h.num_rows.clamp_max(out_cap)))
        merged, valid = concat_tables(outs[i])
        outs[i] = None
        # compact against the slot mask, not merged.num_rows: valid rows
        # are scattered per chunk, so a prefix mask must not apply
        out = compact(Table(merged.columns, merged.capacity), valid)
        # overflow MUST be read off the pre-clamp row count: with_capacity
        # clamps num_rows (the silent row loss tests/test_dist.py:161 guards)
        overflow[i] = overflow[i] + (out.num_rows > out_cap).to(I32)
        res = out.with_capacity(out_cap)
        if out.capacity > out_cap:
            # a slice would keep the whole merge buffer (the ring's hops
            # and the skew split's heavy rows make it 2 x out_cap): copy
            res = Table({n: c.clone() for n, c in res.columns.items()}, res.num_rows)
        out_shards[i] = res

    if exchange_impl == "ring":
        # the hop-pipelined ring: S arrives one ring hop at a time
        hop_cap = next_pow2(max(128, 2 * out_cap // nchips))
        with span("tpq.dist.exchange"):
            hops = ring_hops(S, dest_s, mesh, nchips, ex_cap)
            for hop, hop_ovf in hops:
                overflow = [o + x for o, x in zip(overflow, hop_ovf)]
                exchanged(hop)
        # shard by shard (the same rows and overflow as hop by hop): one
        # shard's hop outputs are held at a time, not every shard's (at
        # hop_cap each, twice out_cap a shard), and a shard's R rows are
        # freed once it is merged (XLA frees by liveness)
        for i in held:
            for hop, _ in hops:
                add_light(i, hop[i], hop_cap)
            with span("tpq.dist.merge"):
                merge(i)
            if use_lane:
                lane_tables[i] = None
            else:
                R2[i] = None
        del hops, hop  # S's buckets: every hop is a view of them
    else:
        chunk_cap = out_cap // n_chunks
        for c in range(n_chunks):
            with span("tpq.dist.exchange"):
                S2, s_ovf = exchange([ch[c] for ch in s_chunks],
                                     [dch[c].col("d") for dch in d_chunks],
                                     mesh, nchips, ex_cap, impl=exchange_impl)
                overflow = [o + x for o, x in zip(overflow, s_ovf)]
                exchanged(S2)
            for i in held:
                add_light(i, S2[i], chunk_cap)
                # shard i's exchanged rows are dead once joined: free them
                # before the next shard's join (XLA frees by liveness)
                S2[i] = None
                if R2 is not None and c == n_chunks - 1:
                    R2[i] = None
        lane_tables = None  # R's rows, dead once every chunk is joined
    with span("tpq.dist.merge"):
        if exchange_impl != "ring":
            for i in held:
                merge(i)
        ovf = mesh.all_gather([o.reshape(1) for o in overflow])[0]
        observe("tpq.dist.exchange_rows", torch.stack(delivered).sum())
        observe("tpq.dist.exchange_slots", torch.full((), slots, dtype=I64, device=dev))
        observe("tpq.dist.overflow", ovf.sum(dtype=I64))
    return DistTable(out_shards), ovf


def plan_dist_capacities(
    r: DistTable,
    s: DistTable,
    mesh,
    key: str = "key",
    safety: float = 1.25,
) -> tuple[int, int]:
    """Exact capacity planning for the distributed join, from two passes
    over KEYS ONLY:
      1. per-(sender, destination) row counts by `radix_histogram`
         (kernel 5, two launches per shard) -> exchange bucket capacity =
         max over senders and destinations;
      2. a keys-only exchange at that capacity, then the exact per-owner
         join cardinality sum_k cnt_R(k)*cnt_S(k) (sorted counts, no
         scatter) -> output capacity per shard.
    Returns (exchange_capacity, out_capacity_per_shard), each padded by
    `safety` and rounded to a power of two. The same on every process.
    `.host_reads` counts its reads of the host (two a call)."""
    nchips = mesh.size

    def dests(t: Table) -> torch.Tensor:
        # the sentinel id nchips takes the padding rows
        return torch.where(t.valid_mask(), owner_of(t.col(key), nchips), nchips)

    peaks = []
    for R, S in zip(r.shards, s.shards):
        # resolved at call time, so that a caller may wrap the kernel
        hists = [radix_partition.radix_histogram(dests(t), nchips + 1) for t in (R, S)]
        peaks.append(torch.maximum(hists[0][:nchips].max(), hists[1][:nchips].max()))
    plan_dist_capacities.host_reads += 1
    per_bucket = int(mesh.pmax(peaks)[0])
    ex_cap = next_pow2(max(128, int(per_bucket * safety)))

    def keys_to_me(d: DistTable):
        tabs = [Table({key: t.col(key)}, t.num_rows) for t in d.shards]
        return exchange(tabs, [dests(t) for t in tabs], mesh, nchips, ex_cap,
                        impl="dense")

    R2, r_ovf = keys_to_me(r)
    S2, s_ovf = keys_to_me(s)
    totals = []
    for R, S, ro, so in zip(R2, S2, r_ovf, s_ovf):
        cnt_s = _count_keys_in(_sorted_keys(S, key), S.num_rows, _sorted_keys(R, key))
        total = torch.where(R.valid_mask(), cnt_s, 0).sum(dtype=I64)
        totals.append(torch.maximum(total, (ro + so).to(I64)))
    plan_dist_capacities.host_reads += 1
    per_out = int(mesh.pmax(totals)[0])
    out_cap = next_pow2(max(256, int(per_out * safety)))
    return ex_cap, out_cap


plan_dist_capacities.host_reads = 0


def dist_hash_join_planned(
    r: DistTable,
    s: DistTable,
    mesh,
    key: str = "key",
    **kwargs,
) -> tuple[DistTable, torch.Tensor]:
    """Distributed join with capacities planned exactly from the data
    (plan_dist_capacities, eager: two host reads) instead of
    caller-supplied guesses, then dist_hash_join at the planned
    capacities (jitted on a LocalMesh unless `eager=True`). The plan is
    the span tpq.dist.plan; its host ms (its last host read ends its
    device work), host reads and capacities go into the body's record as
    "plan" (trace.attached)."""
    t0, reads = perf_counter_ns(), plan_dist_capacities.host_reads
    with span("tpq.dist.plan"):
        ex_cap, out_cap = plan_dist_capacities(r, s, mesh, key=key)
    plan = {"ms": (perf_counter_ns() - t0) / 1e6,
            "host_reads": plan_dist_capacities.host_reads - reads,
            "exchange_capacity": ex_cap, "out_capacity_per_shard": out_cap}
    with attached(plan=plan):
        return dist_hash_join(r, s, mesh, out_capacity_per_shard=out_cap,
                              exchange_capacity=ex_cap, key=key, **kwargs)


def dist_hash_join_renegotiated(
    r: DistTable,
    s: DistTable,
    mesh,
    out_capacity_per_shard: int,
    exchange_capacity: int | None = None,
    max_retries: int = 6,
    **kwargs,
) -> tuple[DistTable, int]:
    """Distributed join under the renegotiation contract: run, read the
    overflow vector back, and if any shard's exchange bucket, replica
    buffer or join output overflowed, re-run with every static capacity
    grown: output and exchange capacity and replica capacity doubled,
    lane depth by half. Returns (result, retries_used). Each attempt goes
    through dist_hash_join: its capacities are another static set, so on
    a LocalMesh another jitted body (tpq compiles each attempt)."""
    out_cap = out_capacity_per_shard
    ex_cap = exchange_capacity
    skew = kwargs.get("skew")
    for attempt in range(max_retries + 1):
        out, overflow = dist_hash_join(
            r, s, mesh, out_capacity_per_shard=out_cap,
            exchange_capacity=ex_cap, **kwargs)
        if int(overflow.sum()) == 0:
            return out, attempt
        out_cap *= 2
        if ex_cap is not None:
            ex_cap *= 2
        # every static capacity grows, including the lane bucket depth: a
        # heavy un-split build key overflows depth, not output space
        kwargs["lane_depth"] = (kwargs.get("lane_depth", 48) * 3 + 1) // 2
        if skew is not None:
            kwargs["skew"] = skew = SkewConfig(
                candidates_per_shard=skew.candidates_per_shard,
                threshold=skew.threshold,
                replica_capacity_per_shard=2 * skew.replica_capacity_per_shard)
    raise RuntimeError(
        f"distributed renegotiation failed after {max_retries} retries "
        f"(last out_capacity_per_shard {out_cap // 2})")
