#!/usr/bin/env python3
"""Smoke check of tpq_torch on one NVIDIA card (no JAX needed).

Phases, one line each; any failure raises and exits non-zero:
  1. device   — a CUDA card is required; prints nvidia-smi's name and
                power limit;
  2. build    — nvcc builds the kernels from tpq_torch/csrc, one process
                per source, all started together;
  3. kernels  — every kernel on the very arguments its paths hand it,
                byte-equal to its plain torch version and timed beside
                it and, where one exists, beside the one PyTorch call
                that computes the same function; each kernel twice: back
                to back (`ms`, host and card together) and on the card
                alone (`device_ms`, calls queued behind a spin of the
                stream so that the host runs ahead): PAD, PACK and the fused
                walk/emit at config 1, the walk/emit also at each
                work-item size (queries per CTA); the walk-only probe at
                config 3's membership and at config 1's tables (one
                payload), each also at every work-item size; the
                fused walk/emit at config 3's heavy mini table; the
                digit split (JSON name split1) at one pass of the
                config-1 radix merge's sort and over the whole sort
                (every pass held), then the sort at digit widths 4 to 8;
                the u32 key hash at config 1's build keys (bucket ids
                and h2, both salts), also held to numpy's twin on a
                sample; the probe layout kernel at config 1's call
                against its plain version, the sort path, in turns; the
                lane build kernel the same way at config 1's build and
                the skew split's heavy mini table (one partition, D 64),
                and later at config 4's dimension table and config 5's
                largest shard; after config 2, the two-level probe
                layout at config 2's call (2^27 rows, 100M live, four
                payloads, 8,192 partitions) against the sort path, and
                later at config 5's largest shard;
  4. config1  — the 1M x 1M uniform join, hash_join(impl="lane"): one
                join with every launch count zeroed just before it and
                read just after (PAD, PACK, the fused walk/emit, the
                probe layout and the lane build launched, nothing else;
                no hash), num_rows
                equal to numpy's count and the rows byte-equal to the
                C++ oracle; then the bench
                runner: the lane path taken, end-to-end ms, rows/s and
                the per-phase breakdown, the runner's figure beside
                bench.profile's end to end;
  5. config3  — the 1M x 1M zipf-probe join, hash_join(impl="skew"), the
                same way: PAD, PACK, the fused walk/emit, the probe
                kernel, the probe layout, the lane build (3 times) and
                the hash (3 times) launched,
                rows byte-equal
                to the oracle, the split path taken (`join_hash_skew`);
                its heavy rows against
                the heavy buffer (out_capacity // 2, past which the join
                falls back); heavy keys and their share of the probe rows;
  6. merge    — merge_join(sort_engine="radix") at config 1, the same
                way: one split launch per digit pass of its 66 bit specs
                (9 at 8 bits a pass) and no other kernel,
                rows byte-equal to the oracle's merge join; end-to-end ms
                beside the lax engine;
  7. fallback — an h2-colliding key pair clears the lane join's `ok`, and
                all-equal keys the skew join's; each equals the sorted
                join;
  7b. jit     — configs 1 and 3, the radix merge and smoke_pipeline as the
                bench runner jits them (tpq_torch/jit.py: one CUDA graph
                per signature, replayed in one launch): each body once
                with the capture flag set under
                torch.cuda.set_sync_debug_mode("error") (no host read);
                the first jitted call (capture and replay) and a replay on
                a second seed each equal to the C++ oracle, one graph, no
                rerun; smoke_pipeline also at a second filter value; a
                profiled replay launching the same port kernels, by name
                and count, as an eager call of the same body (its
                wrappers' launch counts);
                end-to-end ms eager and jitted in turns (eager, jitted,
                jitted, eager); then, by bench.profile in turns (end to
                end, device busy, idle share): pipeline_100m jitted
                against eager, after a second call on the same tensors
                copied nothing in, with jitted busy over eager busy (the
                sorts' device copies); config 3's shape with impl="lane" (ok
                false: one rerun, then the fallback path's graph, rows
                equal to the oracle); the h2-colliding pair over three
                calls, each equal to the oracle, the second and third
                replaying the fallback path's graph with no kernel wrapper
                run and no rerun;
  8. dryrun   — tpq_torch.dist.dryrun_multichip(8) on the card: the
                chunked+skew, ring+skew and dense+lane+skew variants, each
                62,545 rows byte-equal to the C++ oracle; then the
                dense+lane+skew variant through the process-group mesh as
                a one-rank NCCL group (localhost), its rows equal to the
                one-process mesh's;
 9. config4  — the filter -> hash join -> hash aggregate pipeline:
                smoke_pipeline through full_pipeline(algo="hash") with the
                lane and the sorted join, each byte-equal to the C++
                oracle's filter | join | aggregate; then pipeline_100m
                unchunked through the bench runner's pipeline (dim 2^20
                rows, fact 100,000,000 rows with 2 payloads, filter key <
                2^19, out capacity 2^27): one pipeline with every launch
                count zeroed just before it and read just after (PAD,
                PACK once (the lane tail's), the fused walk/emit, the
                probe layout, the lane build and the aggregate's group
                table pass and
                write (once each) launched, nothing else), the lane
                pushdown path taken, every group's key, count and sums
                equal to numpy's; the pipeline once more with every call
                of those kernels held, as it is made, byte-equal to its
                plain version; the fused walk/emit's call timed, the
                probe layout at its call (2^27 rows into 201,326,592
                slots) beside the sort path, the hash over the 201,326,592
                padded probe keys (the sort path's second hash),
                PACK at the lane tail's call, the group table's pass and
                write at the aggregate's call (2^27 rows, 331,291 groups)
                beside their plain twins and the whole hash path in turns
                with the sort path it replaced (byte-equal over the whole
                capacity), and the run-end pass at the sort path's call
                beside its plain version and, in turns, the sequence
                before it (the plain version with the PACK kernel);
                end-to-end ms, fact rows/s, groups, join rows and peak
                memory;
 10. config4_chunked — scale_bench.bench_pipeline at 100M fact rows in
                chunks of 2^22 on the device streams: first one eager run
                off the clock with every PAD, PACK, walk/emit, hash and
                run-end call held byte-equal to its plain version, as many
                calls as the code makes (SCALE_LAUNCHES); then eager, jitted
                staged, jitted fused, jitted fused, jitted staged, eager,
                each with its chunk loop profiled (busy ms, idle share):
                every group exact against numpy, every chunk on the lane
                path; the first eager run's timed loop counted (exactly
                SCALE_LAUNCHES' launches for its chunks and finalize);
                jitted, one graph a program, no rerun, no capture in the
                loops, no tensor copied in (the chunk programs hand their
                outputs over, the accumulator is updated in place), loop
                busy against eager busy, and the replayed
                loop's port kernels equal to the eager loop's by name and
                count; the dense accumulator's PAD call (its last) timed
                beside index_copy_, and the run-end pass at a full
                chunk's call beside its plain version and the sequence
                before it;
 11. config2  — scale_bench.bench_build_sweep, 10M x 100M with 4 payloads
                in chunks of 2^24, held, then eager, jitted, jitted,
                eager, checked the same way: the count exact against
                numpy's, every chunk on the lane path;
 12. entry    — tpq_torch.query.entry() on the card, byte-equal to the
                oracle's filter | join | aggregate at its shapes;
 13. config5  — dist_125m_8shard, eight shards on the card: the
                histogram kernel at the arguments plan_dist_capacities
                hands it (all 16 calls byte-equal to the plain version,
                the first timed); dist_hash_join_planned(local_impl=
                "lane") with every launch count zeroed just before and
                read just after (the histogram twice per shard, PAD,
                PACK, the fused walk/emit, the lane build and the
                two-level probe layout 8 times each and the hash 48
                times, nothing else), overflow zero,
                num_rows equal to numpy's count, four key-range slices
                byte-equal to the oracle; the join once more with every
                call of those seven kernels held, as it is made, byte-equal
                to its plain version on the same inputs (the sizes past
                2^31 that no CPU test reaches); PAD, PACK, the fused
                walk/emit, the hash, the lane build and the two-level
                layout timed at their largest call of that join
                (`config5_largest` in their records); then the
                planned join with its body jitted (jitted_dist_join): the
                body once under the capture flag with sync debug mode
                error (no host read), the first jitted call and a replay
                each held like the eager join (overflow, count, key
                ranges) and to its checksum, one capture and no rerun,
                peak allocated and reserved eager and jitted under 70 GB,
                a replay's port kernels equal to an eager call's, eager
                and jitted in turns; planning, body eager and body jitted
                ms apart; the multiset checksum equal to the single-card
                lane join's;
 14. scaling  — the weak-scaling bench (bench.scaling) at 2^24 rows a
                shard on 1, 2, 4 and 8 shards of the card: one join at 8
                shards (134M x 134M) counted (the hash and PACK launched,
                nothing else) and held, then jitted against eager
                (jitted_dist_join, as config 5), then the bench jitted:
                every size's overflow zero and num_rows equal to a count
                made without the join, each record naming its one-card
                local mesh and its one capture and no rerun;
 15. overlap  — the overlap matrix (bench.overlap_bench) at 8 shards of
                2^24 rows: dense in 1 and 4 chunks and the ring's hops,
                counted and held (dense_4chunks, ring_hops), each variant
                jitted against eager (jitted_dist_join), then the matrix
                jitted, each variant's num_rows equal to the dense one's.
The line before the last is the kernels' JSON record: `launches` is the
sum over the paths (config 1, config 3, the radix merge, config 4's
pipeline, config 4 chunked, config 2, config 5, the scaling bench's join,
the overlap matrix's two counted joins) of the launches in their one
counted join, pipeline or timed chunk loop, and `launches_per_join`
gives them path by path. The last line is {"ok": true, "device": {...}}.

Run from the repository root:  python3 chip_smoke.py
"""

import functools
import importlib
import inspect
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
ORACLE_DIR = os.path.join(ROOT, "oracle", "build")
# the least time of a kernel: its bytes over the H100 SXM's published
# 3.35 TB/s, or its 64-bit compares over the 67 T/s float32 rate outside
# the tensor cores (the table has no integer rate; a higher rate only
# lowers the bound). Each kernel line also prints the byte bound at the
# copy rate measured in this run.
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def max_abs_err(pairs) -> int:
    """Largest |a - b| over integer tensor pairs: 0 only when byte-equal
    (the difference is taken in int64, not in a double, which would round
    away small differences of 64-bit values; one past int64 wraps, but
    never to 0)."""
    err = 0
    for a, b in pairs:
        check(a.dtype == b.dtype and a.shape == b.shape,
              f"dtype/shape {a.dtype}{tuple(a.shape)} vs {b.dtype}{tuple(b.shape)}")
        if not torch.equal(a, b):
            d = (a.long() - b.long()).abs()
            d = torch.where(d < 0, torch.iinfo(torch.int64).max, d)  # |INT64_MIN|
            err = max(err, int(d.max()))
    return err


def with_wrappers_replaced(run, replace):
    """Runs `run()` with each kernel wrapper of the ported paths (and
    lsd_radix_sort_bits, for its whole-sort check), as the modules of
    the paths name it, replaced by replace(name, wrapper)."""
    from tpq_torch.bench import scale_bench
    from tpq_torch.dist import mesh
    from tpq_torch.kernels import lane2, lane_table, radix_partition, radix_sort
    from tpq_torch.ops import filter as filter_op
    from tpq_torch.ops import skew_join

    # the module (tpq_torch.ops exports the function under its name)
    hash_aggregate = importlib.import_module("tpq_torch.ops.hash_aggregate")
    patched = [(lane_table, "pad"), (lane_table, "pack"), (skew_join, "pack"),
               (lane_table, "probe_layout"), (lane_table, "probe_layout_two_level"),
               (lane_table, "lane_build"),
               (scale_bench, "pad"), (hash_aggregate, "aggregate_runs"),
               (hash_aggregate, "group_insert"), (hash_aggregate, "group_write"),
               (filter_op, "pack"), (lane2, "fused_walk_emit"),
               (lane_table, "probe_walk"), (radix_sort, "split_digit"),
               (radix_sort, "lsd_radix_sort_bits"),
               (radix_partition, "radix_histogram"), (lane_table, "hash_keys"),
               (mesh, "hash_keys")]
    saved = [getattr(m, n) for m, n in patched]
    for (m, n), fn in zip(patched, saved):
        setattr(m, n, replace(n, fn))
    try:
        run()
    finally:
        for (m, n), fn in zip(patched, saved):
            setattr(m, n, fn)


def positional(fn, args, kwargs) -> tuple:
    """A call's arguments as one positional tuple (owner_of passes the
    hash's salt by keyword)."""
    return inspect.signature(fn).bind(*args, **kwargs).args


def record_kernel_calls(run):
    """Runs `run()` with the kernel wrappers replaced by recorders;
    returns {wrapper name: [args, ...]} of what they received."""
    calls = {}

    def recorder(name, fn):
        # wraps copies `launches`: while patched, a wrapper's body counts
        # through its module-global name, which may be this recorder
        @functools.wraps(fn)
        def rec(*args, **kwargs):
            args = positional(fn, args, kwargs)
            calls.setdefault(name, []).append(args)
            return fn(*args)
        return rec

    with_wrappers_replaced(run, recorder)
    return calls


def pad_err(args, got) -> int:
    from tpq_torch.kernels.move import pad_ref

    want = pad_ref(*args)
    return max_abs_err(list(zip(got[0], want[0])) + [(got[1], want[1])])


def pack_err(args, got) -> int:
    from tpq_torch.kernels.move import pack_ref

    want = pack_ref(*args)
    return max_abs_err(list(zip(got[0], want[0])) + [(got[1], want[1])])


def fused_err(args, got) -> int:
    """Over cnt, d_first and the emitted rows (the slots past them are
    unspecified)."""
    from tpq_torch.kernels.lane2 import fused_walk_emit_ref

    outs, cnt, d_first = got
    routs, rcnt, rdf = fused_walk_emit_ref(*args)
    n = min(int(cnt.clamp_max(args[0].plan.inline_k).sum()), args[-1])
    return max_abs_err([(cnt, rcnt), (d_first, rdf)]
                       + [(a[:n], b[:n]) for a, b in zip(outs, routs)])


def probe_err(args, got) -> int:
    from tpq_torch.kernels.lane_table import probe_walk_ref

    (cnt, df, pays), (rcnt, rdf, rpays) = got, probe_walk_ref(*args)
    return max_abs_err([(cnt, rcnt), (df, rdf)]
                       + [(a, b) for row, rrow in zip(pays, rpays)
                          for a, b in zip(row, rrow)])


def hist_err(args, got) -> int:
    from tpq_torch.kernels.radix_partition import radix_histogram_ref

    return max_abs_err([(got, radix_histogram_ref(*args))])


def hash_err(args, got) -> int:
    from tpq_torch.hashing import hash_keys_ref

    return max_abs_err([(got, hash_keys_ref(*args))])


def agg_err(args, got) -> int:
    """Over every output slot (zeros past the groups) and the group count."""
    from tpq_torch.kernels.aggregate import aggregate_runs_ref

    want = aggregate_runs_ref(*args)
    return max_abs_err(list(zip(got[0], want[0])) + [(got[1], want[1])])


def insert_err(args, got) -> int:
    """The group table's pass: its slots follow the hash and the order of
    the atomics, so it is held by what the write makes of it, every
    output slot and the group count, against the twin's table, with
    `ok` and the distinct count."""
    from tpq_torch.kernels.group_table import group_insert_ref, group_write_ref

    want = group_insert_ref(*args)
    pairs = [(got.ok, want.ok), (got.inserted, want.inserted)]
    if bool(want.ok):
        a, b = group_write_ref(got), group_write_ref(want)
        pairs += list(zip(a[0], b[0])) + [(a[1], b[1])]
    return max_abs_err(pairs)


def write_err(args, got) -> int:
    """The group write over every output slot and the group count."""
    from tpq_torch.kernels.group_table import group_write_ref

    want = group_write_ref(*args)
    return max_abs_err(list(zip(got[0], want[0])) + [(got[1], want[1])])


def layout_err(args, got) -> int:
    """The layout against its plain version run on plain torch alone: the
    hash and PAD it calls through lane_table's names (which a holder may
    have replaced by its own) are their plain versions meanwhile."""
    from tpq_torch.hashing import hash_keys_ref
    from tpq_torch.kernels import lane_table
    from tpq_torch.kernels.move import pad_ref

    saved = lane_table.hash_keys, lane_table.pad
    lane_table.hash_keys, lane_table.pad = hash_keys_ref, pad_ref
    try:
        want = lane_table.probe_layout_ref(*args)
    finally:
        lane_table.hash_keys, lane_table.pad = saved
    (qk, pays, lane, qocc, ovf), (wqk, wpays, wlane, wqocc, wovf) = got, want
    check(len(pays) == len(wpays), "probe_layout: payload columns")
    return max_abs_err(list(zip([qk, *pays, lane, qocc, ovf], [wqk, *wpays, wlane, wqocc, wovf])))


def build_err(args, got) -> int:
    """The build kernel against its plain version (the sort path) run on
    plain torch alone, as layout_err runs the layout's: `ok` and blen
    always, and every slot of the tiles where `ok` is true; where it is
    false (a bucket past D, whose rows are unspecified, or an h2 hazard)
    the buckets of fewer than D rows."""
    from tpq_torch.hashing import hash_keys_ref
    from tpq_torch.kernels import lane_table
    from tpq_torch.kernels.move import pad_ref

    saved = lane_table.hash_keys, lane_table.pad
    lane_table.hash_keys, lane_table.pad = hash_keys_ref, pad_ref
    try:
        want = lane_table.build_lane_tables_ref(*args)
    finally:
        lane_table.hash_keys, lane_table.pad = saved
    check(len(got.pays) == len(want.pays), "lane_build: payload columns")
    pairs = [(got.ok, want.ok), (got.blen, want.blen)]
    tiles = list(zip([got.key, *got.pays, got.occ], [want.key, *want.pays, want.occ]))
    if bool(want.ok):
        return max_abs_err(pairs + tiles)
    lanes = (want.blen < want.plan.depth).unsqueeze(1).expand_as(want.occ)
    return max_abs_err(pairs + [(a[lanes], b[lanes]) for a, b in tiles])


ERRS = {"pad": pad_err, "pack": pack_err, "fused_walk_emit": fused_err,
        "radix_histogram": hist_err, "hash_keys": hash_err, "aggregate_runs": agg_err,
        "group_insert": insert_err, "group_write": write_err, "probe_layout": layout_err,
        "probe_layout_two_level": layout_err, "lane_build": build_err}


# kept at their largest call
LARGEST = ("pad", "pack", "fused_walk_emit", "hash_keys", "aggregate_runs", "group_insert",
           "probe_layout", "probe_layout_two_level", "lane_build")


def call_size(name, args) -> int:
    """What picks a join's largest call: PAD's and PACK's output slots
    times row width, the walk/emit's padded queries, the hash's keys, the
    aggregate's rows, the layout's padded slots, the build's tile slots,
    the histogram's ids."""
    if name in ("hash_keys", "aggregate_runs", "group_insert"):
        return args[0].numel()
    if name in ("probe_layout", "probe_layout_two_level"):
        return args[0].npart * args[0].probe_cap
    if name == "lane_build":
        return args[1].nbuckets * args[1].depth
    if name == "pad":
        return args[3] * sum(c.element_size() for c in args[0])
    if name == "pack":
        return args[1].shape[0] * sum(c.element_size() for c in args[0])
    return args[1].shape[0] if name == "fused_walk_emit" else args[0].shape[0]


def hold_kernel_calls(run, keep=LARGEST):
    """Runs `run()` with every call of PAD, PACK, the fused walk/emit, the
    histogram, the hash, the aggregate's run-end pass, its group table,
    the probe layout and the lane build held, as it is made, against the plain version on
    the same inputs; the walk/emit is
    also timed on the card alone at every call. The plain version's buffers go back to the card after each
    check, so that they do not split the memory the run itself needs.
    Returns ({name: (calls, largest max_abs_err)}, {name in `keep`: the
    arguments of its largest call}, [device ms of each walk/emit
    call])."""
    from tpq_torch.bench.runner import device_time

    held, largest, times = {}, {}, []

    def holder(name, fn):
        if name not in ERRS:
            return fn

        @functools.wraps(fn)
        def hold(*args, **kwargs):
            args = positional(fn, args, kwargs)
            got = fn(*args)
            if name == "fused_walk_emit":
                times.append(device_time(lambda: fn(*args), args[1].device, 3)[0] * 1e3)
            n, err = held.get(name, (0, 0))
            held[name] = (n + 1, max(err, ERRS[name](args, got)))
            torch.cuda.empty_cache()
            if name in keep and (name not in largest or call_size(
                    name, args) > call_size(name, largest[name])):
                largest[name] = args
            return got
        return hold

    with_wrappers_replaced(run, holder)
    return held, largest, times


# hash_keys launches of one join or pipeline, from the code: the build
# kernel (lane_build) hashes inside, a probe layout on its sort path
# (plans past LAYOUT2_MAX_PARTS partitions) twice (bucket, lane of the
# padded keys), an identity layout once, the layout kernels (configs 1,
# 3 and 4: 512 partitions, one level; config 5's shards: 16,384, two)
# never. Config 3: both memberships (1 each) and the heavy mini table's
# identity layout (1). Config 5, per shard: owner_of twice for the
# planner's histograms, twice for its keys-only exchange and twice for
# the join's.
HASH_LAUNCHES = {"config1": 0, "config3": 3, "merge": 0, "config4": 0, "dist": 8 * 6}

# Launches of one 8-shard join of the dist benches (the sorted local
# join, which launches no kernel), from the code. Per shard: owner_of
# for R and S (hash); PACK once for R's dense exchange, once per chunk
# of S's dense exchange (the ring's hops are not compacted) and once for
# the output.
DIST_BENCH_LAUNCHES = {
    "scaling": {"hash_keys": 8 * 2, "pack": 8 * 3},
    "overlap_dense_4chunks": {"hash_keys": 8 * 2, "pack": 8 * (1 + 4 + 1)},
    "overlap_ring_hops": {"hash_keys": 8 * 2, "pack": 8 * 2},
}


def bound(nbytes: int, ops: int = 0):
    """(bound ms, "bytes" or "operations")."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / ALU_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def walk_work(tables, lane, qocc):
    """The key compares a walk over these queries does: the bucket
    length of each live query."""
    plan = tables.plan
    p = torch.arange(lane.shape[0], device=lane.device) // plan.probe_cap
    blen = tables.blen[p, lane.long()]
    return int(torch.where(qocc > 0, blen, 0).sum())


class Kernels:
    """Collects each kernel's record for the JSON line."""

    def __init__(self, dev, hbm_bw, iters=20):
        from tpq_torch.bench.runner import cuda_time, device_time

        self.dev, self.hbm_bw, self.iters = dev, hbm_bw, iters
        self.cuda_time, self.device_time = cuda_time, device_time
        self.rec = {}

    def ms(self, fn, n):
        """Back-to-back ms per call, host and card together: where the host
        takes longer to queue a call than the card to run it, the host's."""
        return self.cuda_time(fn, self.dev, n)[0] * 1e3

    def device_ms(self, fn, n):
        """The card's ms per call, the host ahead of it (runner.device_time)."""
        return self.device_time(fn, self.dev, n)[0] * 1e3

    def paired(self, kernel, plain, n_plain):
        """(kernel ms, plain ms), each the mean of two timings taken in
        turns: plain, kernel, kernel, plain."""
        p1, k1, k2, p2 = (self.ms(plain, n_plain), self.ms(kernel, self.iters),
                          self.ms(kernel, self.iters), self.ms(plain, n_plain))
        return (k1 + k2) / 2, (p1 + p2) / 2

    def hold(self, name, label, kernel, plain, n_plain, err, nbytes, ops=0,
             library=None, record=True, n_device=None):
        """Checks a kernel's max_abs_err, times it, prints its line and
        returns its record (kept as the kernel's JSON record if `record`).
        `n_device` calls are queued for the device time (default `iters`):
        fewer where one call launches many kernels, since the card's launch
        queue stops the host once about a thousand wait."""
        check(err == 0, f"{name} ({label}) differs from its plain version")
        t_k, t_p = self.paired(kernel, plain, n_plain)
        t_d = self.device_ms(kernel, n_device or self.iters)
        t_l = self.ms(library, self.iters) if library is not None else None
        t_b, by = bound(nbytes, ops)
        lib = f"{t_l:.4f} ms" if t_l is not None else "none"
        t_m = nbytes / (self.hbm_bw * 1e9) * 1e3
        phase("kernels", f"{name} ({label}): max_abs_err {err}; kernel {t_k:.4f} ms, "
                         f"device {t_d:.4f} ms, plain {t_p:.4f} ms, library {lib}, "
                         f"bound {t_b:.4f} ms ({by}: {nbytes} B, {ops} ops; bytes at "
                         f"the measured {self.hbm_bw:.1f} GB/s {t_m:.4f} ms)")
        rec = {"call": label, "max_abs_err": err, "ms": t_k, "device_ms": t_d,
               "plain_ms": t_p, "bound_ms": t_b, "bound_by": by, "library_ms": t_l}
        if record:
            self.rec[name] = rec
        return rec


def pad_yardsticks(args):
    """(bytes, library call) of a PAD call: the bytes it must move (dest
    of the live prefix read once, the landing rows of each column read
    once, every slot of each column and of occ written once) and
    index_copy_ into zeroed buffers, which computes the same."""
    cols, dest, n_live, out_len = args
    n = dest.shape[0]
    live = ((torch.arange(n, device=dest.device) < n_live)
            & (dest >= 0) & (dest < out_len))
    idx = dest[live].long()
    vals = [c[live] for c in cols]
    esz = sum(c.element_size() for c in cols)

    def library():
        outs = [torch.zeros(out_len, dtype=v.dtype,
                            device=v.device).index_copy_(0, idx, v) for v in vals]
        return outs, torch.zeros(out_len, dtype=torch.int32,
                                 device=idx.device).index_fill_(0, idx, 1)

    return min(int(n_live), n) * 4 + idx.numel() * esz + out_len * (esz + 4), library


def pack_yardsticks(args, total):
    """(bytes, library call) of a PACK call: occ read once, the live rows
    of each column read once, every output slot and `total` written once;
    a boolean-mask index of each column, which computes the live rows."""
    cols, occ = args
    keep = occ != 0
    esz = sum(c.element_size() for c in cols)
    n = occ.shape[0]
    return n * 4 + total * esz + n * esz + 4, lambda: [c[keep] for c in cols]


def agg_yardsticks(args) -> tuple[int, int]:
    """(bytes, valid rows) of a run-end pass: the valid rows of the key
    and values read once, every output slot and the group count written
    once."""
    key, values, num_rows = args
    n = key.shape[0]
    live = max(0, min(int(num_rows), n))
    row = key.element_size() + sum(v.element_size() for v in values)
    return live * row + n * (key.element_size() + 8 * (1 + len(values))) + 4, live


def agg_phase(K, args, label, record):
    """The aggregate's run-end kernel at one call, against its plain
    version; then in turns against the aggregate's sequence before it
    (the plain version with the PACK kernel, `before_ms`); no library
    call computes the same."""
    from tpq_torch.kernels.aggregate import aggregate_runs, aggregate_runs_ref
    from tpq_torch.kernels.move import pack

    key, values, _ = args
    got = aggregate_runs(*args)
    groups = int(got[1])
    nbytes, live = agg_yardsticks(args)
    rec = K.hold("aggregate_runs", f"{label}: key + {len(values)} values x "
                                   f"{key.shape[0]} rows, {live} valid, {groups} groups",
                 lambda: aggregate_runs(*args), lambda: aggregate_runs_ref(*args), 3,
                 agg_err(args, got), nbytes, ops=live, record=record)
    before = functools.partial(aggregate_runs_ref, *args, pack=pack)
    b = before()
    check(max_abs_err(list(zip(got[0], b[0])) + [(got[1], b[1])]) == 0,
          f"aggregate_runs ({label}): the sequence with PACK differs")
    del b, got
    t_k, t_b = K.paired(lambda: aggregate_runs(*args), before, 3)
    rec.update(groups=groups, before_ms=t_b, before_device_ms=K.device_ms(before, 3),
               ms_beside_before=t_k)
    phase("kernels", f"aggregate_runs ({label}): in turns with the sequence before it "
                     f"(plain + PACK kernel) {t_k:.4f} ms against {t_b:.4f} ms; that "
                     f"sequence on the card alone {rec['before_device_ms']:.4f} ms")
    torch.cuda.empty_cache()
    return rec


def sorted_args(args):
    """The run-end pass's call on the sort path of the aggregate whose
    group table takes `args` (key, values, num_rows)."""
    from tpq_torch import Table
    from tpq_torch.ops.merge_join import sort_table_by_key

    key, values, num_rows = args
    names = [f"v{i}" for i in range(len(values))]
    ts = sort_table_by_key(Table({"key": key, **dict(zip(names, values))}, num_rows))
    return ts.col("key"), [ts.col(n) for n in names], ts.num_rows


def group_phase(K, args, groups):
    """The group table's pass and write at the aggregate's call, each
    against its plain twin; hash_aggregate byte-equal to the sort path it
    replaced (sort_aggregate) over the whole capacity, then the hash
    path's pass and write in turns with the sort path. The two kernels
    share the aggregate's least bytes (agg_yardsticks): the pass's bound
    is the live rows read, the write's every output slot written."""
    from tpq_torch import Table
    from tpq_torch.kernels.group_table import (group_insert, group_insert_ref, group_write,
                                               group_write_ref)
    from tpq_torch.ops.hash_aggregate import hash_aggregate, sort_aggregate

    key, values, num_rows = args
    table = group_insert(*args)
    check(bool(table.ok) and int(table.inserted) == groups,
          f"the group table at config 4: ok {bool(table.ok)}, {int(table.inserted)} keys")
    nbytes, live = agg_yardsticks(args)
    read = live * (key.element_size() + sum(v.element_size() for v in values))
    label = (f"config-4 aggregate: key + {len(values)} values x {key.shape[0]} rows, "
             f"{live} live, {groups} groups")
    rec = K.hold("group_insert", label, lambda: group_insert(*args),
                 lambda: group_insert_ref(*args), 3, insert_err(args, table), read)
    K.hold("group_write", label, lambda: group_write(table), lambda: group_write_ref(table),
           3, write_err((table,), group_write(table)), nbytes - read)
    t = Table({"key": key, **{f"v{i}": v for i, v in enumerate(values)}}, num_rows)
    by_hash, by_sort = hash_aggregate(t), sort_aggregate(t)
    check(max_abs_err([(by_hash.num_rows, by_sort.num_rows)]
                      + [(by_hash.columns[k], by_sort.columns[k]) for k in by_sort.columns])
          == 0, "config 4: the hash path's aggregate differs from the sort path's")
    del by_hash, by_sort
    torch.cuda.empty_cache()
    # the hash path's work without its cond, whose eager host read of `ok`
    # would keep the host from running ahead of the card
    def hash_path():
        return group_write(group_insert(*args))

    t_h, t_s = K.paired(hash_path, lambda: sort_aggregate(t), 3)
    t_b = bound(nbytes)[0]
    rec.update(groups=groups, hash_path_ms=t_h, hash_path_device_ms=K.device_ms(hash_path, 3),
               sort_path_ms=t_s, sort_path_device_ms=K.device_ms(lambda: sort_aggregate(t), 3),
               aggregate_bound_ms=t_b)
    phase("kernels", f"config-4 aggregate: hash path {t_h:.4f} ms against the sort path "
                     f"{t_s:.4f} ms in turns (byte-equal over the whole capacity); on the "
                     f"card alone {rec['hash_path_device_ms']:.4f} against "
                     f"{rec['sort_path_device_ms']:.4f} ms; bound {t_b:.4f} ms")
    del table, t
    torch.cuda.empty_cache()
    return rec


def pad_phase(K, args, label, record):
    from tpq_torch.kernels.move import pad, pad_ref

    cols, dest, _, out_len = args
    nbytes, library = pad_yardsticks(args)
    return K.hold("pad", f"{label}: {len(cols)} cols x {dest.shape[0]} rows -> {out_len}",
                  lambda: pad(*args), lambda: pad_ref(*args), 5,
                  pad_err(args, pad(*args)), nbytes, library=library, record=record)


def pack_phase(K, args, label, record):
    from tpq_torch.kernels.move import pack, pack_ref

    cols, occ = args
    got = pack(*args)
    total = int(got[1])
    nbytes, library = pack_yardsticks(args, total)
    return K.hold("pack", f"{label}: {len(cols)} col x {occ.shape[0]} rows, total {total}",
                  lambda: pack(*args), lambda: pack_ref(*args), 5, pack_err(args, got),
                  nbytes, library=library, record=record)


def layout_yardsticks(args) -> int:
    """The bytes a probe layout must move: the key, the payloads and keep
    read once, every slot of the key, the payloads, lane and qocc written
    once."""
    plan, s, key, keep = args
    n, u = s.capacity, plan.npart * plan.probe_cap
    ncols = len(s.names)
    return n * (8 * ncols + (1 if keep is not None else 0)) + u * (8 * ncols + 8)


def layout_phase(K, args, label, record):
    """The layout kernel at one call against its plain version, which is
    the sort path (tpq's stable sort and PAD, with the hash and PAD
    kernels), in turns."""
    from tpq_torch.kernels.lane_table import probe_layout, probe_layout_ref

    plan, s = args[0], args[1]
    got = probe_layout(*args)
    return K.hold("probe_layout", f"{label}: {s.capacity} rows, {len(s.names) - 1} "
                                  f"payloads -> {plan.npart} x {plan.probe_cap} slots",
                  lambda: probe_layout(*args), lambda: probe_layout_ref(*args), 5,
                  layout_err(args, got), layout_yardsticks(args), record=record)


def layout2_phase(K, args, label, record):
    """The two-level layout at one call against its plain version, the
    sort path (tpq's stable sort and PAD, with the hash and PAD kernels),
    in turns, back to back and on the card alone, against the bound of
    the bytes a layout must move (layout_yardsticks)."""
    from tpq_torch.kernels.lane_table import probe_layout_ref, probe_layout_two_level

    plan, s = args[0], args[1]
    got = probe_layout_two_level(*args)
    err = layout_err(args, got)
    del got
    torch.cuda.empty_cache()
    rec = K.hold("probe_layout_two_level",
                 f"{label}: {s.capacity} rows, {int(s.num_rows)} live, {len(s.names) - 1} "
                 f"payloads -> {plan.npart} x {plan.probe_cap} slots",
                 lambda: probe_layout_two_level(*args), lambda: probe_layout_ref(*args), 3,
                 err, layout_yardsticks(args), record=record, n_device=5)
    rec["sort_path_device_ms"] = K.device_ms(lambda: probe_layout_ref(*args), 3)
    phase("kernels", f"probe_layout_two_level ({label}): the sort path on the card alone "
                     f"{rec['sort_path_device_ms']:.4f} ms")
    torch.cuda.empty_cache()
    return rec


def sweep_layout_phase(dev, K):
    """The two-level layout at config 2's call in its benchmark cell: S of
    2^27 rows, 100,000,000 live, four payloads, the plan of 8,192
    partitions of 24,576 slots (the keys drawn uniform over int64: a
    partition's load is the hash's, as over the cell's keys)."""
    from tpq_torch import Table
    from tpq_torch.kernels.lane2 import plan_lane2

    plan = plan_lane2(10_000_000, 1 << 27, out_capacity=1 << 27)
    check((plan.npart, plan.probe_cap) == (8192, 24_576), f"config 2's plan {plan}")
    g = torch.Generator(device=dev).manual_seed(23)
    cols = {name: torch.randint(-(1 << 62), 1 << 62, (1 << 27,), generator=g, device=dev)
            for name in ("key", "p0", "p1", "p2", "p3")}
    s = Table(cols, torch.tensor(100_000_000, dtype=torch.int32, device=dev))
    layout2_phase(K, (plan, s, "key", None), "config 2's call", record=True)
    del s, cols
    torch.cuda.empty_cache()


def build_yardsticks(args) -> int:
    """The bytes a lane build must move: the live rows' key and payloads
    read once, every slot of the key, payload and occ tiles and every
    bucket length written once, and the ok flag."""
    r, plan, key = args
    live = max(0, min(int(r.num_rows), r.capacity))
    width = 8 * len(r.names)  # the key and the payloads, int64 on the tiles
    return live * width + plan.nbuckets * (plan.depth * (width + 4) + 4) + 1


def build_phase(K, args, label, record):
    """The build kernel at one call against its plain version, which is
    the sort path (the composite sort, gathers, PAD and transposes, with
    the hash and PAD kernels), in turns."""
    from tpq_torch.kernels.lane_table import build_lane_tables_ref, lane_build

    r, plan = args[0], args[1]
    got = lane_build(*args)
    return K.hold("lane_build", f"{label}: {int(r.num_rows)} of {r.capacity} rows, "
                                f"{len(r.names) - 1} payloads -> {plan.npart} x "
                                f"{plan.depth} x 128 slots",
                  lambda: lane_build(*args), lambda: build_lane_tables_ref(*args), 5,
                  build_err(args, got), build_yardsticks(args), record=record)


def hash_phase(K, args, label, record):
    """The hash at one call: byte-equal to its plain chain and, on a
    sample of 65,536 keys or fewer, to numpy's twin; bound by its 12
    bytes a key (the key read, the id written)."""
    from tpq_torch.hashing import hash_keys, hash_keys_ref, np_hash_keys

    keys, bits, salt = args
    got = hash_keys(*args)
    n = keys.numel()
    step = max(1, n // 65536)
    check(np.array_equal(got[::step].cpu().numpy(),
                         np_hash_keys(keys[::step].cpu().numpy(), bits, salt)),
          f"hash_keys ({label}) differs from np_hash_keys on a sample")
    return K.hold("hash_keys", f"{label}: {n} keys, bits {bits}, salt {salt:#x}",
                  lambda: hash_keys(*args), lambda: hash_keys_ref(*args), 3,
                  hash_err(args, got), n * 12, ops=13 * n, record=record)


def largest_call_phase(K, largest):
    """PAD, PACK, the fused walk/emit, the hash, the build and the
    two-level layout at their largest call of the planned config-5 join
    (the build's and the layout's: its largest shard), where the bytes they move, not the host, should set their
    time."""
    for name, timed in (("pad", pad_phase), ("pack", pack_phase),
                        ("fused_walk_emit", fused_phase), ("hash_keys", hash_phase),
                        ("lane_build", build_phase), ("probe_layout_two_level", layout2_phase)):
        K.rec[name]["config5_largest"] = timed(K, largest[name], "largest config-5 call",
                                               record=False)
        torch.cuda.empty_cache()
    K.rec["fused_walk_emit"]["config5_largest"]["device_ms_by_chunk"] = chunk_sweep(
        K, largest["fused_walk_emit"], "largest config-5 call")


def fused_phase(K, args, label, record):
    from tpq_torch.kernels.lane2 import fused_walk_emit, fused_walk_emit_ref

    tables, qk, lane, qocc, spays, cap = args
    plan = tables.plan
    got = fused_walk_emit(*args)
    err = fused_err(args, got)
    cnt = got[1]
    n = min(int(cnt.clamp_max(plan.inline_k).sum()), cap)
    u = qk.shape[0]
    nr, ns = len(tables.pays), len(spays)
    matched = int(((cnt > 0) & (qocc > 0)).sum())
    nbytes = (u * 16 + tables.key.numel() * 8 + tables.blen.numel() * 4
              + n * 8 * nr + matched * 8 * ns + u * 8 + n * 8 * (1 + nr + ns))
    return K.hold("fused_walk_emit",
                  f"{label}: npart {plan.npart}, D {plan.depth}, K {plan.inline_k}, "
                  f"u={u}, {n} inline rows of {cap}",
                  lambda: fused_walk_emit(*args), lambda: fused_walk_emit_ref(*args), 3,
                  err, nbytes, walk_work(tables, lane, qocc), record=record)


def chunk_sweep(K, args, label):
    """The fused walk/emit on the card alone at each size of its work
    items (padded queries per CTA), each output byte-equal to the size in
    use's; returns {queries: device ms}."""
    from tpq_torch.kernels import lane2

    plan = args[0].plan
    want, times, saved = lane2.fused_walk_emit(*args), {}, lane2.walk_emit_chunk
    n = min(int(want[1].clamp_max(plan.inline_k).sum()), args[-1])
    try:
        for c in (1024, 2048, 4096):
            lane2.walk_emit_chunk = lambda *_, c=c: min(c, plan.probe_cap)
            got = lane2.fused_walk_emit(*args)
            check(max_abs_err([(got[1], want[1]), (got[2], want[2])]
                              + [(a[:n], b[:n]) for a, b in zip(got[0], want[0])]) == 0,
                  f"fused_walk_emit ({label}) differs at {c} queries a work item")
            times[c] = K.device_ms(lambda: lane2.fused_walk_emit(*args), K.iters)
    finally:
        lane2.walk_emit_chunk = saved
    phase("kernels", f"fused_walk_emit ({label}) on the card alone by queries per work "
                     "item: " + ", ".join(f"{c} {t:.4f} ms" for c, t in times.items())
          + f"; in use {saved(plan, args[1].device.index)}")
    return times


def probe_phase(K, args, label, record):
    from tpq_torch.kernels.lane_table import probe_walk, probe_walk_ref

    tables, qk, lane, qocc = args
    plan = tables.plan
    got = probe_walk(*args)
    cnt, err = got[0], probe_err(args, got)
    u, npay = qk.shape[0], len(tables.pays)
    emitted = int(torch.where(qocc > 0, cnt.clamp_max(plan.inline_k), 0).sum())
    nbytes = (u * 16 + tables.key.numel() * 8 + tables.blen.numel() * 4
              + emitted * 8 * npay + u * 8 + plan.inline_k * npay * u * 8)
    return K.hold("probe_walk",
                  f"{label}: npart {plan.npart}, D {plan.depth}, K {plan.inline_k}, "
                  f"{npay} payload cols, u={u}, {int((cnt > 0).sum())} queries matched",
                  lambda: probe_walk(*args), lambda: probe_walk_ref(*args), 3, err,
                  nbytes, walk_work(tables, lane, qocc), record=record)


def probe_chunk_sweep(K, args, label):
    """The walk-only probe on the card alone at each size of its work
    items (padded queries per CTA), each output byte-equal to the plain
    version's; returns {queries: device ms}."""
    from tpq_torch.kernels import lane_table

    plan, times, saved = args[0].plan, {}, lane_table.probe_walk_chunk
    try:
        for c in sorted({min(c, plan.probe_cap) for c in (1024, 2048, 4096, 8192)}):
            lane_table.probe_walk_chunk = lambda *_, c=c: c
            check(probe_err(args, lane_table.probe_walk(*args)) == 0,
                  f"probe_walk ({label}) differs at {c} queries a work item")
            times[c] = K.device_ms(lambda: lane_table.probe_walk(*args), K.iters)
    finally:
        lane_table.probe_walk_chunk = saved
    phase("kernels", f"probe_walk ({label}) on the card alone by queries per work "
                     "item: " + ", ".join(f"{c} {t:.4f} ms" for c, t in times.items())
          + f"; in use {saved(plan, args[1].device.index)}")
    return times


def digit_of(planes, specs):
    """The digit of a pass: bit b of plane pi is digit bit i (int64)."""
    d = torch.zeros(planes[0].shape[0], dtype=torch.int64, device=planes[0].device)
    for i, (pi, b) in enumerate(specs):
        d |= ((planes[pi].long() >> b) & 1) << i
    return d


def split_phase(K, calls):
    """The digit split at one pass of the radix merge's sort and over the
    whole sort, every pass held byte-equal to its plain version (the
    group's one-bit splits), then the sort timed at each digit width."""
    from tpq_torch.kernels import radix_sort
    from tpq_torch.ops.union_join import union_sort_specs

    (sort_args,) = calls["lsd_radix_sort_bits"]
    specs = list(sort_args[1])
    check(specs == union_sort_specs(64), "the merge's sort ran other bit specs")
    passes = radix_sort.digit_passes(len(specs))
    pass_calls = calls["split_digit"]
    check(len(pass_calls) == passes, f"{len(pass_calls)} digit passes, expected "
                                     f"{passes} for {len(specs)} specs")
    err = max(max_abs_err(list(zip(radix_sort.split_digit(*a),
                                   radix_sort.split_digit_ref(*a)))) for a in pass_calls)
    args = pass_calls[1]  # key bits 7..14
    planes, pspecs = args
    n, np_ = planes[0].shape[0], len(planes)
    digit = digit_of(planes, pspecs)

    def library():
        perm = torch.sort(digit, stable=True).indices
        return [p.index_select(0, perm) for p in planes]

    one_pass = 2 * np_ * n * 4  # every plane read once and written once
    K.hold("split1", f"pass 2 of {passes}: {np_} int32 planes x {n} rows, "
                     f"{len(pspecs)}-bit digit, {int(torch.unique(digit).numel())} "
                     f"digits taken (all {passes} passes checked)",
           lambda: radix_sort.split_digit(*args), lambda: radix_sort.split_digit_ref(*args),
           3, err, one_pass, library=library)

    # the 1-bit split on key bit 0 after the side split, the pass the
    # one-bit design timed, through _split1 (the kernel, 1-bit digit)
    planes1 = radix_sort.split_digit_ref(sort_args[0], specs[:1])
    bit = (planes1[specs[1][0]] >> specs[1][1]) & 1
    args1 = (planes1, bit)
    err = max_abs_err(list(zip(radix_sort._split1(*args1), radix_sort.split1_ref(*args1))))
    K.rec["split1"]["one_bit_pass"] = K.hold(
        "split1", f"_split1, the 1-bit pass 2 of {len(specs)} (key bit 0): {np_} planes x "
                  f"{n} rows, n0 {int((bit == 0).sum())}",
        lambda: radix_sort._split1(*args1), lambda: radix_sort.split1_ref(*args1), 3, err,
        one_pass + n * 4, record=False)

    # the whole sort: every pass on the kernel, then every pass on the
    # plain version (the module global swapped for the plain pass)
    def plain_sort():
        saved = radix_sort.split_digit
        radix_sort.split_digit = radix_sort.split_digit_ref
        try:
            return radix_sort.lsd_radix_sort_bits(*sort_args)
        finally:
            radix_sort.split_digit = saved

    got = radix_sort.lsd_radix_sort_bits(*sort_args)
    err = max_abs_err(list(zip(got, plain_sort())))
    K.rec["split1"]["whole_sort"] = K.hold(
        "split1", f"lsd_radix_sort_bits, all {passes} passes over {np_} planes",
        lambda: radix_sort.lsd_radix_sort_bits(*sort_args), plain_sort, 2, err,
        passes * one_pass, record=False, n_device=5)

    # the sort at each digit width, byte-equal to the default's output
    widths = {}
    for w in range(4, radix_sort.MAX_DIGIT_BITS + 1):
        out = radix_sort.lsd_radix_sort_bits(*sort_args, digit_bits=w)
        check(max_abs_err(list(zip(out, got))) == 0, f"digit width {w} sorts otherwise")
        widths[w] = K.device_ms(
            lambda w=w: radix_sort.lsd_radix_sort_bits(*sort_args, digit_bits=w), 5)
    K.rec["split1"]["sort_device_ms_by_digit_bits"] = widths
    phase("kernels", "split1: whole sort on the card alone by digit width: " + ", ".join(
        f"{w} bits ({radix_sort.digit_passes(len(specs), w)} passes) {t:.4f} ms"
        for w, t in widths.items()) + f"; width in use {radix_sort.DIGIT_BITS}")


def kernel_phase(dev, cfg1, cfg3, hbm_bw):
    from tpq_torch.bench.runner import gen, out_capacity_for
    from tpq_torch.kernels.lane2 import build_lane2_tables, lane2_hash_join, plan_lane2
    from tpq_torch.kernels.lane_table import SALT_H2, SALT_LANE, probe_lane_tables
    from tpq_torch.ops import merge_join
    from tpq_torch.ops.skew_join import skew_hash_join

    K = Kernels(dev, hbm_bw)
    r1, s1 = gen(cfg1.r, dev), gen(cfg1.s, dev)
    cap1 = out_capacity_for(cfg1)
    calls = record_kernel_calls(lambda: lane2_hash_join(r1, s1, cap1))
    for _ in range(3):  # clocks and the caching allocator settle first
        lane2_hash_join(r1, s1, cap1)
    check(set(calls) == {"pad", "pack", "fused_walk_emit", "probe_layout", "lane_build"},
          f"config 1 reached kernels {sorted(calls)}")
    check(len(calls["pad"]) == 1, "expected the tail window's PAD call alone")
    (args,) = calls["lane_build"]
    build_phase(K, args, "config-1 build", record=True)
    # secondary entries: the two hashes of config 1's build keys that the
    # build's sort path makes (12.6 MB of keys and ids, in L2 between
    # timed calls); config 4's padded keys (config4_phase) give the
    # hash's main record
    rk = args[0].col("key")
    h_args, h2_args = (rk, args[1].pbits + 7, SALT_LANE), (rk, 32, SALT_H2)
    K.rec["hash_keys"] = {
        "config1_build": hash_phase(K, h_args, "config-1 build buckets", record=False),
        "config1_build_h2": hash_phase(K, h2_args, "config-1 build h2", record=False)}
    (args,) = calls["pad"]
    pad_phase(K, args, "tail window", record=True)
    (args,) = calls["probe_layout"]
    layout_phase(K, args, "config 1", record=True)
    (args,) = calls["pack"]
    pack_phase(K, args, "config-1 tail", record=True)
    (args,) = calls["fused_walk_emit"]
    fused_phase(K, args, "config 1", record=True)
    K.rec["fused_walk_emit"]["device_ms_by_chunk"] = chunk_sweep(K, args, "config 1")

    # the walk-only probe with a payload column: config 1's tables (D 48,
    # K 4) probed by config 1's S
    tables = build_lane2_tables(
        r1, plan_lane2(r1.capacity, s1.capacity, out_capacity=cap1))
    calls = record_kernel_calls(lambda: probe_lane_tables(tables, s1))
    (args,) = calls["probe_walk"]
    config1_tables = probe_phase(K, args, "config-1 tables, config-1 S", record=False)
    config1_tables["device_ms_by_chunk"] = probe_chunk_sweep(K, args, "config-1 tables")

    r3, s3 = gen(cfg3.r, dev), gen(cfg3.s, dev)
    cap3 = out_capacity_for(cfg3)
    calls = record_kernel_calls(lambda: skew_hash_join(r3, s3, cap3))
    check({"pad", "pack", "fused_walk_emit", "probe_walk"} <= set(calls),
          f"config 3 reached kernels {sorted(calls)}")
    check(len(calls["probe_walk"]) == 2, "expected the R and S membership probes")
    probe_phase(K, calls["probe_walk"][0], "config-3 membership of R", record=True)
    K.rec["probe_walk"]["device_ms_by_chunk"] = probe_chunk_sweep(
        K, calls["probe_walk"][0], "config-3 membership of R")
    K.rec["probe_walk"]["config1_tables"] = config1_tables
    heavy = [a for a in calls["fused_walk_emit"] if a[0].plan.npart == 1]
    check(len(heavy) == 1, "expected one heavy-path fused walk/emit")
    mini = [a for a in calls["lane_build"] if a[1].npart == 1 and a[1].depth == 64]
    check(len(calls["lane_build"]) == 3 and len(mini) == 1,
          "expected the list, heavy mini and light tables' builds")
    K.rec["lane_build"]["config3_mini"] = build_phase(K, mini[0], "config-3 heavy mini table",
                                                      record=False)
    K.rec["fused_walk_emit"]["config3_heavy"] = fused_phase(
        K, heavy[0], "config-3 heavy mini table", record=False)
    K.rec["fused_walk_emit"]["config3_heavy"]["device_ms_by_chunk"] = chunk_sweep(
        K, heavy[0], "config-3 heavy mini table")
    pack_phase(K, calls["pack"][0], "config-3 nomination", record=False)

    calls = record_kernel_calls(
        lambda: merge_join(r1, s1, cap1, sort_engine="radix"))
    split_phase(K, calls)
    return K


def hist_phase(K, calls, nshards):
    from tpq_torch.kernels import radix_partition as rp

    hist_calls = calls["radix_histogram"]
    check(len(hist_calls) == 2 * nshards,
          f"{len(hist_calls)} histogram calls in the planner, expected {2 * nshards}")
    err = max(hist_err(a, rp.radix_histogram(*a)) for a in hist_calls)
    args = hist_calls[0]  # shard 0, R's destinations
    ids, nb = args
    n = ids.shape[0]

    def library():
        return torch.bincount(torch.where((ids >= 0) & (ids < nb), ids, nb),
                              minlength=nb + 1)[:nb]

    K.hold("radix_histogram", f"planner, shard 0 of R: {n} ids into {nb} buckets "
                              f"(all {len(hist_calls)} calls checked)",
           lambda: rp.radix_histogram(*args), lambda: rp.radix_histogram_ref(*args),
           5, err, n * 4 + nb * 4, library=library)


def oracle_run(cmd, inputs: dict, **flags):
    """The C++ oracle's `cmd` on host columns (`inputs` by flag name);
    returns its output columns."""
    from tpq_torch import colio

    os.makedirs(ORACLE_DIR, exist_ok=True)
    exe = os.path.join(ORACLE_DIR, "oracle_smoke")
    if not os.path.exists(exe):
        subprocess.run(["g++", "-std=c++17", "-O2", "-o", exe,
                        os.path.join(ROOT, "oracle", "main.cc")], check=True)
    paths = {k: os.path.join(ORACLE_DIR, f"smoke_{k}.tpqc") for k in (*inputs, "out")}
    for k, cols in inputs.items():
        colio.dump(paths[k], cols)
    subprocess.run([exe, cmd] + [f"--{k}={v}" for k, v in flags.items()]
                   + [f"--{k}={p}" for k, p in paths.items()], check=True)
    out = colio.load(paths["out"])
    for p in paths.values():
        os.remove(p)
    return out


def oracle_rows(r_np, s_np, algo="hash"):
    """The C++ oracle's canonical join of the two relations."""
    return oracle_run("join", {"left": r_np, "right": s_np}, algo=algo)


def oracle_pipeline(dim_np, fact_np, value):
    """The C++ oracle's filter (key < value) | join | aggregate, chained
    as tests/test_query.py chains it."""
    fact_f = oracle_run("filter", {"in": fact_np}, col="key", op="lt", value=value)
    return oracle_run("aggregate", {"in": oracle_rows(dim_np, fact_f)})


def relations_np(cfg):
    from tpq_torch.bench.runner import gen_np

    return gen_np(cfg.r), gen_np(cfg.s)


def true_rows(cfg, r_np, s_np) -> int:
    return int((np.bincount(r_np["key"], minlength=cfg.r.nkeys).astype(np.int64)
                * np.bincount(s_np["key"], minlength=cfg.r.nkeys)).sum())


# PERF.md's limit on a path's peak device memory, 70 GB of the card's 80
PEAK_LIMIT = 70_000_000_000


def wrappers():
    """The kernel wrappers of the ported paths, by their JSON names."""
    from tpq_torch.hashing import hash_keys
    from tpq_torch.kernels.aggregate import aggregate_runs
    from tpq_torch.kernels.group_table import group_insert, group_write
    from tpq_torch.kernels.lane2 import fused_walk_emit
    from tpq_torch.kernels.lane_table import (lane_build, probe_layout, probe_layout_two_level,
                                              probe_walk)
    from tpq_torch.kernels.move import pack, pad
    from tpq_torch.kernels.radix_partition import radix_histogram
    from tpq_torch.kernels.radix_sort import split_digit

    return {"pad": pad, "pack": pack, "fused_walk_emit": fused_walk_emit,
            "probe_walk": probe_walk, "split1": split_digit,
            "radix_histogram": radix_histogram, "hash_keys": hash_keys,
            "aggregate_runs": aggregate_runs, "group_insert": group_insert,
            "group_write": group_write, "probe_layout": probe_layout,
            "probe_layout_two_level": probe_layout_two_level, "lane_build": lane_build}


def run_path(name, dev, cfg, expect, want_op, hbm_bw, oracle_algo="hash"):
    """One preset's join through its entry point, eager (a graph replay
    runs no Python wrapper to count), with every launch count zeroed just
    before it and read just after: the kernels in `expect` must have
    launched and no other. Its rows against numpy's count and the C++
    oracle; then the bench runner's timed (jitted) run and op label."""
    from tpq_torch.bench.runner import gen, join_fn, out_capacity_for, run_config
    from tpq_torch.columnar import canonicalize, tables_equal

    r, s = gen(cfg.r, dev), gen(cfg.s, dev)
    join = join_fn(cfg, r, s, out_capacity_for(cfg))
    ws = wrappers()
    for w in ws.values():
        w.launches = 0
    out = join.eager()
    launches = {k: w.launches for k, w in ws.items()}
    phase(name, f"one join: launches {launches}")
    check(all((v > 0) == (k in expect) for k, v in launches.items()),
          f"expected launches of exactly {sorted(expect)}: {launches}")
    check(launches["hash_keys"] == HASH_LAUNCHES[name],
          f"{launches['hash_keys']} hash launches, expected {HASH_LAUNCHES[name]}")

    r_np, s_np = relations_np(cfg)
    n = true_rows(cfg, r_np, s_np)
    check(int(out.num_rows) == n, f"num_rows {int(out.num_rows)} != numpy's {n}")
    check(tables_equal(canonicalize(out), oracle_rows(r_np, s_np, oracle_algo)),
          "output differs from the C++ oracle")
    phase(name, f"num_rows {n} == numpy count; canonical rows byte-equal to the "
                f"C++ oracle's {oracle_algo} join")

    report = run_config(cfg, hbm_bw=hbm_bw, device=dev)
    op = report["ops"][0]
    check(op["op"] == want_op, f"{want_op} not taken: {op['op']}")
    check(op["reruns"] == 0, f"{name}: a jitted call reran eagerly")
    phase(name, f"{op['op']}: end_to_end {op['elapsed_ms']:.4f} ms (jitted), "
                f"{op['rows_per_sec']:.6e} probe rows/s, measured HBM "
                f"{report['hbm_bw_gbps']:.1f} GB/s, roofline {op['roofline_pct']:.2f}% "
                f"(byte model {op['model_bytes']} B)")
    return launches, s_np, op


def config1_phase(dev, cfg, hbm_bw):
    """Config 1 through run_path, its phases, and the runner's figure
    beside bench.profile's end to end on the same join (3 warm-ups, 10
    calls), twice."""
    from tpq_torch.bench.profile import profile_join
    from tpq_torch.bench.runner import gen, join_fn, out_capacity_for, phase_report

    launches, _, op = run_path("config1", dev, cfg,
                               {"pad", "pack", "fused_walk_emit", "probe_layout",
                                "lane_build"},
                               "join_hash_lane", hbm_bw)
    phases = phase_report(cfg, device=dev)
    phase("config1", "phases (ms): " + ", ".join(
        f"{p['phase']} {p['ms']:.4f}" for p in phases))
    r, s = gen(cfg.r, dev), gen(cfg.s, dev)
    call = join_fn(cfg, r, s, out_capacity_for(cfg))
    prof = [profile_join(call, dev)["end_to_end_ms"] for _ in range(2)]
    call.jitted.clear()
    phase("config1", f"the runner's jitted figure {op['elapsed_ms']:.4f} ms ({cfg.iters} "
                     f"calls after the capture and {cfg.warmup} warm-up) beside "
                     f"bench.profile's end to end {prof[0]:.4f}, {prof[1]:.4f} ms")
    return launches


def config3_phase(dev, cfg, hbm_bw):
    from tpq_torch.bench.runner import gen
    from tpq_torch.ops import skew_join
    from tpq_torch.ops.skew_join import nominate_heavy_keys

    # the heavy output of the counted join's own split (the first call;
    # the bench runner's joins follow)
    split, heavy_outs = skew_join._split, []

    def recording_split(*args, **kwargs):
        light_out, heavy_out, ok = split(*args, **kwargs)
        if not heavy_outs:
            heavy_outs.append(heavy_out)
        return light_out, heavy_out, ok

    skew_join._split = recording_split
    try:
        launches, s_np, _ = run_path(
            "config3", dev, cfg,
            {"pad", "pack", "fused_walk_emit", "probe_walk", "hash_keys", "probe_layout",
             "lane_build"},
            "join_hash_skew", hbm_bw)
    finally:
        skew_join._split = split
    heavy_out = heavy_outs[0]
    phase("config3", f"heavy rows {int(heavy_out.num_rows)} of the heavy buffer's "
                     f"{heavy_out.capacity} (out_capacity // 2; more would send the "
                     f"join to the union engine)")
    s = gen(cfg.s, dev)
    heavy, n_heavy, _ = nominate_heavy_keys(s.col("key"), s.num_rows)
    heavy = heavy[:int(n_heavy)].cpu().numpy()
    share = float(np.isin(s_np["key"], heavy).mean())
    phase("config3", f"heavy keys {len(heavy)}, carrying {share:.4f} of the "
                     f"{len(s_np['key'])} probe rows")
    return launches


def merge_phase(dev, cfg, hbm_bw):
    from dataclasses import replace

    from tpq_torch.bench.runner import cuda_time, gen, out_capacity_for
    from tpq_torch.kernels.radix_sort import digit_passes
    from tpq_torch.ops import merge_join
    from tpq_torch.ops.union_join import union_sort_specs

    cfg = replace(cfg, join=replace(cfg.join, algo="merge", sort_engine="radix"))
    launches, _, _ = run_path("merge", dev, cfg, {"split1"}, "join_merge_radix", hbm_bw,
                           oracle_algo="merge")
    passes = digit_passes(len(union_sort_specs(64)))
    check(launches["split1"] == passes, f"split launched {launches['split1']} times, "
                                        f"expected {passes} digit passes")
    r, s = gen(cfg.r, dev), gen(cfg.s, dev)
    cap = out_capacity_for(cfg)
    t_lax1, t_rad1, t_rad2, t_lax2 = (
        cuda_time(lambda e=e: merge_join(r, s, cap, sort_engine=e), dev, 5)[0] * 1e3
        for e in ("lax", "radix", "radix", "lax"))
    phase("merge", f"end_to_end radix {(t_rad1 + t_rad2) / 2:.4f} ms "
                   f"({t_rad1:.4f}, {t_rad2:.4f}), lax {(t_lax1 + t_lax2) / 2:.4f} ms "
                   f"({t_lax1:.4f}, {t_lax2:.4f}), 5 joins each, in turns")
    return launches


def fallback_phase(dev):
    from tpq_torch import Table
    from tpq_torch.columnar import canonicalize, tables_equal
    from tpq_torch.kernels.lane2 import lane2_path_taken
    from tpq_torch.ops import hash_join
    from tpq_torch.ops.skew_join import skew_path_taken

    k1, k2 = 7302945295039616556, 3449075177175606448  # same (bucket, h2)
    R = Table.from_numpy({"key": np.array([k1, k2, 5, 6, 7], dtype=np.int64),
                          "p0": np.arange(5, dtype=np.int64)}, device=dev)
    S = Table.from_numpy({"key": np.array([k1, k2, k1, 6], dtype=np.int64),
                          "p0": np.arange(4, dtype=np.int64) * 10}, device=dev)
    check(not bool(lane2_path_taken(R, S, 1 << 8)), "h2 collision kept `ok`")
    a = hash_join(R, S, 1 << 8, impl="lane")
    b = hash_join(R, S, 1 << 8, impl="sorted")
    check(int(a.num_rows) == int(b.num_rows) == 4, "fallback row count")
    check(tables_equal(canonicalize(a), canonicalize(b)), "fallback rows differ")
    phase("fallback", "h2 collision: ok=False, lane join == sorted join (4 rows)")

    # one key on both sides: 128 build rows overflow the mini table's D 64
    R = Table.from_numpy({"key": np.full(128, 5, np.int64),
                          "p0": np.arange(128, dtype=np.int64)}, device=dev)
    S = Table.from_numpy({"key": np.full(512, 5, np.int64),
                          "p0": np.arange(512, dtype=np.int64)}, device=dev)
    check(not bool(skew_path_taken(R, S, 1 << 17)), "all-equal keys kept `ok`")
    a = hash_join(R, S, 1 << 17, impl="skew")
    b = hash_join(R, S, 1 << 17, impl="sorted")
    check(int(a.num_rows) == int(b.num_rows) == 128 * 512, "skew fallback row count")
    check(tables_equal(canonicalize(a), canonicalize(b)), "skew fallback rows differ")
    phase("fallback", "all-equal keys: skew ok=False, skew join == sorted join "
                      "(65536 rows)")


# the kernels of tpq_torch/csrc each wrapper launches once a counted
# launch, by the names a trace gives them (bench.profile.PORT_KERNELS)
KERNELS_OF = {"pad": ("pad_kernel",), "pack": ("pack_kernel",),
              "fused_walk_emit": ("walk_emit_kernel",),
              "probe_walk": ("probe_walk_kernel",),
              "split1": ("digit_count_kernel", "digit_scan_kernel", "digit_scatter_kernel"),
              "radix_histogram": ("hist_shared_bins",), "hash_keys": ("hash_keys_kernel",),
              "aggregate_runs": ("agg_runs_kernel",),
              "group_insert": ("group_insert_kernel",), "group_write": ("group_write_kernel",),
              "probe_layout": ("layout_count_kernel", "layout_scan_kernel",
                               "layout_scatter_kernel"),
              "probe_layout_two_level": ("layout2_coarse_count_kernel",
                                         "layout2_group_scan_kernel", "layout2_groups_kernel",
                                         "layout2_coarse_scatter_kernel",
                                         "layout2_fine_count_kernel", "layout2_part_scan_kernel",
                                         "layout2_fine_scatter_kernel"),
              "lane_build": ("lane_build_count_kernel", "lane_build_finish_kernel")}


def eager_port_kernels(fn, dev) -> dict:
    """{kernel of tpq_torch/csrc: launches} of one eager call of fn(), from
    the wrappers' launch counts (zeroed just before, read just after): a
    trace of an eager call lost a hash kernel now and then (configs 1 and
    smoke_pipeline, in every one of three traces), a wrapper's count
    never does."""
    ws = wrappers()
    for w in ws.values():
        w.launches = 0
    fn()
    torch.cuda.synchronize(dev)
    return {k: w.launches for name, w in ws.items() if w.launches
            for k in KERNELS_OF[name]}


def port_kernels_of(fn, dev, traces=3) -> dict:
    """{kernel of tpq_torch/csrc: launches} of one call of fn() as a trace
    sees it (a replay runs no wrapper): the most launches of each kernel
    over `traces` traces of one call each, the call between two small
    elementwise kernels 20 ms away. A trace can lose a device item, never
    add one, so the most over a few traces is the call's count; time
    ranges inside one trace were off by whole kernels (a range around a
    planned config-5 join missed 7 of its first)."""
    from tpq_torch.bench.profile import device_activities, port_launches

    def fence():
        torch.ones(1, device=dev).add_(1)
        torch.cuda.synchronize(dev)

    most: dict = {}
    for _ in range(traces):
        torch.cuda.synchronize(dev)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fence()
            time.sleep(0.02)
            fn()
            torch.cuda.synchronize(dev)
            time.sleep(0.02)
            fence()
        for k, n in port_launches(device_activities(prof)).items():
            most[k] = max(most.get(k, 0), n)
    return most


def body_makes_no_host_read(dev, body) -> int:
    """Runs body() once under the capture flag with sync debug mode
    "error" (a host read raises); returns the conds it recorded."""
    from tpq_torch.jit import deferred

    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with deferred() as preds:
            body()
        torch.cuda.synchronize(dev)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    return len(preds)


def jit_path(label, dev, call, second, want, want2, conds=1):
    """One jitted path (a join_fn call): its body once under the capture
    flag with every sync raising, recording `conds` preds (the join's,
    and a pipeline's aggregate's); the first jitted call (capture, replay)
    and `second()` (a replay on other inputs) against `want` and `want2`,
    one graph and no rerun; the kernels of a profiled replay against an
    eager call's; end-to-end ms eager and jitted in turns."""
    from tpq_torch.bench.runner import cuda_time
    from tpq_torch.columnar import canonicalize, tables_equal

    made = body_makes_no_host_read(dev, call.eager)
    check(made == conds, f"{label}: {made} conds in the body, expected {conds}")
    check(tables_equal(canonicalize(call()), want), f"{label}: jitted call != oracle")
    check(tables_equal(canonicalize(second()), want2),
          f"{label}: replay on the second inputs != oracle")
    jitted = call.jitted
    check(len(jitted._graphs) == 1 and jitted.reruns == 0,
          f"{label}: {len(jitted._graphs)} graphs, {jitted.reruns} reruns")
    eager_k, replay_k = eager_port_kernels(call.eager, dev), port_kernels_of(call, dev)
    check(eager_k and eager_k == replay_k,
          f"{label}: replay kernels {replay_k} != eager {eager_k}")
    e1, j1, j2, e2 = (cuda_time(f, dev, 5)[0] * 1e3
                      for f in (call.eager, call, call, call.eager))
    check(jitted.reruns == 0, f"{label}: a timed call reran")
    phase("jit", f"{label}: body with no host read (sync debug mode error), {conds} cond(s); "
                 f"jitted calls == oracle on two inputs, 1 graph, 0 reruns; profiled "
                 f"replay kernels == eager {replay_k}; end_to_end eager "
                 f"{(e1 + e2) / 2:.4f} ms ({e1:.4f}, {e2:.4f}), jitted "
                 f"{(j1 + j2) / 2:.4f} ms ({j1:.4f}, {j2:.4f}), 5 calls each, in turns")
    jitted.clear()
    return {"eager_ms": [e1, e2], "jitted_ms": [j1, j2], "port_kernels": replay_k}


def turns(label, dev, eager, jitted, joins=10, warmup=3, where="jit") -> dict:
    """bench.profile's end to end, device busy ms and idle share of an
    eager and a jitted call, in turns (eager, jitted, jitted, eager),
    each over `joins` calls after `warmup` calls."""
    from tpq_torch.bench.profile import profile_join

    keys = ("end_to_end_ms", "device_busy_ms", "device_idle_share")
    rows = {"eager": [], "jitted": []}
    for form in ("eager", "jitted", "jitted", "eager"):
        p = profile_join(eager if form == "eager" else jitted, dev, joins, warmup)
        rows[form].append({k: p[k] for k in keys})
    phase(where, f"{label}, in turns (bench.profile: {warmup} warm-ups, {joins} calls): "
          + "; ".join(f"{form} " + ", ".join(f"{r['end_to_end_ms']:.4f} ms (busy "
                                             f"{r['device_busy_ms']:.4f}, idle "
                                             f"{r['device_idle_share']:.4f})" for r in rs)
                      for form, rs in rows.items()))
    return rows


def jit_phase(dev, cfg1, cfg3, smoke_cfg, cfg4):
    """Configs 1 and 3, the radix merge and smoke_pipeline jitted as the
    runner jits them (jit_path each); config 4 (pipeline_100m) jitted
    against eager with no copy-in; the false-pred paths (config 3's shape
    with impl="lane", the h2-colliding pair) jitted against eager."""
    from dataclasses import replace

    from tpq_torch import Table
    from tpq_torch.bench.runner import gen, join_fn, out_capacity_for
    from tpq_torch.columnar import canonicalize, tables_equal
    from tpq_torch.jit import jit
    from tpq_torch.ops import hash_join

    merge = replace(cfg1, join=replace(cfg1.join, algo="merge", sort_engine="radix"))
    out, wants = {}, {}
    for label, cfg, algo in (("config1", cfg1, "hash"), ("config3", cfg3, "hash"),
                             ("merge", merge, "merge")):
        other = replace(cfg, r=replace(cfg.r, seed=cfg.r.seed + 100),
                        s=replace(cfg.s, seed=cfg.s.seed + 100))
        r, s = gen(cfg.r, dev), gen(cfg.s, dev)
        r2, s2 = gen(other.r, dev), gen(other.s, dev)
        call = join_fn(cfg, r, s, out_capacity_for(cfg))
        wants[label] = oracle_rows(*relations_np(cfg), algo)
        out[label] = jit_path(label, dev, call, lambda: call.jitted(r2, s2),
                              wants[label], oracle_rows(*relations_np(other), algo))
        del r, s, r2, s2, call
        torch.cuda.empty_cache()

    dim_np, fact_np = relations_np(smoke_cfg)
    other = replace(smoke_cfg, r=replace(smoke_cfg.r, seed=smoke_cfg.r.seed + 100),
                    s=replace(smoke_cfg.s, seed=smoke_cfg.s.seed + 100))
    dim2_np, fact2_np = relations_np(other)
    v, v2 = smoke_cfg.filter_value, smoke_cfg.filter_value // 2
    dim, fact = (Table.from_numpy(x, device=dev) for x in (dim_np, fact_np))
    dim2, fact2 = (Table.from_numpy(x, device=dev) for x in (dim2_np, fact2_np))
    call = join_fn(smoke_cfg, dim, fact, out_capacity_for(smoke_cfg))
    check(tables_equal(canonicalize(call.jitted(dim, fact, v2)),
                       oracle_pipeline(dim_np, fact_np, v2)),
          f"smoke_pipeline jitted at filter value {v2} != oracle")
    out["smoke_pipeline"] = jit_path(
        f"smoke_pipeline (filter values {v}, {v2})", dev, call,
        lambda: call.jitted(dim2, fact2, v), oracle_pipeline(dim_np, fact_np, v),
        oracle_pipeline(dim2_np, fact2_np, v), conds=2)
    del dim, fact, dim2, fact2, call
    torch.cuda.empty_cache()

    # config 4: the graph reads the 3.2 GB fact table in place
    r, s = gen(cfg4.r, dev), gen(cfg4.s, dev)
    call = join_fn(cfg4, r, s, out_capacity_for(cfg4))
    call()
    call()
    jitted = call.jitted
    check(jitted.copies == 0 and jitted.captures == 1 and jitted.reruns == 0,
          f"config 4: two calls on the same tensors made {jitted.copies} copies, "
          f"{jitted.captures} captures, {jitted.reruns} reruns")
    phase("jit", "config 4 (pipeline_100m): a second call on the same tensors copied "
                 "nothing in (0 copies, 1 capture, 0 reruns)")
    out["config4"] = turns("config 4 (pipeline_100m)", dev, call.eager, call)
    check(jitted.copies == 0 and jitted.reruns == 0,
          f"config 4: {jitted.copies} copies, {jitted.reruns} reruns in the turns")
    busy = {f: [r["device_busy_ms"] for r in rs] for f, rs in out["config4"].items()}
    gaps = [j - sum(busy["eager"]) / 2 for j in busy["jitted"]]
    out["config4"]["busy_gap_ms"] = gaps
    phase("jit", "config 4 (pipeline_100m): jitted busy over the mean eager busy, each "
                 "jitted turn: " + ", ".join(f"{g:.4f} ms" for g in gaps)
          + " (the sorts' device copies run as memcpy nodes)")
    jitted.clear()
    del r, s, call, jitted
    torch.cuda.empty_cache()

    # a pred that stays false: the lane join on config 3's zipf probes
    lane3 = replace(cfg3, join=replace(cfg3.join, impl="lane"))
    r, s = gen(lane3.r, dev), gen(lane3.s, dev)
    call = join_fn(lane3, r, s, out_capacity_for(lane3))
    jitted = call.jitted
    for n in (1, 2):
        check(tables_equal(canonicalize(call()), wants["config3"]),
              f"config 3 shape, impl lane, jitted call {n} != oracle")
    check(jitted.reruns == 1 and len(jitted._graphs) == 2,
          f"config 3 shape, impl lane: {jitted.reruns} reruns, "
          f"{len(jitted._graphs)} graphs after two calls")
    path = jitted._last[next(iter(jitted._last))]
    phase("jit", f"config 3's shape with impl lane: ok false; the first call reran "
                 f"eagerly (path {path}), the second replayed that path's graph; both "
                 f"== the C++ oracle")
    out["config3_lane"] = turns("config 3's shape, impl lane (_FELL_BACK_TO_SORTED)",
                                dev, call.eager, call)
    check(jitted.reruns == 1, f"config 3 shape, impl lane: {jitted.reruns} reruns")
    jitted.clear()
    del r, s, call, jitted
    torch.cuda.empty_cache()

    k1, k2 = 7302945295039616556, 3449075177175606448  # same (bucket, h2)
    r_np = {"key": np.array([k1, k2, 5, 6, 7], dtype=np.int64),
            "p0": np.arange(5, dtype=np.int64)}
    s_np = {"key": np.array([k1, k2, k1, 6], dtype=np.int64),
            "p0": np.arange(4, dtype=np.int64) * 10}
    want = oracle_rows(r_np, s_np)
    r, s = (Table.from_numpy(x, device=dev) for x in (r_np, s_np))
    body = functools.partial(hash_join, r, s, 1 << 8, impl="lane")
    lane = jit(lambda r, s: hash_join(r, s, 1 << 8, impl="lane"))
    check(tables_equal(canonicalize(lane(r, s)), want) and lane.reruns == 1,
          f"jitted h2 pair, call 1: {lane.reruns} reruns, or rows != oracle")
    ws = wrappers()
    for w in ws.values():
        w.launches = 0
    for n in (2, 3):
        check(tables_equal(canonicalize(lane(r, s)), want),
              f"jitted h2 pair, call {n}: rows != oracle")
    launched = {k: w.launches for k, w in ws.items() if w.launches}
    check(lane.reruns == 1 and len(lane._graphs) == 2 and not launched,
          f"jitted h2 pair: {lane.reruns} reruns, {len(lane._graphs)} graphs, eager "
          f"launches {launched} in calls 2 and 3")
    phase("jit", "h2-colliding pair jitted, three calls == the C++ oracle's: the first "
                 "reran eagerly (1 rerun), the second and third replayed the fallback "
                 "path's graph (no kernel wrapper ran, no rerun)")
    out["h2_pair"] = turns("h2-colliding pair", dev, body, lambda: lane(r, s))
    check(lane.reruns == 1, f"jitted h2 pair: {lane.reruns} reruns in the turns")
    lane.clear()
    return out


def canon(cols: dict) -> dict:
    """Canonical (lexicographic) row order of host columns."""
    order = np.lexsort(tuple(cols[n] for n in reversed(list(cols))))
    return {n: c[order] for n, c in cols.items()}


def free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def dryrun_phase(dev):
    import torch.distributed as dist

    from tpq_torch.columnar import tables_equal
    from tpq_torch.dist import (DRYRUN_VARIANTS, dryrun_multichip, dryrun_relations,
                                make_mesh, multihost, run_dryrun)

    out = dryrun_multichip(8, device=dev)
    r, s, expected = dryrun_relations()
    check(expected == 62_545, f"the dryrun relations join to {expected} rows")
    want = oracle_rows(r, s)
    for name, (res, retries) in out.items():
        got = canon(res.to_numpy())
        check(len(got["key"]) == expected, f"{name}: {len(got['key'])} rows")
        check(tables_equal(got, want), f"{name}: rows differ from the C++ oracle")
        phase("dryrun", f"{name}: {expected} rows over 8 shards after {retries} "
                        f"retries, byte-equal to the C++ oracle")

    name = "dense+lane+skew"
    variant = {name: DRYRUN_VARIANTS[name]}
    check(multihost.init(f"localhost:{free_port()}", 1, 0, device=dev),
          "no process group initialized")
    try:
        pg = multihost.ProcessGroupMesh(device=dev)
        (res, _), = run_dryrun(pg, variant).values()
    finally:
        dist.destroy_process_group()
    got = res.to_numpy()
    check(tables_equal(canon(got), canon(out[name][0].to_numpy())),
          "the one-rank NCCL mesh's rows differ from the 8-shard one-process mesh's")
    (one, _), = run_dryrun(make_mesh(1, dev), variant).values()
    check(tables_equal(got, one.to_numpy()),
          "the one-rank NCCL mesh's rows differ from the 1-shard one-process mesh's")
    phase("dryrun", f"{name} through a one-rank NCCL process group: rows equal to "
                    f"the 8-shard one-process mesh's, and row for row to the "
                    f"1-shard one's")


def config4_phase(dev, K, smoke_cfg, cfg, hbm_bw):
    """Config 4's pipeline: smoke_pipeline against the oracle, then
    pipeline_100m unchunked through the bench runner; returns the
    launches of its one counted pipeline."""
    from tpq_torch import Table
    from tpq_torch.bench.runner import gen, join_fn, out_capacity_for, run_config
    from tpq_torch.bench.scale_bench import groups_equal, pipeline_truth
    from tpq_torch.columnar import canonicalize, tables_equal
    from tpq_torch.kernels import lane2
    from tpq_torch.query import full_pipeline

    # the `ok` (and whether `keep` was pushed down) of each probe/emit
    # that a pipeline's lane join makes itself
    probe_emit, oks = lane2.lane2_probe_emit, []

    def recording_probe_emit(*args, **kwargs):
        out, ok = probe_emit(*args, **kwargs)
        oks.append((kwargs.get("keep") is not None, bool(ok)))
        return out, ok

    def lane_path_taken(run):
        oks.clear()
        lane2.lane2_probe_emit = recording_probe_emit
        try:
            result = run()
        finally:
            lane2.lane2_probe_emit = probe_emit
        return result, oks == [(True, True)]

    dim_np, fact_np = relations_np(smoke_cfg)
    value, cap = smoke_cfg.filter_value, out_capacity_for(smoke_cfg)
    want = oracle_pipeline(dim_np, fact_np, value)
    dim, fact = Table.from_numpy(dim_np, device=dev), Table.from_numpy(fact_np, device=dev)
    for impl in ("lane", "sorted"):  # eager
        out, taken = lane_path_taken(lambda: full_pipeline(
            dim, fact, "key", "lt", value, cap, algo="hash", join_impl=impl))
        check(tables_equal(canonicalize(out), want),
              f"smoke_pipeline ({impl} join) differs from the C++ oracle")
        if impl == "lane":
            check(taken, f"smoke_pipeline: the lane pushdown fell back ({oks})")
    phase("config4", f"smoke_pipeline: {len(want['key'])} groups, lane (pushdown path "
                     f"taken) and sorted joins byte-equal to the C++ oracle's filter | "
                     f"join | aggregate")

    # pipeline_100m; the numpy ground truth assumes the preset's streams
    check((cfg.r.rows, cfg.r.nkeys, cfg.r.payloads, cfg.r.seed, cfg.s.nkeys, cfg.s.seed,
           cfg.join.algo, cfg.join.impl) == (1 << 20, 1 << 20, 1, 1, 1 << 20, 2, "hash", "lane"),
          f"{cfg.name} is not the relations pipeline_truth makes")
    value = cfg.filter_value
    t0 = time.perf_counter()
    truth = pipeline_truth(cfg.r.rows, cfg.s.rows, cfg.s.payloads, value)
    join_rows = int(truth["count"].sum())
    phase("config4", f"{cfg.name}: numpy ground truth {len(truth['key'])} groups of "
                     f"{join_rows} join rows ({time.perf_counter() - t0:.1f} s)")
    r, s = gen(cfg.r, dev), gen(cfg.s, dev)
    out_cap = out_capacity_for(cfg)
    pipe = join_fn(cfg, r, s, out_cap)
    ws = wrappers()
    for w in ws.values():
        w.launches = 0
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out, taken = lane_path_taken(pipe.eager)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    launches = {k: w.launches for k, w in ws.items()}
    phase("config4", f"one pipeline (dim {cfg.r.rows}, fact {cfg.s.rows} rows of capacity "
                     f"{s.capacity}, out capacity {out_cap}): launches {launches}; peak "
                     f"memory {peak} B")
    expect = {"pad", "pack", "fused_walk_emit", "group_insert", "group_write",
              "probe_layout", "lane_build"}
    check(all((v > 0) == (k in expect) for k, v in launches.items()),
          f"expected launches of exactly {sorted(expect)}: {launches}")
    check(launches["hash_keys"] == HASH_LAUNCHES["config4"],
          f"{launches['hash_keys']} hash launches, expected {HASH_LAUNCHES['config4']}")
    # the aggregate's group table, one pass and one write (no run-end
    # pass: its `ok` holds); PACK once, the lane tail's
    check((launches["group_insert"], launches["group_write"], launches["pack"]) == (1, 1, 1),
          f"{launches['group_insert']} table passes, {launches['group_write']} writes and "
          f"{launches['pack']} PACK launches, expected 1, 1 and 1")
    got = out.to_numpy()
    check(len(got["key"]) == len(truth["key"]) and groups_equal(got, truth),
          f"{len(got['key'])} groups differ from numpy's {len(truth['key'])}")
    del out, got
    check(taken, f"pipeline_100m: the counted pipeline's lane pushdown fell back ({oks})")
    phase("config4", f"lane pushdown path taken (the `ok` of the counted pipeline's own "
                     f"lane2_probe_emit(keep=...)); every group's key, count and sums equal "
                     f"to numpy's ({len(truth['key'])} groups)")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    held, largest, walk_ms = hold_kernel_calls(pipe.eager)
    for name, (calls, err) in held.items():
        check(calls == launches[name], f"{name}: {calls} calls held, {launches[name]} "
                                       f"launched")
        check(err == 0, f"{name} differs from its plain version at config 4's arguments "
                        f"(max_abs_err {err})")
    check(set(held) == expect, f"held {sorted(held)}")
    phase("config4", "every kernel call of a pipeline byte-equal to its plain version: "
          + ", ".join(f"{k} {c}" for k, (c, _) in held.items())
          + f" ({time.perf_counter() - t0:.1f} s); fused walk/emit on the card alone "
          + ", ".join(f"{t:.4f}" for t in walk_ms) + " ms")
    del r, s, pipe
    largest.pop("pad")
    torch.cuda.empty_cache()
    K.rec["lane_build"]["config4_dim"] = build_phase(K, largest.pop("lane_build"),
                                                     "config-4 dimension table", record=False)
    torch.cuda.empty_cache()
    layout_args = largest.pop("probe_layout")
    K.rec["probe_layout"]["config4"] = layout_phase(K, layout_args, "config-4 pipeline",
                                                    record=False)
    torch.cuda.empty_cache()
    # the hash's main record: the padded probe keys, which the layout's
    # sort path (plans past LAYOUT_MAX_PARTS) hashes a second time; the
    # pipeline itself launches no hash
    from tpq_torch.kernels.lane_table import SALT_LANE, probe_layout

    qk = probe_layout(*layout_args)[0]
    K.rec["hash_keys"].update(hash_phase(
        K, (qk, layout_args[0].pbits + 7, SALT_LANE),
        "config-4 padded probe keys (the sort path's second hash)", record=False))
    del qk, layout_args
    torch.cuda.empty_cache()
    K.rec["fused_walk_emit"]["config4"] = fused_phase(
        K, largest.pop("fused_walk_emit"), "config-4 pipeline", record=False)
    K.rec["fused_walk_emit"]["config4"]["device_ms_in_pipeline"] = walk_ms
    torch.cuda.empty_cache()
    (cols, occ), agg_args = largest.pop("pack"), largest.pop("group_insert")
    check(len(cols) == 1 and occ.shape[0] == 201_326_592,
          "the one PACK call is not the lane tail's over the padded queries")
    K.rec["pack"]["config4_tail"] = pack_phase(K, (cols, occ), "config-4 lane tail",
                                               record=False)
    del cols, occ
    torch.cuda.empty_cache()
    key, values, num_rows = agg_args
    check(key.shape[0] == out_cap and len(values) == 3 and int(num_rows) == join_rows,
          f"the aggregate's call: {key.shape[0]} rows, {len(values)} values, "
          f"{int(num_rows)} valid")
    group_phase(K, agg_args, len(truth["key"]))
    rec = agg_phase(K, sorted_args(agg_args), "config-4 aggregate (sort path)", record=True)
    check(rec["groups"] == len(truth["key"]),
          f"the run-end pass's {rec['groups']} groups at config 4")
    del largest, agg_args, key, values, num_rows
    torch.cuda.empty_cache()

    report = run_config(cfg, hbm_bw=hbm_bw, device=dev)
    op = report["ops"][0]
    check(op["op"] == "pipeline", f"the pipeline's lane path not taken: {op['op']}")
    check(report["out_rows"] == len(truth["key"]), "the runner's pipeline groups")
    check(op["reruns"] == 0, "config 4: a jitted pipeline reran eagerly")
    del report
    torch.cuda.empty_cache()
    phase("config4", f"pipeline: end_to_end {op['elapsed_ms']:.4f} ms (jitted), "
                     f"{op['rows_per_sec']:.6e} fact rows/s, {len(truth['key'])} groups, "
                     f"{join_rows} join rows, peak memory {peak} B, roofline "
                     f"{op['roofline_pct']:.2f}% (byte model {op['model_bytes']} B)")
    return launches


# Launches of the scale benches' programs, from the code: the lane build
# is one build kernel call; a chunk's probe layout is the one-level
# layout kernel at config 4's 512 partitions and the two-level one at
# config 2's 8,192; a chunk walks and emits once, then PACKs and PADs the
# lane tail; config
# 4's chunk also runs its aggregate's run-end pass once and PADs the
# groups into the accumulator, and its finalize PACKs the groups once. A bench run
# builds twice (the warm-up's tables, the timed build), runs
# min(2, nchunks) warm-up chunks before its loop, and config 4 finalizes
# once in the warm-up and once a loop.
LANE_BUILD = {"lane_build": 1}
LANE_CHUNK = {"pad": 1, "pack": 1, "fused_walk_emit": 1, "probe_layout_two_level": 1}
SCALE_LAUNCHES = {
    "config4_chunked": {"build": LANE_BUILD,
                        "chunk": {"pad": 2, "pack": 1, "fused_walk_emit": 1,
                                  "probe_layout": 1, "aggregate_runs": 1},
                        "finalize": {"pack": 1}, "warm_finalizes": 1},
    "config2": {"build": LANE_BUILD, "chunk": LANE_CHUNK, "finalize": {},
                "warm_finalizes": 0},
}


def scale_launches(label, nchunks, whole_run) -> dict:
    """The launches SCALE_LAUNCHES gives for one timed loop of `nchunks`
    chunks, or (`whole_run`) for an unprofiled bench run, by the wrappers
    it launches."""
    c = SCALE_LAUNCHES[label]
    builds, chunks, fins = 0, nchunks, 1 if c["finalize"] else 0
    if whole_run:
        builds, chunks, fins = 2, nchunks + min(2, nchunks), fins + c["warm_finalizes"]
    counts = {k: builds * c["build"].get(k, 0) + chunks * c["chunk"].get(k, 0)
              + fins * c["finalize"].get(k, 0)
              for k in ("pad", "pack", "fused_walk_emit", "hash_keys", "aggregate_runs",
                        "probe_layout", "probe_layout_two_level", "lane_build")}
    return {k: n for k, n in counts.items() if n}


def held_scale_run(label, dev, bench):
    """One eager bench run, off the clock and unprofiled, with every
    PAD, PACK, walk/emit, hash and run-end call held against its plain
    version (hold_kernel_calls): each byte-equal, as many calls as the
    code makes."""
    reps = []
    t0 = time.perf_counter()
    held, _, walk_ms = hold_kernel_calls(
        lambda: reps.append(bench(device=dev, eager=True, log=lambda _: None)), keep=())
    want = scale_launches(label, reps[0]["nchunks"], whole_run=True)
    calls = {k: n for k, (n, _) in held.items()}
    check(calls == want, f"{label}: calls held {calls}, the code makes {want}")
    check(all(err == 0 for _, err in held.values()),
          f"{label}: a kernel differs from its plain version at the chunk shapes: {held}")
    phase(label, f"held eager run: every call byte-equal to its plain version "
                 f"({calls}); walk/emit device ms a chunk {min(walk_ms):.4f}-"
                 f"{max(walk_ms):.4f} ({time.perf_counter() - t0:.1f} s)")
    torch.cuda.empty_cache()


def scale_forms(label, dev, bench, forms):
    """Runs a scale bench held (held_scale_run), then in each form of
    `forms` ((name, keyword arguments), in order), with its timed loop
    profiled. The first eager run's timed loop is counted (every launch
    count zeroed just before it and read just after: exactly
    scale_launches'). Every jitted run: one graph a program, no rerun, no
    capture in its loops, and its loop's port kernels equal to the eager
    loop's by name and count. Returns (reports by form, launches)."""
    from tpq_torch.bench import scale_bench

    held_scale_run(label, dev, bench)
    ws, timed_loop = wrappers(), scale_bench._timed_loop
    reports, launches, eager_kernels, counts = {}, None, None, {}

    def counted_loop(loop, *args):
        def counted():
            if counts:  # the profiled run of the loop
                return loop()
            for w in ws.values():
                w.launches = 0
            res = loop()
            counts.update({k: w.launches for k, w in ws.items()})
            return res
        return timed_loop(counted, *args)

    for name, kw in forms:
        counting = kw.get("eager") and launches is None
        if counting:
            scale_bench._timed_loop = counted_loop
        try:
            rep = bench(device=dev, profile=True, log=lambda _: None, **kw)
        finally:
            scale_bench._timed_loop = timed_loop
        if counting:
            launches = dict(counts)
            got = {k: v for k, v in launches.items() if v}
            want = scale_launches(label, rep["nchunks"], whole_run=False)
            check(got == want, f"{label}: the timed loop launched {got}, the code "
                               f"makes {want}")
            phase(label, f"the first eager run's timed loop ({rep['nchunks']} chunks): "
                         f"launches {got}, as the code makes")
        check(rep["lane_path_taken_all_chunks"], f"{label} {name}: a chunk fell back")
        if kw.get("eager"):
            eager_kernels = eager_kernels or rep["port_kernels"]
            what = "eager"
        else:
            bad = {n: st for n, st in rep["jit"].items()
                   if st["graphs"] != 1 or st["reruns"] != 0}
            check(not bad, f"{label} {name}: programs not at one graph and no rerun: {bad}")
            check(rep["loop_captures"] == 0,
                  f"{label} {name}: {rep['loop_captures']} graphs captured in its loops")
            check(rep["port_kernels"] == eager_kernels,
                  f"{label} {name}: the replayed loop's port kernels "
                  f"{rep['port_kernels']} != the eager loop's {eager_kernels}")
            # the hand-off: a chunk's programs read each other's outputs in
            # place, and config 4's state is updated in place in the graph
            check(rep["copies_per_chunk"] == 0,
                  f"{label} {name}: {rep['copies_per_chunk']} tensors copied in per chunk")
            eager_busy = [r["loop_busy_ms"] for r in reports["eager"]]
            what = (f"one graph a program, 0 reruns, 0 captures in the loops, loop's "
                    f"port kernels == eager's; "
                    f"{rep['copies_per_chunk']:.2f} tensors "
                    f"({rep['copied_bytes_per_chunk']:.0f} B) copied in per chunk; "
                    f"loop busy / the eager runs' mean so far "
                    f"{rep['loop_busy_ms'] / (sum(eager_busy) / len(eager_busy)):.4f}; "
                    f"captures " + ", ".join(f"{n} {st['captures']}"
                                             for n, st in rep["jit"].items()))
        phase(label, f"{name}: {rep['elapsed_ms']:.4f} ms (build {rep['build_ms']:.4f}, "
                     f"loop {rep['loop_ms']:.4f}, loop busy {rep['loop_busy_ms']:.4f}, "
                     f"idle {rep['loop_idle_share']:.4f}); {what}; loop port kernels "
                     f"{rep['port_kernels']}")
        reports.setdefault(name, []).append(rep)
        torch.cuda.empty_cache()
    return reports, launches


def config4_chunked_phase(dev, K):
    """scale_bench.bench_pipeline at 100M fact rows, eager and jitted
    (staged and fused) in turns; the accumulator's PAD call of the last
    eager run's last chunk and the run-end pass of its last full chunk
    timed. Returns the counted run's launches."""
    from tpq_torch.bench import scale_bench

    hash_aggregate = importlib.import_module("tpq_torch.ops.hash_aggregate")
    calls, agg_calls = [], []

    def bench(**kw):
        pad = scale_bench.pad  # held, in the held run
        runs = hash_aggregate.aggregate_runs

        def last_call(*args):
            calls[:] = [args]
            return pad(*args)

        def last_two(*args):
            agg_calls[:] = agg_calls[-1:] + [args]
            return runs(*args)

        scale_bench.pad, hash_aggregate.aggregate_runs = last_call, last_two
        try:
            return scale_bench.bench_pipeline(**kw)
        finally:
            scale_bench.pad, hash_aggregate.aggregate_runs = pad, runs

    forms = [("eager", {"eager": True}), ("jit_staged", {}),
             ("jit_fused", {"staged": False}), ("jit_fused", {"staged": False}),
             ("jit_staged", {}), ("eager", {"eager": True})]
    reps, launches = scale_forms("config4_chunked", dev, bench, forms)
    rep = reps["eager"][0]
    check(rep["groups_exact"], "config 4 chunked: groups differ from numpy's")
    phase("config4_chunked", f"{rep['n_fact']} fact rows in {rep['nchunks']} chunks of "
                             f"{rep['chunk_rows']}: {rep['groups']} groups exact against "
                             f"numpy in every form, {rep['join_rows']} join rows, lane "
                             f"path taken in every chunk; eager "
                             f"{rep['fact_rows_per_sec']:.6e} fact rows/s, roofline "
                             f"{rep['roofline_pct']:.2f}%")
    K.rec["pad"]["config4_accumulator"] = pad_phase(
        K, calls[0], "config-4 chunked accumulator", record=False)
    check(agg_calls[0][0].shape[0] < rep["n_fact"] and rep["nchunks"] > 2,
          "config 4 chunked: the run-end call kept is not a chunk's")
    K.rec["aggregate_runs"]["config4_chunk"] = agg_phase(
        K, agg_calls[0], "config-4 chunk", record=False)
    del calls, agg_calls
    torch.cuda.empty_cache()
    return launches


def config2_phase(dev):
    """scale_bench.bench_build_sweep, eager and jitted in turns. Returns
    the counted eager run's launches."""
    from tpq_torch.bench.scale_bench import bench_build_sweep

    forms = [("eager", {"eager": True}), ("jit", {}), ("jit", {}),
             ("eager", {"eager": True})]
    reps, launches = scale_forms("config2", dev, bench_build_sweep, forms)
    rep = reps["eager"][0]
    check(rep["count_exact"], "config 2: the count differs from numpy's")
    phase("config2", f"{rep['n_build']} x {rep['n_probe']} rows, {rep['payloads']} "
                     f"payloads, {rep['nchunks']} chunks of {rep['chunk_rows']}: "
                     f"{rep['out_rows']} join rows == numpy's count in every form, lane "
                     f"path taken in every chunk; eager {rep['probe_rows_per_sec']:.6e} "
                     f"probe rows/s, roofline {rep['roofline_pct']:.2f}%")
    torch.cuda.empty_cache()
    return launches


def entry_phase(dev):
    from tpq_torch.columnar import canonicalize, tables_equal
    from tpq_torch.query import entry

    fn, (dim, fact, value) = entry(device=dev)
    check(dim.device.type == dev.type, "entry() placed its relations off the card")
    out = fn(dim, fact, value)
    want = oracle_pipeline(dim.to_numpy(), fact.to_numpy(), value)
    check(tables_equal(canonicalize(out), want), "entry() differs from the C++ oracle")
    phase("entry", f"entry(): {int(out.num_rows)} groups byte-equal to the C++ oracle's "
                   f"filter | join | aggregate")


def peaks(dev, run):
    """(run()'s result, peak allocated bytes, peak reserved bytes), from
    an emptied cache."""
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    out = run()
    torch.cuda.synchronize(dev)
    return out, torch.cuda.max_memory_allocated(dev), torch.cuda.max_memory_reserved(dev)


def jitted_dist_join(dev, label, mesh, eager, jitted, check_result,
                     bodies=None) -> dict:
    """A distributed join of a LocalMesh jitted (its body one CUDA graph,
    the results handed over) against its eager body: the first jitted
    call (the warm-up, the capture, a replay) and a replay, each result
    held by check_result(out, ovf); their peak allocated and reserved
    bytes, the jitted ones against PEAK_LIMIT; a replay's port kernels
    equal to an eager call's (of `bodies`, (eager, jitted) calls of the
    body alone, where the join plans first); eager and jitted in turns
    (bench.profile, 2 calls a turn); no rerun. An eager call frees the
    mesh's graphs first, as the benches free a graph before the next
    join: an 8-shard body's memory pool does not fit beside an eager run
    of it. Returns the record for PERF.md."""
    def eager_call():
        mesh.clear()
        return eager()

    eager_body, jitted_body = bodies or (eager, jitted)

    (out, ovf), alloc_e, res_e = peaks(dev, eager_call)
    check_result(out, ovf)
    del out, ovf
    mesh.clear()
    (out, ovf), alloc_j, res_j = peaks(dev, jitted)
    check_result(out, ovf)
    del out, ovf
    check_result(*jitted())
    (prog,) = mesh.programs.values()
    check((prog.captures, prog.reruns, prog.copies) == (1, 0, 0),
          f"{label}: captures {prog.captures}, reruns {prog.reruns}, copies "
          f"{prog.copies} after two calls")
    phase(label, f"jitted: first call and a replay exact, {prog.captures} capture, "
                 f"{prog.reruns} reruns, {prog.copies} copies; peak allocated / reserved "
                 f"eager {alloc_e} / {res_e} B, jitted {alloc_j} / {res_j} B (limit "
                 f"{PEAK_LIMIT} B)")
    for what, b in (("jitted allocated", alloc_j), ("jitted reserved", res_j)):
        check(b <= PEAK_LIMIT, f"{label}: peak {what} {b} B over {PEAK_LIMIT} B")
    mesh.clear()
    eager_k = eager_port_kernels(eager_body, dev)
    jitted_body()  # the graph captured again, off the trace
    replay_k = port_kernels_of(jitted_body, dev)
    check(eager_k and eager_k == replay_k,
          f"{label}: replay kernels {replay_k} != eager {eager_k}")
    seen = []

    def jitted_call():  # the captures and reruns of each jitted turn's graph
        res = jitted()
        progs = list(mesh.programs.values())
        seen.append((sum(p.captures for p in progs), sum(p.reruns for p in progs)))
        return res

    # two warm-ups: a jitted turn's first call captures, its second replays
    rows = turns(label, dev, eager_call, jitted_call, joins=2, warmup=2, where=label)
    check(all(r == 0 for _, r in seen) and all(c == 1 for c, _ in seen),
          f"{label}: (captures, reruns) in the turns {sorted(set(seen))}")
    phase(label, f"profiled replay's port kernels == eager call's {replay_k}; each "
                 f"jitted turn: 1 capture (its first warm-up), 0 reruns")
    mesh.clear()
    return {"turns": rows, "peak_allocated": [alloc_e, alloc_j],
            "peak_reserved": [res_e, res_j], "port_kernels": replay_k}


def config5_phase(dev, K, cfg):
    """The distributed join at dist_125m_8shard, eager (counted, held,
    against the oracle) and jitted; returns its launches."""
    from tpq_torch import Table
    from tpq_torch.bench.runner import cuda_time
    from tpq_torch.columnar import next_pow2, tables_equal
    from tpq_torch.dist import (DistTable, dist_hash_join, dist_hash_join_planned,
                                make_mesh, plan_dist_capacities)
    from tpq_torch.kernels.lane2 import lane2_hash_join, lane2_path_taken, plan_lane2
    from tpq_torch.kernels.lane_table import plan_pressure
    from tpq_torch.verify import M64, multiset_checksum, sample_key_ranges, slice_by_key

    t0 = time.perf_counter()
    r_np, s_np = relations_np(cfg)
    mesh = make_mesh(cfg.mesh_shape[0], dev)
    R, S = DistTable.from_numpy(r_np, mesh), DistTable.from_numpy(s_np, mesh)
    cnt_r = np.bincount(r_np["key"], minlength=cfg.r.nkeys).astype(np.int64)
    cnt_s = np.bincount(s_np["key"], minlength=cfg.r.nkeys).astype(np.int64)
    n = int((cnt_r * cnt_s).sum())
    phase("config5", f"{cfg.name}: R and S of {cfg.r.rows} rows on {mesh.size} "
                     f"shards of capacity {R.local_capacity}, {n} join rows by numpy "
                     f"({time.perf_counter() - t0:.1f} s to generate and place)")

    hist_phase(K, record_kernel_calls(lambda: plan_dist_capacities(R, S, mesh)),
               mesh.size)
    ex_cap, out_cap = plan_dist_capacities(R, S, mesh)

    def body(eager):
        return dist_hash_join(R, S, mesh, out_cap, exchange_capacity=ex_cap,
                              local_impl="lane", eager=eager)

    def planned(eager):
        return dist_hash_join_planned(R, S, mesh, local_impl="lane", eager=eager)

    conds = body_makes_no_host_read(dev, lambda: body(True))
    check(conds == 0, f"the lane body recorded {conds} conds")
    phase("config5", "the body after the plan under the capture flag, sync debug mode "
                     "error: no host read, 0 conds")

    ranges, wants = sample_key_ranges(r_np["key"]), []
    for lo, hi in ranges:
        wants.append(oracle_rows(slice_by_key(r_np, lo, hi), slice_by_key(s_np, lo, hi)))
    check(len(ranges) == 4, f"{len(ranges)} key ranges sampled")

    def checked(out, ovf) -> int:
        """Overflow 0, numpy's count, the oracle's key-range slices; the
        result's multiset checksum."""
        check(int(ovf.sum()) == 0, f"overflow {ovf.tolist()}")
        got = int(out.shard_rows.sum())
        check(got == n, f"num_rows {got} != numpy's {n}")
        for (lo, hi), want in zip(ranges, wants):
            parts = []
            for t in out.shards:
                k = t.col("key")
                m = t.valid_mask() & (k >= lo) & (k < hi)
                parts.append({c: v[m].cpu().numpy() for c, v in t.columns.items()})
            mine = canon({c: np.concatenate([p[c] for p in parts]) for c in parts[0]})
            check(tables_equal(mine, want), f"key range [{lo}, {hi}) differs from the oracle")
        return sum(int(multiset_checksum(t)) for t in out.shards) & M64

    ws = wrappers()
    for w in ws.values():
        w.launches = 0
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out, ovf = planned(True)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    launches = {k: w.launches for k, w in ws.items()}
    phase("config5", f"one planned join, eager (ex_cap {ex_cap}, out_cap {out_cap} per "
                     f"shard): launches {launches}; peak memory {peak} B")
    expect = {"radix_histogram", "pad", "pack", "fused_walk_emit", "hash_keys", "lane_build",
              "probe_layout_two_level"}
    check(all((v > 0) == (k in expect) for k, v in launches.items()),
          f"expected launches of exactly {sorted(expect)}: {launches}")
    check(launches["hash_keys"] == HASH_LAUNCHES["dist"],
          f"{launches['hash_keys']} hash launches, expected {HASH_LAUNCHES['dist']}")
    check(launches["radix_histogram"] == 2 * mesh.size,
          f"{launches['radix_histogram']} histogram launches, expected {2 * mesh.size}")
    ck_dist = checked(out, ovf)
    phase("config5", f"overflow 0; num_rows {n} == numpy count; 4 key ranges "
                     f"({', '.join(str(len(w['key'])) for w in wants)} output rows) "
                     f"byte-equal to the C++ oracle")
    del out, ovf

    # the same join once more, every kernel call held as it is made
    # against its plain version on the same inputs (the builds over 2^21
    # buckets of D 48, the walk/emit over u 50,331,648 queries)
    t0 = time.perf_counter()
    held, largest, walk_ms = hold_kernel_calls(lambda: planned(True))
    for name, (calls, err) in held.items():
        check(calls == launches[name], f"{name}: {calls} calls held, "
                                       f"{launches[name]} launched")
        check(err == 0, f"{name} differs from its plain version at the dist path's "
                        f"arguments (max_abs_err {err})")
    check(set(held) == expect, f"held {sorted(held)}")
    torch.cuda.empty_cache()
    phase("config5", "every kernel call of a planned join byte-equal to its plain "
                     "version: " + ", ".join(f"{k} {c}" for k, (c, _) in held.items())
          + f" ({time.perf_counter() - t0:.1f} s)")
    largest_call_phase(K, largest)
    K.rec["fused_walk_emit"]["config5_per_join_device_ms"] = sum(walk_ms)
    phase("config5", f"fused walk/emit on the card alone, {len(walk_ms)} calls of a "
                     f"planned join: {sum(walk_ms):.4f} ms in all ("
                     + ", ".join(f"{t:.4f}" for t in walk_ms) + ")")
    del largest
    torch.cuda.empty_cache()

    # the planned join with its body jitted (tpq's shard_map program)
    def checked_same(out, ovf):
        ck = checked(out, ovf)
        check(ck == ck_dist, f"jitted checksum {ck:#x} != eager {ck_dist:#x}")

    rec = jitted_dist_join(dev, "config5", mesh, lambda: planned(True),
                           lambda: planned(False), checked_same,
                           bodies=(lambda: body(True), lambda: body(False)))
    t_plan = cuda_time(lambda: plan_dist_capacities(R, S, mesh), dev, 3)[0] * 1e3
    t_body_j = cuda_time(lambda: body(False), dev, 3)[0] * 1e3
    mesh.clear()
    t_body_e = cuda_time(lambda: body(True), dev, 3)[0] * 1e3
    e2e = {f: [r["end_to_end_ms"] for r in rows] for f, rows in rec["turns"].items()}
    phase("config5", f"planning {t_plan:.4f} ms, body eager {t_body_e:.4f} ms, jitted "
                     f"{t_body_j:.4f} ms (each the mean of 3 after a warm-up); planned "
                     f"end to end eager " + ", ".join(f"{t:.4f}" for t in e2e["eager"])
          + ", jitted " + ", ".join(f"{t:.4f}" for t in e2e["jitted"]) + " ms; "
          f"{n / (min(e2e['jitted']) / 1e3):.6e} join rows/s jitted")
    del R, S

    # the single-card lane join of the same relations. Its output
    # capacity is twice the pow2 above the count, because the plan's tail
    # window (1/256 of it) must hold the rows past K = 4 matches; its
    # depth is the renegotiation loop's first step from 48, 72, because
    # at 48 some buckets of a 2^27-row build overflow and the join would
    # answer through its sorted fallback. Both counts are printed.
    torch.cuda.empty_cache()
    R1 = Table.from_numpy(r_np, device=dev)
    S1 = Table.from_numpy(s_np, device=dev)
    cap1 = 2 * next_pow2(n)
    plan0 = plan_lane2(R1.capacity, S1.capacity, out_capacity=next_pow2(n))
    plan = plan_lane2(R1.capacity, S1.capacity, depth=72, out_capacity=cap1)
    load, tail = plan_pressure(R1, S1, plan0)
    phase("config5", f"single card: {int((load > plan0.depth).sum())} of "
                     f"{plan0.nbuckets} buckets hold more than {plan0.depth} build rows "
                     f"(fullest {int(load.max())}); {int(tail)} tail rows against "
                     f"windows of {plan0.tail_out_cap} (out capacity {next_pow2(n)}) "
                     f"and {plan.tail_out_cap} ({cap1})")
    del load
    check(bool(lane2_path_taken(R1, S1, cap1, plan=plan)),
          "the single-card lane join fell back")
    one = lane2_hash_join(R1, S1, cap1, plan=plan)
    check(int(one.num_rows) == n, f"single-card num_rows {int(one.num_rows)}")
    ck_one = int(multiset_checksum(one)) & M64
    check(ck_dist == ck_one, f"checksums differ: dist {ck_dist:#x}, "
                             f"single card {ck_one:#x}")
    del one
    t_one = cuda_time(lambda: lane2_hash_join(R1, S1, cap1, plan=plan), dev, 2)[0] * 1e3
    phase("config5", f"multiset checksum {ck_dist:#018x} equal to the single-card "
                     f"lane join's (npart {plan.npart}, D {plan.depth}, out capacity "
                     f"{cap1}; {t_one:.4f} ms per join, mean of 2 after a warm-up)")
    rec.update(plan_ms=t_plan, body_ms={"eager": t_body_e, "jitted": t_body_j})
    phase("config5", "summary " + json.dumps(rec))
    return launches


def counted_held_join(dev, label, mesh, join, want_rows, expect):
    """Drives one distributed join with every launch count zeroed just
    before and read just after: exactly the wrappers of `expect` ({name:
    launches, from the code}) launched, as often as it says, overflow 0
    and `want_rows` rows. Then drives it once more with every kernel call
    held, as it is made, byte-equal to its plain version. Returns the
    counted run's launches."""
    from tpq_torch.bench.scaling import joined_rows

    ws = wrappers()
    for w in ws.values():
        w.launches = 0
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out, ovf = join()
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    launches = {k: w.launches for k, w in ws.items()}
    phase(label, f"launches {launches}; peak memory {peak} B, "
                 f"{'under' if peak < PEAK_LIMIT else 'OVER'} the {PEAK_LIMIT} B limit")
    check(all(v == expect.get(k, 0) for k, v in launches.items()),
          f"expected launches {expect}: {launches}")
    got = joined_rows(out, mesh)
    check(int(ovf.sum()) == 0 and got == want_rows,
          f"overflow {ovf.tolist()}, {got} rows of {want_rows}")
    del out, ovf
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    held, _, _ = hold_kernel_calls(join, keep=())
    check(set(held) == set(expect), f"held {sorted(held)}")
    for name, (calls, err) in held.items():
        check(calls == launches[name], f"{name}: {calls} calls held, {launches[name]} "
                                       f"launched")
        check(err == 0, f"{name} differs from its plain version at {label}'s arguments "
                        f"(max_abs_err {err})")
    torch.cuda.empty_cache()
    phase(label, f"overflow 0; {got} rows == the count without the join; every kernel "
                 "call byte-equal to its plain version: "
                 + ", ".join(f"{k} {c}" for k, (c, _) in held.items())
                 + f" ({time.perf_counter() - t0:.1f} s)")
    return launches


def bench_join_checker(label, mesh, want_rows):
    """check_result for a bench join: overflow 0 and `want_rows` rows."""
    from tpq_torch.bench.scaling import joined_rows

    def check_result(out, ovf):
        got = joined_rows(out, mesh)
        check(int(ovf.sum()) == 0 and got == want_rows,
              f"{label}: overflow {ovf.tolist()}, {got} rows of {want_rows}")
    return check_result


def bench_records_jitted(label, rows):
    """Every record of a bench run on the card says it ran jitted, its
    graph captured once and never rerun."""
    for r in rows:
        check(r["jitted"] and r["captures"] == 1 and r["reruns"] == 0,
              f"{label}: record {r} not run as one graph without a rerun")


def scaling_phase(dev):
    """The weak-scaling bench at 2^24 rows a shard on 1, 2, 4 and 8
    shards of the card: first one join at 8 shards (134M x 134M, the
    bench's arguments) counted and held (counted_held_join), eager, and
    jitted against eager (jitted_dist_join); then the bench, jitted,
    each size's overflow 0 and num_rows equal to a count made without the
    join. Returns the counted join's launches and the jitted record."""
    from tpq_torch.bench.scaling import place_uniform, run_weak_scaling, true_join_rows
    from tpq_torch.dist import dist_hash_join, make_mesh

    per, n = 1 << 24, 8
    mesh = make_mesh(n, dev)
    R = place_uniform(per * n, per * n, 1, 77, mesh)
    S = place_uniform(per * n, per * n, 1, 78, mesh)
    want = true_join_rows(per * n, per * n, 77, 78, dev)
    launches = counted_held_join(
        dev, "scaling", mesh,
        lambda: dist_hash_join(R, S, mesh, out_capacity_per_shard=4 * per, eager=True),
        want, DIST_BENCH_LAUNCHES["scaling"])
    rec = jitted_dist_join(
        dev, "scaling", mesh,
        lambda: dist_hash_join(R, S, mesh, out_capacity_per_shard=4 * per, eager=True),
        lambda: dist_hash_join(R, S, mesh, out_capacity_per_shard=4 * per),
        bench_join_checker("scaling", mesh, want))
    del R, S
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    rows = run_weak_scaling(rows_per_chip=per, mesh_sizes=(1, 2, 4, 8), device=dev)
    check([r["n_chips"] for r in rows] == [1, 2, 4, 8], "a mesh size did not run")
    bench_records_jitted("scaling", rows)
    name = torch.cuda.get_device_name(dev)
    for r in rows:
        check(r["mesh"] == "local" and r["cards"] == 1 and r["device"] == name,
              f"record {r} does not name its one-card local mesh")
        phase("scaling", f"{r['n_chips']} shards on one card, {r['rows_total']} x "
                         f"{r['rows_total']} rows: {r['num_rows']} rows == the count "
                         f"without the join; jitted (1 capture, 0 reruns) "
                         f"{r['elapsed_ms']:.4f} ms, "
                         f"{r['rows_per_sec_per_chip']:.6e} rows/s on the card, efficiency "
                         f"{r['efficiency']:.4f}")
    phase("scaling", f"{time.perf_counter() - t0:.1f} s")
    phase("scaling", "summary " + json.dumps(rec))
    torch.cuda.empty_cache()
    return launches


def overlap_phase(dev):
    """The overlap matrix at 8 shards of 2^24 rows, out capacity 2^26 a
    shard: first one dense_4chunks and one ring_hops join (the matrix's
    relations) each counted and held (counted_held_join), eager; each
    variant jitted against eager (jitted_dist_join); then the matrix,
    jitted, every variant's num_rows equal to the dense one's; on one
    card chunks and hops run in order, so it shows what they cost, not
    overlap. Returns the counted joins' launches by variant."""
    from tpq_torch.bench.overlap_bench import VARIANTS, run_overlap_matrix
    from tpq_torch.bench.scaling import place_uniform, true_join_rows
    from tpq_torch.dist import dist_hash_join, make_mesh

    per, n = 1 << 24, 8
    mesh = make_mesh(n, dev)
    R = place_uniform(per * n, per * n, 1, 71, mesh)
    S = place_uniform(per * n, per * n, 1, 72, mesh)
    want = true_join_rows(per * n, per * n, 71, 72, dev)
    launches, recs = {}, {}
    for variant, kw in VARIANTS:
        path = f"overlap_{variant}"

        def join(eager, kw=kw):
            return dist_hash_join(R, S, mesh, out_capacity_per_shard=4 * per, eager=eager,
                                  **kw)

        if path in DIST_BENCH_LAUNCHES:
            launches[path] = counted_held_join(dev, path, mesh, lambda: join(True), want,
                                               DIST_BENCH_LAUNCHES[path])
        recs[variant] = jitted_dist_join(dev, path, mesh, lambda: join(True),
                                         lambda: join(False),
                                         bench_join_checker(path, mesh, want))
    del R, S
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    rows = run_overlap_matrix(mesh, rows_per_shard=per, out_capacity_per_shard=4 * per)
    check([r["variant"] for r in rows] == ["dense_1chunk", "dense_4chunks", "ring_hops"],
          "a variant did not run")
    bench_records_jitted("overlap", rows)
    for r in rows:
        check(r["mesh"] == "local" and r["num_rows"] == want, f"record {r}")
        phase("overlap", f"{r['variant']}: {r['num_rows']} rows of {r['rows_total']} in "
                         f"(equal in every variant and to the count without the join), "
                         f"jitted (1 capture, 0 reruns), best of 3 {r['elapsed_ms']} ms, "
                         f"{r['vs_dense_1chunk']} of dense_1chunk")
    phase("overlap", f"{time.perf_counter() - t0:.1f} s")
    phase("overlap", "summary " + json.dumps(recs))
    torch.cuda.empty_cache()
    return launches


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA card visible; this check runs only on a card")
    sys.path.insert(0, ROOT)
    from tpq_torch.bench import roofline
    from tpq_torch.bench.runner import card_info
    from tpq_torch.config import PRESETS
    from tpq_torch.kernels import _build

    dev = torch.device("cuda:0")
    card = card_info()
    print(card, flush=True)
    phase("device", f"{torch.cuda.get_device_name(dev)}; torch {torch.__version__}, "
                    f"CUDA {torch.version.cuda}; {card}")

    t0 = time.perf_counter()
    secs = _build.build(force=True)
    _build.lib()
    phase("build", f"nvcc built {os.path.relpath(_build.SO, ROOT)} from "
                   f"{len(_build.sources())} sources in {secs:.1f} s "
                   f"({time.perf_counter() - t0:.1f} s with loading)")

    hbm_bw = roofline.measure_hbm_bw(device=dev)
    phase("device", f"measured copy rate {hbm_bw:.1f} GB/s")

    cfg1, cfg3 = PRESETS["single_chip_1m"], PRESETS["zipf_skew"]
    K = kernel_phase(dev, cfg1, cfg3, hbm_bw)
    per_join = {"config1": config1_phase(dev, cfg1, hbm_bw),
                "config3": config3_phase(dev, cfg3, hbm_bw),
                "merge": merge_phase(dev, cfg1, hbm_bw),
                "config4": config4_phase(dev, K, PRESETS["smoke_pipeline"],
                                         PRESETS["pipeline_100m"], hbm_bw)}
    per_join["config4_chunked"] = config4_chunked_phase(dev, K)
    per_join["config2"] = config2_phase(dev)
    sweep_layout_phase(dev, K)
    entry_phase(dev)
    fallback_phase(dev)
    phase("jit", "summary " + json.dumps(jit_phase(dev, cfg1, cfg3,
                                                   PRESETS["smoke_pipeline"],
                                                   PRESETS["pipeline_100m"])))
    dryrun_phase(dev)
    per_join["dist"] = config5_phase(dev, K, PRESETS["dist_125m_8shard"])
    per_join["scaling"] = scaling_phase(dev)
    per_join.update(overlap_phase(dev))
    records = K.rec

    meta = {
        "pad": ("tpq_torch/csrc/move.cu", "tpq/kernels/move.py:117"),
        "pack": ("tpq_torch/csrc/move.cu", "tpq/kernels/move.py:242"),
        "fused_walk_emit": ("tpq_torch/csrc/lane2.cu", "tpq/kernels/lane2.py:223"),
        "probe_walk": ("tpq_torch/csrc/lane2.cu", "tpq/kernels/lane_table.py:293"),
        "split1": ("tpq_torch/csrc/radix_sort.cu", "tpq/kernels/radix_sort.py:140"),
        "radix_histogram": ("tpq_torch/csrc/radix_partition.cu",
                            "tpq/kernels/radix_partition.py:48"),
        "hash_keys": ("tpq_torch/csrc/hash.cu", "tpq/hashing.py:63"),
        "aggregate_runs": ("tpq_torch/csrc/aggregate.cu", "tpq/ops/hash_aggregate.py:59"),
        "group_insert": ("tpq_torch/csrc/group_table.cu", "none (tpq sorts the capacity)"),
        "group_write": ("tpq_torch/csrc/group_table.cu", "none (tpq sorts the capacity)"),
        "probe_layout": ("tpq_torch/csrc/layout.cu",
                         "none (tpq's stable sort and PAD, tpq/kernels/lane_table.py:232)"),
        "probe_layout_two_level": ("tpq_torch/csrc/layout.cu",
                                   "none (tpq's stable sort and PAD, "
                                   "tpq/kernels/lane_table.py:232)"),
        "lane_build": ("tpq_torch/csrc/lane_build.cu",
                       "none (tpq's composite sort, gathers and PAD, "
                       "tpq/kernels/lane_table.py:113)"),
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(c[name] for c in per_join.values()),
         "launches_per_join": {path: c[name] for path, c in per_join.items()},
         **records[name]}
        for name, (src, rep) in meta.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
