"""Lane-bucket hash table: build, probe layout, tail and the `ok` flag
(port of tpq/kernels/lane_table.py).

The layout is tpq's, so that the same inputs give the same tables:

  * hash(key) -> (partition p = top pbits, lane l = low 7 bits). A
    partition's table is a [D, 128] tile per column: lane l's bucket is
    the column (0..D-1, l).
  * build: a bucket's rows in the order of the stable sort by the
    composite (bucket << 32) | h2, where h2 is a second 32-bit hash;
    equal keys share h2, so their runs are contiguous in d. Two distinct
    keys that collide on (bucket, h2) clear `ok` and the join falls back.
    On the card a plan of depth at most LANE_BUILD_MAX_DEPTH takes
    `lane_build` (tpq_torch/csrc/lane_build.cu: each live row parked in
    its bucket by an atomic count, then each bucket sorted by (h2, row)
    and every tile slot written once); a deeper plan and a CPU tensor
    take `build_lane_tables_ref`, tpq's sort: rows ranked within their
    bucket, PADded lane-major, then transposed to [npart, D, 128].
  * probe layout: queries grouped by partition and PADded to [npart,
    probe_cap]; the identity when npart == 1 and probe_cap equals the
    probe capacity (the skew join's broadcast tables). On the card a
    plan of at most LAYOUT_MAX_PARTS partitions takes `probe_layout`
    (tpq_torch/csrc/layout.cu: a stable count, scan and scatter, the
    scan also filling the dead slots), one of up to LAYOUT2_MAX_PARTS
    (config 2's, config 5's shards') `probe_layout_two_level` (the same
    file: a stable partition by the high half of the partition bits,
    then one by the low half into the padded slots); a larger one, the
    identity and a CPU tensor take `probe_layout_ref`, tpq's stable
    sort and PAD. Each layout observes its path (layout_passes).
  * walk only (probe_lane_tables, the membership probe of the skew
    join): count, first match depth and the first K matches' build
    payloads of every padded query, by `probe_walk`
    (tpq_torch/csrc/lane2.cu) beside its plain version `probe_walk_ref`.
  * tail: queries with more than K matches are PACKed, their extra
    matches expanded and PADded into a window spliced after the inline
    rows. It always runs (tpq conds it on a nonzero tail,
    tpq/kernels/lane_table.py:448): with no tail rows only slots at or
    after the inline total change, which lie past num_rows.
  * counters (jit.observe): the tail's queries and rows and the inline
    rows of every lane join, and the constants of its plan: the tail
    window's rows, the padded probe slots, the table slots and the
    payload columns a side (the walk/emit's shapes).

Any static-capacity violation (bucket depth > D, probe partition
overflow, tail caps, output overflow) clears `ok`, and lane2_hash_join
then answers with the union-sort engine.

The port keeps int64 keys and payloads whole: tpq's 32-bit planes exist
because the TPU has no 64-bit vector ALU. int32 columns are widened to
int64 inside the join and narrowed back at its output.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from tpq_torch.columnar import Table
from tpq_torch.hashing import hash_keys
from tpq_torch.jit import observe
from tpq_torch.kernels import _build
from tpq_torch.kernels.move import MAX_COLS, pack, pad
from tpq_torch.ops._expand import expand_segments, last_start
from tpq_torch.ops.union_join import planes_col
from tpq_torch.trace import span

I32 = torch.int32
I64 = torch.int64
L = 128
MAX_K = 8  # kMaxK in csrc/lane2.cu: inline ranks probe_walk emits
SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may use
MAX_CHUNK = 4096  # padded queries per work item of the walk/emit (kMaxChunk in lane2.cu)
# what a CTA of the walk/emit costs beside its queries, in queries: the
# tile copy, the ticket and the look-back. Fitted to chip_smoke.py's
# sweeps of queries per CTA (PERF.md): with it work_item_queries picks
# the fastest size measured at configs 1 and 5 and at config 3's heavy
# table (1,024, 3,072 and 4,096 queries).
CTA_OVERHEAD_QUERIES = 1024
SALT_LANE = 0x1A9E0001
SALT_H2 = 0x1A9E0002
LAYOUT_TILE = 4096  # kTile in csrc/layout.cu (the kernel checks the scratch size)
# kMaxParts in csrc/layout.cu: the layout kernel's per-tile bins take 24
# bytes a partition of a block's shared memory beside its 32 KB stage;
# plan_lane2 gives 512 partitions at a build side of 2^20 rows (configs
# 1, 3 and 4). Past it the two-level layout bins each of its passes by
# half of the partition bits: 8,192 partitions at config 2, 16,384 at
# config 5's shards. kMaxParts2 there: ten bits a pass at most
LAYOUT_MAX_PARTS = 1024
LAYOUT2_MAX_PARTS = 1 << 20
# kMaxDepth in csrc/lane_build.cu: the build kernel sorts each bucket's
# rows in shared memory, 8 bytes a depth for each of the 128 lanes, D KB
# a block: 227 depths fill a Hopper block's 232,448 bytes. Growing D by
# half from 48 gives 72, 108 and 162 to the kernel, 243 to the sort path
LANE_BUILD_MAX_DEPTH = SMEM_LIMIT // (8 * L)


@dataclass(frozen=True)
class LanePlan:
    pbits: int          # partitions = 2^pbits
    depth: int          # D: table rows (bucket capacity per lane)
    probe_cap: int      # padded probe rows per partition
    inline_k: int       # match ranks emitted inline
    tail_rows_cap: int  # compacted queries with cnt > K
    tail_out_cap: int   # tail output rows

    @property
    def npart(self) -> int:
        return 1 << self.pbits

    @property
    def nbuckets(self) -> int:
        return self.npart * L


@dataclass
class LaneTables:
    plan: LanePlan
    key: torch.Tensor         # int64 [npart, D, 128]
    pays: list[torch.Tensor]  # int64 [npart, D, 128] each
    occ: torch.Tensor         # int32 [npart, D, 128], 0/1
    blen: torch.Tensor        # int32 [npart, 128]: bucket lengths
    ok: torch.Tensor          # 0-d bool: no depth overflow, no h2 hazard


def _as_i64(col: torch.Tensor) -> torch.Tensor:
    if col.dtype not in (I32, I64):
        raise TypeError(f"lane join: int32 or int64 columns, got {col.dtype}")
    return col.to(I64)


def _tiles(x: torch.Tensor, plan: LanePlan) -> torch.Tensor:
    """lane-major [p*128+l, D] -> [p, D, 128]."""
    return x.reshape(plan.npart, L, plan.depth).transpose(1, 2).contiguous()


def lane_tables_from_numpy(plan: LanePlan, key_planes, pay_planes, occ, ok,
                           device="cuda") -> LaneTables:
    """The port's tables from tpq's LaneTables fields as numpy arrays:
    key planes (1 for int32 keys, (lo, hi) for int64), payload planes in
    (lo, hi) pairs (tpq's int64 payloads), occ [npart, D, 128], ok."""
    def col(planes):
        ts = [torch.from_numpy(np.array(p)).to(device) for p in planes]
        return planes_col(tuple(ts), I64) if len(ts) == 2 else ts[0].to(I64)

    occ_t = torch.from_numpy(np.array(occ)).to(device=device, dtype=I32)
    return LaneTables(
        plan=plan, key=col(key_planes),
        pays=[col(pay_planes[i:i + 2]) for i in range(0, len(pay_planes), 2)],
        occ=occ_t, blen=occ_t.sum(1, dtype=I32),
        ok=torch.tensor(bool(np.asarray(ok)), device=device))


def _rank_in_group(group: torch.Tensor) -> torch.Tensor:
    """group: sorted [N]. Returns i - first_index_of(group[i]) as int64."""
    i = torch.arange(group.shape[0], dtype=I64, device=group.device)
    new = torch.ones_like(group, dtype=torch.bool)
    # written in place: a slice assignment would add a device copy, which
    # a CUDA graph runs as a slower memcpy node
    torch.ne(group[1:], group[:-1], out=new[1:])
    return i - last_start(new)


def build_lane_tables_ref(r: Table, plan: LanePlan, key: str = "key") -> LaneTables:
    """Plain torch build (tpq's sort): defines the contract the kernel is
    held to, and is the sort path of plans past LANE_BUILD_MAX_DEPTH."""
    D, nb = plan.depth, plan.nbuckets
    rk = _as_i64(r.col(key))
    valid = r.valid_mask()
    h = hash_keys(rk, plan.pbits + 7, SALT_LANE)
    bucket = torch.where(valid, h, nb).to(I64)
    h2 = hash_keys(rk, 32, SALT_H2).to(I64) & 0xFFFFFFFF
    comp_s, perm = torch.sort((bucket << 32) | h2, stable=True)
    bucket_s = comp_s >> 32
    key_s = rk[perm]
    pays_s = [_as_i64(r.col(n))[perm] for n in r.names if n != key]

    # h2 hazard: two distinct live keys with one (bucket, h2) would break
    # the contiguity of a key's run in d, which the tail relies on
    hazard = ((comp_s[1:] == comp_s[:-1]) & (key_s[1:] != key_s[:-1])
              & (comp_s[1:] < (nb << 32))).any()

    rank = _rank_in_group(bucket_s)
    live = bucket_s < nb
    overflow = (live & (rank >= D)).any()
    dest = torch.where(live & (rank < D), bucket_s * D + rank, nb * D).to(I32)
    padded, occ = pad([key_s, *pays_s], dest, valid.sum(dtype=I32), nb * D)
    tiles = [_tiles(x, plan) for x in padded]
    return LaneTables(plan=plan, key=tiles[0], pays=tiles[1:],
                      occ=_tiles(occ, plan),
                      blen=occ.reshape(nb, D).sum(1, dtype=I32).reshape(plan.npart, L),
                      ok=~overflow & ~hazard)


def lane_build(r: Table, plan: LanePlan, key: str = "key") -> LaneTables:
    """The build as one count-and-place kernel pair on the card
    (csrc/lane_build.cu); see build_lane_tables_ref for the contract:
    every output byte equal wherever `ok` is true, `ok` equal always
    (where a bucket overflows its rows are unspecified). Takes plans of
    depth at most LANE_BUILD_MAX_DEPTH. Calls counted in `.launches` (a
    call launches each of the two kernels once)."""
    dev = r.col(key).device
    if dev.type == "cpu":
        return build_lane_tables_ref(r, plan, key)
    if dev.type != "cuda":
        raise RuntimeError(f"lane_build: no kernel for device {dev}")
    if plan.depth > LANE_BUILD_MAX_DEPTH:
        raise ValueError(f"lane_build: depth {plan.depth} past {LANE_BUILD_MAX_DEPTH} "
                         "takes build_lane_tables_ref")
    rk = _as_i64(r.col(key)).contiguous()
    pays = [_as_i64(r.col(n)).contiguous() for n in r.names if n != key]
    if len(pays) > MAX_COLS - 1:  # as the sort path, whose PAD moves the key beside them
        raise ValueError(f"lane_build: at most {MAX_COLS - 1} payload columns")
    if r.capacity >= 2**31:
        raise ValueError("lane_build: int32 row ids need capacity < 2^31")
    shape = (plan.npart, plan.depth, L)
    t_key = torch.empty(shape, dtype=I64, device=dev)
    t_pays = [torch.empty(shape, dtype=I64, device=dev) for _ in pays]
    occ = torch.empty(shape, dtype=I32, device=dev)
    blen = torch.zeros((plan.npart, L), dtype=I32, device=dev)  # the kernel's counters
    ok = torch.empty((), dtype=torch.bool, device=dev)
    with _build.on_device(rk):
        code = _build.lib().tpq_lane_build(
            rk.data_ptr(), _build.ptr_array(pays), len(pays), r.num_rows.data_ptr(),
            r.num_rows.element_size(), r.capacity, plan.pbits, plan.depth, SALT_LANE,
            SALT_H2, t_key.data_ptr(), _build.ptr_array(t_pays), occ.data_ptr(),
            blen.data_ptr(), ok.data_ptr(), _build.stream_of(rk))
    _build.check(code, "lane_build")
    lane_build.launches += 1
    return LaneTables(plan=plan, key=t_key, pays=t_pays, occ=occ, blen=blen, ok=ok)


lane_build.launches = 0


def _build_takes_kernel(plan: LanePlan, device: torch.device) -> bool:
    """The build kernel takes CUDA tensors at a depth of at most
    LANE_BUILD_MAX_DEPTH; the rest take the sort path."""
    return device.type == "cuda" and plan.depth <= LANE_BUILD_MAX_DEPTH


@span("tpq.lane.build")
def build_lane_tables(r: Table, plan: LanePlan, key: str = "key") -> LaneTables:
    """The lane tables of r's live rows: the kernel on the card
    (lane_build), the sort path (build_lane_tables_ref) on a CPU tensor
    and past LANE_BUILD_MAX_DEPTH."""
    if _build_takes_kernel(plan, r.col(key).device):
        return lane_build(r, plan, key)
    return build_lane_tables_ref(r, plan, key)


def plan_pressure(r: Table, s: Table, plan: LanePlan, key: str = "key"):
    """What a relation pair asks of a plan's static capacities, before any
    join. Returns (load int64[nbuckets]: build rows per bucket, more than
    D overflow it; tail 0-d int64: the matches past the K-th of every
    probe row, which the tail window of tail_out_cap rows must hold)."""
    rk = _as_i64(r.col(key))[r.valid_mask()]
    load = torch.bincount(hash_keys(rk, plan.pbits + 7, SALT_LANE).to(I64),
                          minlength=plan.nbuckets)
    rs = torch.sort(rk).values
    sk = _as_i64(s.col(key))[s.valid_mask()]
    cnt = torch.searchsorted(rs, sk, right=True) - torch.searchsorted(rs, sk)
    return load, (cnt - plan.inline_k).clamp_min(0).sum()


def probe_layout_ref(plan: LanePlan, s: Table, key: str, keep=None):
    """Plain torch probe layout: defines the contract the kernels are
    held to, and is the sort path of plans past LAYOUT2_MAX_PARTS. Groups the
    queries by partition (one stable sort) and PADs them to the
    [npart * probe_cap] layout. `keep` (bool[capacity], optional) is a
    pushed-down filter: dropped rows go to the dead partition like
    padding.

    Returns (qk_p int64[u], spay_p [int64[u]], lane_p int32[u],
    qocc int32[u], overflow 0-d bool)."""
    npart, probe_cap = plan.npart, plan.probe_cap
    sk = _as_i64(s.col(key))
    spays = [_as_i64(s.col(n)) for n in s.names if n != key]
    valid = s.valid_mask()
    if keep is not None:
        valid = valid & keep
    h = hash_keys(sk, plan.pbits + 7, SALT_LANE)
    if npart == 1 and probe_cap == s.capacity:
        # one partition holding every query: the layout is the identity
        # (no sort, no PAD), padded probe order = row order
        return (sk, spays, (h & (L - 1)).to(I32), valid.to(I32),
                torch.zeros((), dtype=torch.bool, device=sk.device))
    bucket_p = torch.where(valid, h >> 7, npart)
    bp_s, perm = torch.sort(bucket_p, stable=True)

    rank = _rank_in_group(bp_s)
    live = bp_s < npart
    overflow = (live & (rank >= probe_cap)).any()
    dest = torch.where(live & (rank < probe_cap),
                       bp_s * probe_cap + rank, npart * probe_cap).to(I32)
    padded, qocc = pad([sk[perm], *[x[perm] for x in spays]], dest,
                       valid.sum(dtype=I32), npart * probe_cap)
    qk_p = padded[0]
    # lane from the padded keys (dead slots get a garbage lane that the
    # kernels mask with qocc)
    lane_p = (hash_keys(qk_p, plan.pbits + 7, SALT_LANE) & (L - 1)).to(I32)
    return qk_p, padded[1:], lane_p, qocc, overflow


def layout_passes(plan: LanePlan, capacity: int, device) -> int:
    """The probe layout's path for a plan over `capacity` rows on `device`,
    by shape alone: 1, the one-level kernel (probe_layout), up to
    LAYOUT_MAX_PARTS partitions; 2, the two-level kernels
    (probe_layout_two_level), up to LAYOUT2_MAX_PARTS; 0, the sort path
    (probe_layout_ref), past that, for the identity layout (one
    partition as wide as the table) and off the card."""
    if torch.device(device).type != "cuda" or (plan.npart == 1
                                               and plan.probe_cap == capacity):
        return 0
    if plan.npart <= LAYOUT_MAX_PARTS:
        return 1
    return 2 if plan.npart <= LAYOUT2_MAX_PARTS else 0


def _layout_operands(what: str, plan: LanePlan, s: Table, key: str, keep):
    """The layout kernels' checked operands: the key and the payloads as
    contiguous int64 (the key 16-byte aligned), keep contiguous, and the
    outputs (qk_p, spay_p, lane_p, qocc, overflow) made empty."""
    dev = s.col(key).device
    u = plan.npart * plan.probe_cap
    sk = _as_i64(s.col(key)).contiguous()
    spays = [_as_i64(s.col(n)).contiguous() for n in s.names if n != key]
    if len(spays) > MAX_COLS:
        raise ValueError(f"{what}: at most {MAX_COLS} payload columns")
    if u >= 2**31 or s.capacity >= 2**31:
        raise ValueError(f"{what}: int32 slots and rows need u, capacity < 2^31")
    if sk.data_ptr() % 16:  # the one-level count reads the keys in 16-byte loads
        sk = sk.clone()
    if keep is not None:
        if keep.dtype != torch.bool or tuple(keep.shape) != (s.capacity,) \
                or keep.device != dev:
            raise ValueError(f"{what}: keep must be bool[{s.capacity}] on {dev}")
        keep = keep.contiguous()
    outs = (torch.empty(u, dtype=I64, device=dev),
            [torch.empty(u, dtype=I64, device=dev) for _ in spays],
            torch.empty(u, dtype=I32, device=dev), torch.empty(u, dtype=I32, device=dev),
            torch.empty((), dtype=torch.bool, device=dev))
    return sk, spays, keep, outs


def probe_layout(plan: LanePlan, s: Table, key: str, keep=None):
    """The probe layout as one stable partition on the card
    (csrc/layout.cu: count, scan with the dead slots' fill, scatter); see
    probe_layout_ref for the contract, byte for byte over all u slots.
    Takes the plans layout_passes gives 1: at most LAYOUT_MAX_PARTS
    partitions, no identity layout. Calls counted in `.launches` (a call
    launches each of the three kernels once)."""
    dev = s.col(key).device
    if dev.type == "cpu":
        return probe_layout_ref(plan, s, key, keep)
    if dev.type != "cuda":
        raise RuntimeError(f"probe_layout: no kernel for device {dev}")
    if layout_passes(plan, s.capacity, dev) != 1:
        raise ValueError(f"probe_layout: {plan.npart} partitions of {plan.probe_cap} "
                         f"over {s.capacity} rows take another layout")
    sk, spays, keep, outs = _layout_operands("probe_layout", plan, s, key, keep)
    qk_p, spay_p, lane_p, qocc, overflow = outs
    ntiles = max(1, -(-s.capacity // LAYOUT_TILE))
    scratch = torch.empty((ntiles + 1) * plan.npart, dtype=I32, device=dev)
    with _build.on_device(sk):
        code = _build.lib().tpq_probe_layout(
            sk.data_ptr(), _build.ptr_array(spays), len(spays),
            keep.data_ptr() if keep is not None else None, s.num_rows.data_ptr(),
            s.num_rows.element_size(), s.capacity, plan.pbits, plan.probe_cap, SALT_LANE,
            qk_p.data_ptr(), _build.ptr_array(spay_p), lane_p.data_ptr(),
            qocc.data_ptr(), overflow.data_ptr(), scratch.data_ptr(), scratch.numel(),
            _build.stream_of(sk))
    _build.check(code, "probe_layout")
    probe_layout.launches += 1
    return outs


probe_layout.launches = 0


def probe_layout_two_level(plan: LanePlan, s: Table, key: str, keep=None):
    """The probe layout as two stable partitions on the card
    (csrc/layout.cu): the live rows by the high half of the partition
    bits into a compact intermediate, then each of those runs by the low
    half into its padded slots, the dead slots filled by the second
    pass's scan; see probe_layout_ref for the contract, byte for byte
    over all u slots. Takes the plans layout_passes gives 2: more than
    LAYOUT_MAX_PARTS partitions, at most LAYOUT2_MAX_PARTS. Holds an
    intermediate of the key and the payloads over the capacity meanwhile.
    Calls counted in `.launches` (a call launches its seven kernels once
    each)."""
    dev = s.col(key).device
    if dev.type == "cpu":
        return probe_layout_ref(plan, s, key, keep)
    if dev.type != "cuda":
        raise RuntimeError(f"probe_layout_two_level: no kernel for device {dev}")
    if layout_passes(plan, s.capacity, dev) != 2:
        raise ValueError(f"probe_layout_two_level: {plan.npart} partitions of "
                         f"{plan.probe_cap} over {s.capacity} rows take another layout")
    sk, spays, keep, outs = _layout_operands("probe_layout_two_level", plan, s, key, keep)
    qk_p, spay_p, lane_p, qocc, overflow = outs
    mid = torch.empty((1 + len(spays)) * s.capacity, dtype=I64, device=dev)
    with _build.on_device(sk):
        lib = _build.lib()
        scratch = torch.empty(lib.tpq_probe_layout2_scratch(s.capacity, plan.pbits),
                              dtype=I32, device=dev)
        code = lib.tpq_probe_layout2(
            sk.data_ptr(), _build.ptr_array(spays), len(spays),
            keep.data_ptr() if keep is not None else None, s.num_rows.data_ptr(),
            s.num_rows.element_size(), s.capacity, plan.pbits, plan.probe_cap, SALT_LANE,
            qk_p.data_ptr(), _build.ptr_array(spay_p), lane_p.data_ptr(),
            qocc.data_ptr(), overflow.data_ptr(), mid.data_ptr(), mid.numel(),
            scratch.data_ptr(), scratch.numel(), _build.stream_of(sk))
    _build.check(code, "probe_layout_two_level")
    probe_layout_two_level.launches += 1
    return outs


probe_layout_two_level.launches = 0


@span("tpq.lane.layout")
def _probe_layout(plan: LanePlan, s: Table, key: str, keep=None):
    """The probe layout of the lane joins, by layout_passes: the one-level
    kernel (probe_layout), the two-level kernels (probe_layout_two_level)
    or the plain sort path (probe_layout_ref). Observes the path taken as
    `tpq.lane.layout_passes` (a constant beside the graph: 0 the sort
    path, 1 or 2 the kernels' passes). Returns probe_layout_ref's
    tuple."""
    passes = layout_passes(plan, s.capacity, s.col(key).device)
    observe("tpq.lane.layout_passes", passes)
    return (probe_layout_ref, probe_layout, probe_layout_two_level)[passes](plan, s, key, keep)


# ---------------------------------------------------------------------------
# work items of the walk kernels
# ---------------------------------------------------------------------------

def work_item_queries(plan: LanePlan, ctas_at_once) -> int:
    """Padded queries per CTA of a walk kernel: of a whole partition (up
    to MAX_CHUNK), 2,048 and 1,024, the size with the least waves x (CTA
    overhead + queries), a wave being ctas_at_once(size), the CTAs of the
    kernel at that size that the card holds at once."""
    best = None
    for chunk in sorted({min(plan.probe_cap, q) for q in (MAX_CHUNK, 2048, 1024)},
                        reverse=True):
        nwork = plan.npart * -(-plan.probe_cap // chunk)
        cost = -(-nwork // max(1, ctas_at_once(chunk))) * (CTA_OVERHEAD_QUERIES + chunk)
        if best is None or cost < best[0]:
            best = (cost, chunk)
    return best[1]


@functools.lru_cache(maxsize=None)
def probe_walk_chunk(plan: LanePlan, device_index: int) -> int:
    """work_item_queries of the walk-only probe, kept per plan and card
    (its wrapper asks on every call). Its CTAs at once do not depend on
    the size: the whole key tile is its shared memory. Its cost per CTA
    is taken to be the walk/emit's; chip_smoke.py's sweeps show the pick
    the fastest size at config 3's membership and at config 1's tables
    (PERF.md)."""
    slots = _build.lib().tpq_probe_walk_slots(plan.depth)
    return work_item_queries(plan, lambda chunk: slots)


# ---------------------------------------------------------------------------
# the walk-only probe (kernel 4)
# ---------------------------------------------------------------------------

def walk_ref(tables: LaneTables, qk, lane, qocc, n_sel: int):
    """Plain torch bucket walk shared by both probe kernels' plain
    versions (tpq's _walk). Each live padded query q of partition
    p = q // probe_cap walks depths d < blen[p, lane[q]] of its bucket.
    Returns (cnt int32[u], d_first int32[u] (-1 without a match),
    d_sel [int64[u]] * n_sel: the depth of match j, 0 where j >= cnt,
    base int64[u]: the flat table slot of depth 0)."""
    plan = tables.plan
    D, dev = plan.depth, qk.device
    u = plan.npart * plan.probe_cap
    p = torch.arange(u, device=dev) // plan.probe_cap
    live = qocc > 0
    lane = lane.to(I64)
    blen = tables.blen[p, lane]
    base = p * (D * L) + lane
    key_flat = tables.key.reshape(-1)
    cnt = torch.zeros(u, dtype=I32, device=dev)
    d_first = torch.full((u,), -1, dtype=I32, device=dev)
    d_sel = [torch.zeros(u, dtype=I64, device=dev) for _ in range(n_sel)]
    for d in range(D):
        m = live & (d < blen) & (key_flat[base + d * L] == qk)
        for j in range(n_sel):
            d_sel[j] = torch.where(m & (cnt == j), d, d_sel[j])
        d_first = torch.where(m & (cnt == 0), d, d_first)
        cnt += m.to(I32)
    return cnt, d_first, d_sel, base


def probe_walk_ref(tables: LaneTables, qk, lane, qocc):
    """Plain torch walk-only probe: defines the contract the kernel is
    held to. Returns (cnt int32[u], d_first int32[u], pays): pays[j][i]
    int64[u] is build payload column i of query q's match j for
    j < min(cnt, K), else 0 (dead queries: cnt 0, d_first -1)."""
    K = tables.plan.inline_k
    cnt, d_first, d_sel, base = walk_ref(tables, qk, lane, qocc, K)
    flats = [t.reshape(-1) for t in tables.pays]
    pays = [[torch.where(cnt > j, f[base + d_sel[j] * L], 0) for f in flats]
            for j in range(K)]
    return cnt, d_first, pays


def probe_walk(tables: LaneTables, qk, lane, qocc):
    """The walk-only probe on the padded probe layout; see
    probe_walk_ref for the contract. Launches counted in `.launches`."""
    if qk.device.type == "cpu":
        return probe_walk_ref(tables, qk, lane, qocc)
    if qk.device.type != "cuda":
        raise RuntimeError(f"probe_walk: no kernel for device {qk.device}")
    plan = tables.plan
    D, K, npart, probe_cap = plan.depth, plan.inline_k, plan.npart, plan.probe_cap
    u = npart * probe_cap
    dev = qk.device
    if D * L * 8 + 1024 > SMEM_LIMIT:
        raise ValueError(f"probe_walk: depth {D} does not fit shared memory")
    if len(tables.pays) > MAX_COLS or not 1 <= K <= MAX_K:
        raise ValueError(f"probe_walk: at most {MAX_COLS} payload columns and "
                         f"1 <= K <= {MAX_K}")
    if u >= 2**31:
        raise ValueError("probe_walk: int32 query indices need u < 2^31")

    def need(t, shape, dtype, what):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"probe_walk: {what} must be {dtype}{shape} on "
                             f"{dev}, got {t.dtype}{tuple(t.shape)} on {t.device}")
        return t.contiguous()

    def aligned(t):  # the tile copy and the bucket lengths' loads take 16 bytes
        return t if t.data_ptr() % 16 == 0 else t.clone()

    tshape = (npart, D, L)
    t_key = aligned(need(tables.key, tshape, I64, "table key"))
    t_pays = [need(t, tshape, I64, "table payload") for t in tables.pays]
    blen = aligned(need(tables.blen, (npart, L), I32, "blen"))
    qk = need(qk, (u,), I64, "query key")
    lane = need(lane, (u,), I32, "lane")
    qocc = need(qocc, (u,), I32, "qocc")

    cnt = torch.empty(u, dtype=I32, device=dev)
    d_first = torch.empty(u, dtype=I32, device=dev)
    pays = [[torch.empty(u, dtype=I64, device=dev) for _ in t_pays]
            for _ in range(K)]
    with _build.on_device(qk):
        chunk = probe_walk_chunk(plan, dev.index)
        code = _build.lib().tpq_probe_walk(
            t_key.data_ptr(), _build.ptr_array(t_pays), len(t_pays),
            blen.data_ptr(), npart, D, K, probe_cap, chunk, qk.data_ptr(),
            lane.data_ptr(), qocc.data_ptr(), cnt.data_ptr(), d_first.data_ptr(),
            _build.ptr_array([o for row in pays for o in row]),
            _build.stream_of(qk))
    _build.check(code, "probe_walk")
    probe_walk.launches += 1
    return cnt, d_first, pays


probe_walk.launches = 0


def probe_lane_tables(tables: LaneTables, s: Table, key: str = "key"):
    """Probe layout + walk-only probe. Returns (qk_p int64[u], spay_p
    [int64[u]], cnt int32[u], d_first int32[u], inline_pays [K][npay]
    int64[u], qocc int32[u], lane_p int32[u], overflow 0-d bool), all in
    the padded [npart * probe_cap] probe order. tpq's inline payloads
    are 32-bit planes; here npay counts int64 columns."""
    qk_p, spay_p, lane_p, qocc, overflow = _probe_layout(tables.plan, s, key)
    cnt, d_first, pays = probe_walk(tables, qk_p, lane_p, qocc)
    return qk_p, spay_p, cnt, d_first, pays, qocc, lane_p, overflow


# ---------------------------------------------------------------------------
# emit, tail and the ok flag
# ---------------------------------------------------------------------------

def _splice_tail(cols, tables: LaneTables, cnt_eff, d_first, qk_p, spay_p,
                 lane_p, total_inline, out_capacity: int) -> None:
    """Append the matches past the K-th of every query after the inline
    rows, in place. PACK carries only the padded row ids; the rest is
    gathered at tail size. The tail rows are PADded into a small window
    at total_inline and added into the output."""
    plan = tables.plan
    K, D, dev = plan.inline_k, plan.depth, cnt_eff.device
    u = plan.npart * plan.probe_cap
    # no more tail queries than queries: a one-partition plan over fewer
    # than tail_rows_cap rows has u < tail_rows_cap (tpq's shapes
    # disagree there)
    tcap = min(plan.tail_rows_cap, u)
    window = min(plan.tail_out_cap + 2048, out_capacity)

    (tq,), n_t = pack([torch.arange(u, dtype=I32, device=dev)],
                      (cnt_eff > K).to(I32))
    tq = tq[:tcap].clamp_max(u - 1).to(I64)
    t_live = torch.arange(tcap, device=dev) < n_t
    counts_t = torch.where(t_live, cnt_eff[tq] - K, 0)
    seg, rnk, _, vout = expand_segments(counts_t, plan.tail_out_cap)
    qsrc = tq[seg]
    # the matched run is contiguous in d (same h2, checked at build):
    # extra match m sits at d_first + K + m in the same bucket
    d_pick = (d_first[qsrc] + K + rnk).clamp_max(D - 1)
    slot = (((qsrc // plan.probe_cap) * D + d_pick) * L
            + lane_p[qsrc]).clamp(0, plan.npart * D * L - 1)
    tail_cols = ([torch.where(vout, qk_p[qsrc], 0)]
                 + [torch.where(vout, t.reshape(-1)[slot], 0) for t in tables.pays]
                 + [torch.where(vout, x[qsrc], 0) for x in spay_p])

    tail_n = torch.minimum(vout.sum(dtype=I32),
                           (out_capacity - total_inline).clamp_min(0))
    w0 = ((total_inline // 1024) * 1024).clamp(0, max(out_capacity - window, 0))
    # rows whose window-relative dest >= window are dropped by pad; that
    # only happens when the output overflows, which num_rows reports
    wdest = (total_inline - w0) + torch.arange(plan.tail_out_cap, dtype=I32,
                                               device=dev)
    wcols, _ = pad(tail_cols, wdest, tail_n, window)
    # slots at/after total_inline hold unwritten rows: clear, then add
    widx = w0.to(I64) + torch.arange(window, device=dev)
    in_tail = widx >= total_inline
    for c, wq in zip(cols, wcols):
        c[widx] = torch.where(in_tail, 0, c[widx]) + wq


def _probe_emit_common(fused_fn, tables: LaneTables, s: Table,
                       out_capacity: int, key: str,
                       r_names: list[str] | None, r_dtypes: list | None,
                       keep=None) -> tuple[Table, torch.Tensor]:
    """Emit, tail and regroup around the fused walk+emit
    (tpq_torch.kernels.lane2.fused_probe_emit2). Returns (table, ok)."""
    plan = tables.plan
    K = plan.inline_k
    if r_names is None:
        r_names = [f"p{i}" for i in range(len(tables.pays))]
        r_dtypes = [I64] * len(tables.pays)
    s_names = [n for n in s.names if n != key]

    (out_cols, cnt, d_first, qk_p, spay_p, qocc, lane_p,
     probe_ovf) = fused_fn(tables, s, out_capacity, key, keep=keep)

    cnt_eff = torch.where(qocc > 0, cnt, 0)
    # int64 sums are native on the card, so tpq's i32 branch for
    # u * D < 2^31 collapses into its i64 form
    total64 = cnt_eff.sum(dtype=I64)
    inline64 = cnt_eff.clamp_max(K).sum(dtype=I64)
    total = total64.clamp_max(2**31 - 1).to(I32)
    total_inline = inline64.clamp_max(2**31 - 1).to(I32)
    tail_out64 = total64 - inline64
    tail_queries = (cnt_eff > K).sum()
    caps_ok = ((tail_queries <= plan.tail_rows_cap)
               & (tail_out64 <= plan.tail_out_cap)
               & (total_inline <= out_capacity))
    ok = tables.ok & ~probe_ovf & caps_ok
    # how full the tail's window runs, and the walk/emit's shapes (the
    # benchmark's emit roofline counts its least bytes from them)
    observe("tpq.lane.tail_queries", tail_queries)
    observe("tpq.lane.tail_rows", tail_out64)
    observe("tpq.lane.inline_rows", inline64)
    observe("tpq.lane.tail_cap", plan.tail_out_cap)
    observe("tpq.lane.probe_slots", plan.npart * plan.probe_cap)
    observe("tpq.lane.table_slots", plan.npart * plan.depth * L)
    observe("tpq.lane.build_payloads", len(tables.pays))
    observe("tpq.lane.probe_payloads", len(spay_p))

    # the Table contract leaves rows >= num_rows unspecified: the emit
    # buffer's unwritten slots stay as they are. tpq's lax.cond(tail_out >
    # 0, ...) is dropped: with no tail rows PACK finds none, every
    # expanded slot is invalid, and only the slots at or after
    # total_inline change, which lie past num_rows (no host read)
    cols = list(out_cols)
    _splice_tail(cols, tables, cnt_eff, d_first, qk_p, spay_p, lane_p,
                 total_inline, out_capacity)

    names = [key] + [f"r_{n}" for n in r_names] + [f"s_{n}" for n in s_names]
    dtypes = ([s.col(key).dtype] + list(r_dtypes)
              + [s.col(n).dtype for n in s_names])
    return Table({n: c.to(dt) for n, c, dt in zip(names, cols, dtypes)},
                 total), ok
