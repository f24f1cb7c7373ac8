"""Probe-layout inputs that a tiled partition kernel can get wrong, a
numpy statement of the layout and one of the two-level layout's passes,
shared by tests/test_torch_layout.py (the plain version against numpy
and tpq, the two-level statement against the layout's, on the CPU) and
tests/test_torch_cuda.py (the kernels against the plain version, on the
card). Each case is built from a seed with numpy; its partition count
and row count are parameters, so that the card can run it over many
4,096-row tiles and a ragged last one while the CPU runs it small."""

import numpy as np

from tpq_torch.hashing import np_hash_keys
from tpq_torch.kernels.lane_table import LAYOUT_TILE, SALT_LANE, LanePlan

CASES = ("keep_none", "keep_half", "keep_all_false", "num_rows_below", "num_rows_0",
         "overflow", "int32", "pays_0", "pays_1", "pays_3")


def _partition(keys: np.ndarray, pbits: int) -> np.ndarray:
    return np_hash_keys(keys.astype(np.int64), pbits + 7, SALT_LANE).astype(np.int64) >> 7


def layout_case(name: str, npart: int, rows: int):
    """(plan, columns {"key", "p0", ...} of `rows` rows, num_rows, keep
    bool[rows] or None) of a named case. probe_cap is twice the mean live
    rows a partition plus an odd 21, so that no tile size divides the
    layout; "overflow" sends three fifths of the rows to partition 0,
    past a probe_cap of 1.5 times the mean plus 5. Keys repeat (every
    seventh row copies another)."""
    rng = np.random.default_rng(sum(map(ord, name)) + 7 * npart + rows)
    pbits = npart.bit_length() - 1
    npay = {"pays_0": 0, "pays_1": 1, "pays_3": 3}.get(name, 2)
    if name == "int32":
        keys = rng.integers(-(1 << 31), 1 << 31, rows).astype(np.int32)
        pays = [rng.integers(-(1 << 31), 1 << 31, rows).astype(np.int32) for _ in range(npay)]
    else:
        keys = rng.integers(-(1 << 62), 1 << 62, rows)
        pays = [rng.integers(-(1 << 62), 1 << 62, rows) for _ in range(npay)]
    keys[3::7] = keys[:rows - 3:7]
    if name == "overflow":
        pool = rng.integers(-(1 << 62), 1 << 62, 64 * npart + 4096)
        pool = pool[_partition(pool, pbits) == 0]
        heavy = rng.random(rows) < 0.6
        keys[heavy] = rng.choice(pool, int(heavy.sum()))
    num_rows = {"num_rows_below": rows * 2 // 3 + 1, "num_rows_0": 0}.get(name, rows)
    keep = {"keep_half": rng.random(rows) < 0.5,
            "keep_all_false": np.zeros(rows, bool)}.get(name)
    live = max(1, num_rows if keep is None else int(keep[:num_rows].sum()))
    mean = max(1, live // npart)
    probe_cap = mean * 3 // 2 + 5 if name == "overflow" else mean * 2 + 21
    plan = LanePlan(pbits=pbits, depth=48, probe_cap=probe_cap, inline_k=4,
                    tail_rows_cap=2048, tail_out_cap=4096)
    cols = {"key": keys, **{f"p{i}": p for i, p in enumerate(pays)}}
    return plan, cols, num_rows, keep


def np_probe_layout(plan: LanePlan, cols: dict, num_rows: int, keep):
    """The layout stated in numpy: partition p's live rows (row < num_rows
    and keep), in row order, fill slots p * probe_cap + rank for rank <
    probe_cap with the key, the payloads (both widened to int64), lane
    hash & 127 and qocc 1; every other slot holds key and payloads 0,
    qocc 0 and lane hash(0) & 127. overflow: a partition holds more live
    rows than probe_cap. Returns (qk, [pays], lane, qocc, overflow)."""
    npart, cap = plan.npart, plan.probe_cap
    u = npart * cap
    bits = plan.pbits + 7
    key = cols["key"].astype(np.int64)
    pays = [v.astype(np.int64) for k, v in cols.items() if k != "key"]
    valid = np.arange(len(key)) < num_rows
    if keep is not None:
        valid &= keep
    h = np_hash_keys(key, bits, SALT_LANE).astype(np.int64)
    qk = np.zeros(u, np.int64)
    qpays = [np.zeros(u, np.int64) for _ in pays]
    lane = np.full(u, np_hash_keys(np.zeros(1, np.int64), bits, SALT_LANE)[0] & 127, np.int32)
    qocc = np.zeros(u, np.int32)
    overflow = False
    for p in range(npart):
        rows = np.flatnonzero(valid & (h >> 7 == p))
        overflow |= len(rows) > cap
        rows = rows[:cap]
        slots = p * cap + np.arange(len(rows))
        qk[slots] = key[rows]
        for q, v in zip(qpays, pays):
            q[slots] = v[rows]
        lane[slots] = h[rows] & 127
        qocc[slots] = 1
    return qk, qpays, lane, qocc, overflow


def _stable_ranks(ids: np.ndarray):
    """(order, rank): the rows of `ids` stably sorted by id, and each
    sorted row's rank among the rows of its id."""
    order = np.argsort(ids, kind="stable")
    sorted_ids = ids[order]
    return order, np.arange(len(ids)) - np.searchsorted(sorted_ids, sorted_ids)


def np_two_level_layout(plan: LanePlan, cols: dict, num_rows: int, keep,
                        tile: int = LAYOUT_TILE):
    """The two-level layout of csrc/layout.cu stated in numpy, tile by
    tile, its tables as the kernels keep them. Partition p = g << f | j,
    c = pbits // 2 group bits g over f = pbits - c fine bits j. Coarse:
    each tile's live rows of group g go, in row order, to the compact
    intermediate after group g's rows of the tiles before it (ccounts,
    scanned per group, from the group's first row gbase). Fine: group g's
    run cut into tiles of `tile` rows (fine tile T of g: gtile[g] <= T <
    gtile[g + 1], fewer than ntiles + 2^c in all), each tile's rows of
    fine id j put in row order after the partition's rows of the tiles
    before it (fcounts, scanned over the group's tiles), ranks at or past
    probe_cap dropped; every partition's slots past its rows written
    dead. Returns np_probe_layout's tuple."""
    npart, cap = plan.npart, plan.probe_cap
    c = plan.pbits // 2
    f = plan.pbits - c
    ngroups, nfine = 1 << c, 1 << f
    key = cols["key"].astype(np.int64)
    pays = [v.astype(np.int64) for k, v in cols.items() if k != "key"]
    n = len(key)
    valid = np.arange(n) < num_rows
    if keep is not None:
        valid &= keep
    h = np_hash_keys(key, plan.pbits + 7, SALT_LANE).astype(np.int64)
    part = h >> 7

    # coarse
    ntiles = max(1, -(-n // tile))
    tiles = [np.flatnonzero(valid[t * tile:(t + 1) * tile]) + t * tile for t in range(ntiles)]
    ccounts = np.stack([np.bincount(part[rows] >> f, minlength=ngroups) for rows in tiles], 1)
    gtotal = ccounts.sum(1)
    gbase = np.concatenate([[0], np.cumsum(gtotal)])
    ccounts = gbase[:-1, None] + np.cumsum(ccounts, 1) - ccounts
    mid = np.full(n, -1, np.int64)  # the source row of each intermediate row
    for t, rows in enumerate(tiles):
        order, rank = _stable_ranks(part[rows] >> f)
        mid[ccounts[part[rows[order]] >> f, t] + rank] = rows[order]
    assert (mid[:gbase[-1]] >= 0).all()

    # fine
    ftiles = ntiles + ngroups
    gtile = np.concatenate([[0], np.cumsum(-(-gtotal // tile))])
    assert gtile[-1] <= ftiles
    fine = []  # (group, source rows) of each fine tile
    for t in range(gtile[-1]):
        g = int(np.searchsorted(gtile, t, side="right") - 1)
        start = gbase[g] + (t - gtile[g]) * tile
        fine.append((g, mid[start:min(start + tile, gbase[g + 1])]))
    fcounts = np.zeros((nfine, ftiles), np.int64)
    for t, (_, rows) in enumerate(fine):
        fcounts[:, t] = np.bincount(part[rows] & (nfine - 1), minlength=nfine)
    total = np.zeros(npart, np.int64)
    for g in range(ngroups):
        run = fcounts[:, gtile[g]:gtile[g + 1]]
        total[g << f:(g + 1) << f] = run.sum(1)
        fcounts[:, gtile[g]:gtile[g + 1]] = np.cumsum(run, 1) - run

    bits = plan.pbits + 7
    garbage = -0x5A5A5A5A5A5A5A5A  # in no slot once every slot is written
    qk = np.full(npart * cap, garbage, np.int64)
    qpays = [np.full(npart * cap, garbage, np.int64) for _ in pays]
    lane = np.full(npart * cap, garbage & 0x7FFFFFFF, np.int32)
    qocc = np.full(npart * cap, garbage & 0x7FFFFFFF, np.int32)
    dead_lane = np_hash_keys(np.zeros(1, np.int64), bits, SALT_LANE)[0] & 127
    for p in range(npart):
        dead = slice(p * cap + min(total[p], cap), (p + 1) * cap)
        qk[dead] = 0
        for q in qpays:
            q[dead] = 0
        lane[dead] = dead_lane
        qocc[dead] = 0
    for t, (g, rows) in enumerate(fine):
        order, rank = _stable_ranks(part[rows] & (nfine - 1))
        rows = rows[order]
        j = part[rows] & (nfine - 1)
        r = fcounts[j, t] + rank
        kept = r < cap
        slots = ((g << f) | j[kept]) * cap + r[kept]
        rows = rows[kept]
        qk[slots] = key[rows]
        for q, v in zip(qpays, pays):
            q[slots] = v[rows]
        lane[slots] = h[rows] & 127
        qocc[slots] = 1
    return qk, qpays, lane, qocc, bool((total > cap).any())
