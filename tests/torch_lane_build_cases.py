"""Lane-build inputs that a count-and-place kernel can get wrong, and a
numpy statement of its algorithm, shared by
tests/test_torch_lane_build.py (the statement against the sort path,
build_lane_tables_ref, on the CPU) and tests/test_torch_cuda.py (the
kernel against the sort path, on the card). Each case is built from a
seed with numpy; the card runs it at its own size (`card=True`: the
uniform 2^20 join's 512 partitions, a 16,384-partition plan), the CPU
small."""

import numpy as np

from tpq_torch.hashing import np_hash_keys
from tpq_torch.kernels.lane_table import L, SALT_H2, SALT_LANE, LanePlan
from tpq_torch.kernels.move import MAX_COLS

# the h2-colliding pair of tests/test_kernels.py: one (bucket, h2) at
# pbits 3, two keys
H2_PAIR = (7302945295039616556, 3449075177175606448)

CASES = ("uniform", "one_part_d48", "one_part_d64", "many_parts_dead_slots", "d72",
         "d108", "int32_keys", "pays_0", "pays_max", "num_rows_0", "bucket_at_d",
         "bucket_past_d", "h2_pair")


def buckets(keys: np.ndarray, pbits: int) -> np.ndarray:
    return np_hash_keys(keys.astype(np.int64), pbits + 7, SALT_LANE).astype(np.int64)


def h2s(keys: np.ndarray) -> np.ndarray:
    return np_hash_keys(keys.astype(np.int64), 32, SALT_H2).astype(np.int64) & 0xFFFFFFFF


def _plan(pbits: int, depth: int) -> LanePlan:
    return LanePlan(pbits=pbits, depth=depth, probe_cap=1024, inline_k=4,
                    tail_rows_cap=2048, tail_out_cap=4096)


def build_case(name: str, card: bool = False):
    """(plan, columns {"key", "p0", ...} of the capacity's rows, num_rows)
    of a named case. Keys repeat (about every fifth live row copies
    another), so equal keys share a bucket and h2 and their rows keep
    row order; rows past num_rows hold keys of their own, which the
    build must ignore."""
    rng = np.random.default_rng(sum(map(ord, name)) + 1000 * card)
    # pbits, depth, capacity, live rows, key range (0: any int64)
    pbits, depth, cap, live, span = {
        "uniform": (9, 48, 1 << 20, (1 << 20) - 17, 1 << 20) if card
        else (3, 48, 1 << 14, 15_000, 1 << 14),
        "one_part_d48": (0, 48, 4096, 3_000, 0),
        "one_part_d64": (0, 64, 8192, 4_500, 0),
        "many_parts_dead_slots": (14, 48, 1 << 18, 150_001, 0) if card
        else (8, 48, 1 << 14, 9_001, 0),
        "d72": (3, 72, 1 << 16, 40_000, 0),
        "d108": (3, 108, 1 << 17, 64_000, 0),
        "int32_keys": (3, 48, 1 << 14, 12_000, 0),
        "pays_0": (3, 48, 1 << 14, 12_000, 0),
        "pays_max": (3, 48, 1 << 14, 12_000, 0),
        "num_rows_0": (3, 48, 1 << 14, 0, 0),
        "bucket_at_d": (3, 48, 1 << 14, 12_000, 0),
        "bucket_past_d": (3, 48, 1 << 14, 12_000, 0),
        "h2_pair": (3, 48, 1 << 14, 12_000, 0),
    }[name]
    # the most payloads a build takes: the sort path's PAD moves the key
    # beside them in at most MAX_COLS columns
    npay = {"pays_0": 0, "pays_max": MAX_COLS - 1}.get(name, 1 if name == "uniform" else 2)
    if name == "int32_keys":
        keys = rng.integers(-(1 << 31), 1 << 31, cap).astype(np.int32)
        pays = [rng.integers(-(1 << 31), 1 << 31, cap).astype(np.int32) for _ in range(npay)]
    else:
        keys = (rng.integers(0, span, cap) if span
                else rng.integers(-(1 << 62), 1 << 62, cap))
        pays = [rng.integers(-(1 << 62), 1 << 62, cap) for _ in range(npay)]
    if not span and live > 5:
        keys[3:live:5] = keys[1:live - 2:5]
    if name in ("bucket_at_d", "bucket_past_d"):
        # one bucket holds D live rows of distinct keys, or one past D:
        # its own rows get keys of other buckets, then D (D + 1) rows get
        # keys of its own
        want = depth + (name == "bucket_past_d")
        pool = rng.integers(-(1 << 62), 1 << 62, 4 * want << (pbits + 7))
        pb = buckets(pool, pbits)
        inside, outside = pool[pb == pb[0]], pool[pb != pb[0]]
        assert len(inside) >= want
        mine = np.flatnonzero(buckets(keys[:live], pbits) == pb[0])
        keys[mine] = outside[:len(mine)]
        keys[rng.choice(live, want, replace=False)] = inside[:want]
    if name == "h2_pair":
        keys[[5, live - 9, live // 2]] = [H2_PAIR[0], H2_PAIR[1], H2_PAIR[0]]
    cols = {"key": keys, **{f"p{i}": p for i, p in enumerate(pays)}}
    return _plan(pbits, depth), cols, live


def np_lane_build(plan: LanePlan, cols: dict, num_rows: int, seed: int = 0):
    """The build kernel's algorithm stated in numpy
    (tpq_torch/csrc/lane_build.cu). Count and place: the live rows
    arrive in an order drawn from `seed` (the atomics' order); each
    takes the next depth of its bucket, and a depth under D parks the
    word (h2 << 32) | row. Finish: each bucket's parked words sorted as
    unsigned 64-bit values, depth d of column (p, l) gets the key and
    payloads of the d-th row (widened to int64) and occ 1, every other
    slot 0; blen = min(count, D); ok false on a count past D or on two
    neighbours with one h2 and two keys. Returns (key, [pays], occ,
    blen, ok, count per bucket)."""
    npart, D, nb = plan.npart, plan.depth, plan.nbuckets
    live = max(0, min(num_rows, len(cols["key"])))
    key = cols["key"][:live].astype(np.int64)
    pays = [v[:live].astype(np.int64) for k, v in cols.items() if k != "key"]
    b = buckets(key, plan.pbits)
    h2 = h2s(key)
    arrival = np.random.default_rng(seed).permutation(live)
    depth = np.empty(live, np.int64)
    by_bucket = arrival[np.argsort(b[arrival], kind="stable")]
    count = np.bincount(b, minlength=nb)
    first = np.concatenate([[0], np.cumsum(count)[:-1]])
    depth[by_bucket] = np.arange(live) - first[b[by_bucket]]
    parked = np.flatnonzero(depth < D)
    word = ((h2[parked] << 32) | parked).astype(np.uint64)
    order = parked[np.lexsort((word, b[parked]))]  # each bucket's words sorted
    pb = b[order]
    d = np.arange(len(order)) - np.searchsorted(pb, pb)  # the depth in its bucket
    slot = ((pb >> 7) * D + d) * L + (pb & (L - 1))
    t_key = np.zeros(npart * D * L, np.int64)
    t_key[slot] = key[order]
    t_pays = []
    for p in pays:
        t = np.zeros(npart * D * L, np.int64)
        t[slot] = p[order]
        t_pays.append(t)
    occ = np.zeros(npart * D * L, np.int32)
    occ[slot] = 1
    same = (pb[1:] == pb[:-1]) & (h2[order][1:] == h2[order][:-1])
    hazard = bool((same & (key[order][1:] != key[order][:-1])).any())
    ok = not hazard and not bool((count > D).any())
    shape = (npart, D, L)
    return (t_key.reshape(shape), [t.reshape(shape) for t in t_pays], occ.reshape(shape),
            np.minimum(count, D).astype(np.int32).reshape(npart, L), ok, count)


def bucket_order(b: np.ndarray, h2: np.ndarray, D: int, seed: int) -> dict:
    """The kernel's order stated bucket by bucket, as it makes it: the
    rows arrive in an order drawn from `seed`, each bucket keeps the
    first D arrivals' words (h2 << 32) | row, and the finish sorts them
    by insertion. Returns {bucket: [rows in depth order]}."""
    parked: dict = {}
    for row in np.random.default_rng(seed).permutation(len(b)):
        col = parked.setdefault(int(b[row]), [])
        if len(col) < D:
            col.append((int(h2[row]) << 32) | int(row))
    out = {}
    for bucket, col in parked.items():
        for i in range(1, len(col)):
            v, j = col[i], i
            while j > 0 and col[j - 1] > v:
                col[j] = col[j - 1]
                j -= 1
            col[j] = v
        out[bucket] = [w & 0xFFFFFFFF for w in col]
    return out
