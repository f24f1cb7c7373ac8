"""Inputs of the aggregate that a tiled kernel can get wrong, shared by
tests/test_torch_aggregate.py (the plain versions against numpy, on the
CPU) and tests/test_torch_cuda.py (the kernels against the plain
versions, on the card). `agg_case` is a key-sorted table as sort_rows
hands it to the run-end pass: keys ascending over the valid rows, the
dtype's max in the padding rows, whose values are noise that must reach
no output. `hash_case` is the same rows as the group table's pass takes
them: the valid rows shuffled, the padding's keys noise too. Built from a
seed with numpy; `scale` multiplies the rows, so that the card can run a
case over more 4,096-row tiles than the CPU."""

import numpy as np

TILE = 4096  # the kernel's tile (AGG_TILE in tpq_torch/kernels/aggregate.py)
IX = np.iinfo(np.int64).max
IN = np.iinfo(np.int64).min

CASES = ("rows_0", "rows_1", "rows_n", "rows_past_n", "one_run", "all_distinct",
         "int64_max_key", "int32", "wrapping_sums", "runs_4095_4096_4097", "one_value",
         "fourteen_values", "fifteen_values", "no_values", "int64_min_max_keys")


def _values(rng, n, dtypes):
    return [rng.integers(0, IX, n, dtype=np.int64) if d == "i64"
            else rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32) for d in dtypes]


def _sorted_keys(rng, n, domain, dtype=np.int64):
    return np.sort(rng.integers(0, domain, n)).astype(dtype)


def agg_case(name: str, scale: int = 1):
    """(key, [values], num_rows) of a named case; num_rows may exceed the
    capacity (an overflowed join's count)."""
    rng = np.random.default_rng(sum(map(ord, name)) + scale)
    n = 3 * TILE * scale + 517
    dtypes = ["i64", "i64", "i64"]
    live = n - 1000 * scale
    kdt = np.int64
    if name == "rows_0":
        live = 0
    elif name == "rows_1":
        live = 1
    elif name == "rows_n":
        live = n
    elif name == "rows_past_n":
        live = n + 1000
    elif name == "int32":
        kdt, dtypes = np.int32, ["i32", "i32", "i64"]
    elif name == "one_value":
        dtypes = ["i64"]
    elif name == "fourteen_values":
        dtypes = ["i64", "i32"] * 7
    elif name == "fifteen_values":
        dtypes = ["i64"] * 15
    elif name == "no_values":
        dtypes = []
    valid = min(live, n)
    if name == "one_run":
        keys = np.full(valid, 7, kdt)
    elif name == "all_distinct":
        keys = np.arange(valid, dtype=kdt) * 3 - 5
    elif name == "int64_max_key":
        # real INT64_MAX keys at the end of the valid rows, next to the
        # padding's INT64_MAX: they stay a group of their own
        keys = _sorted_keys(rng, valid, 1 << 40)
        keys[-3:] = IX
    elif name == "int64_min_max_keys":
        # INT64_MIN and INT64_MAX groups about the others, -1 and 0 among them
        keys = np.sort(np.concatenate([rng.integers(-(1 << 40), 1 << 40, valid - 9),
                                       [IN] * 4, [IX] * 3, [-1, 0]])).astype(kdt)
    elif name == "wrapping_sums":
        keys = np.repeat(np.arange(-(-valid // 2), dtype=kdt), 2)[:valid]
    elif name == "runs_4095_4096_4097":
        # runs of a tile's length and one off it, so that run ends fall
        # on, before and after tile boundaries
        lens = np.tile([TILE - 1, TILE, TILE + 1, 1, 2], -(-valid // (3 * TILE)))
        keys = np.repeat(np.arange(len(lens), dtype=kdt), lens)[:valid]
    else:
        keys = _sorted_keys(rng, valid, max(1, valid // 100), kdt)
    key = np.full(n, np.iinfo(kdt).max, kdt)
    key[:valid] = keys
    values = _values(rng, n, dtypes)
    if name == "wrapping_sums":
        values[0][:] = IX - rng.integers(0, 1000, n)  # two of them overflow int64
    return key, values, live


def np_aggregate(key, values, num_rows):
    """numpy's groups of the valid rows: np.unique's runs, sums in uint64
    (which wrap); every output row from the group count on 0. Returns
    ([key', count, sums...], G)."""
    n = len(key)
    live = max(0, min(num_rows, n))
    uk, starts, counts = np.unique(key[:live], return_index=True, return_counts=True)
    g = len(uk)
    out_key = np.zeros(n, key.dtype)
    out_key[:g] = uk
    count = np.zeros(n, np.int64)
    count[:g] = counts
    outs = [out_key, count]
    for v in values:
        s = np.zeros(n, np.int64)
        if g:
            u = v[:live].astype(np.int64).view(np.uint64)
            s[:g] = np.add.reduceat(u, starts).view(np.int64)
        outs.append(s)
    return outs, g


def hash_case(name: str, scale: int = 1):
    """agg_case's rows as the group table takes them: the valid rows in a
    seeded random order, the padding's keys random (they must reach no
    output either)."""
    key, values, live = agg_case(name, scale)
    rng = np.random.default_rng(sum(map(ord, name)) + 7 * scale)
    valid = min(max(live, 0), len(key))
    order = np.concatenate([rng.permutation(valid), np.arange(valid, len(key))])
    key, values = key[order], [v[order] for v in values]
    info = np.iinfo(key.dtype)
    key[valid:] = rng.integers(info.min, info.max, len(key) - valid, dtype=key.dtype)
    return key, values, live


def np_groups(key, values, num_rows):
    """numpy's groups of the valid rows in any order: np.unique, sums in
    uint64 (which wrap) by np.add.at; every output row from the group
    count on 0. Returns ([key', count, sums...], G)."""
    n = len(key)
    live = max(0, min(num_rows, n))
    uk, inv, counts = np.unique(key[:live], return_inverse=True, return_counts=True)
    g = len(uk)
    out_key = np.zeros(n, key.dtype)
    out_key[:g] = uk
    count = np.zeros(n, np.int64)
    count[:g] = counts
    outs = [out_key, count]
    for v in values:
        s = np.zeros(g, np.uint64)
        np.add.at(s, inv.reshape(-1), v[:live].astype(np.int64).view(np.uint64))
        full = np.zeros(n, np.int64)
        full[:g] = s.view(np.int64)
        outs.append(full)
    return outs, g
