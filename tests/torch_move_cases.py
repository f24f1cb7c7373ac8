"""PAD and PACK inputs that a tiled kernel can get wrong, shared by
tests/test_torch_move.py (plain versions against numpy placement, on the
CPU) and tests/test_torch_cuda.py (kernels against plain versions, on the
card). Each case is built from a seed with numpy; its size is a
parameter, so that the card can run it past one persistent grid of
4,096-row tiles while the CPU runs it small."""

import numpy as np

TILE = 4096  # the kernels' tile: output slots of PAD, rows of PACK


def _cols(rng, n, dtypes):
    return [rng.integers(-(1 << 62), 1 << 62, n).astype(np.int64) if d == "i64"
            else rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)
            for d in dtypes]


def _landing(rng, n_landing, out_len):
    return np.sort(rng.choice(out_len, n_landing, replace=False)).astype(np.int32)


def pad_case(name: str, scale: int = 1):
    """(columns, dest int32, n_live int, out_len) of a named case."""
    rng = np.random.default_rng(sum(map(ord, name)) + scale)
    if name == "sentinel_runs":
        # live runs of overflow sentinels (dest = out_len) longer than a
        # tile, between strictly increasing landing rows, as an
        # overflowing build or probe layout hands PAD
        n, out_len = 30_000 * scale, 50_001 * scale
        n_live = 25_000 * scale
        k = np.arange(n_live)
        sent = (((k // (5_000 * scale)) % 2) == 1) | (rng.random(n_live) < 0.05)
        dest = rng.integers(-5, out_len + 5, n).astype(np.int32)  # dead rows: any
        dest[:n_live] = out_len
        dest[:n_live][~sent] = _landing(rng, int((~sent).sum()), out_len)
        return _cols(rng, n, ["i64", "i32"]), dest, n_live, out_len
    if name == "dropped_negative":
        # live rows with dest < 0 and past out_len, dropped like sentinels
        n, out_len = 20_000 * scale, 30_000 * scale
        drop = rng.random(n) < 0.3
        dest = np.empty(n, np.int32)
        dest[~drop] = _landing(rng, int((~drop).sum()), out_len)
        dest[drop] = np.where(rng.random(int(drop.sum())) < 0.5, -1 - rng.integers(0, 9, int(drop.sum())),
                              out_len + rng.integers(0, 9, int(drop.sum())))
        return _cols(rng, n, ["i32"]), dest, n, out_len
    if name == "none_live":
        # nothing live; the dead dest is arbitrary, not monotone, and
        # partly inside [0, out_len)
        n, out_len = 9_000 * scale, 10_000 * scale
        dest = rng.integers(-100, out_len + 100, n).astype(np.int32)
        return _cols(rng, n, ["i64"]), dest, 0, out_len
    if name == "all_slots":
        # every slot filled, out_len not a multiple of the tile
        n = out_len = 3 * TILE * scale + 7
        dest = np.arange(n, dtype=np.int32)
        return _cols(rng, n, ["i32", "i64"]), dest, n, out_len
    if name == "sixteen_cols":
        n, out_len = 20_000 * scale, 33_333 * scale
        dest = _landing(rng, n, out_len)
        return _cols(rng, n, ["i32", "i64"] * 8), dest, 15_000 * scale, out_len
    if name == "window":
        # the tail's window: dest = offset + arange, the rows past the
        # window dropped, n_live past N clamped to N
        n, out_len = 6_144 * scale, 8_192 * scale
        dest = (5_000 * scale + np.arange(n)).astype(np.int32)
        return _cols(rng, n, ["i64"] * 3), dest, n + 11, out_len
    raise KeyError(name)


PAD_CASES = ["sentinel_runs", "dropped_negative", "none_live", "all_slots",
             "sixteen_cols", "window"]


def pack_case(name: str, scale: int = 1):
    """(columns, occ int32) of a named case."""
    rng = np.random.default_rng(sum(map(ord, name)) + scale)
    if name == "many_tiles":
        # many more tiles than SMs: a long look-back chain, and most of
        # the output zero-filled past `total`
        n = 300 * TILE * scale + 3
        occ = (rng.random(n) < 0.05).astype(np.int32)
        return _cols(rng, n, ["i64", "i32"]), occ
    if name == "all_live":
        n = 5 * TILE * scale + 1
        return _cols(rng, n, ["i32", "i64"]), np.ones(n, np.int32)
    if name == "none_live":
        n = 5 * TILE * scale + 2
        return _cols(rng, n, ["i64"]), np.zeros(n, np.int32)
    if name == "any_nonzero":
        # occ values other than 0/1 count as live
        n = 7 * TILE * scale - 1
        occ = rng.integers(-2, 3, n).astype(np.int32) * (rng.random(n) < 0.5)
        return _cols(rng, n, ["i32"]), occ.astype(np.int32)
    if name == "sixteen_cols":
        n = 9 * TILE * scale + 5
        occ = (rng.random(n) < 0.5).astype(np.int32)
        return _cols(rng, n, ["i64", "i32"] * 8), occ
    if name == "short":
        n = 3
        return _cols(rng, n, ["i32"]), np.array([0, 1, 1], np.int32)
    raise KeyError(name)


PACK_CASES = ["many_tiles", "all_live", "none_live", "any_nonzero", "sixteen_cols",
              "short"]


def pad_np(cols, dest, n_live, out_len):
    """numpy placement: rows k < n_live with 0 <= dest[k] < out_len."""
    d = dest.astype(np.int64)
    keep = (np.arange(len(dest)) < n_live) & (d >= 0) & (d < out_len)
    outs = []
    for c in cols:
        o = np.zeros(out_len, c.dtype)
        o[d[keep]] = c[keep]
        outs.append(o)
    occ = np.zeros(out_len, np.int32)
    occ[d[keep]] = 1
    return outs, occ


def pack_np(cols, occ):
    """numpy compaction: live rows in order, zeros after them."""
    keep = occ != 0
    outs = []
    for c in cols:
        o = np.zeros_like(c)
        o[:int(keep.sum())] = c[keep]
        outs.append(o)
    return outs, int(keep.sum())
