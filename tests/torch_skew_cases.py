"""The skew join's heavy-overflow inputs and numpy's join of them, shared
by tests/test_torch_skew.py (on the CPU) and tests/test_torch_cuda.py
(on the card). Built from a seed with numpy; no JAX."""

import numpy as np

# out_capacity of the cases: the heavy buffer is half of it, 8,192 rows
OUT_CAPACITY = 1 << 14


def heavy_case(r7: int, s7: int):
    """Key 7 r7 times in R beside 5,000 distinct keys; key 7 s7 times in S
    beside 3,000 keys drawn from R's distinct keys. Key 7 alone gives
    r7 * s7 heavy matches."""
    rng = np.random.default_rng(61)
    distinct = rng.permutation(np.unique(rng.integers(100, 1 << 40, 6000))[:5000])
    rk = np.concatenate([np.full(r7, 7), distinct]).astype(np.int64)
    sk = np.concatenate([np.full(s7, 7), rng.choice(distinct, 3000)]).astype(np.int64)
    r = {"key": rk, "p0": rng.integers(0, 1 << 62, rk.size)}
    s = {"key": sk, "p0": rng.integers(0, 1 << 62, sk.size)}
    return r, s


def numpy_join(r, s) -> dict:
    """numpy's inner equi-join of one-payload relations, in canonical row
    order (rows sorted by key, then r_p0, then s_p0)."""
    ri, si = np.nonzero(r["key"][:, None] == s["key"][None, :])
    cols = {"key": r["key"][ri], "r_p0": r["p0"][ri], "s_p0": s["p0"][si]}
    order = np.lexsort(tuple(cols[n] for n in reversed(list(cols))))
    return {n: c[order] for n, c in cols.items()}
