"""tpq_torch PAD and PACK (the plain versions, as the wrappers run them on
CPU tensors) held against tpq's Pallas pad/pack in interpret mode and
against numpy placement, at tests/test_move.py's fast-tier shapes.
Integer data: every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpq.kernels.move import pack as jpack
from tpq.kernels.move import pad as jpad
from tpq_torch.kernels.move import pack, pad

torch.set_num_threads(2)

# name: (n_live, out_len, nplanes, seed, n_alloc)
PAD_CASES = {
    "3000into4096": (3000, 4096, 1, 0, 3000),
    "empty": (0, 2048, 2, 2, 2048),
    "one": (1, 2048, 1, 4, 1),
    "dead_suffix": (1000, 4096, 2, 7, 1500),
}
# name: (n, density, nplanes, seed)
PACK_CASES = {"dense60": (4096, 0.6, 1, 0), "full": (2048, 1.0, 2, 3)}


def _pad_inputs(n_live, out_len, nplanes, seed, n_alloc):
    rng = np.random.default_rng(seed)
    dest = np.sort(rng.choice(out_len, size=n_live, replace=False)).astype(np.int32)
    planes = [rng.integers(1, 1 << 30, size=n_alloc).astype(np.int32)
              for _ in range(nplanes)]
    # rows past n_live carry tpq's overflow sentinel (a dest >= out_len),
    # or zeros when nothing is live, as tests/test_move.py passes them
    full = np.full(n_alloc, 0 if n_live == 0 else out_len, np.int32)
    full[:n_live] = dest
    return planes, full, dest


def _pack_inputs(n, density, nplanes, seed):
    rng = np.random.default_rng(seed)
    occ = (rng.random(n) < density).astype(np.int32)
    planes = [rng.integers(1, 1 << 30, size=n).astype(np.int32)
              for _ in range(nplanes)]
    return planes, occ


@pytest.fixture(scope="module")
def tpq_results():
    """tpq's pad/pack on every case, run once (interpret-mode Pallas)."""
    res = {}
    for name, (n_live, out_len, nplanes, seed, n_alloc) in PAD_CASES.items():
        planes, full, _ = _pad_inputs(n_live, out_len, nplanes, seed, n_alloc)
        outs, occ = jpad([jnp.asarray(p) for p in planes], jnp.asarray(full),
                         n_live, out_len)
        res[name] = ([np.asarray(o) for o in outs], np.asarray(occ))
    for name, case in PACK_CASES.items():
        planes, occ = _pack_inputs(*case)
        outs, total = jpack([jnp.asarray(p) for p in planes], jnp.asarray(occ))
        res[name] = ([np.asarray(o) for o in outs], int(total))
    return res


@pytest.mark.parametrize("name", list(PAD_CASES))
def test_pad_matches_tpq_and_numpy(tpq_results, name):
    n_live, out_len, nplanes, seed, n_alloc = PAD_CASES[name]
    planes, full, dest = _pad_inputs(n_live, out_len, nplanes, seed, n_alloc)
    outs, occ = pad([torch.from_numpy(p) for p in planes], torch.from_numpy(full),
                    n_live, out_len)
    j_outs, j_occ = tpq_results[name]
    want_occ = np.zeros(out_len, np.int32)
    want_occ[dest] = 1
    assert occ.dtype == torch.int32
    np.testing.assert_array_equal(occ.numpy(), j_occ)
    np.testing.assert_array_equal(occ.numpy(), want_occ)
    for p, o, jo in zip(planes, outs, j_outs):
        want = np.zeros(out_len, np.int32)
        want[dest] = p[:n_live]
        assert o.dtype == torch.int32
        np.testing.assert_array_equal(o.numpy(), jo)
        np.testing.assert_array_equal(o.numpy(), want)


@pytest.mark.parametrize("name", list(PACK_CASES))
def test_pack_matches_tpq_and_numpy(tpq_results, name):
    planes, occ = _pack_inputs(*PACK_CASES[name])
    outs, total = pack([torch.from_numpy(p) for p in planes], torch.from_numpy(occ))
    j_outs, j_total = tpq_results[name]
    k = int(occ.sum())
    assert total.dtype == torch.int32 and int(total) == j_total == k
    for p, o, jo in zip(planes, outs, j_outs):
        np.testing.assert_array_equal(o.numpy(), jo)
        np.testing.assert_array_equal(o.numpy()[:k], p[occ.astype(bool)])
        assert (o.numpy()[k:] == 0).all()


def test_pad_pack_int64_columns():
    """The port moves 64-bit columns whole; a tensor n_live and a
    dest past out_len drop rows as tpq's pad does."""
    rng = np.random.default_rng(3)
    n, out_len = 5000, 8192
    dest = np.sort(rng.choice(out_len + 500, size=n, replace=False)).astype(np.int32)
    key = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, n,
                       dtype=np.int64)
    small = rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64).astype(np.int32)
    n_live = torch.tensor(4000, dtype=torch.int32)
    (pk, ps), occ = pad([torch.from_numpy(key), torch.from_numpy(small)],
                        torch.from_numpy(dest), n_live, out_len)
    keep = (np.arange(n) < 4000) & (dest < out_len)
    want_k = np.zeros(out_len, np.int64)
    want_k[dest[keep]] = key[keep]
    np.testing.assert_array_equal(pk.numpy(), want_k)
    assert pk.dtype == torch.int64 and ps.dtype == torch.int32
    assert int(occ.sum()) == int(keep.sum())

    (back_k, back_s), total = pack([pk, ps], occ)
    assert int(total) == int(keep.sum())
    np.testing.assert_array_equal(back_k.numpy()[:int(total)], key[keep])
    np.testing.assert_array_equal(back_s.numpy()[:int(total)], small[keep])
    assert (back_k.numpy()[int(total):] == 0).all()

    (none,), zero = pack([torch.from_numpy(key)], torch.zeros(n, dtype=torch.int32))
    assert int(zero) == 0 and not none.any()


def test_pad_pack_roundtrip():
    rng = np.random.default_rng(11)
    n_live, out_len = 3000, 8192
    dest = np.sort(rng.choice(out_len, size=n_live, replace=False)).astype(np.int32)
    p = rng.integers(1, 1 << 30, size=n_live).astype(np.int32)
    padded, occ = pad([torch.from_numpy(p)], torch.from_numpy(dest), n_live, out_len)
    packed, total = pack(padded, occ)
    assert int(total) == n_live
    np.testing.assert_array_equal(packed[0].numpy()[:n_live], p)


def test_wrappers_run_no_plain_version_off_cpu():
    """A tensor on neither the CPU nor a card raises; it never reaches the
    plain version."""
    x = torch.zeros(16, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        pad([x], x, 4, 32)
    with pytest.raises(RuntimeError, match="no kernel"):
        pack([x], x)
