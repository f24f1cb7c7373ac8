"""tpq_torch foundations held against tpq: hashing, datagen streams,
Table, colio, planes, and the import boundary (no jax in the port)."""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpq import colio as jcolio
from tpq import datagen as jdatagen
from tpq import hashing as jhashing
from tpq.ops.union_join import col_planes as jcol_planes
from tpq_torch import Table, colio, datagen, hashing
from tpq_torch.columnar import canonicalize, next_pow2, tables_equal
from tpq_torch.ops.union_join import col_planes, planes_col

from conftest import REPO

torch.set_num_threads(2)

IMIN, IMAX = np.iinfo(np.int64).min, np.iinfo(np.int64).max


def _keys() -> np.ndarray:
    rng = np.random.default_rng(5)
    edge = np.array([IMIN, IMAX, 0, 1, -1, 2**32, -(2**32), 2**31, -(2**31)],
                    dtype=np.int64)
    return np.concatenate([edge, rng.integers(IMIN, IMAX, 2000, dtype=np.int64)])


@pytest.mark.parametrize("bits", [1, 7, 16, 32])
def test_hash_keys_matches_tpq(bits):
    keys = _keys()
    for salt in (0, 0x1A9E0001, 0x1A9E0002):
        got = hashing.hash_keys(torch.from_numpy(keys), bits, salt).numpy()
        want = np.asarray(jhashing.hash_keys(jnp.asarray(keys), bits, salt))
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, hashing.np_hash_keys(keys, bits, salt))
    if bits == 32:
        assert (got < 0).any()  # all 32 bits kept, as tpq's hash_keys


def test_hash_u64_and_split_match_tpq():
    keys = _keys()
    for bits in (1, 9, 20, 31):
        got = hashing.hash_u64(torch.from_numpy(keys), bits, salt=17).numpy()
        want = np.asarray(jhashing.hash_u64(jnp.asarray(keys), bits, salt=17))
        np.testing.assert_array_equal(got, want)
    lo, hi = hashing.split_i64(torch.from_numpy(keys))
    jlo, jhi = jhashing.split_i64(jnp.asarray(keys))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo).astype(np.int64))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi).astype(np.int64))


@pytest.mark.parametrize("kind,nkeys,theta", [
    ("uniform", 1000, 1.0), ("zipf", 512, 1.0), ("zipf", 100, 0.8)])
def test_datagen_streams_match_tpq(kind, nkeys, theta):
    got = datagen.gen_relation_np(5000, nkeys, payloads=3, seed=99, kind=kind,
                                  theta=theta)
    want = jdatagen.gen_relation_np(5000, nkeys, payloads=3, seed=99, kind=kind,
                                    theta=theta)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes(), k


def test_table_roundtrip_and_canonical_order():
    cols = {"key": np.array([2, 1, 2, 1, 9], dtype=np.int64),
            "p0": np.array([0, 5, -1, 4, 3], dtype=np.int32)}
    t = Table.from_numpy(cols)
    assert t.capacity == next_pow2(5) == 8
    assert t.num_rows.dtype == torch.int32 and int(t.num_rows) == 5
    assert t.valid_mask().tolist() == [True] * 5 + [False] * 3
    back = t.to_numpy()
    assert tables_equal(back, cols)
    c = canonicalize(t)
    assert c["key"].tolist() == [1, 1, 2, 2, 9]
    assert c["p0"].tolist() == [4, 5, -1, 0, 3]
    with pytest.raises(ValueError):
        Table.from_numpy(cols, capacity=4)
    with pytest.raises(ValueError):
        Table({"a": torch.zeros(4), "b": torch.zeros(8)}, 2)


def test_colio_roundtrip_and_bytes_match_tpq(tmp_path):
    cols = {"key": np.array([1, -2, IMAX, IMIN], dtype=np.int64),
            "x": np.array([0.5, 1.5, -2.5, 3.0], dtype=np.float32),
            "n": np.array([7, 8, 9, 10], dtype=np.int32)}
    p, pj = tmp_path / "t.tpqc", tmp_path / "tj.tpqc"
    colio.dump(str(p), cols)
    jcolio.dump(str(pj), cols)
    assert p.read_bytes() == pj.read_bytes()
    out = colio.load(str(p))
    assert tables_equal(out, cols)


def test_planes_roundtrip_matches_tpq():
    keys = _keys()
    lo, hi = col_planes(torch.from_numpy(keys))
    jlo, jhi = jcol_planes(jnp.asarray(keys))
    np.testing.assert_array_equal(lo.numpy().view(np.uint32), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy().view(np.uint32), np.asarray(jhi))
    back = planes_col((torch.from_numpy(np.array(jlo)),
                       torch.from_numpy(np.array(jhi))), torch.int64)
    np.testing.assert_array_equal(back.numpy(), keys)


def test_import_leaves_no_jax():
    # counts only the modules the import adds, whatever the interpreter's
    # start-up loaded before it
    code = ("import sys; before = set(sys.modules); "
            "import tpq_torch, tpq_torch.ops, tpq_torch.kernels.lane2, "
            "tpq_torch.bench.runner; "
            "bad = sorted(m for m in set(sys.modules) - before "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'tpq')); "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
