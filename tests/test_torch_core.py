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
from tpq_torch.dist.mesh import OWNER_SALT
from tpq_torch.kernels import lane_table
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


# (bits, salt) of hash_keys' call sites: the lane build and probe layout
# at pbits + 7 (pbits 0, 5, 9 and 14: the skew join's one-partition
# tables, config 1 and config 4, config 5's shards), h2, owner_of
@pytest.mark.parametrize("bits,salt", [
    (7, lane_table.SALT_LANE), (12, lane_table.SALT_LANE), (16, lane_table.SALT_LANE),
    (21, lane_table.SALT_LANE), (32, lane_table.SALT_H2), (32, OWNER_SALT)])
def test_hash_keys_call_sites_match_plain_and_numpy(bits, salt):
    """On the CPU hash_keys is its plain version; int32 keys are widened
    as tpq widens them."""
    keys = _keys()
    got = hashing.hash_keys(torch.from_numpy(keys), bits, salt)
    assert got.dtype == torch.int32
    assert torch.equal(got, hashing.hash_keys_ref(torch.from_numpy(keys), bits, salt))
    np.testing.assert_array_equal(got.numpy(), hashing.np_hash_keys(keys, bits, salt))
    k32 = keys.astype(np.int32)
    np.testing.assert_array_equal(hashing.hash_keys(torch.from_numpy(k32), bits, salt).numpy(),
                                  hashing.np_hash_keys(k32, bits, salt))


@pytest.mark.parametrize("bits", [0, 33])
def test_hash_keys_rejects_bits_out_of_range(bits):
    with pytest.raises(ValueError, match="bits must be in 1..32"):
        hashing.hash_keys(torch.zeros(4, dtype=torch.int64), bits)


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
    t = Table.from_numpy(cols, device="cpu")
    assert t.capacity == next_pow2(5) == 8
    assert t.num_rows.dtype == torch.int32 and int(t.num_rows) == 5
    assert t.valid_mask().tolist() == [True] * 5 + [False] * 3
    back = t.to_numpy()
    assert tables_equal(back, cols)
    c = canonicalize(t)
    assert c["key"].tolist() == [1, 1, 2, 2, 9]
    assert c["p0"].tolist() == [4, 5, -1, 0, 3]
    with pytest.raises(ValueError):
        Table.from_numpy(cols, capacity=4, device="cpu")
    with pytest.raises(ValueError):
        Table({"a": torch.zeros(4), "b": torch.zeros(8)}, 2)


def test_entry_points_default_to_the_card():
    """Table.from_numpy, gen_relation and lane_tables_from_numpy place
    their tensors on "cuda" unless told otherwise; without a card torch's
    own error surfaces (no silent CPU)."""
    import inspect

    from tpq_torch.kernels.lane_table import lane_tables_from_numpy

    for fn in (Table.from_numpy, datagen.gen_relation, lane_tables_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        assert Table.from_numpy({"key": np.arange(3)}).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            Table.from_numpy({"key": np.arange(3)})
        with pytest.raises((AssertionError, RuntimeError)):
            datagen.gen_relation(10, 5)


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


@pytest.mark.parametrize("runs", ["long", "singletons", "mixed"])
def test_last_start_matches_numpy(runs):
    """The run start of every position: one long run (a padding suffix),
    all singletons (union_join's invalid rows), and random runs."""
    from tpq_torch.ops._expand import last_start

    n = 5000
    rng = np.random.default_rng(3)
    is_start = {"long": np.arange(n) % 4000 == 0, "singletons": np.ones(n, bool),
                "mixed": rng.random(n) < 0.2}[runs]
    is_start[0] = True
    want = np.maximum.accumulate(np.where(is_start, np.arange(n), 0))
    got = last_start(torch.from_numpy(is_start))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
