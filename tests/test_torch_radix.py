"""tpq_torch's LSD radix sort and radix-engine merge join: the 1-bit split
and the digit pass (kernel 6, plain torch versions here) and
lsd_radix_sort_bits in digit passes against tpq's one split per bit spec
(interpret-mode Pallas, run once in a module fixture), the digit pass
against numpy's stable argsort by the digit, the other sorts against
numpy stable sorts, and merge_join(sort_engine="radix") against the
port's lax engine and the C++ oracle. tpq's radix merge join is not
called (322 s cold). Integer data: every comparison is exact
(tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpq.kernels import radix_sort as jradix
from tpq_torch import Table, colio, datagen
from tpq_torch.columnar import canonicalize
from tpq_torch.kernels import radix_sort as radix
from tpq_torch.kernels.radix_sort import (_split1, digit_passes, lsd_radix_sort,
                                          lsd_radix_sort_bits, radix_sort_perm,
                                          sort_rows, split_digit, split_digit_ref)
from tpq_torch.ops import merge_join
from tpq_torch.ops.merge_join import sort_table_by_key

from conftest import assert_tables_equal
import torch_oracle  # noqa: F401  (builds the oracle before any test runs)

torch.set_num_threads(2)

# the arbitrary bit sequence of tests/test_kernels.py: a (3 bits) LSD,
# then b (1 bit) major, idx carried
_RNG = np.random.default_rng(6)
N = 3000
A = _RNG.integers(0, 8, size=N).astype(np.int32)
B = _RNG.integers(0, 2, size=N).astype(np.int32)
IDX = np.arange(N, dtype=np.int32)
SPECS = [(0, 0), (0, 1), (0, 2), (1, 0)]
# one split pass over planes with negative values; bit of every 3rd row
SPLIT_PLANES = [_RNG.integers(-(1 << 31), 1 << 31, N).astype(np.int32), IDX]
SPLIT_BITS = {"mixed": (np.arange(N) % 3 == 0).astype(np.int32),
              "all ones": np.ones(N, np.int32), "all zeros": np.zeros(N, np.int32)}

# digit passes: full-range planes with negative values (bit 31 taken),
# a small-valued plane and the carried row ids; every prefix length in
# GROUP_LENGTHS is a sequence of its own. The first 7 specs span three
# planes, repeat bit 17 of plane 0 and take a bit of the carried ids.
G = 700
GROUP_PLANES = [_RNG.integers(-(1 << 31), 1 << 31, G).astype(np.int32),
                _RNG.integers(0, 16, G).astype(np.int32),
                np.arange(G, dtype=np.int32)]
GROUP_SPECS = [(0, 3), (0, 31), (1, 0), (0, 17), (0, 17), (2, 1), (1, 2), (0, 0),
               (2, 0), (1, 3), (0, 8), (0, 9), (0, 10), (1, 1), (2, 5), (0, 30), (0, 31)]
GROUP_LENGTHS = (1, 7, 8, 9, 17)


@pytest.fixture(scope="module")
def tpq_radix():
    """tpq's lsd_radix_sort_bits and its _split1 (n0 = some, 0, n), once;
    tpq's sort after each prefix of GROUP_SPECS (one split a spec)."""
    sort = jradix.lsd_radix_sort_bits(
        [jnp.asarray(A), jnp.asarray(B), jnp.asarray(IDX)], SPECS)
    splits = {}
    for name, bit in SPLIT_BITS.items():
        n0 = int((bit == 0).sum())
        splits[name] = [np.asarray(x) for x in jradix._split1(
            [jnp.asarray(p) for p in SPLIT_PLANES], jnp.asarray(bit), jnp.int32(n0))]
    groups, planes = {}, [jnp.asarray(p) for p in GROUP_PLANES]
    for i, spec in enumerate(GROUP_SPECS, 1):
        planes = jradix.lsd_radix_sort_bits(planes, [spec])
        if i in GROUP_LENGTHS:
            groups[i] = [np.asarray(x) for x in planes]
    return {"sort": [np.asarray(x) for x in sort], "splits": splits, "groups": groups}


def test_lsd_radix_sort_bits_matches_tpq(tpq_radix):
    out = lsd_radix_sort_bits([torch.from_numpy(x) for x in (A, B, IDX)], SPECS)
    order = np.lexsort((IDX, A, B))
    np.testing.assert_array_equal(out[2].numpy(), order)
    for mine, theirs in zip(out, tpq_radix["sort"]):
        np.testing.assert_array_equal(mine.numpy(), theirs)


@pytest.mark.parametrize("bits", list(SPLIT_BITS))
def test_split1_matches_tpq(tpq_radix, bits):
    bit = SPLIT_BITS[bits]
    out = _split1([torch.from_numpy(p) for p in SPLIT_PLANES], torch.from_numpy(bit))
    for mine, theirs in zip(out, tpq_radix["splits"][bits]):
        np.testing.assert_array_equal(mine.numpy(), theirs)
    order = np.argsort(bit, kind="stable")
    np.testing.assert_array_equal(out[1].numpy(), order)


@pytest.mark.parametrize("digit_bits", [8, 3])
@pytest.mark.parametrize("length", GROUP_LENGTHS)
def test_lsd_radix_sort_bits_digit_passes_match_tpq(tpq_radix, monkeypatch, length,
                                                    digit_bits):
    """The specs sorted digit_bits a pass (the last pass short) give tpq's
    one split per spec, and the passes counted are ceil(specs / bits)."""
    passes = []

    def count(planes, specs):
        passes.append(len(specs))
        return split_digit(planes, specs)

    monkeypatch.setattr(radix, "split_digit", count)
    out = lsd_radix_sort_bits([torch.from_numpy(p) for p in GROUP_PLANES],
                              GROUP_SPECS[:length], digit_bits=digit_bits)
    assert len(passes) == digit_passes(length, digit_bits) and sum(passes) == length
    assert max(passes) <= digit_bits
    for mine, theirs in zip(out, tpq_radix["groups"][length]):
        np.testing.assert_array_equal(mine.numpy(), theirs)


def _digit_np(planes, specs):
    d = np.zeros(planes[0].shape[0], np.int64)
    for i, (pi, b) in enumerate(specs):
        d |= ((planes[pi].astype(np.int64) >> b) & 1) << i
    return d


@pytest.mark.parametrize("case", ["one bit", "8 bits over 3 planes", "repeated bits",
                                  "one digit for all", "n = 1", "bit of the ids"])
def test_split_digit_ref_matches_numpy_argsort(case):
    """The plain digit pass (the group's one-bit splits in order) is a
    stable sort by the digit the kernel forms, every plane carried."""
    rng = np.random.default_rng(len(case))
    n = 1 if case == "n = 1" else 5000
    planes = [rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32),
              rng.integers(-4, 4, n).astype(np.int32),
              np.full(n, -7, np.int32), np.arange(n, dtype=np.int32)]
    specs = {"one bit": [(0, 31)],
             "8 bits over 3 planes": [(0, 0), (1, 1), (0, 31), (1, 31), (3, 0), (0, 7),
                                      (1, 0), (0, 15)],
             "repeated bits": [(0, 4), (0, 4), (1, 2), (1, 2), (0, 4)],
             "one digit for all": [(2, b) for b in range(8)],
             "n = 1": [(0, 1), (1, 2)],
             "bit of the ids": [(3, 2), (3, 0), (0, 9)]}[case]
    out = split_digit([torch.from_numpy(p) for p in planes], specs)
    order = np.argsort(_digit_np(planes, specs), kind="stable")
    for mine, p in zip(out, planes):
        np.testing.assert_array_equal(mine.numpy(), p[order])


def test_digit_runs_join_consecutive_bits_of_one_plane():
    a, b = torch.zeros(3, dtype=torch.int32), torch.zeros(3, dtype=torch.int32)
    runs = radix.digit_runs([(a, 3), (a, 4), (a, 5), (b, 0), (a, 6), (a, 6), (a, 7)])
    assert [(src is a, first, n) for src, first, n in runs] == [
        (True, 3, 3), (False, 0, 1), (True, 6, 1), (True, 6, 2)]


def test_split_digit_checks_its_specs():
    planes = [torch.zeros(10, dtype=torch.int32)]
    for specs in ([], [(0, 0)] * 9, [(1, 0)], [(0, 32)]):
        with pytest.raises(ValueError):
            split_digit(planes, specs)


def test_lsd_radix_sort_matches_numpy():
    """Duplicates, live-prefix padding, a carried value plane (the case
    of tests/test_kernels.py's slow lsd_radix_sort test)."""
    rng = np.random.default_rng(5)
    n, n_live = 5000, 4321
    keys = rng.integers(0, 1 << 20, size=n).astype(np.int64)
    vals = rng.integers(0, 1 << 31, size=n).astype(np.int32)
    klo = torch.from_numpy((keys & 0xFFFFFFFF).astype(np.uint32).view(np.int32))
    khi = torch.from_numpy((keys >> 32).astype(np.int32))
    out = lsd_radix_sort([klo, khi], [torch.from_numpy(vals)],
                         torch.tensor(n_live), key_bits=20)
    got = ((out[1].numpy().astype(np.int64) << 32)
           | (out[0].numpy().astype(np.int64) & 0xFFFFFFFF))
    order = np.argsort(keys[:n_live], kind="stable")
    np.testing.assert_array_equal(got[:n_live], keys[:n_live][order])
    np.testing.assert_array_equal(out[2].numpy()[:n_live], vals[:n_live][order])
    # the padding rows follow, sorted by the key passes like the rest
    pad_order = n_live + np.argsort(keys[n_live:], kind="stable")
    np.testing.assert_array_equal(out[2].numpy()[n_live:], vals[pad_order])


def test_radix_sort_perm_matches_numpy():
    rng = np.random.default_rng(2)
    keys = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, 4096,
                        dtype=np.int64)
    keys[::7] = keys[3]  # ties keep their order
    perm = radix_sort_perm(torch.from_numpy(keys)).numpy()
    np.testing.assert_array_equal(perm, np.argsort(keys, kind="stable"))
    perm = radix_sort_perm(torch.from_numpy(keys), num_valid=1000).numpy()
    np.testing.assert_array_equal(perm[:1000], np.argsort(keys[:1000], kind="stable"))
    assert sorted(perm[1000:]) == list(range(1000, 4096))


@pytest.mark.parametrize("fn", [sort_rows, sort_table_by_key])
def test_sort_rows_cosorts_all_columns(fn):
    rng = np.random.default_rng(7)
    cols = {"p0": rng.integers(0, 1 << 40, 700),
            "key": rng.integers(-50, 50, 700),
            "p1": rng.integers(-(1 << 31), 1 << 31, 700).astype(np.int32)}
    t = Table.from_numpy(cols, device="cpu")  # capacity 1024: padding last
    out = fn(t)
    assert list(out.names) == ["key", "p0", "p1"] and int(out.num_rows) == 700
    order = np.argsort(cols["key"], kind="stable")
    for name in out.names:
        np.testing.assert_array_equal(out.col(name)[:700].numpy(), cols[name][order])
    assert (out.col("key")[700:] == np.iinfo(np.int64).max).all()


def _oracle_merge(oracle, tmp_path, r, s):
    pr, ps, po = (tmp_path / f"merge_{x}.tpqc" for x in ("r", "s", "out"))
    colio.dump(str(pr), r)
    colio.dump(str(ps), s)
    oracle("join", algo="merge", left=pr, right=ps, out=po)
    return colio.load(str(po))


def _negative_case():
    """tests/test_kernels.py's radix-merge case: negative keys exercise
    the sign bias."""
    r = datagen.gen_relation_np(800, 200, payloads=1, seed=91)
    s = datagen.gen_relation_np(1200, 200, payloads=1, seed=92)
    r["key"][:50] -= 1 << 40
    s["key"][:70] -= 1 << 40
    return r, s


def test_merge_join_radix_matches_lax_and_oracle(oracle, tmp_path):
    r, s = _negative_case()
    R, S = Table.from_numpy(r, device="cpu"), Table.from_numpy(s, device="cpu")
    before = split_digit.launches, _split1.launches
    a = merge_join(R, S, 1 << 13)
    b = merge_join(R, S, 1 << 13, sort_engine="radix", key_bits=64)
    # the plain version: no kernel here
    assert (split_digit.launches, _split1.launches) == before
    assert int(a.num_rows) == int(b.num_rows) > 0
    assert_tables_equal(canonicalize(b), canonicalize(a), "radix vs lax")
    assert_tables_equal(canonicalize(b), _oracle_merge(oracle, tmp_path, r, s),
                        "radix vs oracle")


def test_merge_join_radix_edge_keys(oracle, tmp_path):
    """INT64_MIN/MAX keys sort by the biased high plane, not as padding."""
    im, ix = np.iinfo(np.int64).min, np.iinfo(np.int64).max
    r = {"key": np.array([im, ix, ix, 0, -1, 5], dtype=np.int64),
         "p0": np.arange(6, dtype=np.int64)}
    s = {"key": np.array([ix, im, 5, 5, 7, ix, 0], dtype=np.int64),
         "p0": np.arange(7, dtype=np.int64) * 10}
    out = merge_join(Table.from_numpy(r, device="cpu"),
                     Table.from_numpy(s, device="cpu"), 1 << 8, sort_engine="radix")
    assert_tables_equal(canonicalize(out), _oracle_merge(oracle, tmp_path, r, s),
                        "radix edge keys")


def test_merge_join_radix_narrow_key_bits():
    """key_bits < 64 sorts a bounded key domain in fewer passes; int32
    keys and payloads keep their dtypes."""
    rng = np.random.default_rng(8)
    r = {"key": rng.integers(0, 1 << 12, 3000).astype(np.int32),
         "p0": rng.integers(0, 1 << 40, 3000)}
    s = {"key": rng.integers(0, 1 << 12, 2000).astype(np.int32),
         "q": rng.integers(-100, 100, 2000).astype(np.int32)}
    R, S = Table.from_numpy(r, device="cpu"), Table.from_numpy(s, device="cpu")
    a = merge_join(R, S, 1 << 13)
    b = merge_join(R, S, 1 << 13, sort_engine="radix", key_bits=12)
    assert [c.dtype for c in b.columns.values()] == [torch.int32, torch.int64,
                                                     torch.int32]
    assert int(a.num_rows) == int(b.num_rows)
    assert_tables_equal(canonicalize(b), canonicalize(a), "key_bits 12")


def test_merge_join_radix_two_runs_identical():
    r, s = _negative_case()
    outs = [merge_join(Table.from_numpy(r, device="cpu"),
                       Table.from_numpy(s, device="cpu"), 1 << 13,
                       sort_engine="radix") for _ in range(2)]
    for k in outs[0].columns:
        assert torch.equal(outs[0].columns[k], outs[1].columns[k]), k
