"""tpq_torch's skew join and its pieces held against tpq's: the walk-only
probe (kernel 4, fed identical tables) at a broadcast and a partitioned
plan, the identity probe layout, compaction, heavy-key nomination and
the whole heavy/light split join on the zipf case of
tests/test_ops_oracle.py; then the port alone against the C++ oracle,
the fallback and determinism. Each tpq call runs once, in a module
fixture (interpret-mode Pallas); the port runs its plain torch kernel
versions. Integer data: every comparison is exact (tolerance 0)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_skew_cases as skew_cases

from tpq import Table as JTable
from tpq import datagen as jdatagen
from tpq.columnar import canonicalize as jcanonicalize
from tpq.kernels import lane_table as jlane_table
from tpq.ops import filter as jfilter
from tpq.ops import skew_join as jskew
from tpq_torch import Table, colio, datagen
from tpq_torch.columnar import canonicalize
from tpq_torch.jit import deferred
from tpq_torch.kernels.lane_table import (LanePlan, _probe_layout,
                                          lane_tables_from_numpy,
                                          probe_lane_tables)
from tpq_torch.ops import hash_join
from tpq_torch.ops.filter import compact, compact_indices
from tpq_torch.ops.skew_join import (nominate_heavy_keys, skew_hash_join,
                                     skew_path_taken)
from tpq_torch.ops.union_join import union_join

from conftest import assert_tables_equal
import torch_oracle  # noqa: F401  (builds the oracle before any test runs)
from torch_host_reads import host_reads

torch.set_num_threads(2)


def _i64(lo, hi) -> np.ndarray:
    """tpq's (lo, hi) 32-bit planes -> int64."""
    lo, hi = np.asarray(lo), np.asarray(hi)
    return ((hi.astype(np.uint32).astype(np.uint64) << np.uint64(32))
            | lo.astype(np.uint32).astype(np.uint64)).view(np.int64)


def _cpu(cols, **kw):
    return Table.from_numpy(cols, device="cpu", **kw)


# ---------------------------------------------------------------------------
# the walk-only probe (kernel 4) on tpq's tables
# ---------------------------------------------------------------------------

def _bcast_case():
    """One partition, identity layout (probe_cap == S capacity), two
    payload columns and K 8; key 7 has 10 build rows, so K cuts."""
    r = jdatagen.gen_relation_np(400, 300, payloads=2, seed=31)
    r = {k: np.concatenate([v, np.full(10, 7) if k == "key" else np.arange(10)])
         for k, v in r.items()}
    s = jdatagen.gen_relation_np(1000, 330, payloads=1, seed=32)
    s["key"][:5] = 7
    plan = LanePlan(pbits=0, depth=24, probe_cap=1024, inline_k=8,
                    tail_rows_cap=2048, tail_out_cap=4096)
    return plan, r, s


def _part_case():
    """Four partitions through the sort + PAD layout, one payload, K 4."""
    r = jdatagen.gen_relation_np(1000, 600, payloads=1, seed=33)
    s = jdatagen.gen_relation_np(1500, 650, payloads=1, seed=34)
    plan = LanePlan(pbits=2, depth=16, probe_cap=1024, inline_k=4,
                    tail_rows_cap=2048, tail_out_cap=4096)
    return plan, r, s


PROBE_CASES = {"broadcast": _bcast_case, "partitioned": _part_case}


@pytest.fixture(scope="module")
def tpq_probes():
    """tpq's build and probe_lane_tables at both plans, run once."""
    out = {}
    for name, case in PROBE_CASES.items():
        plan, r, s = case()
        jplan = jlane_table.LanePlan(*dataclasses.astuple(plan))
        tables = jlane_table.build_lane_tables(JTable.from_numpy(r), jplan)
        (qk_p, _, cnt, d_first, pays, qocc, lane_p,
         ovf) = jlane_table.probe_lane_tables(tables, JTable.from_numpy(s))
        out[name] = {
            "tables": ([np.asarray(x) for x in tables.key_planes],
                       [np.asarray(x) for x in tables.pay_planes],
                       np.asarray(tables.occ), bool(tables.ok)),
            "qk": _i64(*qk_p), "cnt": np.asarray(cnt),
            "d_first": np.asarray(d_first), "qocc": np.asarray(qocc),
            "lane": np.asarray(lane_p), "overflow": bool(ovf),
            "pays": [[_i64(row[i], row[i + 1]) for i in range(0, len(row), 2)]
                     for row in pays],
        }
    return out


@pytest.mark.parametrize("case", list(PROBE_CASES))
def test_probe_lane_tables_matches_tpq(tpq_probes, case):
    plan, r, s = PROBE_CASES[case]()
    want = tpq_probes[case]
    tables = lane_tables_from_numpy(plan, *want["tables"], device="cpu")
    assert bool(tables.ok)
    qk, _, cnt, d_first, pays, qocc, lane, ovf = probe_lane_tables(tables, _cpu(s))
    np.testing.assert_array_equal(qk.numpy(), want["qk"])
    np.testing.assert_array_equal(cnt.numpy(), want["cnt"])
    np.testing.assert_array_equal(d_first.numpy(), want["d_first"])
    np.testing.assert_array_equal(qocc.numpy(), want["qocc"])
    np.testing.assert_array_equal(lane.numpy(), want["lane"])
    assert not bool(ovf) and not want["overflow"]
    assert len(pays) == plan.inline_k == len(want["pays"])
    for mine, theirs in zip(pays, want["pays"]):
        assert len(mine) == len(theirs) == len(r) - 1
        for a, b in zip(mine, theirs):
            np.testing.assert_array_equal(a.numpy(), b)
    if case == "broadcast":  # key 7's probes have more matches than K
        assert (want["cnt"][want["qocc"] > 0] > plan.inline_k).any()


def test_identity_probe_layout_matches_tpq():
    plan, _, s = _bcast_case()
    jplan = jlane_table.LanePlan(*dataclasses.astuple(plan))
    keep = np.arange(1024) % 3 != 0
    jk, jp, jl, jq, jovf = jlane_table._probe_layout(
        jplan, JTable.from_numpy(s), "key", keep=jnp.asarray(keep))
    qk, spay, lane, qocc, ovf = _probe_layout(plan, _cpu(s), "key",
                                              keep=torch.from_numpy(keep))
    assert qk.shape == (1024,)
    np.testing.assert_array_equal(qk.numpy(), _i64(*jk))
    np.testing.assert_array_equal(spay[0].numpy(), _i64(*jp))
    np.testing.assert_array_equal(lane.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(qocc.numpy(), np.asarray(jq))
    assert not bool(ovf) and not bool(jovf)


# ---------------------------------------------------------------------------
# compaction, capacity, nomination
# ---------------------------------------------------------------------------

def test_compact_matches_tpq():
    t = jdatagen.gen_relation_np(3000, 500, payloads=2, seed=41)
    t["p1"] = t["p1"].astype(np.int32)
    keep = np.random.default_rng(42).random(4096) < 0.4
    want = jfilter.compact(JTable.from_numpy(t), jnp.asarray(keep))
    got = compact(_cpu(t), torch.from_numpy(keep))
    n = int(want.num_rows)
    assert int(got.num_rows) == n == int(keep[:3000].sum())
    assert list(got.names) == list(want.names)
    for name in got.names:
        assert got.col(name).dtype == torch.from_numpy(t[name]).dtype
        np.testing.assert_array_equal(got.col(name)[:n].numpy(),
                                      np.asarray(want.col(name))[:n])


def test_compact_indices_matches_tpq():
    keep = np.random.default_rng(43).random(5000) < 0.3
    jperm, jn = jfilter.compact_indices(jnp.asarray(keep))
    perm, n = compact_indices(torch.from_numpy(keep))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    assert int(n) == int(jn) == int(keep.sum())


@pytest.mark.parametrize("capacity", [4096, 1 << 14, 512])
def test_with_capacity_matches_tpq(capacity):
    t = jdatagen.gen_relation_np(3000, 500, payloads=1, seed=44)
    want = JTable.from_numpy(t).with_capacity(capacity)
    got = _cpu(t).with_capacity(capacity)
    assert got.capacity == capacity and int(got.num_rows) == int(want.num_rows)
    for name in got.names:
        np.testing.assert_array_equal(got.col(name).numpy(),
                                      np.asarray(want.col(name)))


# the zipf and uniform cases of tests/test_ops_oracle.py's skew test
ZIPF_R = datagen.gen_relation_np(12000, 16384, payloads=1, seed=11)
ZIPF_S = datagen.gen_relation_np(12000, 16384, payloads=1, seed=22, kind="zipf")
UNIF_S = datagen.gen_relation_np(4000, 16384, payloads=1, seed=33)
KNOBS = {"stride": 4, "sample_threshold": 8}


@pytest.mark.parametrize("stride,threshold,num_rows", [
    (4, 8, 12000), (16, 16, 12000), (4, 8, 5000), (4, 1, 12000)])
def test_nominate_heavy_keys_matches_tpq(stride, threshold, num_rows):
    keys = np.zeros(16384, np.int64)
    keys[:12000] = ZIPF_S["key"]
    jh, jn, jok = jskew.nominate_heavy_keys(jnp.asarray(keys), num_rows,
                                            heavy_cap=64, stride=stride,
                                            sample_threshold=threshold)
    h, n, ok = nominate_heavy_keys(torch.from_numpy(keys),
                                   torch.tensor(num_rows, dtype=torch.int32),
                                   heavy_cap=64, stride=stride,
                                   sample_threshold=threshold)
    assert int(n) == int(jn) and bool(ok) == bool(jok)
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
    if threshold == 1:
        assert not bool(ok)  # more than heavy_cap distinct keys
    else:
        assert bool(ok) and int(n) > 0


# ---------------------------------------------------------------------------
# the whole split join
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tpq_skew_join():
    """tpq's skew_hash_join on the zipf case, run once (eager)."""
    out = jskew.skew_hash_join(JTable.from_numpy(ZIPF_R), JTable.from_numpy(ZIPF_S),
                               1 << 17, **KNOBS)
    return jcanonicalize(out)


def test_skew_join_matches_tpq(tpq_skew_join):
    out = skew_hash_join(_cpu(ZIPF_R), _cpu(ZIPF_S), 1 << 17, **KNOBS)
    assert int(out.num_rows) == 8832
    assert_tables_equal(canonicalize(out), tpq_skew_join, "skew vs tpq")


def test_deferred_skew_join_matches_tpq(tpq_skew_join):
    """The body a jitted skew join captures (the capture flag set: the
    `ok` cond recorded, the splice run unread; every host read raising)
    gives tpq's rows, with its pred true."""
    with deferred() as preds, host_reads("raise"):
        out = skew_hash_join(_cpu(ZIPF_R), _cpu(ZIPF_S), 1 << 17, **KNOBS)
    assert len(preds) == 1 and bool(preds[0])
    assert int(out.num_rows) == 8832
    assert_tables_equal(canonicalize(out), tpq_skew_join, "deferred skew vs tpq")


def _oracle_rows(oracle, tmp_path, r, s, tag):
    pr, ps, po = (tmp_path / f"{tag}_{x}.tpqc" for x in ("r", "s", "out"))
    colio.dump(str(pr), r)
    colio.dump(str(ps), s)
    oracle("join", algo="hash", left=pr, right=ps, out=po)
    return colio.load(str(po))


@pytest.mark.parametrize("s_cols,cap", [(ZIPF_S, 1 << 17), (UNIF_S, 1 << 15)],
                         ids=["zipf", "uniform"])
def test_skew_join_matches_oracle(oracle, tmp_path, s_cols, cap):
    R, S = _cpu(ZIPF_R), _cpu(s_cols)
    out = skew_hash_join(R, S, cap, **KNOBS)
    assert int(out.num_rows) <= cap
    assert_tables_equal(canonicalize(out),
                        _oracle_rows(oracle, tmp_path, ZIPF_R, s_cols, "skew"),
                        "skew vs oracle")


def test_skew_path_taken_on_zipf():
    R, S = _cpu(ZIPF_R), _cpu(ZIPF_S)
    assert bool(skew_path_taken(R, S, 1 << 17, **KNOBS))
    assert bool(skew_path_taken(R, S, 1 << 17))  # the default knobs


def test_skew_fallback_exact(oracle, tmp_path):
    """All-equal keys overflow the mini table's depth 64: `ok` clears
    and the join equals the sorted one and the oracle."""
    r = {"key": np.full(128, 5, np.int64), "p0": np.arange(128, dtype=np.int64)}
    s = {"key": np.full(512, 5, np.int64), "p0": np.arange(512, dtype=np.int64)}
    R, S = _cpu(r), _cpu(s)
    assert not bool(skew_path_taken(R, S, 1 << 17))
    a = hash_join(R, S, 1 << 17, impl="skew")
    b = union_join(R, S, 1 << 17)
    assert int(a.num_rows) == int(b.num_rows) == 128 * 512
    assert_tables_equal(canonicalize(a), canonicalize(b), "skew fallback")
    assert_tables_equal(canonicalize(a),
                        _oracle_rows(oracle, tmp_path, r, s, "fallback"),
                        "skew fallback vs oracle")


def test_skew_join_two_runs_identical():
    a = hash_join(_cpu(ZIPF_R), _cpu(ZIPF_S), 1 << 17, impl="skew")
    b = hash_join(_cpu(ZIPF_R), _cpu(ZIPF_S), 1 << 17, impl="skew")
    assert int(a.num_rows) == int(b.num_rows) == 8832
    for k in a.columns:
        assert torch.equal(a.columns[k], b.columns[k]), k


# ---------------------------------------------------------------------------
# heavy matches past the heavy buffer (out_capacity // 2): the port alone
# against numpy's join and the oracle (tpq splices the cut buffer and
# gives the same wrong rows, so it is no reference here)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r7,s7,taken", [
    (10, 1000, False),  # 10,000 heavy rows: past the heavy buffer, falls back
    (8, 1024, True),    # 8,192: the heavy buffer exactly full, the split holds
    (8, 1025, False),   # 8,200: one heavy row per R row too many
], ids=["past", "full", "one_past"])
def test_skew_heavy_overflow_falls_back_exact(oracle, tmp_path, r7, s7, taken):
    r, s = skew_cases.heavy_case(r7, s7)
    R, S = _cpu(r), _cpu(s)
    cap = skew_cases.OUT_CAPACITY
    assert bool(skew_path_taken(R, S, cap)) == taken
    out = skew_hash_join(R, S, cap)
    want = skew_cases.numpy_join(r, s)
    assert int(out.num_rows) == len(want["key"]) == r7 * s7 + 3000
    got = canonicalize(out)
    assert_tables_equal(got, want, "heavy overflow vs numpy")
    assert_tables_equal(got, _oracle_rows(oracle, tmp_path, r, s, "heavy"),
                        "heavy overflow vs oracle")
