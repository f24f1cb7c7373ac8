"""tpq_torch's distributed join and its pieces held against tpq's on the
CPU: the bucket histogram (kernel 5, plain torch version here),
partition_padded and msd_partition, owner_of, the whole dense + skew +
chunked join shard by shard on an 8-shard one-process mesh against
tpq's on its 8 simulated devices, and plan_dist_capacities. Then the
port alone: the ring and ragged rungs against dense, the lane local join
against the sorted one and the C++ oracle, the dryrun's exact count,
overflow, the empty relation, the checksum, and a two-process gloo run of
the process-group mesh against the one-process mesh. tpq runs once per
function, in module fixtures, never its lane join under shard_map.
Integer data: every comparison is exact (tolerance 0)."""

import collections
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from tpq import verify as jverify
from tpq.dist import dist_join as jdist
from tpq.dist import make_mesh as jmake_mesh
from tpq.dist import owner_of as jowner_of
from tpq.kernels import radix_partition as jrp
from tpq.kernels import radix_sort as jrs
from tpq_torch import Table, colio, datagen, verify
from tpq_torch.columnar import canonicalize, next_pow2
from tpq_torch.config import PRESETS
from tpq_torch.dist import (DistTable, SkewConfig, dist_hash_join,
                            dist_hash_join_planned, dist_hash_join_renegotiated,
                            dryrun_multichip, make_mesh, multihost, owner_of,
                            plan_dist_capacities)
from tpq_torch.dist.exchange import exchange
from tpq_torch.kernels.radix_partition import (MAX_BUCKETS, partition_padded,
                                               radix_histogram, radix_histogram_ref)
from tpq_torch.kernels.radix_sort import msd_partition

from conftest import assert_tables_equal
import torch_oracle  # noqa: F401  (builds the oracle before any test runs)

torch.set_num_threads(2)


def _canon(cols: dict) -> dict:
    names = list(cols)
    order = np.lexsort(tuple(cols[n] for n in reversed(names)))
    return {n: cols[n][order] for n in names}


def _oracle_rows(oracle, tmp_path, r, s, tag, algo="hash"):
    pr, ps, po = (tmp_path / f"{tag}_{x}.tpqc" for x in ("r", "s", "out"))
    colio.dump(str(pr), r)
    colio.dump(str(ps), s)
    oracle("join", algo=algo, left=pr, right=ps, out=po)
    return colio.load(str(po))


def _expected_count(r, s) -> int:
    rc = collections.Counter(r["key"].tolist())
    sc = collections.Counter(s["key"].tolist())
    return sum(rc[k] * sc[k] for k in rc)


# ---------------------------------------------------------------------------
# kernel 5 and the partition helpers
# ---------------------------------------------------------------------------

def _hist_ids(case):
    """tests/test_kernels.py's case (sentinel ids sprinkled in) and the
    planner's shape (nbuckets = nchips + 1 = 9) with negative ids."""
    rng = np.random.default_rng(0 if case == "sentinel" else 1)
    if case == "sentinel":
        ids = rng.integers(0, 64, 1 << 14).astype(np.int32)
        ids[::17] = 64
        return ids, 64
    ids = rng.integers(-3, 12, 1 << 13).astype(np.int32)
    ids[::5] = 8  # the planner's busy sentinel-free bucket
    return ids, 9


HIST_CASES = ["sentinel", "planner"]


@pytest.fixture(scope="module")
def tpq_hist():
    """tpq's radix_histogram (interpret-mode Pallas) on both cases, once."""
    out = {}
    for case in HIST_CASES:
        ids, nb = _hist_ids(case)
        out[case] = np.asarray(jrp.radix_histogram(jnp.asarray(ids), nb, tile=2048,
                                                   interpret=True))
    return out


@pytest.mark.parametrize("case", HIST_CASES)
def test_radix_histogram_matches_tpq(tpq_hist, case):
    ids, nb = _hist_ids(case)
    t = torch.from_numpy(ids)
    before = radix_histogram.launches
    got = radix_histogram(t, nb)
    assert radix_histogram.launches == before  # the plain version on the CPU
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), tpq_hist[case])
    np.testing.assert_array_equal(radix_histogram_ref(t, nb).numpy(), tpq_hist[case])
    inr = ids[(ids >= 0) & (ids < nb)]
    np.testing.assert_array_equal(got.numpy(), np.bincount(inr, minlength=nb))


def test_radix_histogram_rejects_what_the_kernel_cannot_take():
    ids = torch.zeros(100, dtype=torch.int32)
    with pytest.raises(ValueError):
        radix_histogram(ids, MAX_BUCKETS + 1)
    with pytest.raises(ValueError):
        radix_histogram(ids.to(torch.int64), 8)
    # any N: no tile multiple needed
    assert radix_histogram(torch.arange(7, dtype=torch.int32), 5).tolist() == [1] * 5


@pytest.mark.parametrize("n,nbuckets,offset", [(1, 1, 0), (100_003, 9, 1),
                                               (4099, MAX_BUCKETS, 3)])
def test_radix_histogram_takes_any_slice(n, nbuckets, offset):
    """The contract the kernel is held to on the card, here on the CPU:
    a slice at any offset and of any length, ids below 0 and at or past
    nbuckets ignored, equal to numpy's bincount of the ids in range."""
    rng = np.random.default_rng(n + offset)
    all_ids = rng.integers(-3, nbuckets + 3, n + offset).astype(np.int32)
    got = radix_histogram(torch.from_numpy(all_ids)[offset:], nbuckets)
    ids = all_ids[offset:]
    inr = ids[(ids >= 0) & (ids < nbuckets)]
    np.testing.assert_array_equal(got.numpy(), np.bincount(inr, minlength=nbuckets))


@pytest.mark.parametrize("extra", [False, True])
def test_partition_padded_matches_tpq(extra):
    rng = np.random.default_rng(1)
    n = 1 << 12
    bucket = rng.integers(0, 17, n).astype(np.int32)  # 16 = padding sentinel
    sub = rng.integers(0, 5, n).astype(np.int32)
    ex_j = (jnp.asarray(sub),) if extra else ()
    ex_t = (torch.from_numpy(sub),) if extra else ()
    for cap in (1 << 10, 200):  # fits; overflows
        want = jrp.partition_padded(jnp.asarray(bucket), 16, cap, ex_j)
        got = partition_padded(torch.from_numpy(bucket), 16, cap, ex_t)
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert bool(got[3]) == bool(want[3]) == (cap == 200)


def test_msd_partition_matches_tpq():
    rng = np.random.default_rng(2)
    keys = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, 3000,
                        dtype=np.int64)
    keys[:4] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, -1, 0]
    for bits, cap in ((4, 512), (3, 300)):
        want = jrs.msd_partition(jnp.asarray(keys), 2900, bits, cap)
        got = msd_partition(torch.from_numpy(keys), 2900, bits, cap)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("nchips", [8, 6])
def test_owner_of_matches_tpq(nchips):
    rng = np.random.default_rng(nchips)
    keys = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, 5000,
                        dtype=np.int64)
    keys[:3] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, 0]
    got = owner_of(torch.from_numpy(keys), nchips)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jowner_of(jnp.asarray(keys),
                                                                    nchips)))
    assert got.min() >= 0 and got.max() < nchips


# ---------------------------------------------------------------------------
# the whole join against tpq's, shard by shard
# ---------------------------------------------------------------------------

# tests/test_dist.py's skew-split case
SK_R = datagen.gen_relation_np(4096, 5000, payloads=1, seed=51, kind="zipf")
SK_S = datagen.gen_relation_np(4096, 5000, payloads=1, seed=52, kind="zipf")
SK_KW = dict(out_capacity_per_shard=1 << 17, exchange_capacity=2048,
             skew=SkewConfig(candidates_per_shard=8, threshold=256,
                             replica_capacity_per_shard=2048), n_chunks=2)


@pytest.fixture(scope="module")
def tpq_dist():
    """tpq's dist_hash_join (sorted local join, dense exchange, skew
    split, two chunks) and plan_dist_capacities on its 8-device CPU
    mesh, once each. The join is jitted and compiled at XLA's backend
    optimization level 0: the same integer results in about 10 s where
    the default level takes about 4 minutes cold."""
    mesh = jmake_mesh(8)
    R = jdist.DistTable.from_numpy(SK_R, mesh)
    S = jdist.DistTable.from_numpy(SK_S, mesh)
    kw = dict(SK_KW, skew=jdist.SkewConfig(8, 256, 2048))

    def join(rc, rn, sc, sn):
        out, ovf = jdist.dist_hash_join(jdist.DistTable(rc, rn), jdist.DistTable(sc, sn),
                                        mesh, **kw)
        return out.columns, out.shard_rows, ovf

    args = (R.columns, R.shard_rows, S.columns, S.shard_rows)
    cols, counts, ovf = jax.jit(join).lower(*args).compile(
        {"xla_backend_optimization_level": 0})(*args)
    counts = np.asarray(counts)
    lc = len(next(iter(cols.values()))) // 8
    shards = [{n: np.asarray(c)[i * lc:i * lc + counts[i]] for n, c in cols.items()}
              for i in range(8)]
    return {"shards": shards, "counts": counts, "overflow": np.asarray(ovf),
            "plan": jdist.plan_dist_capacities(R, S, mesh)}


def _port_tables(mesh, r=SK_R, s=SK_S):
    return DistTable.from_numpy(r, mesh), DistTable.from_numpy(s, mesh)


def test_dist_join_matches_tpq_shard_by_shard(tpq_dist):
    mesh = make_mesh(8, "cpu")
    R, S = _port_tables(mesh)
    out, ovf = dist_hash_join(R, S, mesh, **SK_KW)
    np.testing.assert_array_equal(ovf.numpy(), tpq_dist["overflow"])
    assert int(ovf.sum()) == 0
    np.testing.assert_array_equal(out.shard_rows.numpy(), tpq_dist["counts"])
    assert out.local_capacity == 1 << 17
    for i, (mine, theirs) in enumerate(zip(out.shards_numpy(), tpq_dist["shards"])):
        assert_tables_equal(_canon(mine), _canon(theirs), f"shard {i}")


def test_plan_dist_capacities_matches_tpq(tpq_dist):
    mesh = make_mesh(8, "cpu")
    R, S = _port_tables(mesh)
    assert plan_dist_capacities(R, S, mesh) == tuple(tpq_dist["plan"])


# ---------------------------------------------------------------------------
# the port alone: rungs, local impls, the dryrun, edge cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["ring", "ragged"])
def test_exchange_rung_delivers_what_dense_does(impl):
    """Each destination receives the same multiset of rows (the case of
    tests/test_dist.py's ring test), ragged rows packed in sender order."""
    mesh = make_mesh(8, "cpu")
    rng = np.random.default_rng(7)
    cols = {"key": rng.integers(0, 1 << 40, size=4096).astype(np.int64),
            "p0": rng.integers(0, 1 << 30, size=4096).astype(np.int64)}
    T = DistTable.from_numpy(cols, mesh)
    dests = [owner_of(t.col("key"), 8) for t in T.shards]
    dense, ovf_d = exchange(T.shards, dests, mesh, 8, 512, impl="dense")
    other, ovf_o = exchange(T.shards, dests, mesh, 8, 512, impl=impl)
    assert sum(int(o) for o in ovf_d + ovf_o) == 0
    total = 0
    for a, b in zip(dense, other):
        assert int(a.num_rows) == int(b.num_rows)
        total += int(a.num_rows)
        assert_tables_equal(_canon(a.to_numpy()), _canon(b.to_numpy()), impl)
        if impl == "ragged":  # sender order: every sender's rows in row order
            assert torch.equal(a.col("key")[:int(a.num_rows)], b.col("key")[:int(b.num_rows)])
    assert total == 4096


@pytest.mark.parametrize("impl", ["ring", "ragged"])
def test_dist_join_rung_matches_dense(impl):
    mesh = make_mesh(8, "cpu")
    R, S = _port_tables(mesh)
    kw = dict(SK_KW, n_chunks=1)
    a, ovf_a = dist_hash_join(R, S, mesh, **kw)
    b, ovf_b = dist_hash_join(R, S, mesh, exchange_impl=impl, **kw)
    assert int(ovf_a.sum()) == int(ovf_b.sum()) == 0
    for i, (x, y) in enumerate(zip(a.shards_numpy(), b.shards_numpy())):
        assert_tables_equal(_canon(x), _canon(y), f"{impl} shard {i}")


@pytest.mark.parametrize("impl", ["dense", "ring"])
def test_lane_local_impl_matches_sorted_and_oracle(oracle, tmp_path, impl):
    """tests/test_dist.py's lane case (R built once per shard, probed per
    ring hop or once after the dense exchange)."""
    r = datagen.gen_relation_np(1500, 400, payloads=1, seed=31)
    s = datagen.gen_relation_np(2500, 400, payloads=2, seed=32)
    mesh = make_mesh(8, "cpu")
    R, S = _port_tables(mesh, r, s)
    lane, ovf_l = dist_hash_join(R, S, mesh, 1 << 14, exchange_impl=impl,
                                 local_impl="lane", lane_depth=16)
    srt, ovf_s = dist_hash_join(R, S, mesh, 1 << 14, exchange_impl=impl)
    assert int(ovf_l.sum()) == int(ovf_s.sum()) == 0
    for i, (x, y) in enumerate(zip(lane.shards_numpy(), srt.shards_numpy())):
        assert_tables_equal(_canon(x), _canon(y), f"lane vs sorted, shard {i}")
    expected = _oracle_rows(oracle, tmp_path, r, s, f"lane_{impl}")
    assert_tables_equal(_canon(lane.to_numpy()), expected, "lane vs oracle")
    assert_tables_equal(_canon(srt.to_numpy()), expected, "sorted vs oracle")


def test_dryrun_multichip_on_the_cpu(oracle, tmp_path):
    from tpq_torch.dist import dryrun_relations

    out = dryrun_multichip(8, device="cpu")
    r, s, expected = dryrun_relations()
    assert expected == 62_545
    want = _oracle_rows(oracle, tmp_path, r, s, "dryrun")
    assert list(out) == ["chunked+skew", "ring+skew", "dense+lane+skew"]
    for name, (res, _retries) in out.items():
        assert_tables_equal(_canon(res.to_numpy()), want, name)


def test_exchange_overflow_detected():
    mesh = make_mesh(8, "cpu")
    # all rows share one key -> all land on one shard; tiny buckets
    R = DistTable.from_numpy({"key": np.zeros(4096, dtype=np.int64)}, mesh)
    _, overflow = dist_hash_join(R, R, mesh, out_capacity_per_shard=1 << 10,
                                 exchange_capacity=128)
    assert overflow.shape == (8,) and int(overflow.sum()) > 0


def test_dist_empty_relation():
    mesh = make_mesh(8, "cpu")
    R, S = _port_tables(mesh, datagen.gen_relation_np(0, 10, payloads=1, seed=1),
                        datagen.gen_relation_np(64, 10, payloads=1, seed=2))
    out, overflow = dist_hash_join(R, S, mesh, out_capacity_per_shard=256)
    assert int(overflow.sum()) == 0
    assert len(out.to_numpy()["key"]) == 0


def test_renegotiation_and_planning_recover_the_zipf_join(oracle, tmp_path):
    """tests/test_dist.py's ring-overflow case: from a capacity that
    overflows, the renegotiated join grows to the full result; the planned
    join overflows nothing; both equal the oracle. (The lane local join
    would overflow its bucket depth on these unsplit zipf keys: the
    dryrun's lane variant splits them first.)"""
    r = datagen.gen_relation_np(1024, 600, payloads=1, seed=1, kind="zipf")
    s = datagen.gen_relation_np(2048, 600, payloads=1, seed=2, kind="zipf")
    mesh = make_mesh(8, "cpu")
    R, S = _port_tables(mesh, r, s)
    _, ovf = dist_hash_join(R, S, mesh, 1 << 14, exchange_impl="ring")
    assert int(ovf.sum()) > 0  # overflow reported, not rows dropped silently
    out, retries = dist_hash_join_renegotiated(R, S, mesh, 1 << 14,
                                               exchange_impl="ring")
    assert retries >= 1
    planned, ovf = dist_hash_join_planned(R, S, mesh)
    assert int(ovf.sum()) == 0
    want = _oracle_rows(oracle, tmp_path, r, s, "reneg")
    assert len(want["key"]) == _expected_count(r, s)
    assert_tables_equal(_canon(out.to_numpy()), want, "renegotiated")
    assert_tables_equal(_canon(planned.to_numpy()), want, "planned lane")


def test_skew_split_diverts_heavy_keys():
    """tests/test_dist.py's divert case: buckets of 512 overflow without
    the split and hold with it."""
    r = datagen.gen_relation_np(8192, 50_000, payloads=1, seed=61, kind="zipf")
    s = datagen.gen_relation_np(8192, 50_000, payloads=1, seed=62, kind="zipf")
    mesh = make_mesh(8, "cpu")
    R, S = _port_tables(mesh, r, s)
    _, ovf = dist_hash_join(R, S, mesh, 1 << 17, exchange_capacity=512)
    assert int(ovf.sum()) > 0
    out, ovf = dist_hash_join(R, S, mesh, 1 << 17, exchange_capacity=512,
                              skew=SkewConfig(8, 128, 4096))
    assert int(ovf.sum()) == 0
    assert len(out.to_numpy()["key"]) == _expected_count(r, s)


# ---------------------------------------------------------------------------
# verify
# ---------------------------------------------------------------------------

def test_multiset_checksum_matches_numpy_and_tpq():
    rng = np.random.default_rng(9)
    cols = {"key": rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, 3000,
                                dtype=np.int64),
            "p0": rng.integers(0, 1 << 62, 3000),
            "p1": rng.integers(-(1 << 31), 1 << 31, 3000).astype(np.int32)}
    cols["key"][:10] |= np.int64(np.iinfo(np.int64).min)  # top bit set
    t = Table.from_numpy(cols, device="cpu")
    want = verify.multiset_checksum_np(cols)
    assert want == jverify.multiset_checksum_np(cols)
    got = verify.multiset_checksum(t)
    assert got.dtype == torch.int64 and int(got) & verify.M64 == want
    from tpq import Table as JTable

    assert int(np.asarray(jverify.multiset_checksum(JTable.from_numpy(cols)))) == want
    # per-part sums add up, wrapping, to the whole: order-invariant
    halves = [Table.from_numpy({k: v[sl] for k, v in cols.items()}, device="cpu")
              for sl in (slice(1700, None), slice(0, 1700))]
    assert sum(int(verify.multiset_checksum(h)) for h in halves) & verify.M64 == want


def test_slices_and_ranges_match_tpq():
    keys = SK_R["key"]
    ranges = verify.sample_key_ranges(keys, n_ranges=4, target_rows=256, seed=3)
    assert ranges == jverify.sample_key_ranges(keys, n_ranges=4, target_rows=256, seed=3)
    for lo, hi in ranges:
        assert_tables_equal(verify.slice_by_key(SK_R, lo, hi),
                            jverify.slice_by_key(SK_R, lo, hi), "slice")


def test_dist_125m_8shard_preset():
    cfg = PRESETS["dist_125m_8shard"]
    assert cfg.mesh_shape == (8,)
    for spec, seed in ((cfg.r, 1), (cfg.s, 2)):
        assert (spec.rows, spec.nkeys, spec.payloads, spec.seed, spec.kind) == (
            125_000_000, 125_000_000, 1, seed, "uniform")
    # tpq's placement at this size: 8 shards of next_pow2(ceil(125M / 8))
    assert next_pow2(-(-cfg.r.rows // 8)) == 16_777_216


# ---------------------------------------------------------------------------
# the process-group mesh: two gloo processes against the one-process mesh
# ---------------------------------------------------------------------------

PG_R = datagen.gen_relation_np(2000, 700, payloads=1, seed=71, kind="zipf")
PG_S = datagen.gen_relation_np(3000, 700, payloads=2, seed=72, kind="zipf")
PG_SKEW = SkewConfig(8, 64, 1024)
PG_VARIANTS = {
    "dense+chunks": dict(out_capacity_per_shard=1 << 18, exchange_capacity=2048,
                         skew=PG_SKEW, n_chunks=2),
    "ring": dict(out_capacity_per_shard=1 << 18, exchange_impl="ring", skew=PG_SKEW),
    "ragged+lane": dict(out_capacity_per_shard=1 << 18, exchange_impl="ragged",
                        local_impl="lane", skew=PG_SKEW),
}


def _pg_results(mesh) -> dict:
    """{variant: (per held shard live rows, overflow)} on `mesh`, plus
    the planned capacities."""
    R, S = _port_tables(mesh, PG_R, PG_S)
    out = {}
    for name, kw in PG_VARIANTS.items():
        res, ovf = dist_hash_join(R, S, mesh, **kw)
        out[name] = (res.shards_numpy(), ovf.numpy())
    out["plan"] = plan_dist_capacities(R, S, mesh)
    return out


def _gloo_worker(rank, store_path, out_dir):
    store = dist.FileStore(store_path, 2)
    assert multihost.init(num_processes=2, process_id=rank, device="cpu", store=store)
    try:
        res = _pg_results(multihost.ProcessGroupMesh())
        flat = {"plan": np.asarray(res.pop("plan"))}
        for name, ((shard,), ovf) in res.items():
            flat[f"{name}/overflow"] = ovf
            flat.update({f"{name}/{c}": v for c, v in shard.items()})
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **flat)
    finally:
        dist.destroy_process_group()


def test_process_group_mesh_matches_one_process_mesh(tmp_path):
    ctx = mp.spawn(_gloo_worker, args=(str(tmp_path / "store"), str(tmp_path)),
                   nprocs=2, join=False)
    try:
        for _ in range(240):  # at most 120 s
            if ctx.join(timeout=0.5):
                break
        else:
            pytest.fail("the gloo ranks did not finish within 120 s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    local = _pg_results(make_mesh(2, "cpu"))
    for rank in range(2):
        got = np.load(tmp_path / f"rank{rank}.npz")
        assert tuple(got["plan"]) == local["plan"]
        for name in PG_VARIANTS:
            shards, ovf = local[name]
            np.testing.assert_array_equal(got[f"{name}/overflow"], ovf)
            assert int(ovf.sum()) == 0
            want = shards[rank]
            mine = {c: got[f"{name}/{c}"] for c in want}
            # the same rows in the same order: both meshes run one body
            assert_tables_equal(mine, want, f"{name}, rank {rank}")
    total = sum(len(local["ring"][0][i]["key"]) for i in range(2))
    assert total == _expected_count(PG_R, PG_S)
