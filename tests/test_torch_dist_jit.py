"""tpq's compiled distributed join, ported (tpq_torch.dist.dist_join's
jitted body), on the CPU: every variant's body runs under the capture
flag (`jit.deferred`) with every host read raising, along the branch path
an eager run takes (`jit.decided`), each of its conds recording a pred
that agrees with that path, and gives the eager body's shards and
overflow; the jitted entry points, which on CPU tensors run the body
itself, give the eager body's shards; the jitted bodies are keyed by
static capacities, never traced ones; the scaling and overlap benches
stay exact. The graphs run on the card only (tests/test_torch_cuda.py).
No tpq call: the eager body is held to tpq and the C++ oracle in
tests/test_torch_dist.py. Integer data: every comparison is exact."""

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch_host_reads import host_reads

from tpq_torch import datagen
from tpq_torch.bench import overlap_bench, runner, scaling
from tpq_torch.dist import (DRYRUN_VARIANTS, DistTable, SkewConfig, dist_hash_join,
                            dist_hash_join_planned, dist_hash_join_renegotiated,
                            dryrun_relations, jitted_join, make_mesh, multihost,
                            plan_dist_capacities, run_dryrun)
from tpq_torch.jit import _flatten, decided, deferred

torch.set_num_threads(2)

SHARDS = 8
PER = 1 << 11  # rows a shard
SKEW = SkewConfig(candidates_per_shard=8, threshold=64, replica_capacity_per_shard=2048)
# variant: its keyword arguments and the conds its body records (the
# sorted local join's one a shard per chunk or ring hop, and the skew
# split's heavy join one a shard; the lane local join has none)
VARIANTS = {
    "dense": ({}, SHARDS),
    "dense_4chunks": ({"n_chunks": 4}, 4 * SHARDS),
    "ring": ({"exchange_impl": "ring"}, SHARDS * SHARDS),
    "lane": ({"local_impl": "lane"}, 0),
    "lane_planned": ({"local_impl": "lane", "exchange_capacity": "planned"}, 0),
    "chunked+skew": ({"n_chunks": 2, "skew": SKEW}, 3 * SHARDS),
    "ring+skew": ({"exchange_impl": "ring", "skew": SKEW}, SHARDS * SHARDS + SHARDS),
    "dense+lane+skew": ({"local_impl": "lane", "skew": SKEW}, SHARDS),
}


@pytest.fixture(scope="module")
def relations():
    """Uniform R and S (the dense, ring and lane variants) and zipf ones
    over 2^16 keys at theta 0.6 (the skew variants), PER rows a shard,
    with the planned exchange capacity of the uniform pair."""
    mesh = make_mesh(SHARDS, "cpu")
    n = SHARDS * PER

    def placed(seed, **kw):
        return DistTable.from_numpy(datagen.gen_relation_np(n, kw.pop("nkeys", n), 1, seed,
                                                            **kw), mesh)

    uniform = placed(71), placed(72)
    zipf = (placed(73, nkeys=1 << 16, kind="zipf", theta=0.6),
            placed(74, nkeys=1 << 16, kind="zipf", theta=0.6))
    ex_cap, _ = plan_dist_capacities(*uniform, mesh)
    return mesh, uniform, zipf, ex_cap


def _join_kwargs(name, ex_cap):
    kw, nconds = VARIANTS[name]
    kw = dict(kw)
    if kw.get("exchange_capacity") == "planned":
        kw["exchange_capacity"] = ex_cap
    return kw, nconds


def _shards_equal(a: DistTable, b: DistTable) -> None:
    assert len(a.shards) == len(b.shards)
    for x, y in zip(a.shards_numpy(), b.shards_numpy()):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_body_makes_no_host_read_on_its_path(relations, name):
    """The body at static capacities traced along the path an eager run
    takes: no host read, as many conds as the variant makes, each pred
    agreeing with the path, and the eager body's shards and overflow (0)."""
    mesh, uniform, zipf, ex_cap = relations
    r, s = zipf if "skew" in name else uniform
    kw, nconds = _join_kwargs(name, ex_cap)
    with decided() as path:
        want, want_ovf = dist_hash_join(r, s, mesh, 8 * PER, eager=True, **kw)
    assert len(path) == nconds
    with deferred(tuple(path)) as preds, host_reads("raise"):
        got, ovf = dist_hash_join(r, s, mesh, 8 * PER, eager=True, **kw)
    assert [bool(p) for p in preds] == path
    assert int(want_ovf.sum()) == 0 and torch.equal(ovf, want_ovf)
    assert int(got.shard_rows.sum()) > 0
    _shards_equal(got, want)


@pytest.mark.parametrize("name", list(DRYRUN_VARIANTS))
def test_dryrun_variant_body_makes_no_host_read(name):
    """The dryrun's own relations and knobs at its first attempt's
    capacity (1 << 15 a shard), traced along the eager path: no host
    read, the dryrun's exact count."""
    r_np, s_np, expected = dryrun_relations()
    mesh = make_mesh(SHARDS, "cpu")
    r, s = DistTable.from_numpy(r_np, mesh), DistTable.from_numpy(s_np, mesh)
    kw = DRYRUN_VARIANTS[name]
    with decided() as path:
        want, _ = dist_hash_join(r, s, mesh, 1 << 15, eager=True, **kw)
    with deferred(tuple(path)) as preds, host_reads("raise"):
        got, ovf = dist_hash_join(r, s, mesh, 1 << 15, eager=True, **kw)
    assert preds and [bool(p) for p in preds] == path
    assert int(ovf.sum()) == 0 and int(got.shard_rows.sum()) == expected
    _shards_equal(got, want)


@pytest.mark.parametrize("entry", ["join", "planned", "renegotiated", "dryrun"])
def test_jitted_entry_points_equal_the_eager_body(relations, entry):
    """Each entry point's default (jitted) form on CPU tensors gives the
    eager body's shards and overflow, and keeps its jitted body on the
    mesh until mesh.clear()."""
    _, (r, s), _, _ = relations
    mesh = make_mesh(SHARDS, "cpu")
    if entry == "dryrun":
        r_np, s_np, _ = dryrun_relations()
        dr, ds = DistTable.from_numpy(r_np, mesh), DistTable.from_numpy(s_np, mesh)
        for k, (res, retries) in run_dryrun(mesh).items():
            want, want_retries = dist_hash_join_renegotiated(
                dr, ds, mesh, 1 << 15, eager=True, **DRYRUN_VARIANTS[k])
            _shards_equal(res, want)
            assert retries == want_retries
    else:
        call = {"join": lambda **kw: dist_hash_join(r, s, mesh, 4 * PER, **kw),
                "planned": lambda **kw: dist_hash_join_planned(r, s, mesh, **kw),
                "renegotiated": lambda **kw: dist_hash_join_renegotiated(
                    r, s, mesh, 1 << 8, local_impl="lane", **kw)}[entry]
        (got, ovf), (want, want_ovf) = call(), call(eager=True)
        _shards_equal(got, want)
        assert torch.equal(torch.as_tensor(ovf), torch.as_tensor(want_ovf))
    assert mesh.programs
    mesh.clear()
    assert not mesh.programs


def _statics(out_cap: int) -> dict:
    return dict(out_capacity_per_shard=out_cap, exchange_capacity=None, algo="hash",
                exchange_impl="dense", key="key", skew=None, n_chunks=1,
                local_impl="sorted", lane_depth=48)


def test_jitted_bodies_keyed_by_static_capacities(relations):
    """One jitted body a static set, made once: a second out_cap is a
    second callable, the same one the same callable; the capacities are
    closed over, so the body's arguments hold tensors only (no number
    for jit to trace)."""
    _, (r, s), _, _ = relations
    mesh = make_mesh(SHARDS, "cpu")
    a, b = jitted_join(mesh, **_statics(1 << 12)), jitted_join(mesh, **_statics(1 << 13))
    assert a is not b and jitted_join(mesh, **_statics(1 << 12)) is a
    dist_hash_join(r, s, mesh, 1 << 12)
    dist_hash_join(r, s, mesh, 1 << 13)
    assert set(mesh.programs.values()) == {a, b}
    leaves: list = []
    for x in (r, s):
        _flatten(x, leaves, top=True)
    assert leaves and all(isinstance(x, torch.Tensor) for x in leaves)


@pytest.mark.parametrize("eager", [False, True])
def test_weak_scaling_and_overlap_exact_in_both_forms(eager):
    """The benches with and without their jitted bodies: every count
    exact (each bench checks it and raises otherwise), every record
    labelled as not run as a CUDA graph (on the CPU jit runs the body)."""
    rows = scaling.run_weak_scaling(rows_per_chip=2**10, mesh_sizes=(1, 8),
                                    device="cpu", eager=eager)
    assert [r["n_chips"] for r in rows] == [1, 8]
    for r in rows:
        n = r["rows_total"]
        assert r["num_rows"] == scaling.true_join_rows(n, n, 77, 78, "cpu") > 0
        assert r["jitted"] is False
    mesh = make_mesh(SHARDS, "cpu")
    rows = overlap_bench.run_overlap_matrix(mesh, rows_per_shard=2**10, eager=eager)
    want = scaling.true_join_rows(SHARDS * 2**10, SHARDS * 2**10, 71, 72, "cpu")
    assert [r["num_rows"] for r in rows] == [want] * 3
    assert all(r["jitted"] is False for r in rows) and not mesh.programs


def test_runner_eager_reaches_the_scaling_bench(monkeypatch):
    """`runner --scaling ... --eager` runs the bench's eager bodies; the
    default its jitted ones."""
    seen = []
    real = scaling.run_weak_scaling

    def spy(**kw):
        seen.append(kw["eager"])
        return real(**kw)

    monkeypatch.setattr(scaling, "run_weak_scaling", spy)
    for extra in ([], ["--eager"]):
        runner.main(["--scaling", "1,2", "--rows-per-chip", "512", "--device", "cpu",
                     *extra])
    assert seen == [False, True]


def test_process_group_runs_eagerly_and_says_so(tmp_path):
    """On a process group (a one-rank gloo group here) the join's body
    runs eagerly, chosen by the mesh type: no jitted body is kept, and
    the scaling record says `jitted` false."""
    store = dist.FileStore(str(tmp_path / "store"), 1)
    assert multihost.init(num_processes=1, process_id=0, device="cpu", store=store)
    try:
        mesh = multihost.ProcessGroupMesh()
        assert mesh.programs is None
        rows = scaling.run_weak_scaling(rows_per_chip=2**9, mesh_sizes=(1,),
                                        device="cpu", process_group=True)
    finally:
        dist.destroy_process_group()
    (r,) = rows
    assert (r["mesh"], r["jitted"]) == ("process_group", False)
    assert r["num_rows"] == scaling.true_join_rows(2**9, 2**9, 77, 78, "cpu")
