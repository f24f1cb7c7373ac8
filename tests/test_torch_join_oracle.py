"""tpq_torch's hash join (lane and sorted impls, plain kernel versions on
the CPU) held against the C++ oracle: canonical-order byte equality on
the join cases of tests/test_ops_oracle.py, edge keys, empty sides,
all-equal keys, overflow, the h2-collision fallback and determinism.
The port runs alone here; nothing is compiled, so every case is cheap."""

import argparse
from dataclasses import replace

import numpy as np
import pytest
import torch

from tpq_torch import Table, colio, datagen
from tpq_torch.bench.runner import add_join_args, config_from_args, run_config
from tpq_torch.columnar import canonicalize
from tpq_torch.config import PRESETS
from tpq_torch.kernels import radix_sort
from tpq_torch.kernels.lane2 import lane2_path_taken
from tpq_torch.kernels.lane_table import LanePlan
from tpq_torch.ops import hash_join
from tpq_torch.ops.filter import compact
from tpq_torch.ops.union_join import union_join, union_sort_specs

from conftest import assert_tables_equal
import torch_oracle  # noqa: F401  (builds the oracle before any test runs)

torch.set_num_threads(2)

IMPLS = ["lane", "sorted"]

# tests/test_ops_oracle.py's _JOIN_CASES: (nr, ns, nkeys, kind, out_capacity)
JOIN_CASES = [
    (1000, 1500, 300, "uniform", 1 << 14),
    (1000, 1500, 2_000_000, "uniform", 1 << 10),  # mostly no matches
    (2048, 2048, 64, "uniform", 1 << 17),  # heavy duplicates
    (2000, 1500, 1000, "zipf", 1 << 17),  # skewed
    (1, 1, 1, "uniform", 1 << 4),
    (7, 1, 3, "uniform", 1 << 4),
]


def _oracle_join(oracle, tmp_path, r_cols, s_cols, tag):
    pr, ps, po = (tmp_path / f"{tag}_{x}.tpqc" for x in ("r", "s", "out"))
    colio.dump(str(pr), r_cols)
    colio.dump(str(ps), s_cols)
    oracle("join", algo="hash", left=pr, right=ps, out=po)
    return colio.load(str(po))


def _join_case(oracle, tmp_path, r_cols, s_cols, impl, out_capacity, tag):
    expected = _oracle_join(oracle, tmp_path, r_cols, s_cols, tag)
    out = hash_join(Table.from_numpy(r_cols, device="cpu"),
                    Table.from_numpy(s_cols, device="cpu"), out_capacity, impl=impl)
    assert int(out.num_rows) <= out_capacity, f"{tag}: overflow"
    assert_tables_equal(canonicalize(out), expected, tag)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("ci", range(len(JOIN_CASES)))
def test_join_matches_oracle(oracle, tmp_path, impl, ci):
    nr, ns, nkeys, kind, cap = JOIN_CASES[ci]
    r = datagen.gen_relation_np(nr, nkeys, payloads=2, seed=11, kind=kind)
    s = datagen.gen_relation_np(ns, nkeys, payloads=1, seed=22, kind=kind)
    _join_case(oracle, tmp_path, r, s, impl, cap, f"{impl}_case{ci}")


@pytest.mark.parametrize("impl", IMPLS)
def test_join_edge_keys(oracle, tmp_path, impl):
    """INT64_MIN/MAX keys must not collide with padding."""
    im, ix = np.iinfo(np.int64).min, np.iinfo(np.int64).max
    r = {"key": np.array([im, ix, ix, 0, -1, 5], dtype=np.int64),
         "p0": np.arange(6, dtype=np.int64)}
    s = {"key": np.array([ix, im, 5, 5, 7, ix, 0], dtype=np.int64),
         "p0": np.arange(7, dtype=np.int64) * 10}
    _join_case(oracle, tmp_path, r, s, impl, 1 << 8, f"{impl}_edge")


@pytest.mark.parametrize("impl", IMPLS)
def test_join_empty_sides(oracle, tmp_path, impl):
    r = datagen.gen_relation_np(0, 10, payloads=1, seed=1)
    s = datagen.gen_relation_np(100, 10, payloads=1, seed=2)
    _join_case(oracle, tmp_path, r, s, impl, 1 << 10, f"{impl}_empty_r")
    _join_case(oracle, tmp_path, s, r, impl, 1 << 10, f"{impl}_empty_s")


@pytest.mark.parametrize("impl", IMPLS)
def test_join_all_equal_keys(oracle, tmp_path, impl):
    """Worst-case duplicates: |R|x|S| cross product within one key."""
    r = {"key": np.zeros(64, dtype=np.int64), "p0": np.arange(64, dtype=np.int64)}
    s = {"key": np.zeros(32, dtype=np.int64), "p0": np.arange(32, dtype=np.int64)}
    _join_case(oracle, tmp_path, r, s, impl, 4096, f"{impl}_allequal")


@pytest.mark.parametrize("impl", IMPLS)
def test_join_overflow_detected(impl):
    r = Table.from_numpy({"key": np.zeros(64, dtype=np.int64)}, device="cpu")
    s = Table.from_numpy({"key": np.zeros(64, dtype=np.int64)}, device="cpu")
    out = hash_join(r, s, 128, impl=impl)  # true size 4096
    assert int(out.num_rows) == 4096  # > capacity: the caller sees overflow


def test_lane_h2_hazard_falls_back_exact(oracle, tmp_path):
    """Two distinct keys colliding on the full (bucket, h2) composite
    (the pair of tests/test_kernels.py) clear `ok`; the join is still
    exact through the sorted fallback."""
    plan = LanePlan(pbits=3, depth=16, probe_cap=1024, inline_k=4,
                    tail_rows_cap=2048, tail_out_cap=4096)
    k1, k2 = 7302945295039616556, 3449075177175606448  # same (bucket, h2)
    r = {"key": np.array([k1, k2, 5, 6, 7], dtype=np.int64),
         "p0": np.arange(5, dtype=np.int64)}
    s = {"key": np.array([k1, k2, k1, 6], dtype=np.int64),
         "p0": np.arange(4, dtype=np.int64) * 10}
    R, S = Table.from_numpy(r, device="cpu"), Table.from_numpy(s, device="cpu")
    assert not bool(lane2_path_taken(R, S, 1 << 8, plan=plan))
    assert not bool(lane2_path_taken(R, S, 1 << 8))
    a = hash_join(R, S, 1 << 8, impl="lane")
    b = hash_join(R, S, 1 << 8, impl="sorted")
    assert int(a.num_rows) == int(b.num_rows) == 4
    assert_tables_equal(canonicalize(a), canonicalize(b), "h2 fallback")
    _join_case(oracle, tmp_path, r, s, "lane", 1 << 8, "h2")


@pytest.mark.parametrize("impl", IMPLS)
def test_determinism_two_runs(impl):
    """Same inputs twice => byte-identical output columns."""
    r = datagen.gen_relation_np(2000, 100, payloads=1, seed=1)
    s = datagen.gen_relation_np(2000, 100, payloads=1, seed=2)
    a = hash_join(Table.from_numpy(r, device="cpu"),
                  Table.from_numpy(s, device="cpu"), 1 << 17, impl=impl)
    b = hash_join(Table.from_numpy(r, device="cpu"),
                  Table.from_numpy(s, device="cpu"), 1 << 17, impl=impl)
    assert int(a.num_rows) == int(b.num_rows)
    for k in a.columns:
        assert torch.equal(a.columns[k], b.columns[k]), k


def test_int32_columns_keep_their_dtype():
    """int32 keys and payloads ride the lane path widened to int64 and
    come back as int32, equal to the sorted engine's rows."""
    rng = np.random.default_rng(4)
    r = {"key": rng.integers(-50, 50, 900).astype(np.int32),
         "p0": rng.integers(-(1 << 31), 1 << 31, 900).astype(np.int32)}
    s = {"key": rng.integers(-50, 50, 700).astype(np.int32),
         "q": rng.integers(0, 1 << 40, 700)}
    R, S = Table.from_numpy(r, device="cpu"), Table.from_numpy(s, device="cpu")
    a = hash_join(R, S, 1 << 15, impl="lane")
    b = union_join(R, S, 1 << 15)
    assert [c.dtype for c in a.columns.values()] == [torch.int32, torch.int32,
                                                     torch.int64]
    assert_tables_equal(canonicalize(a), canonicalize(b), "int32")


def test_runner_smoke_1k_on_cpu():
    """The bench runner at smoke_1k: the lane path runs, the row count is
    the true join size, and no time is reported off the card."""
    cfg = PRESETS["smoke_1k"]
    rep = run_config(cfg, device="cpu")
    r = datagen.gen_relation_np(cfg.r.rows, cfg.r.nkeys, cfg.r.payloads, cfg.r.seed)
    s = datagen.gen_relation_np(cfg.s.rows, cfg.s.nkeys, cfg.s.payloads, cfg.s.seed)
    true_rows = int((np.bincount(r["key"], minlength=cfg.r.nkeys)
                     * np.bincount(s["key"], minlength=cfg.r.nkeys)).sum())
    assert rep["out_rows"] == int(rep["output"].num_rows) == true_rows
    assert rep["ops"][0]["op"] == "join_hash_lane"
    assert rep["ops"][0]["elapsed_ms"] is None



def test_runner_cli_selects_the_radix_merge(monkeypatch):
    """--algo and --sort-engine reach the runner's join: the radix merge
    runs one digit pass per 8 of its 66 bit specs, labels its row by its
    engine and gives the lax engine's rows."""
    passes = []

    def split(planes, specs, _split=radix_sort.split_digit):
        passes.append(len(specs))
        return _split(planes, specs)

    monkeypatch.setattr(radix_sort, "split_digit", split)
    p = argparse.ArgumentParser()
    add_join_args(p)
    cfg = config_from_args(p.parse_args(["--config=smoke_1k", "--algo=merge",
                                         "--sort-engine=radix"]))
    rep = run_config(cfg, device="cpu")
    assert rep["ops"][0]["op"] == "join_merge_radix"
    assert passes == [8] * 8 + [2] and len(union_sort_specs(64)) == sum(passes) == 66
    lax = run_config(replace(cfg, join=replace(cfg.join, sort_engine="lax")),
                     device="cpu")
    assert lax["ops"][0]["op"] == "join_merge_lax" and len(passes) == 9
    assert rep["out_rows"] == lax["out_rows"] > 0
    assert_tables_equal(canonicalize(rep["output"]), canonicalize(lax["output"]))


def test_unported_paths_raise():
    """The paths that raised before the pipeline was ported now run:
    probe_keep on every impl gives the join of the compacted probe side,
    and the runner runs a pipeline preset. Nothing of them raises."""
    rng = np.random.default_rng(9)
    r = {"key": rng.integers(0, 40, 300), "p0": np.arange(300, dtype=np.int64)}
    s = {"key": rng.integers(0, 40, 500), "p0": np.arange(500, dtype=np.int64)}
    R, S = Table.from_numpy(r, device="cpu"), Table.from_numpy(s, device="cpu")
    keep = S.col("key") < 25
    want = canonicalize(union_join(R, compact(S, keep), 1 << 14))
    for impl in ("lane", "sorted", "skew"):
        got = hash_join(R, S, 1 << 14, impl=impl, probe_keep=keep)
        assert_tables_equal(canonicalize(got), want, impl)
    rep = run_config(PRESETS["smoke_pipeline"], device="cpu")
    assert rep["ops"][0]["op"] == "pipeline" and rep["out_rows"] > 0
