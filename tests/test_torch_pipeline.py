"""tpq_torch's filter, hash aggregate, pipeline (filter -> hash join ->
hash aggregate, config 4), entry step and capacity renegotiation, on the
CPU with the plain kernel versions.

Held against the C++ oracle (canonical-order byte equality): the filter
and aggregate cases of tests/test_ops_oracle.py and the chained pipeline
of tests/test_query.py. Held against tpq (exact, live rows in the order
both emit): the aggregate and the sorted pipeline, tpq run once each in
one module fixture; tpq's lane pipeline is not called (its own test is
slow-marked), the port's lane path is held to the oracle and to the
port's sorted path instead. Integer data: every comparison is exact."""

import numpy as np
import pytest
import torch

from tpq_torch import Table, colio, datagen
from tpq_torch.bench.runner import add_join_args, config_from_args, join_fn, run_config
from tpq_torch.columnar import canonicalize
from tpq_torch.config import PRESETS
from tpq_torch.kernels.lane2 import lane2_hash_join, lane2_path_taken
from tpq_torch.ops import hash_join
from tpq_torch.ops.filter import filter_table, keep_mask
from tpq_torch.ops.hash_aggregate import hash_aggregate
from tpq_torch.ops.renegotiate import run_renegotiated
from tpq_torch.query import entry, full_pipeline, jit_pipeline

from conftest import assert_tables_equal
import torch_oracle  # noqa: F401  (builds the oracle before any test runs)

torch.set_num_threads(2)

IX = np.iinfo(np.int64).max
IM = np.iinfo(np.int64).min


def _t(cols) -> Table:
    return Table.from_numpy(cols, device="cpu")


def _live(t) -> dict:
    """A Table's live rows as host columns (jax or torch)."""
    n = int(t.num_rows)
    return {k: np.asarray(v)[:n] for k, v in t.columns.items()}


def _oracle(oracle, tmp_path, cmd, tag, ins: dict, **kw):
    """Runs one oracle command on host columns; returns its output."""
    args = {}
    for name, cols in ins.items():
        p = tmp_path / f"{tag}_{name}.tpqc"
        colio.dump(str(p), cols)
        args[name] = p
    out = tmp_path / f"{tag}_out.tpqc"
    oracle(cmd, **args, **kw, out=out)
    return colio.load(str(out))


def _oracle_pipeline(oracle, tmp_path, dim, fact, value, tag):
    """The oracle's filter | join | aggregate, chained on files as
    tests/test_query.py chains it."""
    ff = _oracle(oracle, tmp_path, "filter", f"{tag}_f", {"in": fact},
                 col="key", op="lt", value=value)
    j = _oracle(oracle, tmp_path, "join", f"{tag}_j", {"left": dim, "right": ff},
                algo="hash")
    return _oracle(oracle, tmp_path, "aggregate", f"{tag}_a", {"in": j})


# --- filter and aggregate against the oracle (tests/test_ops_oracle.py) ---

@pytest.mark.parametrize("op,value", [("lt", 50), ("ge", 100), ("eq", 7), ("ne", 7)])
def test_filter_matches_oracle(oracle, tmp_path, op, value):
    t = datagen.gen_relation_np(2048, 200, payloads=2, seed=44)
    want = _oracle(oracle, tmp_path, "filter", f"filt_{op}", {"in": t},
                   col="key", op=op, value=value)
    out = filter_table(_t(t), "key", op, value)
    assert_tables_equal(canonicalize(out), want, f"filter_{op}")


@pytest.mark.parametrize(
    "rows,nkeys,kind", [(4096, 128, "uniform"), (4096, 1024, "zipf"), (1, 1, "uniform")])
def test_aggregate_matches_oracle(oracle, tmp_path, rows, nkeys, kind):
    t = datagen.gen_relation_np(rows, nkeys, payloads=2, seed=33, kind=kind)
    want = _oracle(oracle, tmp_path, "aggregate", f"agg_{rows}_{nkeys}", {"in": t})
    out = hash_aggregate(_t(t))
    assert_tables_equal(canonicalize(out), want, f"agg_{rows}_{nkeys}_{kind}")


def test_aggregate_edge_keys(oracle, tmp_path):
    """A real INT64_MAX group next to the padding (whose sort keys are
    INT64_MAX) stays its own group."""
    t = {"key": np.array([IX, IX, 3, 3, 3], dtype=np.int64),
         "p0": np.array([1, 2, 3, 4, 5], dtype=np.int64)}
    out = hash_aggregate(_t(t))
    want = _oracle(oracle, tmp_path, "aggregate", "agg_edge", {"in": t})
    assert_tables_equal(canonicalize(out), want, "agg_edge")
    assert canonicalize(out)["count"].tolist() == [3, 2]


def test_aggregate_two_row_sum_wraps(oracle, tmp_path):
    """Payloads are non-negative 63-bit values, so two of them overflow:
    the sum wraps in int64, as the oracle's does."""
    big = (1 << 62) + 12345
    t = {"key": np.array([5, 9, 5, IM], dtype=np.int64),
         "p0": np.array([big, 1, big, IX], dtype=np.int64),
         "p1": np.array([IX, 0, IX, IX], dtype=np.int64)}
    out = hash_aggregate(_t(t))
    got = canonicalize(out)
    assert got["key"].tolist() == [IM, 5, 9]
    assert got["sum_p0"].tolist() == [IX, 2 * big - (1 << 64), 1]
    assert got["sum_p1"].tolist() == [IX, -2, 0]
    want = _oracle(oracle, tmp_path, "aggregate", "agg_wrap", {"in": t})
    assert_tables_equal(got, want, "agg_wrap")


def test_aggregate_output_contract():
    """Capacity = the input's, num_rows = the groups, columns key, count
    (int64), sum_<name> in input order; groups in ascending key order;
    two runs give the same bytes."""
    t = datagen.gen_relation_np(3000, 64, payloads=2, seed=3)
    t["key"] = t["key"].astype(np.int32)
    a, b = hash_aggregate(_t(t)), hash_aggregate(_t(t))
    assert a.capacity == 4096 and int(a.num_rows) == 64
    assert list(a.names) == ["key", "count", "sum_p0", "sum_p1"]
    assert [c.dtype for c in a.columns.values()] == [torch.int32] + [torch.int64] * 3
    live = _live(a)
    assert np.array_equal(live["key"], np.arange(64, dtype=np.int32))
    for k in a.columns:
        assert torch.equal(a.columns[k], b.columns[k]), k


# --- the pipeline against the chained oracle (tests/test_query.py) -------

@pytest.mark.parametrize("algo,impl", [("hash", "sorted"), ("hash", "lane"),
                                       ("merge", "sorted")])
def test_pipeline_matches_chained_oracle(oracle, tmp_path, algo, impl):
    dim = datagen.gen_relation_np(1024, 1024, payloads=1, seed=1)
    fact = datagen.gen_relation_np(8192, 1024, payloads=2, seed=2)
    want = _oracle_pipeline(oracle, tmp_path, dim, fact, 512, f"{algo}_{impl}")
    out = full_pipeline(_t(dim), _t(fact), "key", "lt", 512, out_capacity=1 << 14,
                        algo=algo, join_impl=impl)
    assert_tables_equal(canonicalize(out), want, f"pipeline_{algo}_{impl}")


def test_lane_pushdown_equals_filter_then_join():
    """probe_keep pushed into the lane probe layout == the filtered
    relation joined (the config-4 fusion); the lane path is taken."""
    dim = _t(datagen.gen_relation_np(512, 512, payloads=1, seed=5))
    fact = _t(datagen.gen_relation_np(4096, 512, payloads=2, seed=6))
    keep = fact.col("key") < 300
    assert bool(lane2_path_taken(dim, fact, 1 << 13, probe_keep=keep))
    fused = lane2_hash_join(dim, fact, 1 << 13, probe_keep=keep)
    staged = lane2_hash_join(dim, filter_table(fact, "key", "lt", 300), 1 << 13)
    assert int(fused.num_rows) == int(staged.num_rows) > 0
    assert_tables_equal(canonicalize(fused), canonicalize(staged), "lane_pushdown")


def test_lane_pushdown_fallback_filters():
    """A pushed-down filter that overflows the lane plan (one key in every
    fact row past a partition's probe capacity) falls back to the union
    engine on the compacted relation: rows equal the sorted impl's."""
    dim = _t({"key": np.arange(64, dtype=np.int64), "p0": np.arange(64, dtype=np.int64)})
    fact = _t({"key": np.full(4096, 3, np.int64), "p0": np.arange(4096, dtype=np.int64)})
    keep = fact.col("p0") % 3 != 0
    assert not bool(lane2_path_taken(dim, fact, 1 << 13, probe_keep=keep))
    a = hash_join(dim, fact, 1 << 13, impl="lane", probe_keep=keep)
    b = hash_join(dim, fact, 1 << 13, impl="sorted", probe_keep=keep)
    assert int(a.num_rows) == int(b.num_rows) == int(keep.sum())
    assert_tables_equal(canonicalize(a), canonicalize(b), "pushdown_fallback")


def test_pipeline_lane_impl_matches_sorted():
    """The lane pipeline (pushdown) == the sorted pipeline (compaction
    first): query.py's fusion decision."""
    dim = _t(datagen.gen_relation_np(512, 512, payloads=1, seed=7))
    fact = _t(datagen.gen_relation_np(4096, 512, payloads=2, seed=8))
    a = full_pipeline(dim, fact, "key", "lt", 200, out_capacity=1 << 13,
                      algo="hash", join_impl="lane")
    b = full_pipeline(dim, fact, "key", "lt", 200, out_capacity=1 << 13,
                      algo="hash", join_impl="sorted")
    assert int(a.num_rows) > 0
    assert_tables_equal(canonicalize(a), canonicalize(b), "pipeline_lane")


def test_jit_pipeline_two_filter_values(oracle, tmp_path):
    """One jit_pipeline callable serves two filter values (tpq's one
    compiled program; the port's jit, which on CPU tensors runs the
    body), each equal to the chained oracle."""
    dim = datagen.gen_relation_np(512, 512, payloads=1, seed=3)
    fact = datagen.gen_relation_np(2048, 512, payloads=1, seed=4)
    pipe = jit_pipeline(1 << 12, join_impl="lane")
    outs = [pipe(_t(dim), _t(fact), v) for v in (100, 400)]
    assert int(outs[1].num_rows) > int(outs[0].num_rows) > 0
    for v, out in zip((100, 400), outs):
        want = _oracle_pipeline(oracle, tmp_path, dim, fact, v, f"jit{v}")
        assert_tables_equal(canonicalize(out), want, f"jit_{v}")


def test_pipeline_determinism_two_runs():
    dim = _t(datagen.gen_relation_np(1024, 700, payloads=1, seed=1))
    fact = _t(datagen.gen_relation_np(4096, 700, payloads=2, seed=2))
    a, b = (full_pipeline(dim, fact, "key", "lt", 600, 1 << 13, join_impl="lane")
            for _ in range(2))
    assert int(a.num_rows) == int(b.num_rows) > 0
    for k in a.columns:
        assert torch.equal(a.columns[k], b.columns[k]), k


def test_runner_pipeline_preset(oracle, tmp_path):
    """The runner's pipeline branch at smoke_pipeline: op "pipeline", the
    lane pushdown path taken, groups equal to the chained oracle, no time
    off the card; the profile's join_fn gives the same pipeline."""
    import argparse

    p = argparse.ArgumentParser()
    add_join_args(p)
    cfg = config_from_args(p.parse_args(["--config=smoke_pipeline"]))
    rep = run_config(cfg, device="cpu")
    op = rep["ops"][0]
    assert op["op"] == "pipeline" and op["elapsed_ms"] is None
    assert op["rows"] == cfg.s.rows
    dim = datagen.gen_relation_np(cfg.r.rows, cfg.r.nkeys, cfg.r.payloads, cfg.r.seed)
    fact = datagen.gen_relation_np(cfg.s.rows, cfg.s.nkeys, cfg.s.payloads, cfg.s.seed)
    want = _oracle_pipeline(oracle, tmp_path, dim, fact, cfg.filter_value, "runner")
    assert rep["out_rows"] == len(want["key"])
    assert_tables_equal(canonicalize(rep["output"]), want, "runner_pipeline")
    again = join_fn(cfg, _t(dim), _t(fact), rep["out_capacity"])()
    assert_tables_equal(canonicalize(again), want, "join_fn_pipeline")


# --- renegotiation (tests/test_renegotiate.py) ---------------------------

def test_renegotiate_wrapper_semantics_no_compile():
    """A stub operator that reports a true size of 100: one retry at
    next_pow2(max(16, 100))."""
    calls = []

    def make(cap):
        calls.append(cap)
        return lambda a, b: Table({"key": torch.zeros(max(cap, 8), dtype=torch.int64)}, 100)

    t = _t({"key": np.zeros(4, np.int64)})
    out = run_renegotiated(make, (t, t), out_capacity=8)
    assert int(out.num_rows) == 100
    assert calls == [8, 128], calls


def test_renegotiate_grows_to_fit(oracle, tmp_path):
    """64 x 32 all-equal keys -> 2,048 rows from capacity 64: the join is
    run again at a capacity that holds them, oracle-exact."""
    r = {"key": np.zeros(64, dtype=np.int64), "p0": np.arange(64, dtype=np.int64)}
    s = {"key": np.zeros(32, dtype=np.int64), "p0": np.arange(32, dtype=np.int64)}
    want = _oracle(oracle, tmp_path, "join", "reneg", {"left": r, "right": s},
                   algo="hash")
    calls = []

    def make(cap):
        calls.append(cap)
        return lambda a, b: hash_join(a, b, cap)

    out = run_renegotiated(make, (_t(r), _t(s)), out_capacity=64)
    assert int(out.num_rows) == 2048
    assert len(calls) >= 2 and calls[-1] >= 2048, calls
    assert_tables_equal(canonicalize(out), want, "renegotiated")


def test_renegotiate_no_retry_when_fits():
    r = datagen.gen_relation_np(500, 400, payloads=1, seed=3)
    s = datagen.gen_relation_np(700, 400, payloads=1, seed=4)
    calls = []

    def make(cap):
        calls.append(cap)
        return lambda a, b: hash_join(a, b, cap)

    out = run_renegotiated(make, (_t(r), _t(s)), out_capacity=1 << 13)
    assert len(calls) == 1
    assert 0 < int(out.num_rows) <= 1 << 13


def test_renegotiate_gives_up():
    """An operator that never fits raises after max_retries + 1 tries."""
    calls = []

    def make(cap):
        calls.append(cap)
        return lambda: Table({"key": torch.zeros(cap, dtype=torch.int64)}, 2 * cap + 1)

    with pytest.raises(RuntimeError, match="2 retries"):
        run_renegotiated(make, (), out_capacity=8, max_retries=2)
    assert len(calls) == 3


# --- against tpq ----------------------------------------------------------

def _agg_input():
    """tests/test_ops_oracle.py's 4096 x 128 aggregate case with an
    INT64_MAX and an INT64_MIN group added."""
    t = datagen.gen_relation_np(4096, 128, payloads=2, seed=33)
    t["key"][:3] = IX
    t["key"][-2:] = IM
    return t


@pytest.fixture(scope="module")
def tpq_runs():
    """tpq's hash_aggregate on _agg_input() (its live rows, and its whole
    columns with num_rows) and its entry step (the sorted full_pipeline
    at __graft_entry__.entry's shapes), jitted, once each."""
    import jax

    from tpq import Table as JTable
    from tpq.ops import hash_aggregate as jhash_aggregate

    from __graft_entry__ import entry as jentry

    agg = jax.jit(jhash_aggregate)(JTable.from_numpy(_agg_input()))
    fn, args = jentry()
    pipe = jax.jit(fn)(*args)
    dim, fact, value = args
    return {"agg": _live(agg), "entry": _live(pipe),
            "agg_whole": ({k: np.asarray(v) for k, v in agg.columns.items()},
                          int(agg.num_rows)),
            "dim": _live(dim), "fact": _live(fact), "value": value}


def test_aggregate_equals_tpq(tpq_runs):
    got = _live(hash_aggregate(_t(_agg_input())))
    want = tpq_runs["agg"]
    assert list(got) == list(want)
    assert len(got["key"]) == 130
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def test_aggregate_equals_tpq_over_the_whole_capacity(tpq_runs):
    """Every output byte of the capacity equal to tpq's, the rows past the
    groups included (tpq's PACK zeroes them), dtypes and num_rows too."""
    out = hash_aggregate(_t(_agg_input()))
    want, groups = tpq_runs["agg_whole"]
    assert int(out.num_rows) == groups == 130
    assert list(out.names) == list(want)
    for k, v in want.items():
        got = out.col(k).numpy()
        assert got.dtype == v.dtype and np.array_equal(got, v), k
        assert not got[groups:].any(), k


def test_sorted_pipeline_equals_tpq(tpq_runs):
    """The port's sorted full_pipeline on tpq's entry relations: row for
    row tpq's output."""
    r = tpq_runs
    out = full_pipeline(_t(r["dim"]), _t(r["fact"]), "key", "lt", r["value"],
                        out_capacity=1 << 12, algo="hash", join_impl="sorted")
    got = _live(out)
    assert list(got) == list(r["entry"]) == ["key", "count", "sum_r_p0", "sum_s_p0",
                                             "sum_s_p1"]
    for k in got:
        assert np.array_equal(got[k], r["entry"][k]), k


def test_entry_equals_tpq(tpq_runs):
    """entry(device="cpu") at __graft_entry__.entry's shapes and default
    sorted join: its relations are tpq's, its output tpq's row for row."""
    fn, (dim, fact, value) = entry(device="cpu")
    assert value == tpq_runs["value"] and dim.device.type == "cpu"
    for mine, theirs in ((dim, tpq_runs["dim"]), (fact, tpq_runs["fact"])):
        got = _live(mine)
        assert all(np.array_equal(got[k], theirs[k]) for k in theirs)
    got = _live(fn(dim, fact, value))
    assert len(got["key"]) > 0
    for k in tpq_runs["entry"]:
        assert np.array_equal(got[k], tpq_runs["entry"][k]), k


def test_filter_keep_mask_takes_the_column_dtype():
    """The comparison value takes the column's dtype (tpq's
    jnp.asarray(value, c.dtype)) and device."""
    t = _t({"key": np.array([-5, 0, 5], dtype=np.int32)})
    assert keep_mask(t, "key", "lt", 1)[:3].tolist() == [True, True, False]
    assert keep_mask(t, "key", "ge", 0)[:3].tolist() == [False, True, True]
    assert keep_mask(t, "key", "ge", 0).dtype == torch.bool
