"""tpq_torch's bench reporting, trace capture, weak scaling,
overlap matrix and the runner's options, on the CPU.

The report's markdown is held byte-equal to tpq's, the op log's file to
tpq's records. The weak-scaling and overlap benches run at smoke size on
one-process meshes; their counts are held to numpy's join count, which
no tpq join computes (tpq's own benches need its distributed join).
Integer data: every comparison is exact."""

import collections
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tpq.bench import report as jreport
from tpq_torch import datagen
from tpq_torch.bench import runner
from tpq_torch.bench.overlap_bench import run_overlap_matrix
from tpq_torch.bench.report import emit_json, markdown_table
from tpq_torch.bench.scaling import device_placed, run_weak_scaling
from tpq_torch.config import PRESETS
from tpq_torch.dist import DistTable, make_mesh, multihost
from tpq_torch.trace import span, trace_if

torch.set_num_threads(2)

# the keys of tpq's records (tpq/bench/scaling.py:66-74,
# tpq/bench/overlap_bench.py:71-75)
SCALING_KEYS = {"n_chips", "rows_total", "elapsed_ms", "rows_per_sec_per_chip",
                "efficiency", "exchange_impl", "n_chunks"}
OVERLAP_KEYS = {"variant", "n_chips", "rows_total", "elapsed_ms", "vs_dense_1chunk"}


def _join_count(rows, nkeys, seed_r, seed_s) -> int:
    r = collections.Counter(datagen.uniform_keys(rows, nkeys, seed_r).tolist())
    s = collections.Counter(datagen.uniform_keys(rows, nkeys, seed_s).tolist())
    return sum(c * s[k] for k, c in r.items())


@pytest.mark.parametrize("rows,columns", [
    ([{"op": "join", "ms": 1.0, "rows": 7}, {"op": "agg", "ms": 2.345, "rows": 9}], None),
    ([{"a": 1.005, "b": "x"}, {"b": "y"}], ["a", "b", "c"]),   # missing cells
    ([{"n": 3, "f": float("nan"), "g": None, "big": 1e20}], None),
    ([], None),
])
def test_markdown_table_matches_tpq(rows, columns):
    got = markdown_table(rows, columns)
    assert got == jreport.markdown_table(rows, columns)
    assert got.encode() == jreport.markdown_table(rows, columns).encode()


def test_emit_json_matches_tpq(tmp_path):
    payload = {"ops": [{"op": "join", "ms": 1.5}], "path": tmp_path}  # path: default=str
    emit_json(str(tmp_path / "a.json"), payload)
    jreport.emit_json(str(tmp_path / "b.json"), payload)
    assert (tmp_path / "a.json").read_bytes() == (tmp_path / "b.json").read_bytes()


def test_trace_if_writes_a_trace(tmp_path):
    with trace_if(None), span("tpq.nothing"):
        torch.ones(4).sum()
    out = tmp_path / "trace"
    with trace_if(str(out)), span("tpq.join_hash"):
        torch.arange(1000).sort()
    (f,) = out.iterdir()
    names = {e.get("name") for e in json.loads(f.read_text())["traceEvents"]}
    assert "tpq.join_hash" in names


def test_weak_scaling_counts_exact():
    rows = run_weak_scaling(rows_per_chip=2**10, mesh_sizes=(1, 2, 4), device="cpu")
    assert [r["n_chips"] for r in rows] == [1, 2, 4]
    for r in rows:
        assert SCALING_KEYS <= set(r)
        assert (r["mesh"], r["cards"], r["device"]) == ("local", 0, "cpu")
        assert r["rows_total"] == 2**10 * r["n_chips"]
        assert r["num_rows"] == _join_count(r["rows_total"], r["rows_total"], 77, 78)
        assert r["elapsed_ms"] is None and r["efficiency"] is None  # not measured


def test_weak_scaling_on_a_process_group_runs_its_own_size(tmp_path):
    """A one-rank gloo group: of the sizes asked, only the group's own
    runs, one shard per rank."""
    store = dist.FileStore(str(tmp_path / "store"), 1)
    assert multihost.init(num_processes=1, process_id=0, device="cpu", store=store)
    try:
        rows = run_weak_scaling(rows_per_chip=2**9, mesh_sizes=(1, 2), device="cpu",
                                process_group=True)
    finally:
        dist.destroy_process_group()
    (r,) = rows
    assert (r["n_chips"], r["mesh"], r["cards"]) == (1, "process_group", 0)
    assert r["num_rows"] == _join_count(2**9, 2**9, 77, 78)


def test_device_streams_place_like_from_numpy():
    """The shards the card makes by the device streams hold the live rows
    tpq's placement of the numpy streams does (rows not a multiple of the
    mesh: a short last shard)."""
    mesh = make_mesh(3, "cpu")
    got = device_placed(1000, 1000, 2, 5, mesh)
    want = DistTable.from_numpy(datagen.gen_relation_np(1000, 1000, 2, 5), mesh)
    assert got.local_capacity == want.local_capacity
    for a, b in zip(got.shards_numpy(), want.shards_numpy()):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_overlap_matrix_counts_equal(tmp_path):
    rows = run_overlap_matrix(make_mesh(4, "cpu"), rows_per_shard=2**10,
                              trace_dir=str(tmp_path / "t"))
    assert [r["variant"] for r in rows] == ["dense_1chunk", "dense_4chunks", "ring_hops"]
    want = _join_count(4 * 2**10, 4 * 2**10, 71, 72)
    for r in rows:
        assert OVERLAP_KEYS <= set(r)
        assert (r["mesh"], r["n_chips"], r["rows_total"]) == ("local", 4, 2 * 4 * 2**10)
        assert r["num_rows"] == want
        assert r["elapsed_ms"] is None  # not measured on the CPU
    assert not (tmp_path / "t").exists()  # the ring is traced only where timed


@pytest.mark.parametrize("now,status", [(100.0, "OK"), (80.0, "OK"), (74.0, "REGRESSED")])
def test_check_regression(now, status):
    base = {"ops": [{"op": "join_hash_lane", "rows_per_sec": 100.0},
                    {"op": "join_merge_lax", "rows_per_sec": 1.0}]}
    report = {"ops": [{"op": "join_hash_lane", "rows_per_sec": now},
                      {"op": "pipeline", "rows_per_sec": 1.0}]}  # not in the baseline
    lines, failed = runner.check_regression(report, base, 0.25)
    assert len(lines) == 1 and lines[0].endswith(status)
    assert failed == ([] if status == "OK" else ["join_hash_lane"])


def test_runner_cli_scaling_and_log(tmp_path, capsys):
    """--scaling prints its table to stderr and its one-line JSON last on
    stdout; a join run's trace goes to --trace-dir; --check refuses a
    run without times."""
    rep = runner.main(["--scaling", "1,2", "--rows-per-chip", "512", "--device", "cpu"])
    out, err = capsys.readouterr()
    last = json.loads(out.strip().splitlines()[-1])
    assert last["metric"] == runner.SCALING_METRIC and last["value"] is None
    assert [r["n_chips"] for r in last["scaling"]] == [1, 2] == \
        [r["n_chips"] for r in rep["scaling"]]
    assert "| n_chips |" in err

    trace = tmp_path / "trace"
    base = tmp_path / "base.json"
    base.write_text(json.dumps({"ops": [{"op": "join_hash_lane", "rows_per_sec": 1.0}]}))
    args = ["--config", "smoke_1k", "--device", "cpu", "--trace-dir", str(trace)]
    rep = runner.main(args)
    out, _ = capsys.readouterr()
    last = json.loads(out.strip().splitlines()[-1])
    assert last["metric"] == runner.METRIC and last["value"] is None
    assert (rep["config"], [op["op"] for op in rep["ops"]]) == ("smoke_1k", ["join_hash_lane"])
    (f,) = trace.iterdir()
    assert "tpq.join_hash" in {e.get("name") for e in json.loads(f.read_text())["traceEvents"]}
    assert PRESETS["smoke_1k"].join.impl == "lane"
    with pytest.raises(ValueError, match="no rows/s measured"):
        runner.main(args + ["--check", str(base)])
