"""A cell's whole run at a tiny size on the CPU, through the port's CPU
twins (jit is the body itself there, the kernels their plain versions):
the comparison passes on the program, and fails on a corrupted result,
on the control (the reference in int32 in the program's place) and on
the faults a cell can have: an answer altered where it is produced,
half of the probe side left out. Only the look for a card is skipped."""

from __future__ import annotations

import time

import pytest
import torch

from tiny_cells import CELLS, SEED, tiny
from benchmark.harness import cell as harness, spec


def run(cell, control=False, trace=False, seconds=0.3):
    return harness.run(cell, SEED, seconds, trace, "cpu", time.perf_counter(),
                       control=control)


@pytest.mark.parametrize("workload", CELLS)
def test_program_is_correct(workload):
    cell = tiny(workload)
    result, info = run(cell)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"probe_rows_per_s", "query_p95_ms", "setup_s"} or \
        result["attempted"] < 2
    assert info["path"].get("taken", True)
    assert info["counters"] == {"reruns": 0, "copies": 0, "captures": 0}
    assert len(info["compared"]) >= 1


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_is_correct(workload):
    result, info = run(tiny(workload), trace=True)
    assert result["correct"], result["checks"]
    assert info["compared"] == [result["attempted"] - 1]
    assert result["metrics"] == {}  # no device work on the CPU: nothing to read
    assert "busy_s" in result["device"] and "breakdown" in result


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    result, _ = run(tiny(workload), control=True)
    assert not result["correct"]
    assert result["checks"]["rows_wrong"]["value"] > 0


def _patched_query(monkeypatch, workload, fault):
    """Breaks the program where its answer is made: the join's result, or
    the aggregate's run-end pass; or leaves half of the probe side out."""
    import importlib

    import tpq_torch.ops as ops
    import tpq_torch.query as query
    from tpq_torch.columnar import Table

    def halved(t):
        return Table(t.columns, t.num_rows // 2)

    if workload.startswith("join"):
        real = ops.hash_join
        if fault == "half":
            monkeypatch.setattr(ops, "hash_join",
                                lambda r, s, *a, **k: real(r, halved(s), *a, **k))
        else:
            def altered(r, s, *a, **k):
                out = real(r, s, *a, **k)
                out.columns["s_p0"][0] += 1
                return out
            monkeypatch.setattr(ops, "hash_join", altered)
    else:
        if fault == "half":
            real = query.full_pipeline
            monkeypatch.setattr(query, "full_pipeline",
                                lambda dim, fact, *a, **k: real(dim, halved(fact), *a, **k))
        else:
            agg = importlib.import_module("tpq_torch.ops.hash_aggregate")
            real = agg.aggregate_runs

            def altered(key, values, num_rows):
                cols, groups = real(key, values, num_rows)
                cols[2][0] += 1  # the first group's first sum
                return cols, groups
            monkeypatch.setattr(agg, "aggregate_runs", altered)


@pytest.mark.parametrize("fault", ["altered", "half"])
@pytest.mark.parametrize("workload", CELLS)
def test_faults_are_not_correct(monkeypatch, workload, fault):
    _patched_query(monkeypatch, workload, fault)
    result, _ = run(tiny(workload))
    assert not result["correct"]
    assert result["failed"] >= 1
    if fault == "half" and workload.startswith("join"):
        assert result["checks"]["count_wrong"]["value"] == result["attempted"]


def test_corrupted_result_is_not_correct(monkeypatch):
    from benchmark.queries import join

    real = join.prepare

    def prepare(*a, **k):
        prepared = real(*a, **k)
        call = prepared.call

        def corrupt():
            out = call()
            out.columns["r_p0"][3] ^= 1
            return out
        prepared.call = corrupt
        return prepared

    monkeypatch.setattr(join, "prepare", prepare)
    result, _ = run(tiny("join_1m.uniform"))
    assert not result["correct"]
    assert result["checks"]["rows_wrong"]["value"] >= 1


def test_pipeline_zeros_past_the_groups_are_compared(monkeypatch):
    from benchmark.queries import pipeline

    real = pipeline.prepare

    def prepare(*a, **k):
        prepared = real(*a, **k)
        call = prepared.call

        def stray():
            out = call()
            out.columns["count"][-1] = 1
            return out
        prepared.call = stray
        return prepared

    monkeypatch.setattr(pipeline, "prepare", prepare)
    result, _ = run(tiny("pipeline_100m.filter_half"))
    assert not result["correct"]
    assert result["checks"]["nonzero_past_rows"]["value"] == 1


def test_same_seed_same_inputs():
    cell = tiny("join_1m.zipf_theta1")
    a = harness.make_inputs(cell, SEED, "cpu")
    b = harness.make_inputs(cell, SEED, "cpu")
    c = harness.make_inputs(cell, SEED + 1, "cpu")
    for side in a:
        for n in a[side].columns:
            assert torch.equal(a[side].columns[n], b[side].columns[n])
    assert not torch.equal(a["probe"].columns["p0"], c["probe"].columns["p0"])


def test_traffic_key_seed_replaces_the_configurations():
    plain, fallback = tiny("join_1m.uniform"), tiny("join_1m.uniform_fallback")
    a = harness.make_inputs(plain, SEED, "cpu")
    b = harness.make_inputs(fallback, SEED, "cpu")
    assert not torch.equal(a["build"].columns["key"], b["build"].columns["key"])
    assert torch.equal(a["probe"].columns["key"], b["probe"].columns["key"])


@pytest.mark.parametrize("workload,taken", [("join_1m.uniform", True),
                                            ("join_1m.uniform_fallback", False)])
def test_lane_path_at_the_cells_size(workload, taken):
    """At the cell's own size the program's lane join takes its path on
    the preset draw and falls back to the union sort on the other."""
    from tpq_torch.columnar import Table
    from tpq_torch.kernels.lane2 import lane2_path_taken

    cell = spec.resolve(spec.load_benchmark(), workload)
    inputs = harness.make_inputs(cell, SEED, "cpu")
    r, s = (Table(inputs[k].columns, inputs[k].rows) for k in ("build", "probe"))
    assert bool(lane2_path_taken(r, s, spec.out_capacity(cell.config))) is taken


@pytest.mark.cuda
def test_cells_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for workload in CELLS:
        cell = tiny(workload)
        result, _ = harness.run(cell, SEED, 0.5, False, "cuda", time.perf_counter())
        assert result["correct"], (workload, result["checks"])
        result, _ = harness.run(cell, SEED, 0.5, True, "cuda", time.perf_counter())
        assert result["correct"] and result["metrics"], (workload, result)
        control, _ = harness.run(cell, SEED, 0.5, False, "cuda", time.perf_counter(),
                                 control=True)
        assert not control["correct"]


@pytest.mark.parametrize("workload", ["join_1m.uniform", "join_1m.zipf_theta1"])
def test_overflow_is_reported_not_truncated(workload):
    cell = tiny(workload)
    cell.config["out_capacity_factor"] = 0.5  # fewer output rows than the join has
    result, info = run(cell)
    assert info["expected_rows"] > info["capacity"]
    assert result["correct"], result["checks"]
    assert "rows_wrong" not in result["checks"]  # past the capacity only the count
