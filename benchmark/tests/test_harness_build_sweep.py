"""The cells build_sweep_10m_100m.uniform (config 2) and
join_1m.merge_radix at a tiny size on the CPU, through the harness's
whole run and the port's CPU twins: the comparison passes on the program
and fails on the control and on a result with two payload columns
swapped; the cells' three per-layer readers read the records and the
breakdown a traced window leaves, and nothing where there is nothing."""

from __future__ import annotations

import collections
import importlib
import time

import pytest

from tiny_cells import SEED
from benchmark.harness import cell as harness, kernel_bytes, spec

SWEEP = "build_sweep_10m_100m.uniform"
MERGE = "join_1m.merge_radix"
# the payload columns a planted fault swaps: R's first and second in the
# sweep (four payloads a side), R's and S's one in the merge
SWAPPED = {SWEEP: ("r_p0", "r_p1"), MERGE: ("r_p0", "s_p0")}


def tiny(workload: str) -> spec.Cell:
    """The sweep at 10^3 x 10^4 rows over 10^3 keys (config 2's ratios,
    four payloads a side); the merge at 2^12 rows a side."""
    cell = spec.resolve(spec.load_benchmark(), workload)
    if workload == SWEEP:
        cell.config["build"].update(rows=1000, nkeys=1000)
        cell.config["probe"].update(rows=10_000, nkeys=1000)
    else:
        for side in ("build", "probe"):
            cell.config[side].update(rows=1 << 12, nkeys=1 << 12)
    return cell


def run(cell, control=False, trace=False, seconds=0.3):
    return harness.run(cell, SEED, seconds, trace, "cpu", time.perf_counter(),
                       control=control)


@pytest.mark.parametrize("workload", [SWEEP, MERGE])
def test_program_is_correct(workload):
    result, info = run(tiny(workload))
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["checks"]) == {"count_wrong", "rows_wrong"}
    assert {"probe_rows_per_s", "setup_s"} <= set(result["metrics"])
    assert info["path"]["taken"]
    assert info["counters"] == {"reruns": 0, "copies": 0, "captures": 0}
    assert info["expected_rows"] <= info["capacity"]


@pytest.mark.parametrize("workload", [SWEEP, MERGE])
def test_traced_run_is_correct(workload):
    result, info = run(tiny(workload), trace=True)
    assert result["correct"], result["checks"]
    assert info["compared"] == [result["attempted"] - 1]
    assert result["metrics"] == {}  # no graph replays on the CPU: nothing to read


@pytest.mark.parametrize("workload", [SWEEP, MERGE])
def test_control_is_not_correct(workload):
    result, _ = run(tiny(workload), control=True)
    assert not result["correct"]
    assert result["checks"]["rows_wrong"]["value"] > 0


@pytest.mark.parametrize("workload", [SWEEP, MERGE])
def test_swapped_payloads_are_not_correct(monkeypatch, workload):
    """Two payload columns of every result swapped where the join makes it."""
    import tpq_torch.ops as ops
    from tpq_torch.columnar import Table

    name = "hash_join" if workload == SWEEP else "merge_join"
    real = getattr(ops, name)
    a, b = SWAPPED[workload]

    def swapped(*args, **kwargs):
        out = real(*args, **kwargs)
        cols = dict(out.columns)
        cols[a], cols[b] = cols[b], cols[a]
        return Table(cols, out.num_rows)
    monkeypatch.setattr(ops, name, swapped)
    result, _ = run(tiny(workload))
    assert not result["correct"]
    assert result["checks"]["count_wrong"]["value"] == 0
    assert result["checks"]["rows_wrong"]["value"] > 0


def _record(observed):
    return {"rerun": False, "host_ms": {}, "device_ms": 90.0, "spans": [],
            "conds": [], "observed": observed}


LANE = {"tpq.lane.tail_rows": 442_767, "tpq.lane.tail_cap": 524_288,
        "tpq.lane.inline_rows": 99_577_150, "tpq.lane.probe_slots": 201_326_592,
        "tpq.lane.table_slots": 50_331_648, "tpq.lane.build_payloads": 4,
        "tpq.lane.probe_payloads": 4}
RADIX = {"tpq.radix.passes": 9, "tpq.radix.planes": 8, "tpq.radix.rows": 1 << 21}
PEAK = 3.35e12
EMIT_BYTES = 8 * (5 * 201_326_592 + 5 * 50_331_648 + 9 * 99_577_150)
SPLIT_BYTES = 9 * (1 << 21) * 8 * 4 * 2
OPS = [["_anonymous_namespace_::walk_emit_kernel_long_const___int_const__", 0.6],
       ["at::native::vectorized_elementwise_kernel", 0.9],
       ["_anonymous_namespace_::digit_scatter_kernel_Digit", 0.02],
       ["_anonymous_namespace_::digit_count_kernel_Digit", 0.004],
       ["_anonymous_namespace_::probe_walk_kernel", 0.3]]
QUERIES = 30


@pytest.mark.parametrize("metric,observed,want", [
    ("tail_fill", LANE, 442_767 / 524_288),
    ("emit_roofline_pct", LANE, 100 * (EMIT_BYTES / PEAK) / (0.6 / QUERIES)),
    ("split_roofline_pct", RADIX, 100 * (SPLIT_BYTES / PEAK) / (0.024 / QUERIES)),
])
def test_metric_reads_the_window(monkeypatch, metric, observed, want):
    from tpq_torch import trace

    read = importlib.import_module(f"benchmark.metrics.{metric}").read
    summary = {"trace": True, "queries": QUERIES, "hbm_peak": PEAK,
               "breakdown": {"device_ops": OPS, "idle_gaps": []}}
    ring = collections.deque(maxlen=trace.RING)
    monkeypatch.setattr(trace, "_RECORDS", ring)
    assert read(summary) is None                              # no records
    ring.extend(_record({}) for _ in range(QUERIES))
    assert read(summary) is None                              # a program without them
    ring.extend(_record(dict(observed)) for _ in range(QUERIES))
    assert read(summary) == pytest.approx(want)
    assert read({**summary, "trace": False}) is None          # an untraced run
    assert read({**summary, "queries": 4 * QUERIES}) is None  # fewer records
    if metric != "tail_fill":  # the kernel not among the trace's longest ops
        assert read({**summary, "breakdown": {"device_ops": OPS[1:2]}}) is None
        assert read({**summary, "hbm_peak": None}) is None    # a card not in the table


def test_device_ms_needs_the_first_kernel():
    summary = {"queries": 2, "breakdown": {"device_ops": OPS}}
    assert kernel_bytes.device_ms(summary, kernel_bytes.SPLIT) == pytest.approx(12.0)
    assert kernel_bytes.device_ms({**summary, "breakdown": {"device_ops": OPS[3:]}},
                                  kernel_bytes.SPLIT) is None


def test_merge_reference_is_the_join_reference():
    """The merge join's reference (sorted sides merged) and the hash
    join's give one multiset, duplicate keys on both sides included."""
    import torch

    from benchmark.harness.compare import canonical
    from benchmark.reference import join, merge_join

    g = torch.Generator().manual_seed(11)
    build = {"key": torch.randint(0, 300, (1000,), generator=g),
             "p0": torch.randint(-9, 9, (1000,), generator=g)}
    probe = {"key": torch.randint(0, 300, (700,), generator=g),
             "p0": torch.randint(-9, 9, (700,), generator=g),
             "p1": torch.randint(-9, 9, (700,), generator=g)}
    a, b = merge_join.merge(build, probe), join.join(build, probe)
    assert list(a) == list(b) and a["key"].shape[0] == b["key"].shape[0] > 2000
    a, b = canonical(a, list(a)), canonical(b, list(b))
    assert all(torch.equal(a[n], b[n]) for n in a)
