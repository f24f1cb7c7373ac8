"""The distributed join's cell (dist_125m_8shard.uniform_planned) at a
tiny size on the CPU, through the harness's whole run and the port's CPU
twins: the comparison passes on the program and fails on a result with
one shard's last row dropped and on the control; the sharded result's
columns are each column's live rows over the shards; the cell's three
per-layer readers read the records a traced window leaves."""

from __future__ import annotations

import collections
import importlib
import time

import pytest
import torch

from tiny_cells import SEED
from benchmark.harness import cell as harness, spec
from benchmark.queries import dist_join

WORKLOAD = "dist_125m_8shard.uniform_planned"
ROWS = 8 << 10


def tiny() -> spec.Cell:
    """The cell at 8 x 2^10 rows a side; the harness's capacity twice the
    rows (the real cell's 2^27 holds its about 1.25e8 rows; at this size
    a draw may give a few more rows than 2^13)."""
    cell = spec.resolve(spec.load_benchmark(), WORKLOAD)
    for side in ("build", "probe"):
        cell.config[side].update(rows=ROWS, nkeys=ROWS)
    cell.config["out_capacity_factor"] = 2.0
    return cell


def run(cell, control=False, trace=False, seconds=0.3):
    return harness.run(cell, SEED, seconds, trace, "cpu", time.perf_counter(),
                       control=control)


def test_program_is_correct():
    result, info = run(tiny())
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["checks"]) == {"count_wrong", "rows_wrong"}
    assert set(result["metrics"]) <= {"probe_rows_per_s", "query_p95_ms",
                                      "peak_alloc_GiB", "setup_s"}
    assert {"probe_rows_per_s", "setup_s"} <= set(result["metrics"])
    path = info["path"]
    assert path["overflow"] == [0] * 8 and path["shards"] == 8
    assert len(path["programs"]) == 1  # one static set: one jitted body
    c = info["counters"]
    assert (c["reruns"], c["copies"], c["captures"]) == (0, 0, 0)
    assert c["plan_host_reads"] == 2 * result["attempted"]


def test_traced_run_is_correct():
    result, info = run(tiny(), trace=True)
    assert result["correct"], result["checks"]
    assert info["compared"] == [result["attempted"] - 1]
    assert result["metrics"] == {}  # no graph replays on the CPU: nothing to read


def test_control_is_not_correct():
    result, _ = run(tiny(), control=True)
    assert not result["correct"]
    assert result["checks"]["count_wrong"]["value"] == 0
    assert result["checks"]["rows_wrong"]["value"] > 0


def test_dropped_row_is_not_correct(monkeypatch):
    """One shard's last live row dropped from the program's result."""
    import tpq_torch.dist as dist
    from tpq_torch.columnar import Table

    real = dist.dist_hash_join_planned

    def dropped(*a, **k):
        out, ovf = real(*a, **k)
        t = out.shards[2]
        out.shards[2] = Table(t.columns, (t.num_rows - 1).clamp_min(0))
        return out, ovf
    monkeypatch.setattr(dist, "dist_hash_join_planned", dropped)
    result, _ = run(tiny())
    assert not result["correct"]
    assert result["failed"] == result["attempted"]
    assert result["checks"]["count_wrong"]["value"] == result["attempted"]


def test_lazy_columns_are_the_shards_live_rows():
    from tpq_torch.columnar import Table

    g = torch.Generator().manual_seed(4)
    rows = [5, 0, 16, 1]
    shards = [Table({"key": torch.randint(-9, 9, (16,), generator=g),
                     "s_p0": torch.randint(-9, 9, (16,), generator=g)}, n) for n in rows]
    cols = dist_join.LiveColumns(shards)
    assert list(cols) == ["key", "s_p0"] and len(cols) == 2
    for name in cols:
        want = torch.cat([t.columns[name][:n] for t, n in zip(shards, rows)])
        assert torch.equal(cols[name], want) and cols[name].shape[0] == sum(rows)


def _records(observed, spans, plan):
    return [{"rerun": False, "host_ms": {}, "device_ms": 400.0, "spans": sp,
             "conds": [], "observed": ob, **({"plan": pl} if pl else {})}
            for ob, sp, pl in zip(observed, spans, plan)]


def _span(name, ms):
    return {"name": name, "ms": ms, "discarded": False}


SPANS = [[_span("tpq.dist.route", 1.0), _span("tpq.dist.exchange", 20.0),
          _span("tpq.lane.build", 9.0), _span("tpq.dist.exchange", 30.0)],
         [_span("tpq.dist.exchange", 22.0), _span("tpq.dist.exchange", 28.0)]]
OBSERVED = [{"tpq.dist.exchange_rows": 470, "tpq.dist.exchange_slots": 1000},
            {"tpq.dist.exchange_rows": 480, "tpq.dist.exchange_slots": 1000}]
PLANS = [{"ms": 170.0, "host_reads": 2}, {"ms": 180.0, "host_reads": 2}]


@pytest.mark.parametrize("metric,want", [
    ("plan_ms", 175.0),
    ("exchange_ms", 50.0),
    ("exchange_fill", 0.475),
])
def test_metric_reads_the_window_records(monkeypatch, metric, want):
    from tpq_torch import trace

    read = importlib.import_module(f"benchmark.metrics.{metric}").read
    ring = collections.deque(maxlen=trace.RING)
    monkeypatch.setattr(trace, "_RECORDS", ring)
    assert read({"trace": True, "queries": 2}) is None        # no records
    ring.extend(_records([{}] * 2, [[_span("tpq.lane.layout", 3.0)]] * 2,
                         [None] * 2))
    assert read({"trace": True, "queries": 2}) is None        # a program without them
    ring.extend(_records(OBSERVED, SPANS, PLANS))
    assert read({"trace": True, "queries": 2}) == pytest.approx(want)
    assert read({"trace": False, "queries": 2}) is None       # an untraced run
    assert read({"trace": True, "queries": 8}) is None        # fewer records
