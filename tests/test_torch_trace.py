"""tpq_torch's spans, per-call records, named conds, observed counters and
the jit's stats (tpq_torch/trace.py, tpq_torch/jit.py), and the
benchmark's readers of those records. No tpq call; small shapes.

On the CPU jit(fn) is fn: a jitted call runs its body eagerly, so its
record holds host ms, named conds and observed values but no device ms;
the cuda-marked cases replay graphs and time their operator spans."""

from __future__ import annotations

import collections
import contextlib
import functools
import importlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpq_torch import datagen, trace
from tpq_torch.columnar import Table
from tpq_torch.jit import _Trace, _traced, cond, jit
from tpq_torch.ops import hash_join
from tpq_torch.ops.skew_join import nominate_heavy_keys
from tpq_torch.query import jit_pipeline

torch.set_num_threads(2)

CAP = 1 << 14
LANE_SPANS = ["tpq.lane.build", "tpq.lane.layout", "tpq.lane.emit"]


def _rel(rows, nkeys, seed, payloads=1, device="cpu"):
    return datagen.gen_relation(rows, nkeys, payloads=payloads, seed=seed, device=device)


def _deep_bucket(device="cpu"):
    """R with 49 rows of one key (one lane bucket 49 deep, depth 48) and
    1,000 distinct others; S with that key among 1,500 rows."""
    rk = torch.cat([torch.full((49,), 7, dtype=torch.int64),
                    torch.arange(1000, 2000, dtype=torch.int64)])
    sk = torch.arange(1500, dtype=torch.int64) % 1200
    return (_table(rk, torch.arange(rk.numel(), dtype=torch.int64), device),
            _table(sk, -torch.arange(sk.numel(), dtype=torch.int64), device))


def _table(key, pay, device) -> Table:
    return Table({"key": key.to(device), "p0": pay.to(device)},
                 torch.tensor(key.numel(), dtype=torch.int32, device=device))


def _skewed(device="cpu"):
    """S with one key on 40 % of its 20,000 rows (nominated heavy) and R
    holding it twice."""
    g = torch.Generator().manual_seed(3)
    sk = torch.randint(0, 4096, (20_000,), generator=g, dtype=torch.int64)
    sk[torch.randperm(20_000, generator=g)[:8000]] = 77
    rk = torch.cat([torch.arange(4096, dtype=torch.int64), torch.tensor([77])])
    return _table(rk, rk * 3, device), _table(sk, sk + 1, device)


def _profiled(fn, *args, calls=1):
    """fn(*args) `calls` times under a CPU profiler: (the last result,
    the names of the tpq spans, the records appended)."""
    before = len(trace.records())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(calls):
            out = fn(*args)
    names = {e.name for e in prof.events() if e.name.startswith("tpq.")}
    recs = trace.records()
    return out, names, recs[before:] if len(recs) - before == calls else None


def test_no_profiler_no_record_and_no_span(monkeypatch):
    opened = []
    monkeypatch.setattr(trace, "record_function",
                        lambda name: opened.append(name) or pytest.fail(name))
    r, s = _rel(2000, 2000, 1), _rel(2000, 2000, 2)
    fn = jit(functools.partial(hash_join, out_capacity=CAP, impl="lane"))
    n = len(trace.records())
    with trace.span("tpq.test"):
        out = fn(r, s)
    assert int(out.num_rows) > 0 and len(trace.records()) == n and opened == []
    assert not trace.recording()


def test_spans_by_name_and_one_record_per_call():
    r, s = _rel(2000, 2000, 1), _rel(2000, 2000, 2)
    fn = jit(functools.partial(hash_join, out_capacity=CAP, impl="lane"))
    out, names, recs = _profiled(fn, r, s, calls=3)
    assert set(LANE_SPANS) | {"tpq.jit.signature"} <= names
    assert "tpq.union_join" not in names
    assert recs is not None and len(recs) == 3
    for rec in recs:
        assert rec["rerun"] is False and rec["device_ms"] is None and rec["spans"] == []
        assert rec["conds"] == [["tpq.lane.ok", True]]
        assert rec["host_ms"]["signature"] > 0
    pipe = jit_pipeline(CAP, join_impl="lane")
    _, names, recs = _profiled(pipe, _rel(1000, 1024, 1), _rel(5000, 1024, 2, 2), 512)
    assert {"tpq.filter.keep", "tpq.aggregate.hash", "tpq.aggregate.groups"} <= names
    assert not {"tpq.aggregate.sort", "tpq.aggregate.runs"} & names
    assert recs is not None
    assert recs[0]["conds"] == [["tpq.lane.ok", True], ["tpq.aggregate.ok", True]]


def test_aggregate_table_past_its_limit_falls_back_by_name(monkeypatch):
    """A group table of 16 slots (limit 8) under more groups: the cond
    `tpq.aggregate.ok` takes the sort path, whose spans run, and the
    groups are the hash path's at full size."""
    from tpq_torch.kernels import group_table

    pipe = jit_pipeline(CAP, join_impl="lane")
    args = (_rel(1000, 1024, 1), _rel(5000, 1024, 2, 2), 512)
    want = pipe(*args)
    monkeypatch.setattr(group_table, "MAX_SLOTS", 16)
    out, names, recs = _profiled(pipe, *args)
    assert recs[0]["conds"] == [["tpq.lane.ok", True], ["tpq.aggregate.ok", False]]
    assert {"tpq.aggregate.hash", "tpq.aggregate.sort", "tpq.aggregate.runs"} <= names
    assert "tpq.aggregate.groups" not in names
    assert int(out.num_rows) == int(want.num_rows) > 8
    for k in want.columns:
        assert torch.equal(out.columns[k], want.columns[k]), k


def test_deep_bucket_falls_back_by_name():
    r, s = _deep_bucket()
    fn = jit(functools.partial(hash_join, out_capacity=CAP, impl="lane"))
    out, names, recs = _profiled(fn, r, s)
    assert recs[0]["conds"][0] == ["tpq.lane.ok", False]
    assert [n for n, _ in recs[0]["conds"]] == ["tpq.lane.ok", "tpq.union.small_ok"]
    assert "tpq.union_join" in names and set(LANE_SPANS) <= names
    assert int(out.num_rows) == int(hash_join(r, s, CAP, impl="sorted").num_rows) > 0


def test_heavy_keys_observed_are_the_nomination():
    r, s = _skewed()
    fn = jit(functools.partial(hash_join, out_capacity=1 << 16, impl="skew"))
    _, names, recs = _profiled(fn, r, s)
    obs = recs[0]["observed"]
    _, n_heavy, _ = nominate_heavy_keys(s.col("key"), s.num_rows)
    assert obs["tpq.skew.heavy_keys"] == int(n_heavy) >= 1
    heavy, _, _ = nominate_heavy_keys(s.col("key"), s.num_rows)
    want = int(torch.isin(s.col("key"), heavy[:int(n_heavy)]).sum())
    assert obs["tpq.skew.heavy_probe_rows"] == want >= 8000
    assert obs["tpq.skew.probe_rows"] == 20_000
    assert recs[0]["conds"] == [["tpq.skew.ok", True]]
    assert {"tpq.skew.nominate", "tpq.skew.heavy", "tpq.skew.light"} <= names
    assert fn.stats()["observed"] == obs


def test_stats_counts_calls_reruns_and_branches():
    r, s = _rel(2000, 2000, 1), _rel(2000, 2000, 2)
    fn = jit(functools.partial(hash_join, out_capacity=CAP, impl="lane"))
    for _ in range(3):
        fn(r, s)
    st = fn.stats()
    assert (st["calls"], st["replays"], st["reruns"], st["captures"]) == (3, 0, 0, 0)
    assert st["conds"] == {"tpq.lane.ok": {"then": 3, "else": 0}}
    assert st["phase_ns"]["signature"] > 0 and st["phase_ns"]["launch"] == 0
    fb = jit(functools.partial(hash_join, out_capacity=CAP, impl="lane"))
    dr, ds = _deep_bucket()
    fb(dr, ds)
    fb(dr, ds)
    st = fb.stats()
    assert st["calls"] == 2 and st["reruns"] == 0
    assert st["conds"]["tpq.lane.ok"] == {"then": 0, "else": 2}
    assert sum(st["conds"]["tpq.union.small_ok"].values()) == 2
    fb.clear()
    assert fb.stats()["calls"] == 2  # clear frees graphs, not counts


def test_ring_is_bounded_and_clear_leaves_it(monkeypatch):
    monkeypatch.setattr(trace, "_RECORDS", collections.deque(maxlen=trace.RING))
    for i in range(trace.RING + 5):
        trace.append({"i": i, "device_ms": 1.0})
    recs = trace.records()
    assert len(recs) == trace.RING and recs[0]["i"] == 5 and recs[-1]["i"] == trace.RING + 4
    jit(lambda x: x).clear()
    assert len(trace.records()) == trace.RING
    assert trace.last_calls(2) == recs[-2:] and trace.last_calls(trace.RING + 1) is None


class _FakeMarks(trace.Marks):
    """Marks whose stamps are the count of top-level spans opened when
    written (no card)."""

    def __init__(self):
        super().__init__("cpu")

    def mark(self) -> None:
        self.stamps.append(len(self.spans))


def test_top_level_spans_tile_the_body_and_a_cond_names_what_it_discards():
    """Under a capture, each top-level span stamps where it opens and the
    body's end stamps once more, spans inside another stamp nothing, and
    a span's ms runs from its stamp to the next; the lane join's `ok`
    cond names the lane attempt's spans as what its else branch
    discards."""
    marks = _FakeMarks()
    with trace.capturing(marks):
        with trace.span("tpq.a"):
            with trace.span("tpq.a.b"):
                pass
        with trace.span("tpq.c"):
            pass
        with trace.span("tpq.d"):
            with trace.span("tpq.d.e"):
                pass
        marks.finish()
    assert marks.spans == ["tpq.a", "tpq.c", "tpq.d"] and marks.stamps == [0, 1, 2, 3]
    assert marks.read([1_000_000, 2_500_000, 5_500_000, 9_500_000]) == [1.5, 3.0, 4.0]
    r, s = _deep_bucket()
    marks, run = _FakeMarks(), _Trace(path=(False, True))
    with _traced(run), trace.capturing(marks):
        hash_join(r, s, CAP, impl="lane")
        marks.finish()
    assert run.names == ["tpq.lane.ok", "tpq.union.small_ok"]
    assert [marks.spans[i] for i in run.attempts[0]] == LANE_SPANS
    assert run.attempts[1] is None and marks.spans == LANE_SPANS + ["tpq.union_join"]
    assert len(marks.stamps) == len(marks.spans) + 1
    empty = _FakeMarks()
    empty.finish()
    assert empty.stamps == []  # a body with no span stamps nothing


def _records(spans_list, device_ms=2.0, observed=None):
    return [{"rerun": False, "host_ms": {"signature": 0.1, "load": 0.02, "launch": 0.3,
                                         "read": 0.9, "result": 0.05},
             "device_ms": device_ms, "spans": spans, "conds": [],
             "observed": observed or {}} for spans in spans_list]


def _span(name, ms, discarded=False):
    return {"name": name, "ms": ms, "discarded": discarded}


SPANS = [[_span("tpq.lane.build", 0.2, discarded=True), _span("tpq.lane.layout", 0.3,
                                                               discarded=True),
          _span("tpq.union_join", 1.0)],
         [_span("tpq.lane.layout", 0.25), _span("tpq.skew.light", 0.5, discarded=True)]]
OBSERVED = [{"tpq.skew.heavy_probe_rows": 40, "tpq.skew.probe_rows": 100},
            {"tpq.skew.heavy_probe_rows": 50, "tpq.skew.probe_rows": 100}]


@pytest.mark.parametrize("metric,want", [
    ("jit_host_ms", 0.47),            # signature + load + launch + result, no read
    ("layout_ms", (0.3 + 0.25) / 2),
    ("discarded_device_ms", (0.2 + 0.3 + 0.5) / 2),
    ("heavy_probe_share", 90 / 200),
])
def test_metric_reads_the_window_records(monkeypatch, metric, want):
    read = importlib.import_module(f"benchmark.metrics.{metric}").read
    ring = collections.deque(maxlen=trace.RING)
    ring.extend(_records([[_span("tpq.lane.layout", 99.0)]] * 3))  # before the window
    ring.extend(_records(SPANS, observed=None))
    for rec, obs in zip(list(ring)[-2:], OBSERVED):
        rec["observed"] = obs
    monkeypatch.setattr(trace, "_RECORDS", ring)
    assert read({"trace": True, "queries": 2}) == pytest.approx(want)
    assert read({"trace": True, "queries": 6}) is None        # fewer records
    assert read({"trace": False, "queries": 2}) is None       # an untraced run
    ring[-1]["device_ms"] = None                               # a call with no graph
    assert read({"trace": True, "queries": 2}) is None


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _jitted_cases(dev):
    r, s = _rel(1 << 14, 1 << 14, 1, device=dev), _rel(1 << 14, 1 << 14, 2, device=dev)
    dr, ds = _deep_bucket(dev)
    zr, zs = _skewed(dev)
    return {
        "lane": (functools.partial(hash_join, out_capacity=1 << 16, impl="lane"), (r, s)),
        "fallback": (functools.partial(hash_join, out_capacity=CAP, impl="lane"), (dr, ds)),
        "skew": (functools.partial(hash_join, out_capacity=1 << 16, impl="skew"), (zr, zs)),
        "pipeline": (jit_pipeline(1 << 16, join_impl="lane").__wrapped__,
                     (_rel(4096, 4096, 1, device=dev), _rel(1 << 15, 4096, 2, 2, dev), 2048)),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["lane", "fallback", "skew", "pipeline"])
def test_replay_times_every_operator_span(dev, case):
    body, args = _jitted_cases(dev)[case]
    fn = jit(body)
    want = body(*args)
    fn(*args)
    fn(*args)  # the fallback's second call replays the else path's graph
    _, _, recs = _profiled(fn, *args, calls=2)
    assert recs is not None
    for rec in recs:
        assert not rec["rerun"] and rec["device_ms"] > 0 and rec["spans"]
        assert all(sp["ms"] > 0 for sp in rec["spans"]), rec["spans"]
        total = sum(sp["ms"] for sp in rec["spans"])  # they tile the body
        assert total <= rec["device_ms"] * 1.01 + 1e-3
        discarded = [sp["name"] for sp in rec["spans"] if sp["discarded"]]
        assert discarded == (LANE_SPANS if case == "fallback" else [])
    got = fn(*args)
    torch.cuda.synchronize()
    n = int(want.num_rows)
    assert int(got.num_rows) == n
    for name, c in want.columns.items():
        assert torch.equal(got.columns[name][:n], c[:n]), name


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["lane", "fallback", "skew"])
def test_counters_unchanged_by_span_stamps(dev, case, monkeypatch):
    """The same calls with the spans' stamps left out of the graphs: the
    same reruns, copies, captures and outputs."""
    body, args = _jitted_cases(dev)[case]

    def counted():
        fn = jit(body)
        outs = [fn(*args) for _ in range(3)]
        torch.cuda.synchronize()
        counts = (fn.reruns, fn.copies, fn.captures)
        fn.clear()
        return counts, outs

    with_marks = counted()
    monkeypatch.setattr(trace, "capturing", lambda marks: contextlib.nullcontext())
    without = counted()
    assert with_marks[0] == without[0]
    for a, b in zip(with_marks[1], without[1]):
        n = int(a.num_rows)
        assert n == int(b.num_rows)
        for name in a.columns:
            assert torch.equal(a.columns[name][:n], b.columns[name][:n]), name
