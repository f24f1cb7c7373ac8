"""The frozen copies in benchmark/harness against the port's originals:
the generator's streams, the output capacity, the interval union; and
the peak table, the kernel names and the trace reduction."""

from __future__ import annotations

import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tiny_cells import ROOT
from benchmark.harness import intervals, roofline, spec, streams, tracing


@pytest.mark.parametrize("dist,theta", [("uniform", None), ("zipf", 1.0), ("zipf", 0.5)])
@pytest.mark.parametrize("seed", [0, 2, 2**31 + 7, 2**64 - 1])
def test_streams_match_the_ports_generator(dist, theta, seed):
    from tpq_torch import datagen

    rows, nkeys, payloads = 1000, 777, 2
    keys = {"dist": dist} if theta is None else {"dist": dist, "theta": theta}
    rel = streams.relation(rows, nkeys, payloads, seed, seed, keys, "cpu")
    want = datagen.gen_relation_np(rows, nkeys, payloads, seed, dist, theta or 1.0)
    assert rel.capacity == 1024 and rel.rows == rows
    for name, col in want.items():
        got = rel.live(name).numpy()
        if name == "key":  # the keys in the order the seed draws
            order = np.argsort(streams.stream(seed, torch.arange(rows)).numpy(),
                               kind="stable")
            np.testing.assert_array_equal(got, col[order])
        else:
            np.testing.assert_array_equal(got, col)


def test_seeds_reorder_the_same_keys():
    keys = {"dist": "zipf", "theta": 1.0}
    a = streams.relation(3000, 500, 1, 1, 10, keys, "cpu")
    b = streams.relation(3000, 500, 1, 1, 2**40 + 3, keys, "cpu")
    assert not torch.equal(a.live("key"), b.live("key"))
    assert torch.equal(a.live("key").sort().values, b.live("key").sort().values)
    assert not torch.equal(a.live("p0"), b.live("p0"))


def test_derived_seeds_differ_and_fit_64_bits():
    seeds = {streams.derive_seed(s, k) for s in (0, 1, 2**31 + 5, 9_000_000_000)
             for k in (1, 2)}
    assert len(seeds) == 8
    assert all(0 <= s < 2**64 for s in seeds)


@pytest.mark.parametrize("config,preset", [("join_1m", "single_chip_1m"),
                                           ("join_1m", "zipf_skew"),
                                           ("pipeline_100m", "pipeline_100m")])
def test_out_capacity_is_the_runners(config, preset):
    from tpq_torch.bench.runner import out_capacity_for
    from tpq_torch.config import PRESETS

    import json

    with open(ROOT / "benchmark" / "configs" / f"{config}.json") as f:
        cfg = json.load(f)
    p = PRESETS[preset]
    assert (cfg["build"]["rows"], cfg["probe"]["rows"]) == (p.r.rows, p.s.rows)
    assert (cfg["build"]["payloads"], cfg["probe"]["payloads"]) == (p.r.payloads,
                                                                    p.s.payloads)
    assert spec.out_capacity(cfg) == out_capacity_for(p)


def test_interval_union_is_the_profilers():
    from tpq_torch.bench.profile import busy_us

    rng = random.Random(7)
    for _ in range(50):
        acts = []
        for _ in range(rng.randrange(0, 30)):
            s = rng.uniform(0, 100)
            acts.append((s, s + rng.uniform(0, 10), "k"))
        assert intervals.busy((s, e) for s, e, _ in acts) == pytest.approx(busy_us(acts))


def test_gaps_and_clip():
    acts = [(1, 3), (2, 4), (6, 7), (9, 12)]
    assert intervals.gaps(acts, 0, 10) == [(0, 1), (4, 6), (7, 9)]
    assert intervals.clip(acts, 2.5, 6.5) == [(2.5, 3), (2.5, 4), (6, 6.5)]
    assert intervals.gaps([], 0, 5) == [(0, 5)]


def test_peak_table():
    assert roofline.hbm_peak("NVIDIA H100 80GB HBM3") == 3.35e12
    assert roofline.hbm_peak("cpu") is None and roofline.hbm_peak(None) is None


def test_port_kernel_names_come_from_the_sources():
    from tpq_torch.bench.profile import PORT_KERNELS

    names = tracing.port_kernel_names()
    assert set(PORT_KERNELS) <= names
    assert "copy_kernel" in names
    is_port = tracing.kernel_matcher(names)
    assert is_port("(anonymous namespace)::walk_emit_kernel(long const*, int const*)")
    assert is_port("digit_count_kernel(Digit, long, long, int*)")
    assert is_port("void (anonymous namespace)::pad_kernel<4>(ColList, int const*)")
    assert not is_port("void at::native::elementwise_kernel<128, 2, at::native::"
                       "direct_copy_kernel_cuda(at::TensorIteratorBase&)>")
    assert not is_port("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<x>(y)")
    assert not tracing.kernel_matcher(frozenset())("pad_kernel(x)")


def _event(name, s, e, device=False, thread=1, annotation=False):
    from torch.autograd import DeviceType

    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=s, end=e),
                           device_type=DeviceType.CUDA if device else DeviceType.CPU,
                           thread=thread, is_user_annotation=annotation)


def test_summarise_reads_busy_idle_and_kernels():
    events = [
        _event("window", 0, 100),
        _event("query", 0, 50), _event("query", 50, 100),
        _event("cudaGraphLaunch", 1, 4), _event("cudaStreamSynchronize", 30, 49),
        _event("cudaGraphLaunch", 51, 54), _event("other thread", 0, 100, thread=2),
        _event("query", 0, 50, device=True, annotation=True),  # a span's image
        _event("(anonymous namespace)::pack_kernel(ColList)", 5, 25, device=True),
        _event("void at::native::index_kernel<x>(y)", 20, 30, device=True),
        _event("Memcpy DtoH (Device -> Pinned)", 55, 60, device=True),
        _event("(anonymous namespace)::pack_kernel(ColList)", 95, 120, device=True),
    ]
    r = tracing.summarise(events, tracing.kernel_matcher({"pack_kernel"}))
    assert r["queries"] == 2 and r["window_us"] == 100
    assert r["busy_us"] == 25 + 5 + 5  # [5, 30], [55, 60], [95, 100]
    assert r["port_us"] == 20 + 5 and r["library_us"] == 10 + 5
    idle = dict(r["breakdown"]["idle_gaps"])
    assert idle["cudaGraphLaunch"] == pytest.approx(5e-6)  # [0, 5]: its middle in [1, 4]
    assert idle["cudaStreamSynchronize"] == pytest.approx(25e-6)  # [30, 55]
    assert idle["query"] == pytest.approx(35e-6)  # [60, 95]
    assert r["breakdown"]["device_ops"][0] == ["(anonymous namespace)::pack_kernel(ColList)",
                                               pytest.approx(25e-6)]


def test_summarise_needs_the_window():
    with pytest.raises(RuntimeError):
        tracing.summarise([_event("query", 0, 1)], lambda n: False)


@pytest.mark.parametrize("name", ["device_idle_share", "query_roofline_pct",
                                  "port_kernel_ms", "library_op_ms"])
def test_trace_readers_return_nothing_without_device_work(name):
    read = spec.metric_reader(name)
    summary = {"trace": True, "queries": 3, "window_us": 10.0, "busy_us": 0.0,
               "port_us": 0.0, "library_us": 0.0, "least_bytes": 100, "hbm_peak": None}
    assert read(summary) is None


def test_readers_on_a_trace():
    summary = {"trace": True, "queries": 4, "window_us": 1000.0, "busy_us": 800.0,
               "port_us": 300.0, "library_us": 600.0, "least_bytes": 3.35e6,
               "hbm_peak": 3.35e12}
    assert spec.metric_reader("device_idle_share")(summary) == pytest.approx(0.2)
    assert spec.metric_reader("port_kernel_ms")(summary) == pytest.approx(0.075)
    assert spec.metric_reader("library_op_ms")(summary) == pytest.approx(0.15)
    # 1 us of least time a query against 200 us busy a query
    assert spec.metric_reader("query_roofline_pct")(summary) == pytest.approx(0.5)


def test_readers_of_a_window():
    lat = [i / 1000 for i in range(1, 101)]
    summary = {"trace": False, "queries": 100, "probe_rows": 1000, "window_s": 2.0,
               "latencies_s": lat, "setup_s": 3.5, "peak_alloc_bytes": 2**31}
    assert spec.metric_reader("probe_rows_per_s")(summary) == 50_000
    assert spec.metric_reader("query_p95_ms")(summary) == pytest.approx(95.05)
    assert spec.metric_reader("peak_alloc_GiB")(summary) == 2.0
    assert spec.metric_reader("setup_s")(summary) == 3.5
    assert spec.metric_reader("peak_alloc_GiB")({**summary, "peak_alloc_bytes": None}) is None


def test_a_split_quantity_is_read_by_its_quantity():
    assert spec.metric_reader("probe_rows_per_s.pipeline") is \
        spec.metric_reader("probe_rows_per_s")
    assert spec.metric_reader("library_op_ms.pipeline") is spec.metric_reader("library_op_ms")


def test_every_metric_has_a_reader_and_every_cell_its_metrics():
    bench = spec.load_benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))
    e2e = {m["name"] for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        cell = spec.resolve(bench, w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2, w["name"]
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:  # what a per-layer metric moves is reported there
            assert m["moves"] in names and m["moves"] in e2e, (w["name"], m["name"])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_zipf_on_device_matches_the_host(cuda_device):
    rel_c = streams.relation(5000, 4096, 1, 2, 11, {"dist": "zipf", "theta": 1.0},
                             cuda_device)
    rel_h = streams.relation(5000, 4096, 1, 2, 11, {"dist": "zipf", "theta": 1.0}, "cpu")
    for n in rel_h.columns:
        assert torch.equal(rel_c.columns[n].cpu(), rel_h.columns[n])

