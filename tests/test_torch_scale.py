"""tpq_torch's on-device data streams and scale benches (configs 2 and 4
chunked), on the CPU with the plain kernel versions.

gen_relation_device is held byte-equal to the numpy streams (the
oracle's) at row offsets, key domains that are not powers of two and
rows whose splitmix value has its top bit set. Both benches run at
smoke size with their own exact checks against numpy (the join's count;
every group's count and sums), every chunk on the lane path. Integer
data: every comparison is exact."""

import numpy as np
import pytest
import torch

from torch_host_reads import host_reads

from tpq_torch import datagen
from tpq_torch.bench import runner, scale_bench
from tpq_torch.bench.runner import gen
from tpq_torch.columnar import canonicalize
from tpq_torch.config import RelationSpec
from tpq_torch.jit import deferred
from tpq_torch.query import full_pipeline

from conftest import assert_tables_equal

torch.set_num_threads(2)


@pytest.mark.parametrize("rows,nkeys,payloads,seed,offset", [
    (1000, 1024, 2, 2, 0),
    (5000, 999_983, 3, 7, 123_457),       # nkeys not a power of two, offset
    (3000, 3, 1, 1, (1 << 20) + 5),       # tiny key domain
    (4096, 1 << 20, 4, 0xA5A5, 1 << 16),  # payloads of config 2
])
def test_gen_relation_device_equals_numpy(rows, nkeys, payloads, seed, offset):
    """Rows [offset, offset + rows) of the stream, byte-equal to numpy's;
    about half the rows' splitmix values have the top bit set, where the
    key's unsigned modulo and the payloads' logical shift differ from the
    signed int64 forms."""
    t = datagen.gen_relation_device(rows, nkeys, payloads, seed, row_offset=offset,
                                    device="cpu")
    want = datagen.gen_relation_np(offset + rows, nkeys, payloads, seed)
    assert list(t.names) == list(want) and int(t.num_rows) == rows
    assert t.capacity == 1 << (rows - 1).bit_length()
    for k, v in t.columns.items():
        assert v.dtype == torch.int64
        assert np.array_equal(v[:rows].numpy(), want[k][offset:]), k
    top = datagen._stream(seed, np.arange(offset, offset + rows, dtype=np.uint64))
    n_top = int((top >> np.uint64(63)).sum())
    assert 0.4 * rows < n_top < 0.6 * rows
    if nkeys & (nkeys - 1):  # 2^64 % nkeys != 0: the signed modulo would differ
        signed = torch.from_numpy(top.view(np.int64))
        assert not torch.equal(signed % nkeys, t.col("key")[:rows])


def test_gen_relation_device_capacity_continues_the_stream():
    """Rows past `rows` up to the capacity continue the stream (tpq
    generates the whole capacity); a chunk at an offset is the slice of
    one long relation."""
    t = datagen.gen_relation_device(100, 77, 2, seed=9, capacity=256, row_offset=300,
                                    device="cpu")
    want = datagen.gen_relation_np(556, 77, 2, seed=9)
    assert int(t.num_rows) == 100 and t.capacity == 256
    for k, v in t.columns.items():
        assert np.array_equal(v.numpy(), want[k][300:]), k


def test_runner_gen_uniform_on_device_streams():
    """The runner's relations: uniform specs by the device streams, their
    live rows equal to the host relation and their padding the stream's
    continuation (as tpq's gen_relation_device makes it); zipf from the
    host, zero-padded."""
    for spec in (RelationSpec(rows=3000, nkeys=1000, payloads=2, seed=4),
                 RelationSpec(rows=3000, nkeys=1000, seed=4, kind="zipf")):
        t = gen(spec, "cpu")
        assert int(t.num_rows) == spec.rows and t.capacity == 4096
        want = datagen.gen_relation_np(spec.rows, spec.nkeys, spec.payloads, spec.seed,
                                       spec.kind, spec.theta)
        stream = datagen.gen_relation_np(t.capacity, spec.nkeys, spec.payloads, spec.seed)
        for k in want:
            assert np.array_equal(t.col(k)[:spec.rows].numpy(), want[k]), k
            pad = t.col(k)[spec.rows:].numpy()
            if spec.kind == "uniform":
                assert np.array_equal(pad, stream[k][spec.rows:]), k
            else:
                assert not pad.any(), k


def test_bench_pipeline_smoke():
    """Config 4 chunked at smoke size (4 chunks, the last one short):
    every group exact against numpy, every chunk on the lane path, no
    time off the card."""
    rep = scale_bench.bench_pipeline(n_dim=4096, n_fact=50_000, chunk_rows=1 << 14,
                                     filter_value=2048, device="cpu", log=lambda _: None)
    assert rep["groups_exact"] and rep["lane_path_taken_all_chunks"]
    assert rep["nchunks"] == 4 and rep["groups"] > 1000
    assert rep["elapsed_ms"] is None and "fact_rows_per_sec" not in rep
    want = scale_bench.pipeline_truth(4096, 50_000, 2, 2048)
    assert rep["join_rows"] == int(want["count"].sum())


def test_pipeline_truth_equals_full_pipeline():
    """The bench's numpy ground truth is the pipeline's answer: equal to
    full_pipeline on the same relations, which the oracle tests hold."""
    want = scale_bench.pipeline_truth(1024, 6000, 2, 700)
    dim = datagen.gen_relation_device(1024, 1024, 1, seed=1, device="cpu")
    fact = datagen.gen_relation_device(6000, 1024, 2, seed=2, device="cpu")
    out = full_pipeline(dim, fact, "key", "lt", 700, 1 << 14, join_impl="lane")
    assert_tables_equal(canonicalize(out), want, "pipeline_truth")


def test_bench_build_sweep_smoke():
    """Config 2 at smoke size (3 chunks, 4 payloads): the count exact
    against numpy's bincount product, every chunk on the lane path."""
    rep = scale_bench.bench_build_sweep(n_build=5000, n_probe=40_000, payloads=4,
                                        chunk_rows=1 << 14, device="cpu",
                                        log=lambda _: None)
    assert rep["count_exact"] and rep["lane_path_taken_all_chunks"]
    assert rep["nchunks"] == 3 and rep["out_rows"] == rep["expected_rows"] > 0
    assert rep["elapsed_ms"] is None


def test_consume_reads_every_column():
    """The per-chunk reduction changes when any live value of any column
    does, and ignores the padding."""
    from tpq_torch import Table

    cols = {"key": torch.arange(8), "p0": torch.arange(8) * 3}
    base = scale_bench._consume(Table(cols, 5))
    for name in cols:
        bumped = dict(cols)
        bumped[name] = cols[name].clone()
        bumped[name][2] += 1
        assert scale_bench._consume(Table(bumped, 5)) != base, name
        pad = dict(cols)
        pad[name] = cols[name].clone()
        pad[name][6] += 1
        assert scale_bench._consume(Table(pad, 5)) == base, name


SMOKE_PIPELINE = dict(n_dim=4096, n_fact=50_000, chunk_rows=1 << 14, filter_value=2048,
                      device="cpu", log=lambda _: None)
SMOKE_SWEEP = dict(n_build=5000, n_probe=40_000, payloads=4, chunk_rows=1 << 14,
                   device="cpu", log=lambda _: None)


@pytest.mark.parametrize("staged,eager", [(False, False), (True, True), (False, True)])
def test_bench_pipeline_fused_and_eager_equal_staged(staged, eager):
    """The fused chunk program (tpq's --fused) and the eager bodies give
    the staged programs' groups: each run is held exact to numpy's truth
    by the bench, and the reports agree; a jitted run reports its
    programs (on the CPU jit(fn) is fn: no graph, no copy)."""
    want = scale_bench.bench_pipeline(**SMOKE_PIPELINE)
    rep = scale_bench.bench_pipeline(staged=staged, eager=eager, **SMOKE_PIPELINE)
    assert rep["groups_exact"] and rep["lane_path_taken_all_chunks"]
    assert (rep["groups"], rep["join_rows"]) == (want["groups"], want["join_rows"])
    assert (rep["staged"], rep["eager"]) == (staged, eager)
    chunk_programs = {"probe_core", "agg_core"} if staged else {"chunk_step"}
    if eager:
        assert rep["jit"] is None
    else:
        assert set(rep["jit"]) == {"gen_dim", "build", "gen_chunk", "finalize",
                                   *chunk_programs}
        assert all(st["graphs"] == st["copies"] == 0 for st in rep["jit"].values())
        assert rep["copies_per_chunk"] == rep["loop_captures"] == 0
    assert set(want["jit"]) == {"gen_dim", "build", "gen_chunk", "finalize",
                                "probe_core", "agg_core"}


@pytest.mark.parametrize("which", ["pipeline_staged", "pipeline_fused", "sweep"])
def test_scale_programs_make_no_host_read(monkeypatch, which):
    """Every program the benches jit runs under the capture flag with
    every host read raising and records no cond, its traced numbers (the
    chunk's row offset and row count) reaching it as 0-d tensors, as a
    graph's scalars reach it on the card; the run stays exact."""
    ran = []

    def capturable(fn, **options):  # hand_off, updates: one run a call here
        def call(*args):
            args = tuple(torch.tensor(a) if isinstance(a, int) and not isinstance(a, bool)
                         else a for a in args)
            with deferred() as preds, host_reads("raise"):
                out = fn(*args)
            assert not preds
            ran.append(fn)
            return out
        return call

    monkeypatch.setattr(scale_bench, "jit", capturable)
    if which == "sweep":
        rep = scale_bench.bench_build_sweep(**SMOKE_SWEEP)
        assert rep["count_exact"] and len(set(ran)) == 4
    else:
        rep = scale_bench.bench_pipeline(staged=which == "pipeline_staged",
                                         **SMOKE_PIPELINE)
        assert rep["groups_exact"]
        assert len(set(ran)) == (6 if which == "pipeline_staged" else 5)
    assert rep["lane_path_taken_all_chunks"]


def test_cli_fused_reaches_staged_false(monkeypatch):
    """The CLI's --fused runs the pipeline with staged=False, --eager the
    bodies without graphs; the defaults are staged and jitted."""
    seen = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(runner, "card_info", lambda: "card")
    monkeypatch.setattr(scale_bench, "bench_pipeline", lambda **kw: seen.append(kw) or {})
    monkeypatch.setattr(scale_bench, "bench_build_sweep",
                        lambda **kw: seen.append(kw) or {})
    for argv in (["pipeline", "--fused"], ["pipeline"], ["pipeline", "--eager"],
                 ["sweep", "--eager"]):
        scale_bench.main(argv)
    assert [(kw.get("staged"), kw["eager"]) for kw in seen] == [
        (False, False), (True, False), (True, True), (None, True)]
