"""Heavy-hitter split join for a skewed probe side (port of
tpq/ops/skew_join.py).

The lane join's static caps (probe partition capacity, tail) are sized
for near-uniform keys; a zipf probe side piles a few keys into one
partition and would send the whole join to the union-sort fallback.
This operator splits the key set instead:

  1. NOMINATE — sample every `stride`-th probe key, sort the sample,
     count its runs and keep keys whose sample count reaches the
     threshold: an exact list of candidate heavy keys (PACK).
  2. MEMBERSHIP — a one-partition lane table of the listed keys, probed
     by both relations with the walk-only probe (kernel 4) on the
     identity layout: heavy row masks.
  3. HEAVY PATH — R's heavy rows compacted into a small one-partition
     table with a deep inline budget (K = 8), probed by all of S with the
     fused walk/emit: exactly the matches whose key is listed.
  4. LIGHT PATH — the partitioned lane join of the remaining rows, near
     uniform by construction.
  5. SPLICE — the heavy buffer written at light.num_rows.

Any static violation (list overflow, mini-table overflow, lane caps,
heavy rows past the heavy buffer, splice room) sends the whole join
through the union-sort engine: tpq's lax.cond (tpq/ops/skew_join.py:182)
is jit.cond, one host read eager, none under a graph.
"""

from __future__ import annotations

import torch

from tpq_torch.columnar import Table
from tpq_torch.kernels.lane2 import (build_lane2_tables, lane2_probe_emit,
                                     plan_lane2)
from tpq_torch.kernels.lane_table import LanePlan, probe_lane_tables
from tpq_torch.kernels.move import pack
from tpq_torch.ops._expand import last_start
from tpq_torch.ops.filter import compact
from tpq_torch.trace import marker, span

I32 = torch.int32
I64 = torch.int64


def nominate_heavy_keys(keys: torch.Tensor, num_rows, heavy_cap: int = 2048,
                        stride: int = 16, sample_threshold: int = 16):
    """Heavy-key candidates from a strided sample (step 1).

    Returns (heavy_keys [min(heavy_cap, sample size)], the first n_heavy
    live and the rest zero; n_heavy int32; ok bool, False when more than
    heavy_cap keys reached the threshold). At stride 16 and threshold 16
    a key needs about 256 occurrences to be nominated."""
    dev = keys.device
    sample = keys[::stride]
    m = sample.shape[0]
    i = torch.arange(m, device=dev)
    eff = torch.where(i * stride < num_rows, sample, torch.iinfo(keys.dtype).max)
    ks = torch.sort(eff, stable=True).values
    new = torch.ones(m, dtype=torch.bool, device=dev)
    new[1:] = ks[1:] != ks[:-1]
    # a run's length is known at its last position: nominate there
    run_end = torch.ones(m, dtype=torch.bool, device=dev)
    run_end[:-1] = new[1:]
    runlen = i - last_start(new) + 1
    slive = i < (num_rows + stride - 1) // stride
    nominate = run_end & (runlen >= sample_threshold) & slive
    (packed,), n_heavy = pack([ks], nominate.to(I32))
    return packed[:heavy_cap], n_heavy.clamp_max(heavy_cap), n_heavy <= heavy_cap


def _broadcast_plan(build_cap: int, probe_cap: int, depth: int,
                    inline_k: int, out_capacity: int) -> LanePlan:
    """One-partition lane plan: the whole table is one [depth, 128] tile
    set and the probe layout is the identity."""
    return LanePlan(pbits=0, depth=depth, probe_cap=probe_cap,
                    inline_k=inline_k,
                    tail_rows_cap=max(2048, probe_cap >> 6),
                    tail_out_cap=max(4096, min(out_capacity, probe_cap) >> 4))


def _membership(list_tables, t: Table, key: str) -> torch.Tensor:
    """bool[capacity]: the row's key is in the list table (walk only; one
    partition keeps probe order = row order)."""
    _, _, cnt, _, _, qocc, _, _ = probe_lane_tables(list_tables, t, key)
    return (cnt > 0) & (qocc > 0)


def _split(r: Table, s: Table, out_capacity: int, key: str, heavy_cap: int,
           mini_cap: int, stride: int, sample_threshold: int):
    """Steps 1-4. Returns (light_out, heavy_out, ok)."""
    from tpq_torch.jit import observe

    r_names = [n for n in r.names if n != key]
    r_dtypes = [r.col(n).dtype for n in r_names]

    # the heavy-key list and both relations' heavy masks
    with span("tpq.skew.nominate"):
        heavy_keys, n_heavy, ok_nom = nominate_heavy_keys(
            s.col(key), s.num_rows, heavy_cap, stride, sample_threshold)
        # list table: keys only, one partition
        list_t = Table({key: heavy_keys}, n_heavy)
        list_tables = build_lane2_tables(
            list_t, _broadcast_plan(heavy_cap, r.capacity, depth=48, inline_k=1,
                                    out_capacity=out_capacity), key)
        r_heavy = _membership(list_tables, r, key)
        # the identity layout needs probe_cap == the prober's capacity
        list_tables_s = list_tables
        if s.capacity != r.capacity:
            list_tables_s = build_lane2_tables(
                list_t, _broadcast_plan(heavy_cap, s.capacity, depth=48,
                                        inline_k=1, out_capacity=out_capacity), key)
        s_heavy = _membership(list_tables_s, s, key)

    with span("tpq.skew.heavy"):
        # heavy path: R's heavy rows in a small table, probed by all of S
        r_heavy_small = compact(r, r_heavy).with_capacity(mini_cap)
        heavy_out_cap = out_capacity // 2
        mini_tables = build_lane2_tables(
            r_heavy_small, _broadcast_plan(mini_cap, s.capacity, depth=64,
                                           inline_k=8, out_capacity=heavy_out_cap),
            key)
        heavy_out, ok_heavy = lane2_probe_emit(mini_tables, s, heavy_out_cap,
                                               key=key, r_names=r_names,
                                               r_dtypes=r_dtypes)

    # in a graph the span runs on through the splice (skew_hash_join)
    with span("tpq.skew.light"):
        # light path: the partitioned lane join of the rest
        r_light, s_light = compact(r, ~r_heavy), compact(s, ~s_heavy)
        light_tables = build_lane2_tables(
            r_light, plan_lane2(r_light.capacity, s_light.capacity,
                                out_capacity=out_capacity), key)
        light_out, ok_light = lane2_probe_emit(light_tables, s_light, out_capacity,
                                               key=key, r_names=r_names,
                                               r_dtypes=r_dtypes)

    # s_heavy holds live rows only, so the heavy probe rows are the live
    # rows the light side did not keep: no reduction of its own, one
    # element-wise kernel per counter
    probe_rows = s.num_rows.to(I64)
    observe("tpq.skew.heavy_keys", n_heavy)
    observe("tpq.skew.heavy_probe_rows", probe_rows - s_light.num_rows)
    observe("tpq.skew.probe_rows", probe_rows)

    ok_splice = light_out.num_rows.to(I64) + heavy_out_cap <= out_capacity
    # tpq/ops/skew_join.py:165-167 lacks this guard and splices a heavy
    # buffer cut at its capacity; the port falls back there on purpose
    ok_heavy_rows = heavy_out.num_rows <= heavy_out_cap
    ok = (ok_nom & list_tables.ok & (r_heavy.sum() <= mini_cap)
          & mini_tables.ok & ok_heavy & ok_heavy_rows & ok_light & ok_splice)
    return light_out, heavy_out, ok


def skew_hash_join(r: Table, s: Table, out_capacity: int, key: str = "key",
                   heavy_cap: int = 2048, mini_cap: int = 4096,
                   stride: int = 16, sample_threshold: int = 16) -> Table:
    """Heavy/light split inner equi-join (module docstring), with the
    oracle's semantics. Rows go out light matches first, then heavy."""
    from tpq_torch.jit import cond
    from tpq_torch.ops.union_join import union_join

    attempt = marker()  # the split's spans, which the fallback discards
    light, heavy, ok = _split(r, s, out_capacity, key, heavy_cap, mini_cap,
                              stride, sample_threshold)

    def splice():
        # the whole heavy buffer at light.num_rows, written in place into
        # the light output's columns. `ok` guarantees room; under a graph
        # this runs whatever `ok` is, so the slots are clamped into the
        # buffer (no index past it; they differ only where `ok` is false)
        idx = (light.num_rows.to(I64)
               + torch.arange(heavy.capacity, device=light.device)
               ).clamp_max(out_capacity - 1)
        cols = {n: c.index_copy_(0, idx, heavy.col(n))
                for n, c in light.columns.items()}
        return Table(cols, light.num_rows + heavy.num_rows)

    # tpq's lax.cond(ok, splice, fallback) (tpq/ops/skew_join.py:182)
    return cond(ok, splice, lambda: union_join(r, s, out_capacity, key=key),
                name="tpq.skew.ok", attempt=attempt)


def skew_path_taken(r: Table, s: Table, out_capacity: int, key: str = "key",
                    heavy_cap: int = 2048, mini_cap: int = 4096,
                    stride: int = 16, sample_threshold: int = 16) -> torch.Tensor:
    """The `ok` flag skew_hash_join branches on: True iff the split
    handled the input without the union-sort fallback (bench honesty
    guard)."""
    return _split(r, s, out_capacity, key, heavy_cap, mini_cap, stride,
                  sample_threshold)[2]
