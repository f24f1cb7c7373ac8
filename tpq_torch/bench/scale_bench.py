"""Configs 2 and 4 at full scale, chunked (port of
tpq/bench/scale_bench.py bench_build_sweep and bench_pipeline).

Both benches:
  * make their relations on the device (datagen.gen_relation_device,
    byte-equal to the numpy streams and the oracle's);
  * build the lane tables once, then stream the probe side through the
    lane probe and emit (lane2_probe_emit) in chunks of `chunk_rows`,
    with tpq's chunk sizes and capacity rules, so that both compute what
    tpq's compute;
  * check the result against numpy ground truth from the same streams:
    the join's count for config 2, every group's count and sums for
    config 4;
  * report whether every chunk took the lane path
    (`lane_path_taken_all_chunks`).

Times exist only for a run on a card (host clock around work that ends
in a synchronize; the chunks' generation on the card is inside it, the
ground truth is not); on the CPU the benches run and check, and report
no time.

CLI (needs a card):
  python -m tpq_torch.bench.scale_bench pipeline   # config 4, 100M fact rows
  python -m tpq_torch.bench.scale_bench sweep      # config 2, 10M x 100M
      [--json-out=FILE]
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from tpq_torch import datagen
from tpq_torch.bench import roofline
from tpq_torch.columnar import Table, next_pow2
from tpq_torch.kernels.lane2 import build_lane2_tables, lane2_probe_emit, plan_lane2
from tpq_torch.kernels.move import pad
from tpq_torch.ops.filter import compact, keep_mask
from tpq_torch.ops.hash_aggregate import hash_aggregate

I64 = torch.int64


def _now(dev: torch.device):
    """Host seconds once the card's queued work is done (a synchronize);
    None on the CPU, where no device time is measured."""
    if dev.type != "cuda":
        return None
    torch.cuda.synchronize(dev)
    return time.perf_counter()


def _since(t0, dev: torch.device):
    return None if t0 is None else _now(dev) - t0


def _speed(report: dict, rows: int, rows_key: str, model_bytes: int, hbm_bw) -> None:
    """Adds the rates of a timed run to its report (nothing on the CPU)."""
    ms = report["elapsed_ms"]
    if ms is None:
        return
    report[rows_key] = rows / (ms / 1e3)
    sol_ms = model_bytes / (hbm_bw * 1e9) * 1e3
    report["sol_ms"] = sol_ms
    report["roofline_pct"] = 100.0 * sol_ms / ms


def _consume(t: Table) -> torch.Tensor:
    """A reduction over every output column's live rows, so that each
    column is read: an int64 xor of the wrapping sums. (tpq sums i32
    planes by bitcast because v5e has no fast i64 vector ALU; the card
    sums int64 natively.)"""
    mask = t.valid_mask()
    acc = t.num_rows.to(I64)
    for c in t.columns.values():
        acc = acc ^ torch.where(mask, c.to(I64), 0).sum()
    return acc


def bench_build_sweep(n_build: int = 10_000_000, n_probe: int = 100_000_000,
                      payloads: int = 4, chunk_rows: int = 1 << 24,
                      device="cuda", log=print) -> dict:
    """Config 2: 10M x 100M, 4 payload columns, the probe side streamed in
    chunks against tables built once."""
    dev = torch.device(device)
    hbm_bw = roofline.measure_hbm_bw(device=dev) if dev.type == "cuda" else None
    r_cap = next_pow2(n_build)
    R = datagen.gen_relation_device(n_build, n_build, payloads, seed=1,
                                    capacity=r_cap, device=dev)
    # ~1 match per probe row at these key domains, 1.25x slack
    out_cap = chunk_rows + chunk_rows // 4
    plan = plan_lane2(r_cap, chunk_rows, out_capacity=out_cap)
    r_names = [n for n in R.names if n != "key"]
    r_dtypes = [R.col(n).dtype for n in r_names]
    nchunks = -(-n_probe // chunk_rows)

    def probe_chunk(tables, ci):
        s = datagen.gen_relation_device(
            min(chunk_rows, n_probe - ci * chunk_rows), n_build, payloads, seed=2,
            capacity=chunk_rows, row_offset=ci * chunk_rows, device=dev)
        out, ok = lane2_probe_emit(tables, s, out_cap, r_names=r_names,
                                   r_dtypes=r_dtypes)
        return out.num_rows.to(I64), _consume(out), ok

    probe_chunk(build_lane2_tables(R, plan), 0)  # warm-up, off the clock

    t0 = _now(dev)
    tables = build_lane2_tables(R, plan)
    t_build = _since(t0, dev)

    t0 = _now(dev)
    total = torch.zeros((), dtype=I64, device=dev)
    acc = torch.zeros((), dtype=I64, device=dev)
    oks = []
    for ci in range(nchunks):
        rows_c, acc_c, ok = probe_chunk(tables, ci)
        total, acc = total + rows_c, acc ^ acc_c
        oks.append(ok)
    total = int(total)
    t_probe = _since(t0, dev)
    elapsed = None if t_probe is None else t_probe + t_build

    report = {
        "config": "build_sweep_10m_100m", "device": _device_name(dev),
        "n_build": n_build, "n_probe": n_probe, "payloads": payloads,
        "nchunks": nchunks, "chunk_rows": chunk_rows,
        "elapsed_ms": None if elapsed is None else elapsed * 1e3,
        "build_ms": None if t_build is None else t_build * 1e3,
        "out_rows": total,
        "lane_path_taken_all_chunks": all(bool(o) for o in oks),
        "hbm_bw_gbps": hbm_bw,
    }
    ncols = payloads + 1
    bm = roofline.hash_join_bytes(r_cap, ncols, nchunks * chunk_rows, ncols,
                                  nchunks * out_cap)
    _speed(report, n_probe, "probe_rows_per_sec", sum(b.total for b in bm.values()),
           hbm_bw)

    cr = np.bincount(datagen.uniform_keys(n_build, n_build, seed=1),
                     minlength=n_build).astype(np.int64)
    cs = np.bincount(datagen.uniform_keys(n_probe, n_build, seed=2),
                     minlength=n_build).astype(np.int64)
    expected = int((cr * cs).sum())
    report["expected_rows"] = expected
    report["count_exact"] = expected == total
    if not report["count_exact"]:
        raise RuntimeError(f"config 2: {total} join rows, numpy counts {expected}")
    log(report)
    return report


@functools.lru_cache(maxsize=2)
def pipeline_truth(n_dim: int, n_fact: int, fact_payloads: int,
                   filter_value: int) -> dict[str, np.ndarray]:
    """Config 4's groups from the numpy streams (dim seed 1 with one
    payload, fact seed 2, both keyed over n_dim): filter key <
    filter_value, join, aggregate, as tpq's bench checks them. Columns
    key, count, sum_r_p0, sum_s_p<j>, in ascending key order; sums wrap
    in int64."""
    fk = datagen.uniform_keys(n_fact, n_dim, seed=2)
    pays = datagen.payload_cols(n_fact, fact_payloads, seed=2)
    dk = datagen.uniform_keys(n_dim, n_dim, seed=1)
    dp = datagen.payload_cols(n_dim, 1, seed=1)
    keep = fk < filter_value
    fk2 = fk[keep]
    dmult = np.bincount(dk, minlength=n_dim).astype(np.int64)
    dsum = np.zeros(n_dim, np.int64)
    np.add.at(dsum, dk, dp["p0"])
    cnt = np.zeros(n_dim, np.int64)
    np.add.at(cnt, fk2, dmult[fk2])
    sum_r = np.zeros(n_dim, np.int64)
    np.add.at(sum_r, fk2, dsum[fk2])
    live = cnt > 0
    out = {"key": np.nonzero(live)[0].astype(np.int64), "count": cnt[live],
           "sum_r_p0": sum_r[live]}
    for j in range(fact_payloads):
        v = np.zeros(n_dim, np.int64)
        with np.errstate(over="ignore"):
            np.add.at(v, fk2, pays[f"p{j}"][keep] * dmult[fk2])
        out[f"sum_s_p{j}"] = v[live]
    return out


def groups_equal(got: dict[str, np.ndarray], want: dict[str, np.ndarray]) -> bool:
    """Host group columns equal, by name, after ordering `got` by key."""
    order = np.argsort(got["key"], kind="stable")
    return all(np.array_equal(got[n][order], want[n]) for n in want)


def bench_pipeline(n_dim: int = 1 << 20, n_fact: int = 100_000_000,
                   fact_payloads: int = 2, chunk_rows: int = 1 << 22,
                   filter_value: int = 1 << 19, device="cuda", log=print) -> dict:
    """Config 4 chunked: filter -> hash join -> hash aggregate over the
    fact table, a chunk at a time:

      * the filter is pushed down into the probe layout
        (lane2_probe_emit(keep=...), query.py's fusion);
      * each chunk's groups land in a dense [next_pow2(filter_value)]
        accumulator: after `key < filter_value` every group key is a slot,
        and a chunk's aggregate emits ascending unique keys, so PAD places
        them at their slots and int64 adds fold them in (tpq's u32
        carry-chain adds become native int64 adds, which wrap);
      * finalize compacts the accumulator's groups with PACK.
    """
    dev = torch.device(device)
    hbm_bw = roofline.measure_hbm_bw(device=dev) if dev.type == "cuda" else None
    dim_cap = next_pow2(n_dim)
    dim = datagen.gen_relation_device(n_dim, n_dim, 1, seed=1, capacity=dim_cap,
                                      device=dev)
    # ~live_frac of the fact rows pass the filter: the probe layout is
    # sized for the filtered mass (25% margin before plan_lane2's own
    # 1.5x), the emit buffer for ~1 match per passing row (1.5x slack)
    live_frac = min(1.0, filter_value / n_dim)
    out_cap = max(1 << 13, int(chunk_rows * live_frac * 3 // 2))
    eff_s_cap = max(1 << 12, int(chunk_rows * min(1.0, live_frac * 1.25)))
    plan = plan_lane2(dim_cap, eff_s_cap, out_capacity=out_cap)
    r_names = [n for n in dim.names if n != "key"]
    r_dtypes = [dim.col(n).dtype for n in r_names]
    n_state = next_pow2(min(filter_value, n_dim))
    vnames = (["count"] + [f"sum_r_{n}" for n in r_names]
              + [f"sum_s_p{j}" for j in range(fact_payloads)])
    nchunks = -(-n_fact // chunk_rows)

    def chunk_step(tables, state, ci):
        fact = datagen.gen_relation_device(
            min(chunk_rows, n_fact - ci * chunk_rows), n_dim, fact_payloads, seed=2,
            capacity=chunk_rows, row_offset=ci * chunk_rows, device=dev)
        keep = keep_mask(fact, "key", "lt", filter_value)
        out, ok = lane2_probe_emit(tables, fact, out_cap, r_names=r_names,
                                   r_dtypes=r_dtypes, keep=keep)
        agg = hash_aggregate(Table(out.columns, out.num_rows.clamp_max(out_cap)))
        dest = agg.col("key").clamp(0, n_state - 1).to(torch.int32)
        padded, _ = pad([agg.col(n) for n in vnames], dest, agg.num_rows, n_state)
        return [a + b for a, b in zip(state, padded)], ok

    def finalize(state):
        cols = {"key": torch.arange(n_state, dtype=I64, device=dev),
                **dict(zip(vnames, state))}
        return compact(Table(cols, n_state), state[0] > 0)

    def state0():
        return [torch.zeros(n_state, dtype=I64, device=dev) for _ in vnames]

    tables = build_lane2_tables(dim, plan)  # warm-up, off the clock
    finalize(chunk_step(tables, state0(), 0)[0])
    del tables

    t0 = _now(dev)
    tables = build_lane2_tables(dim, plan)
    t_build = _since(t0, dev)

    t0 = _now(dev)
    state, oks = state0(), []
    for ci in range(nchunks):
        state, ok = chunk_step(tables, state, ci)
        oks.append(ok)
    final = finalize(state)
    groups = int(final.num_rows)
    t_run = _since(t0, dev)
    elapsed = None if t_run is None else t_run + t_build

    report = {
        "config": "pipeline_100m", "device": _device_name(dev),
        "n_dim": n_dim, "n_fact": n_fact, "nchunks": nchunks,
        "chunk_rows": chunk_rows,
        "elapsed_ms": None if elapsed is None else elapsed * 1e3,
        "build_ms": None if t_build is None else t_build * 1e3,
        "groups": groups,
        "join_rows": int(final.col("count")[:groups].sum()),
        "lane_path_taken_all_chunks": all(bool(o) for o in oks),
        "hbm_bw_gbps": hbm_bw,
    }
    nf = fact_payloads + 1
    model = (roofline.filter_bytes(nchunks * chunk_rows, nf).total
             + sum(b.total for b in roofline.hash_join_bytes(
                 dim_cap, 2, nchunks * chunk_rows, nf, nchunks * out_cap).values())
             + roofline.aggregate_bytes(nchunks * out_cap, 4).total)
    _speed(report, n_fact, "fact_rows_per_sec", model, hbm_bw)

    got = {n: c[:groups].cpu().numpy() for n, c in final.columns.items()}
    want = pipeline_truth(n_dim, n_fact, fact_payloads, filter_value)
    report["groups_exact"] = groups == len(want["key"]) and groups_equal(got, want)
    if not report["groups_exact"]:
        raise RuntimeError(f"config 4: {groups} groups differ from numpy's "
                           f"{len(want['key'])}")
    log(report)
    return report


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)


def main(argv=None):
    import argparse
    import json
    import sys

    p = argparse.ArgumentParser()
    p.add_argument("which", choices=["sweep", "pipeline"])
    p.add_argument("--json-out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("tpq_torch.bench.scale_bench measures on a CUDA card; none is visible")
    from tpq_torch.bench.runner import card_info

    if args.which == "sweep":
        rep = bench_build_sweep(log=lambda _: None)
    else:
        rep = bench_pipeline(log=lambda _: None)
    rep["card"] = card_info()
    print(json.dumps(rep))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rep, f, indent=2)
    return rep


if __name__ == "__main__":
    main()
