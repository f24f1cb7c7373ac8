#!/usr/bin/env python3
"""Smoke check of tpq_torch on one NVIDIA card (no JAX needed).

Phases, one line each; any failure raises and exits non-zero:
  1. device   — a CUDA card is required; prints nvidia-smi's name and
                power limit;
  2. build    — nvcc builds the kernels from tpq_torch/csrc;
  3. kernels  — PAD, PACK and the fused walk/emit, on the very arguments
                a config-1 lane join hands them, byte-equal to their
                plain torch versions, each timed beside its plain version;
  4. config1  — the 1M x 1M uniform join through the bench runner
                (hash_join(impl="lane")): the lane path taken, every
                kernel launched, num_rows equal to numpy's count and the
                rows byte-equal to the C++ oracle's; end-to-end ms, rows/s
                and the per-phase breakdown;
  5. fallback — an h2-colliding key pair clears `ok` and the lane join
                equals the sorted one.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.

Run from the repository root:  python3 chip_smoke.py
"""

import functools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
ORACLE_DIR = os.path.join(ROOT, "oracle", "build")


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def max_abs_err(pairs) -> int:
    """Largest |a - b| over tensor pairs (0 when byte-equal)."""
    err = 0
    for a, b in pairs:
        check(a.dtype == b.dtype and a.shape == b.shape,
              f"dtype/shape {a.dtype}{tuple(a.shape)} vs {b.dtype}{tuple(b.shape)}")
        if not torch.equal(a, b):
            err = max(err, int((a.double() - b.double()).abs().max().item()))
    return err


def record_kernel_calls(run):
    """Runs `run()` with the kernel wrappers on the lane path replaced by
    recorders; returns {wrapper name: [args, ...]} of what it received."""
    from tpq_torch.kernels import lane2, lane_table

    calls = {}
    patched = [(lane_table, "pad"), (lane_table, "pack"), (lane2, "fused_walk_emit")]
    saved = [getattr(m, n) for m, n in patched]

    def recorder(name, fn):
        # wraps copies `launches`: while patched, a wrapper's body counts
        # through its module-global name, which is now this recorder
        @functools.wraps(fn)
        def rec(*args):
            calls.setdefault(name, []).append(args)
            return fn(*args)
        return rec

    for (m, n), fn in zip(patched, saved):
        setattr(m, n, recorder(n, fn))
    try:
        run()
    finally:
        for (m, n), fn in zip(patched, saved):
            setattr(m, n, fn)
    return calls


def kernel_phase(dev, cfg, iters=20):
    from tpq_torch.bench.runner import cuda_time, gen, out_capacity_for
    from tpq_torch.kernels.lane2 import (fused_walk_emit, fused_walk_emit_ref,
                                         lane2_hash_join)
    from tpq_torch.kernels.move import pack, pack_ref, pad, pad_ref

    r, s = gen(cfg.r, dev), gen(cfg.s, dev)
    out_cap = out_capacity_for(cfg)
    calls = record_kernel_calls(lambda: lane2_hash_join(r, s, out_cap))
    for _ in range(3):  # clocks and the caching allocator settle first
        lane2_hash_join(r, s, out_cap)
    check(set(calls) == {"pad", "pack", "fused_walk_emit"},
          f"config 1 reached kernels {sorted(calls)}")
    check(len(calls["pad"]) == 3, "expected build, probe and tail-window PAD calls")

    def ms(fn, n):
        return cuda_time(fn, dev, n)[0] * 1e3

    def paired(kernel, plain, n_plain):
        """(kernel ms, plain ms), each the mean of two timings taken in
        turns: plain, kernel, kernel, plain."""
        p1, k1, k2, p2 = (ms(plain, n_plain), ms(kernel, iters),
                          ms(kernel, iters), ms(plain, n_plain))
        return (k1 + k2) / 2, (p1 + p2) / 2

    records = {}
    pad_errs = []
    for label, args in zip(("build", "probe", "tail window"), calls["pad"]):
        cols, dest, n_live, out_len = args
        got, want = pad(*args), pad_ref(*args)
        err = max_abs_err(list(zip(got[0], want[0])) + [(got[1], want[1])])
        pad_errs.append(err)
        t_k, t_p = paired(lambda: pad(*args), lambda: pad_ref(*args), 5)
        phase("kernels", f"pad ({label}): {len(cols)} cols x {dest.shape[0]} rows "
                         f"-> {out_len}; max_abs_err {err}; kernel {t_k:.4f} ms, "
                         f"plain {t_p:.4f} ms")
        if label == "build":
            records["pad"] = (t_k, t_p)
    check(max(pad_errs) == 0, "PAD differs from its plain version")

    (args,) = calls["pack"]
    got, want = pack(*args), pack_ref(*args)
    pack_err = max_abs_err(list(zip(got[0], want[0])) + [(got[1], want[1])])
    t_k, t_p = paired(lambda: pack(*args), lambda: pack_ref(*args), 5)
    records["pack"] = (t_k, t_p)
    phase("kernels", f"pack (tail): {len(args[0])} col x {args[1].shape[0]} rows, "
                     f"total {int(got[1])}; max_abs_err {pack_err}; kernel "
                     f"{t_k:.4f} ms, plain {t_p:.4f} ms")
    check(pack_err == 0, "PACK differs from its plain version")

    (args,) = calls["fused_walk_emit"]
    tables, qk, lane, qocc, spays, cap = args
    (outs, cnt, d_first), (routs, rcnt, rdf) = (fused_walk_emit(*args),
                                                 fused_walk_emit_ref(*args))
    n = min(int(cnt.clamp_max(tables.plan.inline_k).sum()), cap)
    walk_err = max_abs_err([(cnt, rcnt), (d_first, rdf)]
                           + [(a[:n], b[:n]) for a, b in zip(outs, routs)])
    t_k, t_p = paired(lambda: fused_walk_emit(*args),
                      lambda: fused_walk_emit_ref(*args), 3)
    records["fused_walk_emit"] = (t_k, t_p)
    phase("kernels", f"fused_walk_emit: u={qk.shape[0]} queries, {n} inline rows "
                     f"of {cap}; max_abs_err {walk_err}; kernel {t_k:.4f} ms, "
                     f"plain {t_p:.4f} ms")
    check(walk_err == 0, "fused walk/emit differs from its plain version")
    return records, {"pad": max(pad_errs), "pack": pack_err,
                     "fused_walk_emit": walk_err}


def oracle_rows(r_np, s_np):
    """The C++ oracle's canonical join of the two relations."""
    from tpq_torch import colio

    os.makedirs(ORACLE_DIR, exist_ok=True)
    exe = os.path.join(ORACLE_DIR, "oracle_smoke")
    subprocess.run(["g++", "-std=c++17", "-O2", "-o", exe,
                    os.path.join(ROOT, "oracle", "main.cc")], check=True)
    paths = [os.path.join(ORACLE_DIR, f"smoke_{x}.tpqc") for x in ("r", "s", "out")]
    colio.dump(paths[0], r_np)
    colio.dump(paths[1], s_np)
    subprocess.run([exe, "join", "--algo=hash", f"--left={paths[0]}",
                    f"--right={paths[1]}", f"--out={paths[2]}"], check=True)
    out = colio.load(paths[2])
    for p in paths:
        os.remove(p)
    return out


def config1_phase(dev, cfg):
    from tpq_torch import datagen
    from tpq_torch.bench.runner import phase_report, run_config
    from tpq_torch.columnar import canonicalize, tables_equal
    from tpq_torch.kernels.lane2 import fused_walk_emit
    from tpq_torch.kernels.move import pack, pad

    wrappers = {"pad": pad, "pack": pack, "fused_walk_emit": fused_walk_emit}
    for w in wrappers.values():
        w.launches = 0
    report = run_config(cfg, device=dev)
    launches = {k: w.launches for k, w in wrappers.items()}
    op = report["ops"][0]
    phase("config1", f"{op['op']}: launches {launches}")
    check(op["op"] == "join_hash_lane", f"lane path not taken: {op['op']}")
    check(all(v > 0 for v in launches.values()), f"a kernel never ran: {launches}")

    r_np = datagen.gen_relation_np(cfg.r.rows, cfg.r.nkeys, cfg.r.payloads, cfg.r.seed)
    s_np = datagen.gen_relation_np(cfg.s.rows, cfg.s.nkeys, cfg.s.payloads, cfg.s.seed)
    true_rows = int((np.bincount(r_np["key"], minlength=cfg.r.nkeys).astype(np.int64)
                     * np.bincount(s_np["key"], minlength=cfg.r.nkeys)).sum())
    out = report["output"]
    check(report["out_rows"] == true_rows,
          f"num_rows {report['out_rows']} != numpy's {true_rows}")
    check(tables_equal(canonicalize(out), oracle_rows(r_np, s_np)),
          "output differs from the C++ oracle")
    phase("config1", f"num_rows {true_rows} == numpy count; canonical rows "
                     f"byte-equal to the C++ oracle")
    phase("config1", f"end_to_end {op['elapsed_ms']:.4f} ms, "
                     f"{op['rows_per_sec']:.6e} probe rows/s, measured HBM "
                     f"{report['hbm_bw_gbps']:.1f} GB/s, roofline "
                     f"{op['roofline_pct']:.2f}% (byte model {op['model_bytes']} B)")
    phases = phase_report(cfg, device=dev)
    phase("config1", "phases (ms): " + ", ".join(
        f"{p['phase']} {p['ms']:.4f}" for p in phases))
    return launches


def fallback_phase(dev):
    from tpq_torch import Table
    from tpq_torch.columnar import canonicalize, tables_equal
    from tpq_torch.kernels.lane2 import lane2_path_taken
    from tpq_torch.ops import hash_join

    k1, k2 = 7302945295039616556, 3449075177175606448  # same (bucket, h2)
    R = Table.from_numpy({"key": np.array([k1, k2, 5, 6, 7], dtype=np.int64),
                          "p0": np.arange(5, dtype=np.int64)}, device=dev)
    S = Table.from_numpy({"key": np.array([k1, k2, k1, 6], dtype=np.int64),
                          "p0": np.arange(4, dtype=np.int64) * 10}, device=dev)
    check(not bool(lane2_path_taken(R, S, 1 << 8)), "h2 collision kept `ok`")
    a = hash_join(R, S, 1 << 8, impl="lane")
    b = hash_join(R, S, 1 << 8, impl="sorted")
    check(int(a.num_rows) == int(b.num_rows) == 4, "fallback row count")
    check(tables_equal(canonicalize(a), canonicalize(b)), "fallback rows differ")
    phase("fallback", "h2 collision: ok=False, lane join == sorted join (4 rows)")


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA card visible; this check runs only on a card")
    sys.path.insert(0, ROOT)
    from tpq_torch.bench.runner import card_info
    from tpq_torch.config import PRESETS
    from tpq_torch.kernels import _build

    dev = torch.device("cuda:0")
    card = card_info()
    print(card, flush=True)
    phase("device", f"{torch.cuda.get_device_name(dev)}; torch {torch.__version__}, "
                    f"CUDA {torch.version.cuda}; {card}")

    t0 = time.perf_counter()
    secs = _build.build(force=True)
    _build.lib()
    phase("build", f"nvcc built {os.path.relpath(_build.SO, ROOT)} from "
                   f"{len(_build.sources())} sources in {secs:.1f} s "
                   f"({time.perf_counter() - t0:.1f} s with loading)")

    cfg = PRESETS["single_chip_1m"]
    times, errs = kernel_phase(dev, cfg)
    launches = config1_phase(dev, cfg)
    fallback_phase(dev)

    meta = {
        "pad": ("tpq_torch/csrc/move.cu", "tpq/kernels/move.py:117"),
        "pack": ("tpq_torch/csrc/move.cu", "tpq/kernels/move.py:242"),
        "fused_walk_emit": ("tpq_torch/csrc/lane2.cu", "tpq/kernels/lane2.py:223"),
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name, (src, rep) in meta.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
