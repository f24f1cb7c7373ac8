"""Kernel wrappers of two trees of the repository, timed in turns on the
same arguments on one card.

Runs one join of each preset with this tree's code. Every call the join
makes to PAD, PACK, the fused walk/emit, the walk-only probe or the
bucket histogram is also handed to the other tree's wrapper
(`--before`), whose outputs must be byte-equal to this tree's (the
walk/emit's below its emitted rows), and both wrappers are timed on its
arguments in turns, before, after, after, before:
  - `device_ms`: calls queued behind a spin of the stream, the card alone
    (runner.device_time), every device operation of the call included;
  - `host_ms`: the same calls on the host's clock, wrapper entry to
    return, while the card is busy;
  - `ms`: back to back, host and card together (runner.cuda_time).
Prints one JSON line per named call (config 1's build, probe and
tail-window PAD and its tail PACK, and the walk-only probe at its tables,
on no join's path; config 3's nomination PACK and its two membership
probes; the planner's first histogram and the largest PAD and
PACK of the planned config-5 join) and one per preset and kernel with
the sums over every call of its join.

CLI (needs a card):
  python -m tpq_torch.bench.kernel_ab --before=DIR \\
      [--config=single_chip_1m --config=zipf_skew ...] [--out=FILE]
(the parent commit unpacked with `git archive` into a git-ignored
directory makes a `before` tree; its kernels are built there)
"""

from __future__ import annotations

import argparse
import functools
import importlib
import json
import os
import sys

import torch

from tpq_torch.bench.ab import ORDER

N_CALLS = 10  # calls per timing
CONFIGS = ("single_chip_1m", "zipf_skew", "dist_125m_8shard")
# kernel -> (module under tpq_torch.kernels, wrapper)
KERNELS = {"pad": ("move", "pad"), "pack": ("move", "pack"),
           "fused_walk_emit": ("lane2", "fused_walk_emit"),
           "probe_walk": ("lane_table", "probe_walk"),
           "radix_histogram": ("radix_partition", "radix_histogram")}
# the calls named in the output: (preset, kernel, index in the join) -> label
NAMED = {("single_chip_1m", "pad", 0): "config-1 build",
         ("single_chip_1m", "pad", 1): "config-1 probe layout",
         ("single_chip_1m", "pad", 2): "config-1 tail window",
         ("single_chip_1m", "pack", 0): "config-1 tail",
         ("single_chip_1m", "fused_walk_emit", 0): "config 1",
         ("zipf_skew", "fused_walk_emit", 0): "config-3 heavy mini table",
         ("pipeline_100m", "fused_walk_emit", 0): "config-4 pipeline",
         ("single_chip_1m", "probe_walk", 0): "config-1 tables, config-1 S",
         ("zipf_skew", "pack", 0): "config-3 nomination",
         ("zipf_skew", "probe_walk", 0): "config-3 membership of R",
         ("zipf_skew", "probe_walk", 1): "config-3 membership of S",
         ("dist_125m_8shard", "radix_histogram", 0): "planner, shard 0 of R"}


def _own_modules() -> dict:
    return {k: m for k, m in sys.modules.items()
            if k == "tpq_torch" or k.startswith("tpq_torch.")}


def load_tree(root: str) -> dict:
    """{kernel: wrapper} of the tree at `root`, imported beside this
    tree's: this tree's tpq_torch modules are set aside while its modules
    load and put back after. They keep their own _build, and so their
    own kernel library, built here from that tree's sources."""
    saved = _own_modules()
    for k in saved:
        del sys.modules[k]
    sys.path.insert(0, root)
    try:
        mods = {m: importlib.import_module(f"tpq_torch.kernels.{m}")
                for m, _ in KERNELS.values()}
        mods["move"]._build.build(force=True)
        mods["move"]._build.lib()
    finally:
        sys.path.remove(root)
        for k in _own_modules():
            del sys.modules[k]
        sys.modules.update(saved)
    for m in mods.values():
        if not os.path.abspath(m.__file__).startswith(root + os.sep):
            raise RuntimeError(f"loaded {m.__file__}, not the tree at {root}")
    return {k: getattr(mods[m], fn) for k, (m, fn) in KERNELS.items()}


def size(name: str, args) -> int:
    """What picks a join's largest call: PAD's and PACK's output slots
    times row width, the probe's padded queries, the histogram's ids."""
    if name == "pad":
        return args[3] * sum(c.element_size() for c in args[0])
    if name == "pack":
        return args[1].shape[0] * sum(c.element_size() for c in args[0])
    return args[1].shape[0] if name in ("probe_walk", "fused_walk_emit") \
        else args[0].shape[0]


def describe(name: str, args) -> str:
    if name == "pad":
        cols, dest, _, out_len = args
        return f"{len(cols)} cols x {dest.shape[0]} rows -> {out_len}"
    if name == "pack":
        cols, occ = args
        return f"{len(cols)} cols x {occ.shape[0]} rows"
    if name in ("probe_walk", "fused_walk_emit"):
        plan = args[0].plan
        return (f"npart {plan.npart}, D {plan.depth}, K {plan.inline_k}, "
                f"{len(args[0].pays)} payload cols, u={args[1].shape[0]}")
    return f"{args[0].shape[0]} ids into {args[1]} buckets"


def same(a, b) -> bool:
    """Byte equality of two outputs: tensors, or lists and tuples of them."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))


def same_call(name: str, args, a, b) -> bool:
    """Byte equality of two trees' outputs of one call; the walk/emit's
    rows past the emitted ones are unspecified."""
    if name != "fused_walk_emit":
        return same(a, b)
    n = min(int(a[1].clamp_max(args[0].plan.inline_k).sum()), args[-1])
    return same(a[1:], b[1:]) and same([x[:n] for x in a[0]], [x[:n] for x in b[0]])


def time_pair(fns: dict, device) -> dict:
    """{tree: {ms, device_ms, host_ms}}, each the mean of its two turns."""
    from tpq_torch.bench.runner import cuda_time, device_time

    out = {tree: {"ms": 0.0, "device_ms": 0.0, "host_ms": 0.0} for tree in fns}
    for tree in ORDER:
        dev_s, host_s = device_time(fns[tree], device, N_CALLS)
        b2b_s = cuda_time(fns[tree], device, N_CALLS)[0]
        for k, v in (("ms", b2b_s), ("device_ms", dev_s), ("host_ms", host_s)):
            out[tree][k] += v * 1e3 / 2
    return out


def hooked_join(join, trees: dict, device) -> list[dict]:
    """Runs join() with every call of the kernels also made, checked and
    timed on both trees' wrappers; returns one record per call."""
    from tpq_torch.kernels import lane2, lane_table, radix_partition
    from tpq_torch.ops import filter as filter_op
    from tpq_torch.ops import skew_join

    records, counts = [], {}

    def hook(name):
        # wraps copies `launches`: while patched, a wrapper's body counts
        # through its module-global name, which may be this hook
        @functools.wraps(trees["after"][name])
        def call(*args):
            got = trees["after"][name](*args)
            if not same_call(name, args, got, trees["before"][name](*args)):
                raise RuntimeError(f"{name}: the two trees' outputs differ")
            idx = counts[name] = counts.get(name, -1) + 1
            times = time_pair({t: (lambda w=w: w[name](*args)) for t, w in trees.items()},
                              device)
            records.append({"kernel": name, "index": idx, "call": describe(name, args),
                            "size": size(name, args), **times})
            return got
        return call

    patched = [(lane_table, "pad"), (lane_table, "pack"), (skew_join, "pack"),
               (filter_op, "pack"), (lane2, "fused_walk_emit"),
               (lane_table, "probe_walk"), (radix_partition, "radix_histogram")]
    saved = [getattr(m, n) for m, n in patched]
    for m, n in patched:
        setattr(m, n, hook(n))
    try:
        join()
    finally:
        for (m, n), fn in zip(patched, saved):
            setattr(m, n, fn)
    return records


def preset_join(config: str, device):
    """One join of the preset through its entry point, eager (the
    kernel wrappers run, and are recorded, at every call), as
    chip_smoke.py drives it."""
    from tpq_torch.bench.profile import dist_join_fn
    from tpq_torch.bench.runner import gen, join_fn, out_capacity_for
    from tpq_torch.config import PRESETS

    cfg = PRESETS[config]
    if cfg.mesh_shape:
        return dist_join_fn(cfg, device, eager=True)[0]
    r, s = gen(cfg.r, device), gen(cfg.s, device)
    return join_fn(cfg, r, s, out_capacity_for(cfg)).eager


def config1_tables_probe(device):
    """The walk-only probe at config 1's tables (D 48, K 4, one payload)
    probed by config 1's S, as chip_smoke.py times it: on no join's path,
    the probe's case with payloads."""
    from tpq_torch.bench.runner import gen, out_capacity_for
    from tpq_torch.config import PRESETS
    from tpq_torch.kernels.lane2 import build_lane2_tables, plan_lane2
    from tpq_torch.kernels.lane_table import probe_lane_tables

    cfg = PRESETS["single_chip_1m"]
    r, s = gen(cfg.r, device), gen(cfg.s, device)
    tables = build_lane2_tables(r, plan_lane2(r.capacity, s.capacity,
                                              out_capacity=out_capacity_for(cfg)))
    return lambda: probe_lane_tables(tables, s)


def summarize(config: str, records: list[dict]) -> list[dict]:
    rows = []
    for name in KERNELS:
        mine = [r for r in records if r["kernel"] == name]
        if not mine:
            continue
        named = {i: lab for (c, k, i), lab in NAMED.items() if c == config and k == name}
        largest = max(mine, key=lambda r: r["size"])
        for r in mine:
            label = named.get(r["index"])
            if (label is None and config == "dist_125m_8shard" and r is largest
                    and name in ("pad", "pack")):
                label = "largest config-5 call"
            if label is not None:
                rows.append({"config": config, "label": label, **r})
        rows.append({"config": config, "kernel": name, "label": "sum over one join",
                     "calls": len(mine),
                     **{tree: {k: sum(r[tree][k] for r in mine)
                               for k in ("ms", "device_ms", "host_ms")}
                        for tree in ("before", "after")}})
    return rows


def main(argv=None):
    from tpq_torch.bench.runner import card_info
    from tpq_torch.kernels import _build

    p = argparse.ArgumentParser()
    p.add_argument("--before", required=True)
    p.add_argument("--config", action="append", default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    device = torch.device("cuda:0")
    print(card_info(), flush=True)
    _build.build(force=True)
    _build.lib()
    after = {k: getattr(importlib.import_module(f"tpq_torch.kernels.{m}"), fn)
             for k, (m, fn) in KERNELS.items()}
    trees = {"before": load_tree(os.path.abspath(args.before)), "after": after}
    rows, every = [], []
    for config in args.config or CONFIGS:
        join = preset_join(config, device)
        join()  # the allocator and the clocks settle
        records = hooked_join(join, trees, device)
        if config == "single_chip_1m":  # its probe alone: its PAD is no join's
            records += [r for r in hooked_join(config1_tables_probe(device), trees, device)
                        if r["kernel"] == "probe_walk"]
        every += [{"config": config, **r} for r in records]
        for row in summarize(config, records):
            print(json.dumps(row), flush=True)
            rows.append(row)
        del join
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card_info(), "named": rows, "calls": every}, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
