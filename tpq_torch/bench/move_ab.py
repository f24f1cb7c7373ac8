"""PAD and PACK of two trees of the repository, timed in turns on the
same arguments on one card.

Runs one join of each preset with this tree's code. Every PAD and PACK
call the join makes is also handed to the other tree's wrapper
(`--before`), whose outputs must be byte-equal to this tree's, and both
wrappers are timed on its arguments in turns, before, after, after,
before:
  - `device_ms`: calls queued behind a spin of the stream, the card alone
    (runner.device_time), every device operation of the call included;
  - `host_ms`: the same calls on the host's clock, wrapper entry to
    return, while the card is busy;
  - `ms`: back to back, host and card together (runner.cuda_time).
Prints one JSON line per named call (config 1's build, probe and
tail-window PAD and its tail PACK; config 3's nomination PACK; the
largest PAD and PACK of the planned config-5 join) and one per preset
with the sums over every PAD and PACK call of its join.

CLI (needs a card):
  python -m tpq_torch.bench.move_ab --before=DIR \\
      [--config=single_chip_1m --config=zipf_skew ...] [--out=FILE]
(the parent commit unpacked with `git archive` into a git-ignored
directory makes a `before` tree; its kernels are built there)
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

import torch

from tpq_torch.bench.ab import ORDER

N_CALLS = 10  # calls per timing
CONFIGS = ("single_chip_1m", "zipf_skew", "dist_125m_8shard")
# the calls named in the output: (preset, kernel, index in the join) -> label
NAMED = {("single_chip_1m", "pad", 0): "config-1 build",
         ("single_chip_1m", "pad", 1): "config-1 probe layout",
         ("single_chip_1m", "pad", 2): "config-1 tail window",
         ("single_chip_1m", "pack", 0): "config-1 tail",
         ("zipf_skew", "pack", 0): "config-3 nomination"}


def _own_modules() -> dict:
    return {k: m for k, m in sys.modules.items()
            if k == "tpq_torch" or k.startswith("tpq_torch.")}


def load_move(root: str):
    """tpq_torch.kernels.move of the tree at `root`, imported beside this
    tree's: this tree's tpq_torch modules are set aside while it loads and
    put back after. The module keeps its own _build, and so its own kernel
    library, built here from that tree's sources."""
    saved = _own_modules()
    for k in saved:
        del sys.modules[k]
    sys.path.insert(0, root)
    try:
        move = importlib.import_module("tpq_torch.kernels.move")
        move._build.build(force=True)
        move._build.lib()
    finally:
        sys.path.remove(root)
        for k in _own_modules():
            del sys.modules[k]
        sys.modules.update(saved)
    if not os.path.abspath(move.__file__).startswith(root + os.sep):
        raise RuntimeError(f"loaded {move.__file__}, not the tree at {root}")
    return move


def size(name: str, args) -> int:
    """Output slots times row width: what picks a join's largest call."""
    slots = args[3] if name == "pad" else args[1].shape[0]
    return slots * sum(c.element_size() for c in args[0])


def describe(name: str, args) -> str:
    if name == "pad":
        cols, dest, _, out_len = args
        return f"{len(cols)} cols x {dest.shape[0]} rows -> {out_len}"
    cols, occ = args
    return f"{len(cols)} cols x {occ.shape[0]} rows"


def same(a, b) -> bool:
    (oa, xa), (ob, xb) = a, b
    return all(torch.equal(p, q) for p, q in zip(oa, ob)) and torch.equal(xa, xb)


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
    """Runs join() with every PAD and PACK call also made, checked and
    timed on both trees' wrappers; returns one record per call."""
    from tpq_torch.kernels import lane_table
    from tpq_torch.ops import filter as filter_op
    from tpq_torch.ops import skew_join

    records, counts = [], {}

    def hook(name):
        def call(*args):
            got = trees["after"][name](*args)
            if not same(got, trees["before"][name](*args)):
                raise RuntimeError(f"{name}: the two trees' outputs differ")
            idx = counts[name] = counts.get(name, -1) + 1
            times = time_pair({t: (lambda w=w: w[name](*args)) for t, w in trees.items()},
                              device)
            records.append({"kernel": name, "index": idx, "call": describe(name, args),
                            "size": size(name, args), **times})
            return got
        return call

    patched = [(lane_table, "pad"), (lane_table, "pack"), (skew_join, "pack"),
               (filter_op, "pack")]
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
    """One join of the preset through its entry point, as chip_smoke.py
    drives it."""
    from tpq_torch.bench.profile import dist_join_fn
    from tpq_torch.bench.runner import gen, join_fn, out_capacity_for
    from tpq_torch.config import PRESETS

    cfg = PRESETS[config]
    if cfg.mesh_shape:
        return dist_join_fn(cfg, device)[0]
    r, s = gen(cfg.r, device), gen(cfg.s, device)
    return join_fn(cfg, r, s, out_capacity_for(cfg))


def summarize(config: str, records: list[dict]) -> list[dict]:
    rows = []
    for name in ("pad", "pack"):
        mine = [r for r in records if r["kernel"] == name]
        if not mine:
            continue
        named = {i: lab for (c, k, i), lab in NAMED.items() if c == config and k == name}
        largest = max(mine, key=lambda r: r["size"])
        for r in mine:
            label = named.get(r["index"])
            if label is None and config == "dist_125m_8shard" and r is largest:
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
    from tpq_torch.kernels import move as after

    p = argparse.ArgumentParser()
    p.add_argument("--before", required=True)
    p.add_argument("--config", action="append", default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    device = torch.device("cuda:0")
    print(card_info(), flush=True)
    _build.build(force=True)
    _build.lib()
    before = load_move(os.path.abspath(args.before))
    trees = {t: {"pad": m.pad, "pack": m.pack} for t, m in (("before", before),
                                                            ("after", after))}
    rows, every = [], []
    for config in args.config or CONFIGS:
        join = preset_join(config, device)
        join()  # the allocator and the clocks settle
        records = hooked_join(join, trees, device)
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
