"""Two trees of the repository profiled in turns on one card.

For each preset, runs `python -m tpq_torch.bench.profile --config=NAME`
from the root of each tree in the order before, after, after, before, one
process per run, so that both trees meet the same card, clocks and
neighbours. Each tree builds its own kernels at its first run. Prints one
JSON object per run: the profile's (end-to-end ms, device busy ms, idle
share, device activities per join, top items, the card) with the tree
and the turn.

CLI (needs a card):
  python -m tpq_torch.bench.ab --before=DIR --after=DIR \\
      [--config=single_chip_1m --config=zipf_skew ...] [--rounds=N] [--out=FILE]
      [--before-options=OPTIONS]
(a --config value may carry the profile's join options after the preset,
e.g. --config="single_chip_1m --algo=merge --sort-engine=radix")
(`--rounds=N` repeats the four turns N times: 2N runs of each tree)
(`--before-options` adds profile options to the before tree's runs
only: `--before=. --before-options=--eager --after=.` profiles one tree
eager against jitted)
(the parent commit unpacked with `git archive` into a git-ignored
directory makes a `before` tree)
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ORDER = ("before", "after", "after", "before")


def profile(root: str, config: str, extra: str = "") -> dict:
    preset, *options = config.split() + extra.split()
    res = subprocess.run([sys.executable, "-m", "tpq_torch.bench.profile",
                          f"--config={preset}", *options], cwd=root, capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": root})
    if res.returncode != 0:
        raise RuntimeError(f"profile of {config} in {root} failed "
                           f"({res.returncode}):\n{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--before", required=True)
    p.add_argument("--after", required=True)
    p.add_argument("--config", action="append", default=None)
    p.add_argument("--rounds", type=int, default=1)
    p.add_argument("--out", default=None)
    p.add_argument("--before-options", default="")
    args = p.parse_args(argv)
    extra = {"before": args.before_options, "after": ""}
    trees = {"before": os.path.abspath(args.before), "after": os.path.abspath(args.after)}
    rows = []
    for config in args.config or ["single_chip_1m", "zipf_skew", "dist_125m_8shard"]:
        for turn, tree in enumerate(ORDER * args.rounds):
            row = {"tree": tree, "turn": turn, **profile(trees[tree], config, extra[tree])}
            print(json.dumps(row), flush=True)
            rows.append(row)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
