"""The benchmark's cells cut to a size the CPU runs in a blink, for the
tests: the same files, traffic and code paths, smaller tables."""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import spec  # noqa: E402

CELLS = ("join_1m.uniform", "join_1m.zipf_theta1", "pipeline_100m.filter_half",
         "join_1m.uniform_fallback")
SEED = 5_000_000_123  # past 32 bits, as a run's seed may be


def tiny(workload: str, root: Path = ROOT) -> spec.Cell:
    cell = spec.resolve(spec.load_benchmark(root), workload, root)
    if cell.query == "join":
        cell.config["build"].update(rows=3000, nkeys=4096)
        cell.config["probe"].update(rows=3000, nkeys=4096)
    else:
        cell.config["build"].update(rows=1000, nkeys=1024)
        cell.config["probe"].update(rows=20000, nkeys=1024)
        cell.traffic["filter"]["value"] = 512
    return cell
