"""What a cell is, read from BENCHMARK.json and the files it names.

A cell (an entry of `workloads`) names a configuration and a traffic
mix. The configuration's file is the one `configs` gives it; the mix is
benchmark/traffic/<traffic>.json; the mix's "query" names the query
kind, whose call is benchmark/queries/<query>.py and whose plain
reference is benchmark/reference/<query>.py; each metric is read by
benchmark/metrics/<quantity>.py, the quantity being the metric's name up
to its first dot (`probe_rows_per_s.pipeline` is the quantity
`probe_rows_per_s` in the cells that name it, under a bound of its own).
Nothing here knows a cell by name, so a new cell, mix, kind or metric is
a new file and a new entry.
"""

from __future__ import annotations

import importlib
import json
from dataclasses import dataclass
from pathlib import Path

from benchmark.harness.streams import next_pow2

ROOT = Path(__file__).resolve().parents[2]  # the checkout


@dataclass
class Cell:
    """One workload, resolved: its entry, its configuration and traffic
    (the files' contents), and its metrics by kind."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list

    @property
    def query(self) -> str:
        return self.traffic["query"]


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def resolve(bench: dict, workload: str, root: Path = ROOT) -> Cell:
    """The cell `workload` of a BENCHMARK.json's contents."""
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(there are {sorted(entries)})")
    w = entries[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(root / configs[w["config"]]["file"]) as f:
        config = json.load(f)
    with open(root / "benchmark" / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    return Cell(name=workload, chips=int(w["chips"]), config=config, traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, workload)])


def query_module(kind: str):
    """benchmark/queries/<kind>.py: how the program is called."""
    return importlib.import_module(f"benchmark.queries.{kind}")


def reference_module(kind: str):
    """benchmark/reference/<kind>.py: the plain reference and the
    comparison of a kind."""
    return importlib.import_module(f"benchmark.reference.{kind}")


def metric_reader(name: str):
    """The `read(summary)` of benchmark/metrics/<quantity>.py, the
    quantity being `name` up to its first dot."""
    return importlib.import_module(f"benchmark.metrics.{name.split('.')[0]}").read


def out_capacity(config: dict) -> int:
    """The static output capacity of a configuration: the bench runner's
    arithmetic, next_pow2(max(build rows, probe rows) * factor)."""
    rows = max(config["build"]["rows"], config["probe"]["rows"])
    return next_pow2(int(rows * config["out_capacity_factor"]))
