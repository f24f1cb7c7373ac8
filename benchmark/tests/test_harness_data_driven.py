"""The harness takes a new cell as data: in a copy of the benchmark, a
new configuration, traffic mix and metric file and new BENCHMARK.json
entries are picked up and run, and no file already there is edited."""

from __future__ import annotations

import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

from tiny_cells import ROOT

NEW_CONFIG = {"name": "join_tiny", "source": "a test's own", "reduced": [],
              "build": {"rows": 2000, "nkeys": 1500, "payloads": 2, "key_seed": 5},
              "probe": {"rows": 2500, "nkeys": 1500, "payloads": 1, "key_seed": 6},
              "out_capacity_factor": 4.0}
NEW_TRAFFIC = {"query": "join", "probe_keys": {"dist": "zipf", "theta": 0.5},
               "impl": "sorted"}
NEW_METRIC = '''
def read(summary):
    if summary.get("trace"):
        return None
    return summary["queries"] / summary["window_s"]
'''

RUN = """
import json, sys, time
sys.path.insert(0, {copy!r})
sys.path.append({repo!r})
from benchmark.harness import cell as harness, spec
root = spec.ROOT
assert str(root) == {copy!r}, root
cell = spec.resolve(spec.load_benchmark(root), "join_tiny.zipf_half", root)
result, info = harness.run(cell, 77, 0.3, False, "cpu", time.perf_counter())
print(json.dumps(result))
"""


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts and "out" not in p.parts}


def test_new_cell_and_metric_are_data(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", copy / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "out"))
    shutil.copy(ROOT / "BENCHMARK.json", copy / "BENCHMARK.json")
    before = _digests(copy)

    (copy / "benchmark" / "configs" / "join_tiny.json").write_text(json.dumps(NEW_CONFIG))
    (copy / "benchmark" / "traffic" / "zipf_half.json").write_text(json.dumps(NEW_TRAFFIC))
    (copy / "benchmark" / "metrics" / "queries_per_s.py").write_text(NEW_METRIC)
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "join_tiny", "source": "a test's own",
                             "file": "benchmark/configs/join_tiny.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "join_tiny.zipf_half", "config": "join_tiny",
                               "traffic": "zipf_half", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "queries_per_s", "unit": "1/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["join_tiny.zipf_half"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))

    res = subprocess.run([sys.executable, "-c", RUN.format(copy=str(copy), repo=str(ROOT))],
                         capture_output=True, text=True, timeout=600, cwd=copy)
    assert res.returncode == 0, res.stderr[-3000:]
    result = json.loads(res.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    # the new cell takes its own metric and those that name no workloads
    # (peak_alloc_GiB reads nothing on the CPU)
    assert set(result["metrics"]) == {"queries_per_s", "setup_s"}
    after = _digests(copy)
    assert {k: v for k, v in after.items() if k in before} == before  # nothing edited
    assert set(after) - set(before) == {"benchmark/configs/join_tiny.json",
                                        "benchmark/traffic/zipf_half.json",
                                        "benchmark/metrics/queries_per_s.py"}
