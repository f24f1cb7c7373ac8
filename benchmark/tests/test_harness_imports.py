"""Nothing a run loads is JAX, its libraries or the JAX package tpq,
compared by whole top-level module name (tpq_torch is not tpq); the
plain references load nothing of the program either."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest

from tiny_cells import ROOT
from benchmark.harness.guard import forbidden_loaded

RUN_ALL = """
import json, sys, time
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
import runpy
runpy.run_path({run!r}, run_name="benchmark_run_module")  # run.py's imports, no main
from benchmark.harness import cell as harness
from tiny_cells import CELLS, SEED, tiny
for w in CELLS:
    for trace in (False, True):
        harness.run(tiny(w), SEED, 0.1, trace, "cpu", time.perf_counter())
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""

REFERENCE_ONLY = """
import json, sys, time
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from benchmark.harness import cell as harness, spec
from tiny_cells import CELLS, SEED, tiny
for w in CELLS:
    cell = tiny(w)
    ref = spec.reference_module(cell.query)
    inputs = harness.make_inputs(cell, SEED, "cpu")
    exp = ref.expected(cell.config, cell.traffic, inputs)
    ref.control(cell.config, cell.traffic, inputs, "cpu", spec.out_capacity(cell.config)).call()
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def _loaded(script: str) -> list:
    code = script.format(root=str(ROOT), tests=str(ROOT / "benchmark" / "tests"),
                         run=str(ROOT / "benchmark" / "run.py"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_and_no_tpq():
    loaded = _loaded(RUN_ALL)
    assert "tpq_torch" in loaded and "torch" in loaded
    assert forbidden_loaded(loaded) == []


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded(REFERENCE_ONLY)
    assert "tpq_torch" not in loaded
    assert forbidden_loaded(loaded) == []


def test_reference_sources_import_only_torch_and_the_harness():
    allowed = {"__future__", "dataclasses", "torch", "benchmark"}
    for src in sorted((ROOT / "benchmark" / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(src.read_text())):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                tops = {(node.module or "").split(".")[0]}
            else:
                continue
            assert tops <= allowed, (src.name, tops)
            if "benchmark" in tops:  # the harness's helpers, which load no program
                assert node.module in ("benchmark.harness.compare",
                                       "benchmark.harness.query"), (src.name, node.module)


@pytest.mark.parametrize("names,found", [
    (["tpq_torch", "tpq_torch.ops", "tpqx", "torch"], []),
    (["tpq", "tpq_torch"], ["tpq"]),
    (["tpq.ops.hash_join"], ["tpq"]),
    (["jax._src.core", "jaxlib.xla_client", "flax.linen"], ["flax", "jax", "jaxlib"]),
])
def test_names_are_compared_whole(names, found):
    assert forbidden_loaded(names) == found


def test_run_refuses_without_a_card():
    res = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
                          "join_1m.uniform", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert res.returncode != 0
    assert res.stdout.strip() == "" or not res.stdout.strip().splitlines()[-1].startswith("{")
