"""The benchmark of tpq_torch: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA card. The cell
is an entry of BENCHMARK.json's `workloads`; its tables are made on the
card from the seed, the program's call is made ready and warmed up (set
up), then a closed loop of queries runs for `--seconds` (with `--trace
1`, a stretch of it under torch.profiler). The last line of standard
output is the result: `correct`, `attempted`, `failed`, the cell's
end-to-end metrics (trace 0) or per-layer metrics (trace 1), the
device, and the numbers compared beside their limits (`checks`, also
the last lines of standard error). The line before it holds the
program's counters over the window and the path it took.

Exits non-zero with no result when no card is visible or fewer than
the cell asks for, and when jax, jaxlib, flax or tpq is loaded once the
window has closed. Build and kernel caches stay inside the checkout:
the port's kernels in tpq_torch/build/ (the program's own choice), the
CUDA driver's JIT cache under benchmark/out/cache/nv/.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "benchmark" / "out"


def set_environment() -> None:
    """The CUDA driver's JIT cache at a fixed path inside the checkout; the
    checkout's root, not benchmark/, on the import path."""
    os.environ["CUDA_CACHE_PATH"] = str(OUT / "cache" / "nv")
    os.environ["USE_FLAX"] = "0"
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, str(ROOT))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    set_environment()
    import torch

    from benchmark.harness import cell as harness, guard, spec

    if not torch.cuda.is_available():
        print("run.py: no CUDA card is visible; the benchmark runs only on one",
              file=sys.stderr)
        return 2
    cell = spec.resolve(spec.load_benchmark(ROOT), args.workload, ROOT)
    if torch.cuda.device_count() < cell.chips:
        print(f"run.py: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result, info = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                               torch.device("cuda", 0), STARTED)
    print(json.dumps(info), flush=True)
    if args.trace:
        OUT.mkdir(parents=True, exist_ok=True)
        with open(OUT / f"{args.workload}.{args.seed}.trace.json", "w") as f:
            json.dump({"info": info, "result": result}, f)
    found = guard.forbidden_loaded()
    if found:
        print(f"run.py: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
