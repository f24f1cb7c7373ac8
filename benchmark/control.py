"""The control of a cell's comparison, several seeds in one process.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 [--seconds 2]

The control is the cell's plain reference in the next lower precision
(int32 for the configurations' int64), put in the program's place and
run through the same set-up, closed loop and comparison as a run; it has
to come out not correct. One JSON line a seed: correct, the numbers
compared and their limits. The benchmark's own runs never run this.
"""

import sys

from run import ROOT, set_environment  # benchmark/ is on the path


def main(argv=None) -> int:
    import argparse
    import json
    import time

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    set_environment()
    import torch

    from benchmark.harness import cell as harness, spec

    if not torch.cuda.is_available():
        print("control.py: no CUDA card is visible", file=sys.stderr)
        return 2
    cell = spec.resolve(spec.load_benchmark(ROOT), args.workload, ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        result, info = harness.run(cell, seed, args.seconds, False,
                                   torch.device("cuda", 0), time.perf_counter(),
                                   control=True)
        print(json.dumps({"workload": cell.name, "seed": seed, "correct": result["correct"],
                          "attempted": result["attempted"], "failed": result["failed"],
                          "checks": result["checks"], "card": info["card"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
