"""The exchange variants of the distributed join side by side (port of
tpq/bench/overlap_bench.py run_overlap_matrix and main).

Three variants of dist_hash_join on one mesh: the dense exchange in one
chunk, the dense exchange in 4 chunks, and the ring's hops. tpq leaves
the overlap of one chunk's or hop's exchange with the previous one's
join to XLA's collective scheduler. On a `LocalMesh` (n shards on one
card) the port runs chunks and hops in order (dist/overlap.py), so
nothing overlaps: the matrix measures what chunking and ring hops cost
on one card, and each record says so ("mesh": "local"). Across cards
(a process group) the same code runs the collectives through NCCL.

Compiled. Each variant runs jitted, as tpq's `@jax.jit step`
(tpq/bench/overlap_bench.py:25): dist_hash_join's jitted body on the
LocalMesh, one CUDA graph captured at the variant's first call (its
checked call), freed (mesh.clear()) before the next variant, as a
graph's memory pool lives as long as the graph. `eager=True` (`--eager`)
runs the bodies without graphs. Each record says which (`jitted`,
scaling.join_record) with the graph's captures and reruns.

Times: tpq's best of 3 after a warm-up, each join between CUDA events;
on the CPU a record carries no time (None). Outside the timed window,
each variant's num_rows must equal the dense one's.

CLI:  python -m tpq_torch.bench.overlap_bench [--rows-per-shard N]
      [--trace-dir DIR] [--json-out FILE] [--device cuda|cpu] [--eager]
runs 8 shards (config 5's) of 2^24 rows by default, with tpq's output
capacity of 4 x the rows a shard, and prints one record a line and, as
its last line, the records as one JSON object.
"""

from __future__ import annotations

import torch

from tpq_torch.bench.scaling import join_record, joined_rows, mesh_label, place_uniform
from tpq_torch.dist import dist_hash_join
from tpq_torch.trace import trace_if

VARIANTS = [
    ("dense_1chunk", dict(exchange_impl="dense", n_chunks=1)),
    ("dense_4chunks", dict(exchange_impl="dense", n_chunks=4)),
    ("ring_hops", dict(exchange_impl="ring")),
]


def best_ms(fn, device) -> float:
    """Least ms of 3 calls of fn() on the card, each between CUDA
    events, after one warm-up call."""
    fn()
    best = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(device)
        best = min(best, start.elapsed_time(end))
    return best


def run_overlap_matrix(mesh, rows_per_shard: int = 1 << 14,
                       out_capacity_per_shard: int = 1 << 16,
                       trace_dir: str | None = None, eager: bool = False) -> list[dict]:
    """One record per variant: tpq's {variant, n_chips, rows_total,
    elapsed_ms, vs_dense_1chunk}, plus num_rows, mesh_label's keys and
    join_record's. `trace_dir` traces the ring variant (trace.trace_if)."""
    nchips = mesh.size
    n = rows_per_shard * nchips
    R = place_uniform(n, n, 1, 71, mesh)
    S = place_uniform(n, n, 1, 72, mesh)
    timed = mesh.device.type == "cuda"
    rows, base_ms, base_rows = [], None, None
    for name, kw in VARIANTS:
        def join(kw=kw):
            return dist_hash_join(R, S, mesh, out_capacity_per_shard=out_capacity_per_shard,
                                  eager=eager, **kw)

        out, ovf = join()  # jitted: the capture, outside the timed window
        if int(ovf.sum()) != 0:
            raise RuntimeError(f"overlap matrix {name} overflowed: {ovf.tolist()}")
        got = joined_rows(out, mesh)
        del out, ovf
        base_rows = base_rows if base_rows is not None else got
        if got != base_rows:
            raise RuntimeError(f"overlap matrix {name}: {got} rows, dense_1chunk "
                               f"{base_rows}")
        row = {"variant": name, "n_chips": nchips, "rows_total": 2 * n,
               "elapsed_ms": None, "vs_dense_1chunk": None, "num_rows": got,
               **mesh_label(mesh)}
        if timed:
            def run(join=join):
                join()  # the result dropped at once: one join's buffers at a time

            with trace_if(trace_dir if name == "ring_hops" else None):
                row["elapsed_ms"] = round(best_ms(run, mesh.device), 3)
            base_ms = base_ms or row["elapsed_ms"]
            row["vs_dense_1chunk"] = round(row["elapsed_ms"] / base_ms, 3)
        row.update(join_record(mesh, eager))
        rows.append(row)
        if mesh.programs is not None:
            mesh.clear()  # a graph's memory pool goes before the next variant's
    return rows


def main(argv=None):
    import argparse
    import json
    import sys

    from tpq_torch.bench.runner import card_info
    from tpq_torch.columnar import next_pow2
    from tpq_torch.dist import make_mesh

    p = argparse.ArgumentParser()
    p.add_argument("--rows-per-shard", type=int, default=1 << 24)
    p.add_argument("--json-out", default=None)
    p.add_argument("--trace-dir", default=None)
    p.add_argument("--device", default="cuda",
                   help="cpu runs the matrix without times")
    p.add_argument("--eager", action="store_true",
                   help="run the joins eagerly, not as their CUDA graphs")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        sys.exit("tpq_torch.bench.overlap_bench measures on a CUDA card; none is visible")

    mesh = make_mesh(8, args.device)
    rows = run_overlap_matrix(mesh, rows_per_shard=args.rows_per_shard,
                              out_capacity_per_shard=next_pow2(4 * args.rows_per_shard),
                              trace_dir=args.trace_dir, eager=args.eager)
    report = {"overlap_matrix": rows,
              "card": card_info() if mesh.device.type == "cuda" else None}
    for row in rows:
        print(row)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(report, f, indent=2)
    print(json.dumps(report))
    return rows


if __name__ == "__main__":
    main()
