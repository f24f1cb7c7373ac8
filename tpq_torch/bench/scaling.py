"""Weak scaling of the distributed join (port of tpq/bench/scaling.py
run_weak_scaling).

Runs dist_hash_join over meshes of n shards with the rows per shard held
fixed, and reports rows/s per chip (card) and the efficiency against the
first size. Differences from tpq:

  * Mesh. Each size is a `LocalMesh` (make_mesh(n, device)): n shards on
    one card, which the port runs at every size asked for (tpq skips
    sizes above its device count). With a process group (one shard per
    rank), only the group's own size runs. Each record names its mesh
    ("local" or "process_group"), the cards it spans and the card's
    name. rows_per_sec_per_chip divides by the cards the mesh spans
    (tpq's chips): on a process group one a shard, as in tpq; on a
    local mesh the one card, so that the efficiency says how one card's
    throughput holds as its shards and rows grow, not how a join scales
    across cards.
  * Compiled. As tpq's `jax.jit(fn)` at each size (tpq/bench/scaling.py:
    59), the join runs jitted on a LocalMesh (dist_hash_join's jitted
    body: one CUDA graph, captured at its first call, which also gives
    the overflow check); the mesh's graphs are freed (mesh.clear())
    before the next size. `eager=True` runs the body without a graph; a
    process group runs it eagerly always. Each record says which
    (`jitted`) and, jitted, its graph's `captures` and `reruns`.
  * Timing. CUDA events around 3 joins after a warm-up
    (runner.cuda_time) replace tpq's slope timer. On the CPU a record
    carries no time (None).
  * Exactness. Outside the timed window every size's overflow must be 0
    (tpq's assert) and its num_rows must equal a count made without the
    join: a sort of R's keys and a searchsorted of S's, from the same
    streams.
  * Data. On the card each shard is made there by the device streams
    (datagen.gen_relation_device); elsewhere tpq's placement of the
    numpy streams (DistTable.from_numpy). The live rows are the same.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tpq_torch import datagen
from tpq_torch.bench.runner import cuda_time
from tpq_torch.columnar import next_pow2
from tpq_torch.dist import DistTable, dist_hash_join, make_mesh
from tpq_torch.dist.multihost import ProcessGroupMesh


def device_placed(rows: int, nkeys: int, payloads: int, seed: int, mesh) -> DistTable:
    """tpq's placement of the uniform relation (DistTable.from_numpy:
    shard i holds rows [i*per, (i+1)*per) of capacity next_pow2(per)),
    each held shard made on mesh.device by the device streams."""
    per = -(-rows // mesh.size)
    return DistTable([
        datagen.gen_relation_device(max(0, min(per, rows - i * per)), nkeys, payloads,
                                    seed, capacity=next_pow2(per), row_offset=i * per,
                                    device=mesh.device)
        for i in mesh.shard_ids])


def place_uniform(rows: int, nkeys: int, payloads: int, seed: int, mesh) -> DistTable:
    """The uniform relation placed on `mesh`: made on the card where the
    mesh is on one, else from the numpy streams."""
    if mesh.device.type == "cuda":
        return device_placed(rows, nkeys, payloads, seed, mesh)
    return DistTable.from_numpy(
        datagen.gen_relation_np(rows, nkeys, payloads, seed), mesh)


def stream_keys(rows: int, nkeys: int, seed: int, device) -> torch.Tensor:
    """The first `rows` keys of the uniform stream, on `device`."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return datagen.gen_relation_device(rows, nkeys, 0, seed, device=dev).col("key")[:rows]
    return torch.from_numpy(datagen.uniform_keys(rows, nkeys, seed))


def true_join_rows(rows: int, nkeys: int, seed_r: int, seed_s: int, device) -> int:
    """The inner join's row count of the two uniform relations, counted
    without the join: R's keys sorted, each S key's matches by two
    searchsorted (as lane_table.plan_pressure counts)."""
    rs = torch.sort(stream_keys(rows, nkeys, seed_r, device)).values
    sk = stream_keys(rows, nkeys, seed_s, device)
    return int((torch.searchsorted(rs, sk, right=True) - torch.searchsorted(rs, sk)).sum())


def mesh_label(mesh) -> dict:
    """What a record says of the mesh it ran on: its kind, the cards it
    spans and the card's name."""
    cuda = mesh.device.type == "cuda"
    if isinstance(mesh, ProcessGroupMesh):
        kind, cards = "process_group", mesh.size if cuda else 0
    else:
        kind, cards = "local", 1 if cuda else 0
    return {"mesh": kind, "cards": cards,
            "device": torch.cuda.get_device_name(mesh.device) if cuda else str(mesh.device)}


def joined_rows(out: DistTable, mesh) -> int:
    return int(mesh.psum([t.num_rows.to(torch.int64) for t in out.shards])[0])


def join_record(mesh, eager: bool) -> dict:
    """What a record says of how its join ran: `jitted`, whether as its
    CUDA graph (False when `eager`, on a process group, and off the card,
    where jit runs the body itself) and, jitted, the captures and reruns
    of the mesh's jitted bodies (the benches free them before each join,
    so those of this join's)."""
    if eager or mesh.programs is None or mesh.device.type != "cuda":
        return {"jitted": False}
    progs = mesh.programs.values()
    return {"jitted": True, "captures": sum(p.captures for p in progs),
            "reruns": sum(p.reruns for p in progs)}


def run_weak_scaling(rows_per_chip: int = 1 << 16,
                     mesh_sizes: tuple[int, ...] = (1, 2, 4, 8),
                     payloads: int = 1,
                     exchange_impl: str = "dense",
                     algo: str = "hash",
                     n_chunks: int = 1,
                     seed: int = 77,
                     device="cuda",
                     process_group: bool = False,
                     eager: bool = False) -> list[dict]:
    """One record per mesh size: tpq's {n_chips, rows_total, elapsed_ms,
    rows_per_sec_per_chip, efficiency, exchange_impl, n_chunks}, plus
    num_rows, mesh_label's keys and join_record's. With `process_group`
    (an initialized torch.distributed group) only the size of the group
    runs, one shard per rank."""
    rows, base_rate = [], None
    for n in mesh_sizes:
        if process_group:
            if n != dist.get_world_size():
                continue
            # under NCCL the rank's own card
            mesh = ProcessGroupMesh(None if torch.device(device).type == "cuda" else device)
        else:
            mesh = make_mesh(n, device)
        total = rows_per_chip * n
        nkeys = max(64, total)
        R = place_uniform(total, nkeys, payloads, seed, mesh)
        S = place_uniform(total, nkeys, payloads, seed + 1, mesh)
        out_cap = next_pow2(max(256, 4 * rows_per_chip))
        if out_cap % max(1, n_chunks):
            out_cap = next_pow2(out_cap * n_chunks)

        def join():
            return dist_hash_join(R, S, mesh, out_capacity_per_shard=out_cap, algo=algo,
                                  exchange_impl=exchange_impl, n_chunks=n_chunks,
                                  eager=eager)

        # the count first: its buffers are free when the join's graph is captured
        want = true_join_rows(total, nkeys, seed, seed + 1, mesh.device)
        out, ovf = join()  # jitted: the capture, outside the timed window
        if int(ovf.sum()) != 0:
            raise RuntimeError(f"scaling bench overflowed at {n} shards: {ovf.tolist()}")
        got = joined_rows(out, mesh)
        if got != want:
            raise RuntimeError(f"scaling bench at {n} shards: {got} rows, {want} expected")
        del out, ovf
        rec = {"n_chips": n, "rows_total": total, "elapsed_ms": None,
               "rows_per_sec_per_chip": None, "efficiency": None,
               "exchange_impl": exchange_impl, "n_chunks": n_chunks, "num_rows": got,
               **mesh_label(mesh)}
        if mesh.device.type == "cuda":
            def timed():
                join()  # the result dropped at once: one join's buffers at a time

            sec, _ = cuda_time(timed, mesh.device, 3)
            rate = total / sec / rec["cards"]
            base_rate = base_rate or rate
            rec.update(elapsed_ms=sec * 1e3, rows_per_sec_per_chip=rate,
                       efficiency=rate / base_rate)
        rec.update(join_record(mesh, eager))
        rows.append(rec)
        if mesh.programs is not None:
            mesh.clear()  # the graph and the R and S it pins go before the next size
        del R, S
    return rows
