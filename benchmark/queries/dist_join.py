"""The distributed join query: R ⋈ S on "key" over the configuration's
mesh of shards (a `LocalMesh` on one card) through the port's
`dist_hash_join_planned`, as a user runs it over resident shards: each
query plans its capacities (eager, two host reads), then replays the
jitted body of the planned static set.

R and S are placed on the mesh once, in set-up, by tpq's placement
(`DistTable.from_columns`). The result stays row-sharded: `num_rows` is
the shards' rows summed on the card, or the harness's capacity + 1 where
the overflow vector is nonzero; `columns` gathers one column's live
rows across the shards each time it is read, so that the timed call
gathers nothing. The shards are the graph's own outputs (jit's
`hand_off`): they hold until the next query, which is all a closed loop
needs.

Traffic keys read here: "entry" (dist_hash_join_planned), "local_impl"
(lane or sorted), "exchange_impl" (dense, ragged or ring), "n_chunks".
No skew split.
"""

from __future__ import annotations

from collections.abc import Mapping
from types import SimpleNamespace

import torch

from benchmark.harness.query import Prepared
from benchmark.harness.spec import out_capacity


class LiveColumns(Mapping):
    """name -> the live rows of that column over the shards, in shard
    order, gathered when read (one host read of the shards' rows)."""

    def __init__(self, shards: list):
        self.shards = shards

    def __getitem__(self, name: str) -> torch.Tensor:
        rows = torch.stack([t.num_rows for t in self.shards]).tolist()
        return torch.cat([t.columns[name][:n] for t, n in zip(self.shards, rows)])

    def __iter__(self):
        return iter(self.shards[0].columns)

    def __len__(self) -> int:
        return len(self.shards[0].columns)


def prepare(config: dict, traffic: dict, inputs: dict, device) -> Prepared:
    from tpq_torch.dist import DistTable, dist_hash_join_planned, make_mesh
    from tpq_torch.dist.dist_join import plan_dist_capacities

    if traffic["entry"] != "dist_hash_join_planned":
        raise ValueError(f"unknown entry {traffic['entry']!r}")
    mesh = make_mesh(config["mesh"]["shards"], device)
    r, s = (DistTable.from_columns({n: rel.live(n) for n in rel.columns}, mesh)
            for rel in (inputs["build"], inputs["probe"]))
    cap = out_capacity(config)
    kwargs = dict(local_impl=traffic["local_impl"], exchange_impl=traffic["exchange_impl"],
                  n_chunks=int(traffic["n_chunks"]))
    last: dict = {}

    def call():
        out, ovf = dist_hash_join_planned(r, s, mesh, **kwargs)
        last["overflow"] = ovf
        rows = torch.stack([t.num_rows for t in out.shards]).sum(dtype=torch.int64)
        return SimpleNamespace(columns=LiveColumns(out.shards),
                               num_rows=torch.where(ovf.sum() > 0, cap + 1, rows))

    def counters() -> dict:
        progs = list(mesh.programs.values())
        return {"reruns": sum(p.reruns for p in progs),
                "copies": sum(p.copies for p in progs),
                "captures": sum(p.captures for p in progs),
                "plan_host_reads": plan_dist_capacities.host_reads}

    def close() -> None:
        """Keeps the planned static sets and the last overflow vector for
        path(), then frees the mesh's graphs."""
        last["statics"] = [dict(k) for k in mesh.programs]
        last["overflow"] = last["overflow"].tolist() if "overflow" in last else None
        mesh.clear()

    def path() -> dict:
        return {"entry": traffic["entry"], **kwargs, "shards": mesh.size,
                "programs": [{k: st[k] for k in ("exchange_capacity",
                                                 "out_capacity_per_shard")}
                             for st in last.get("statics", [])],
                "overflow": last.get("overflow")}

    return Prepared(call=call, probe_rows=inputs["probe"].rows, counters=counters,
                    path=path, close=close)
