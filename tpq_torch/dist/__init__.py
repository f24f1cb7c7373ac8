"""The distributed join (port of tpq/dist): hash ownership and the meshes,
shuffle exchange, skew handling, chunked exchange and the join with its
capacity planner and renegotiation loop."""

import collections

from tpq_torch.dist.dist_join import (DistTable, SkewConfig,  # noqa: F401
                                      dist_hash_join, dist_hash_join_planned,
                                      dist_hash_join_renegotiated, jitted_join,
                                      plan_dist_capacities)
from tpq_torch.dist.mesh import LocalMesh, make_mesh, owner_of  # noqa: F401
from tpq_torch.dist.multihost import ProcessGroupMesh  # noqa: F401

# tpq's dryrun relations (zipf keys exercise the skew split) and knobs
DRYRUN_R = dict(rows=1024, nkeys=600, payloads=1, seed=1, kind="zipf")
DRYRUN_S = dict(rows=2048, nkeys=600, payloads=1, seed=2, kind="zipf")
DRYRUN_SKEW = SkewConfig(candidates_per_shard=8, threshold=64,
                         replica_capacity_per_shard=1024)
# the three variants: chunked exchange + skew, the ring + skew, and the
# lane local join on the dense exchange + skew
DRYRUN_VARIANTS = {
    "chunked+skew": {"n_chunks": 2, "skew": DRYRUN_SKEW},
    "ring+skew": {"exchange_impl": "ring", "skew": DRYRUN_SKEW},
    "dense+lane+skew": {"local_impl": "lane", "skew": DRYRUN_SKEW},
}


def dryrun_relations():
    """The dryrun's two relations as numpy columns, and their exact join
    count."""
    from tpq_torch import datagen

    r = datagen.gen_relation_np(**DRYRUN_R)
    s = datagen.gen_relation_np(**DRYRUN_S)
    rc = collections.Counter(r["key"].tolist())
    sc = collections.Counter(s["key"].tolist())
    return r, s, sum(rc[k] * sc[k] for k in rc)


def run_dryrun(mesh, variants=DRYRUN_VARIANTS) -> dict:
    """Each variant under dist_hash_join_renegotiated on `mesh` from an
    output capacity of 1 << 15 per shard (its body jitted on a
    LocalMesh). Returns {variant: (result DistTable, retries)}; raises
    unless every variant joins exactly the expected rows over all
    shards."""
    r, s, expected = dryrun_relations()
    R = DistTable.from_numpy(r, mesh)
    S = DistTable.from_numpy(s, mesh)
    out = {}
    for name, kwargs in variants.items():
        res, retries = dist_hash_join_renegotiated(
            R, S, mesh, out_capacity_per_shard=1 << 15, **kwargs)
        got = int(mesh.psum([t.num_rows for t in res.shards])[0])
        if got != expected:
            raise RuntimeError(f"dryrun {name}: {got} joined rows, expected {expected}")
        out[name] = (res, retries)
    return out


def dryrun_multichip(n_shards: int, device="cuda") -> dict:
    """The port's counterpart of __graft_entry__.dryrun_multichip: an
    n-shard one-process mesh on `device`, one full distributed join per
    variant (partition, skew split, exchange, per-shard join), each
    asserted to join the exact row count. Returns run_dryrun's dict."""
    mesh = make_mesh(n_shards, device)
    out = run_dryrun(mesh)
    _, _, expected = dryrun_relations()
    print(f"dryrun_multichip({n_shards}): OK — {expected} joined rows across "
          f"{mesh.size} shards ({', '.join(out)} variants)")
    return out
