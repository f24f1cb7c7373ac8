"""Hash equi-join dispatcher (port of tpq/ops/hash_join.py).

Semantics (every impl, oracle-exact): inner join on `key`; duplicate
keys on both sides yield the full per-key cross product; output columns
key, r_<R payloads...>, s_<S payloads...>; static out_capacity with
overflow visible as num_rows > capacity.
"""

from __future__ import annotations

from tpq_torch.columnar import Table


def hash_join(r: Table, s: Table, out_capacity: int, key: str = "key",
              impl: str = "lane", probe_keep=None) -> Table:
    """Inner equi-join R ⋈ S on `key`.

    impl="lane" (default): lane-bucket tables walked by the fused CUDA
    kernel (tpq_torch/kernels/lane2.py); falls back to the sorted impl
    when a static capacity is exceeded.
    impl="sorted": the union-sort engine (tpq_torch/ops/union_join.py).
    impl="skew": not yet ported.
    """
    if impl == "lane":
        from tpq_torch.kernels.lane2 import lane2_hash_join

        return lane2_hash_join(r, s, out_capacity, key=key,
                               probe_keep=probe_keep)
    if impl == "skew":
        raise NotImplementedError(
            "impl='skew' is not yet ported (ROADMAP.md Queue 1 item 7)")
    if impl != "sorted":
        raise ValueError(f"unknown impl {impl!r}")
    if probe_keep is not None:
        raise NotImplementedError(
            "probe_keep needs the filter operator's compact, not yet ported "
            "(ROADMAP.md Queue 1 item 6)")

    from tpq_torch.ops.union_join import union_join

    return union_join(r, s, out_capacity, key=key)
