"""Pipeline composer: filter -> hash join -> hash aggregate (port of
tpq/query.py full_pipeline and jit_pipeline, and of
__graft_entry__.entry, the single-card flagship step).

tpq jits the whole pipeline into one XLA program (tpq/query.py:62).
jit_pipeline returns the port's jit of it (tpq_torch/jit.py): on the
card one CUDA graph per signature, replayed in one launch, with
filter_value traced as a device scalar; on the CPU the operators run
eagerly. entry()'s step stays a plain function that jit can capture.
"""

from __future__ import annotations

from tpq_torch import datagen
from tpq_torch.columnar import Table
from tpq_torch.jit import jit
from tpq_torch.ops import filter_table, hash_aggregate, hash_join, merge_join
from tpq_torch.ops.filter import keep_mask


def full_pipeline(dim: Table, fact: Table, filter_col: str, filter_op: str,
                  filter_value, out_capacity: int, algo: str = "hash",
                  join_impl: str = "sorted") -> Table:
    """filter(fact) -> join(dim, fact') -> aggregate(by key).

    Output: one row per surviving key group with count + sums over all
    joined payload columns (the oracle's filter | join | aggregate).

    Fusion decision, tpq's: algo "hash" pushes the filter down into the
    join as a predicate mask (the lane impl drops the rows in its probe
    layout; the others compact first); algo "merge" filters first.
    """
    if algo == "hash":
        keep = keep_mask(fact, filter_col, filter_op, filter_value)
        joined = hash_join(dim, fact, out_capacity, impl=join_impl,
                           probe_keep=keep)
    elif algo == "merge":
        joined = merge_join(dim, filter_table(fact, filter_col, filter_op,
                                              filter_value), out_capacity)
    else:
        raise ValueError(f"unknown algo {algo!r}")
    return hash_aggregate(joined)


def jit_pipeline(out_capacity: int, filter_col="key", filter_op="lt",
                 algo="hash", join_impl: str = "sorted"):
    """Returns a jitted (dim, fact, filter_value) -> Table pipeline, as
    tpq's returns jax.jit(run); `.__wrapped__` is the eager run."""

    def run(dim: Table, fact: Table, filter_value) -> Table:
        return full_pipeline(dim, fact, filter_col, filter_op, filter_value,
                             out_capacity, algo, join_impl)

    return jit(run)


def entry(device="cuda"):
    """Returns (fn, example_args): the flagship single-card step on small
    relations, at __graft_entry__.entry's shapes. fn(dim_table,
    fact_table, filter_value) -> aggregated Table."""
    out_cap = 1 << 12

    def step(dim, fact, filter_value):
        return full_pipeline(dim, fact, "key", "lt", filter_value,
                             out_capacity=out_cap, algo="hash")

    dim = datagen.gen_relation(1024, 1024, payloads=1, seed=1, device=device)
    fact = datagen.gen_relation(2048, 1024, payloads=2, seed=2, device=device)
    return step, (dim, fact, 512)
