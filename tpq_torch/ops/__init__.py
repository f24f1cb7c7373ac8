"""Operators (port of tpq/ops): the hash join so far."""

from tpq_torch.ops.hash_join import hash_join  # noqa: F401
