"""Operators (port of tpq/ops): the hash join (lane, sorted and skew
impls) and the merge join."""

from tpq_torch.ops.hash_join import hash_join  # noqa: F401
from tpq_torch.ops.merge_join import merge_join  # noqa: F401
