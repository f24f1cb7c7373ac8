"""Operators (port of tpq/ops): filter, the hash join (lane, sorted and
skew impls), the merge join and the hash aggregate."""

from tpq_torch.ops.filter import filter_table  # noqa: F401
from tpq_torch.ops.hash_aggregate import hash_aggregate  # noqa: F401
from tpq_torch.ops.hash_join import hash_join  # noqa: F401
from tpq_torch.ops.merge_join import merge_join  # noqa: F401
