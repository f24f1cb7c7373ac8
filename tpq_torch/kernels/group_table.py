"""The hash aggregate's group table: group by key in one pass over the
live rows, then order only the groups (no TPU kernel: tpq groups by a
sort of the whole capacity, tpq/ops/hash_aggregate.py, which the port
keeps as its fallback, ops/hash_aggregate.py `sort_aggregate`).

  * group_insert(key, values, num_rows) -> GroupTable: `key` int32 or
    int64 [N], `values` int32 or int64 [N] columns, `num_rows` a 0-d
    int32 or int64 tensor read on the device (it may exceed N: an
    overflowed join's count), at most MAX_VALUES value columns (a wider
    table takes the sort path, ops/hash_aggregate.py). Each live row's key is found or inserted
    in an open-addressed table of `table_slots(N)` hash slots (slot 0
    holds the INT64_MAX key, whose word marks an empty hash slot), and
    its count and values (int32 widened) are added into the key's
    payload row in wrapping int64. `ok` is a 0-d bool: distinct keys <=
    the limit, half the slots; past it the table's groups are
    unspecified and the caller takes another path.
  * group_write(table) -> ([key', count, sum_0, ...], G): the slots
    ordered by key (one stable torch sort of the slots' keys, at most
    MAX_SLOTS + 1 of them), the g-th group (g < G) at row g, G int32
    0-d, every row from G to N zero (the outputs are made by a memset):
    the aggregate's output, byte-equal to the sort path's while `ok`.

On a CUDA tensor each launches its kernel (tpq_torch/csrc/group_table.cu)
once, counted in `.launches`; on a CPU
tensor it runs its plain twin (`group_insert_ref`, `group_write_ref`),
which places the groups in key order, where the kernel's slots follow
the hash: only `ok` and what group_write makes of a table are the
contract. On any other device it raises.
"""

from __future__ import annotations

import dataclasses

import torch

from tpq_torch.columnar import next_pow2
from tpq_torch.kernels import _build

I32, I64 = torch.int32, torch.int64
EMPTY = torch.iinfo(I64).max  # kEmpty in csrc/group_table.cu
MAX_VALUES = 4  # kGtMaxVals: the value columns a table holds (registers, a tile's sums)
# The most hash slots a table has. At its limit (2^20 groups) the slots a
# call touches, the key words (16 MB) and 3 values' payload rows (32 MB),
# are about the H100's 50 MB of L2, where the insert's atomics run; more
# slots would spill them to device memory (csrc/group_table.cu).
MAX_SLOTS = 1 << 21


def table_slots(capacity: int) -> int:
    """The hash slots of a table for `capacity` rows: twice the
    capacity's power of two, at most MAX_SLOTS (read at each call)."""
    return min(2 * next_pow2(capacity), MAX_SLOTS)


@dataclasses.dataclass
class GroupTable:
    """A group table: `keys` int64 [slots + 1] (slot 0 the INT64_MAX
    key's, EMPTY in an empty hash slot), `payload` int64 [slots + 1,
    1 + nvals] (count, then a sum a value column), `inserted` int64 0-d
    (the distinct keys inserted), the key's dtype and the capacity N of
    the input and the output."""

    keys: torch.Tensor
    payload: torch.Tensor
    inserted: torch.Tensor
    key_dtype: torch.dtype
    capacity: int

    @property
    def slots(self) -> int:
        return self.keys.shape[0] - 1

    @property
    def limit(self) -> int:
        return self.slots // 2

    @property
    def ok(self) -> torch.Tensor:
        """bool 0-d: distinct keys <= the limit, read on the device."""
        return self.inserted <= self.limit


def _new_table(key: torch.Tensor, nvals: int) -> GroupTable:
    """An empty table for `key`'s capacity, every key EMPTY, every
    payload word and the counter 0."""
    slots, dev = table_slots(key.shape[0]), key.device
    return GroupTable(torch.full((slots + 1,), EMPTY, dtype=I64, device=dev),
                      torch.zeros((slots + 1, 1 + nvals), dtype=I64, device=dev),
                      torch.zeros((), dtype=I64, device=dev), key.dtype, key.shape[0])


def _check(key: torch.Tensor, values) -> None:
    n = key.shape[0]
    if len(values) > MAX_VALUES:
        raise ValueError(f"group_insert: at most MAX_VALUES ({MAX_VALUES}) value "
                         f"columns, got {len(values)}")
    for c in (key, *values):
        if c.dim() != 1 or c.shape[0] != n:
            raise ValueError(f"group_insert: columns must be 1-D of length {n}, "
                             f"got {tuple(c.shape)}")
        if c.dtype not in (I32, I64):
            raise TypeError(f"group_insert: int32 or int64 columns, got {c.dtype}")
        if c.device != key.device:
            raise ValueError(f"group_insert: columns on {key.device} and {c.device}")


def group_insert_ref(key: torch.Tensor, values, num_rows) -> GroupTable:
    """Plain torch pass: defines the table the kernel fills, up to where
    its groups lie. The live rows sorted by key (stably, the padding
    after them as EMPTY), one group a run; group g in hash slot 1 + g
    (while g < slots), the INT64_MAX key in slot 0; `inserted` the
    distinct live keys. No host read."""
    values = list(values)
    table = _new_table(key, len(values))
    n, dev = key.shape[0], key.device
    live = torch.arange(n, device=dev) < num_rows  # a prefix, before and after the sort
    ks, perm = torch.sort(torch.where(live, key.to(I64), EMPTY), stable=True)
    first = live.clone()
    first[1:] &= ks[1:] != ks[:-1]
    group = torch.cumsum(first, 0) - 1
    is_max = ks == EMPTY
    slot = torch.where(is_max | ~live | (group >= table.slots), 0, group + 1)
    adds = live & ((slot > 0) | is_max)
    table.keys.scatter_(0, slot, torch.where(slot > 0, ks, EMPTY))
    table.payload[:, 0].index_add_(0, slot, adds.to(I64))
    for c, v in enumerate(values):
        table.payload[:, 1 + c].index_add_(0, slot, torch.where(adds, v[perm].to(I64), 0))
    table.inserted.copy_(first.sum())
    return table


def group_insert(key: torch.Tensor, values, num_rows) -> GroupTable:
    """The hash pass (module docstring): a GroupTable."""
    values = list(values)
    _check(key, values)
    dev = key.device
    if dev.type == "cpu":
        return group_insert_ref(key, values, torch.as_tensor(num_rows).reshape(()))
    if dev.type != "cuda":
        raise RuntimeError(f"group_insert: no kernel for device {dev}")
    if not isinstance(num_rows, torch.Tensor) or num_rows.device != dev:
        num_rows = torch.as_tensor(num_rows, device=dev)  # a host value
    if num_rows.numel() != 1:
        raise ValueError("group_insert: num_rows must be one value")
    if num_rows.dtype not in (I32, I64):
        num_rows = num_rows.to(I64)
    key = key.contiguous()
    values = [v.contiguous() for v in values]
    table = _new_table(key, len(values))
    lib, stream = _build.lib(), _build.stream_of(key)
    with _build.on_device(key):
        code = lib.tpq_group_insert(
            key.data_ptr(), key.element_size(), _build.ptr_array(values),
            _build.int_array([v.element_size() for v in values]), len(values),
            num_rows.data_ptr(), num_rows.element_size(), key.shape[0],
            table.keys.data_ptr(), table.payload.data_ptr(), table.inserted.data_ptr(),
            table.slots, table.limit, stream)
    _build.check(code, "group_insert")
    group_insert.launches += 1
    return table


group_insert.launches = 0


def _order(table: GroupTable):
    """The slots' keys in ascending order and the slot of each: stable,
    so slot 0 (the INT64_MAX key's) comes before the empty slots."""
    return torch.sort(table.keys, stable=True)


def group_write_ref(table: GroupTable):
    """Plain torch write: defines the contract the kernel is held to."""
    n, dev = table.capacity, table.keys.device
    keys, perm = _order(table)
    m = min(n, keys.shape[0])  # the rows a group can reach
    g = table.inserted.clamp(0, m)
    live = torch.arange(m, device=dev) < g
    rows = table.payload[perm[:m]]
    outs = [torch.zeros(n, dtype=table.key_dtype, device=dev)]
    outs += [torch.zeros(n, dtype=I64, device=dev) for _ in range(rows.shape[1])]
    outs[0][:m] = torch.where(live, keys[:m], 0)
    for out, j in zip(outs[1:], range(rows.shape[1])):
        out[:m] = torch.where(live, rows[:, j], 0)
    return outs, g.to(I32)


def group_write(table: GroupTable):
    """The groups of a table (module docstring): ([key', count, sum_0,
    ...], G int32)."""
    dev = table.keys.device
    if dev.type == "cpu":
        return group_write_ref(table)
    if dev.type != "cuda":
        raise RuntimeError(f"group_write: no kernel for device {dev}")
    n, nvals = table.capacity, table.payload.shape[1] - 1
    keys, perm = _order(table)
    # made zero (a memset, at the card's full write rate), the kernel
    # writes the groups over rows [0, G)
    key_out = torch.zeros(n, dtype=table.key_dtype, device=dev)
    count = torch.zeros(n, dtype=I64, device=dev)
    sums = [torch.zeros(n, dtype=I64, device=dev) for _ in range(nvals)]
    groups = torch.empty((), dtype=I32, device=dev)
    lib, stream = _build.lib(), _build.stream_of(keys)
    with _build.on_device(keys):
        code = lib.tpq_group_write(
            keys.data_ptr(), perm.data_ptr(), table.payload.data_ptr(), key_out.data_ptr(),
            key_out.element_size(), count.data_ptr(), _build.ptr_array(sums), nvals,
            table.inserted.data_ptr(), keys.shape[0], n, groups.data_ptr(), stream)
    _build.check(code, "group_write")
    group_write.launches += 1
    return [key_out, count, *sums], groups


group_write.launches = 0
