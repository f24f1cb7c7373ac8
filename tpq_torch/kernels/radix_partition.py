"""Radix partition: the bucket histogram and the stable reorder into
padded per-partition planes (port of tpq/kernels/radix_partition.py).

  * radix_histogram(bucket, nbuckets): the count of each id in
    [0, nbuckets), other ids ignored. It runs
    tpq_torch/csrc/radix_partition.cu (one launch, no memset) on CUDA
    tensors and `radix_histogram_ref`, its plain torch version, on CPU
    tensors; the distributed join's capacity planner calls it. tpq's
    `tile` and `interpret` arguments are dropped (a CUDA grid-stride loop
    has no tile, and the CPU runs the plain version), and with `tile` its
    N % tile == 0 requirement: the kernel takes any N at any offset.
  * partition_starts, padded_gather, partition_padded: plain torch, one
    stable sort, a searchsorted and a gather, as tpq's are.
"""

from __future__ import annotations

import torch

from tpq_torch.kernels import _build
from tpq_torch.ops.union_join import _stable_lexsort

I32 = torch.int32
I64 = torch.int64
MAX_BUCKETS = 232448 // 4  # int32 bins in a Hopper block's shared memory

# The stream-state owner (_build.stream_state) of the kernel's ticket and
# bucket accumulator: int32 words, zero between calls (the kernel leaves
# them so)
HIST_OWNER = "histogram"


def radix_histogram_ref(bucket: torch.Tensor, nbuckets: int) -> torch.Tensor:
    """Plain torch histogram: defines the contract the kernel is held to.
    Out-of-range ids go to an extra bin that is cut off."""
    b = bucket.to(I64)
    b = torch.where((b >= 0) & (b < nbuckets), b, nbuckets)
    counts = torch.zeros(nbuckets + 1, dtype=I64, device=b.device)
    counts.scatter_add_(0, b, torch.ones_like(b))
    return counts[:nbuckets].to(I32)


def radix_histogram(bucket: torch.Tensor, nbuckets: int) -> torch.Tensor:
    """int32[nbuckets] counts of each id of `bucket` (int32[N]) in
    [0, nbuckets); ids outside the range (e.g. the padding sentinel) are
    ignored. Launches counted in `.launches`."""
    if bucket.dim() != 1 or bucket.dtype != I32:
        raise ValueError(f"radix_histogram: ids must be int32[N], got "
                         f"{bucket.dtype}{tuple(bucket.shape)}")
    if not 1 <= nbuckets <= MAX_BUCKETS:
        raise ValueError(f"radix_histogram: nbuckets must be in 1..{MAX_BUCKETS} "
                         f"(one block's shared memory), got {nbuckets}")
    if bucket.device.type == "cpu":
        return radix_histogram_ref(bucket, nbuckets)
    if bucket.device.type != "cuda":
        raise RuntimeError(f"radix_histogram: no kernel for device {bucket.device}")
    n = bucket.shape[0]
    if n == 0:
        return torch.zeros(nbuckets, dtype=I32, device=bucket.device)
    bucket = bucket.contiguous()
    out = torch.empty(nbuckets, dtype=I32, device=bucket.device)
    stream = _build.stream_of(bucket)
    acc = _build.stream_state(HIST_OWNER, bucket.device, stream, nbuckets + 1, I32)
    with _build.on_device(bucket):
        code = _build.lib().tpq_radix_histogram(
            bucket.data_ptr(), n, nbuckets, out.data_ptr(), acc.data_ptr(), acc.numel(),
            stream)
    _build.check(code, "radix_histogram")
    radix_histogram.launches += 1
    return out


radix_histogram.launches = 0


def partition_starts(bucket_sorted: torch.Tensor, npart: int) -> torch.Tensor:
    """Exclusive prefix layout of a bucket-sorted column: starts[p] = first
    row of partition p; starts[npart] = end of live rows."""
    ids = torch.arange(npart + 1, dtype=bucket_sorted.dtype,
                       device=bucket_sorted.device)
    return torch.searchsorted(bucket_sorted.contiguous(), ids).to(I32)


def padded_gather(col: torch.Tensor, starts: torch.Tensor, npart: int, cap: int):
    """[N]-sorted column -> [npart, cap] padded planes + validity mask."""
    i = torch.arange(cap, dtype=I64, device=col.device)[None, :]
    s = starts.to(I64)
    src = torch.clamp_max(s[:-1][:, None] + i, col.shape[0] - 1)
    valid = i < (s[1:] - s[:-1])[:, None]
    return col[src], valid


def partition_padded(bucket: torch.Tensor, npart: int, part_cap: int,
                     extra_keys: tuple[torch.Tensor, ...] = ()):
    """Stable-partition row indices by bucket id (sentinel id == npart is
    padding and lands at the end). Returns (rowid2d int32 [npart,
    part_cap], valid2d, starts, overflow_flag). `extra_keys` refine the
    order within a bucket (e.g. (slot, key) for the robin-hood layout).
    tpq's optimization_barrier fences XLA's producers from its sort; eager
    torch has none to fence."""
    n = bucket.shape[0]
    idx = torch.arange(n, dtype=I32, device=bucket.device)
    perm = _stable_lexsort([bucket, *extra_keys])
    bucket_s, idx_s = bucket[perm], idx[perm]
    starts = partition_starts(bucket_s, npart)
    part_len = starts[1:] - starts[:-1]
    overflow = (part_len > part_cap).any()
    rowid2d, valid2d = padded_gather(idx_s, starts, npart, part_cap)
    return rowid2d, valid2d, starts, overflow
