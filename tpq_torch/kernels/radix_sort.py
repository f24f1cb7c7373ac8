"""LSD radix sort for the merge path (port of tpq/kernels/radix_sort.py).

  * _split1(planes, bit): one stable 1-bit split of int32 planes:
    bit-0 rows first, then bit-1 rows, each group in order. tpq's takes
    n0, the zero count, from its caller; here the kernel's own count
    scan yields it. It runs
    tpq_torch/csrc/radix_sort.cu on CUDA tensors and `split1_ref`, its
    plain torch version, on CPU tensors.
  * lsd_radix_sort_bits: one split per (plane, bit) of an arbitrary bit
    sequence, least significant first; lsd_radix_sort: over the low
    key_bits of u32 key planes, live-prefix padding last.
  * radix_sort_perm and sort_rows: one stable torch.sort, as tpq's are
    one lax.sort.

The planes stay tpq's 32-bit planes: the union-sort engine's radix
branch carries its int64 columns as (lo, hi) pairs so that a pass moves
int32 rows. msd_partition partitions by the top key bits through
radix_partition.partition_padded.
"""

from __future__ import annotations

import torch

from tpq_torch.columnar import Table
from tpq_torch.kernels import _build

I32 = torch.int32
I64 = torch.int64


def _check_planes(planes, n: int) -> list[torch.Tensor]:
    if not planes:
        raise ValueError("_split1: at least one plane")
    for p in planes:
        if p.dtype != I32 or p.dim() != 1 or p.shape[0] != n:
            raise ValueError(f"_split1: planes must be int32[{n}], got "
                             f"{p.dtype}{tuple(p.shape)}")
    return [p.contiguous() for p in planes]


def split1_ref(planes, bit: torch.Tensor) -> list[torch.Tensor]:
    """Plain torch split: defines the contract the kernel is held to.
    Row k with z zeros before it goes to z if bit[k] == 0, else to
    n0 + (k - z), n0 being the number of zero bits."""
    z = bit == 0
    z64 = z.to(I64)
    before = torch.cumsum(z64, 0) - z64
    n0 = z64.sum()
    k = torch.arange(bit.shape[0], device=bit.device)
    dest = torch.where(z, before, n0 + k - before)
    outs = []
    for p in planes:
        o = torch.empty_like(p)
        o[dest] = p
        outs.append(o)
    return outs


def _split1(planes, bit: torch.Tensor) -> list[torch.Tensor]:
    """One stable LSD pass: the planes reordered so that bit == 0 rows
    precede bit != 0 rows, order kept within each class. Launches
    counted in `.launches`."""
    n = bit.shape[0]
    planes = _check_planes(planes, n)
    if bit.device.type == "cpu":
        return split1_ref(planes, bit)
    if bit.device.type != "cuda":
        raise RuntimeError(f"_split1: no kernel for device {bit.device}")
    if n >= 2**31:
        raise ValueError("_split1: int32 row counts need n < 2^31")
    bit = bit.to(I32).contiguous()
    lib = _build.lib()
    blocks = max(1, -(-n // lib.tpq_split1_tile()))
    outs = [torch.empty_like(p) for p in planes]
    block_zeros = torch.empty(blocks, dtype=I32, device=bit.device)
    block_offsets = torch.empty(blocks, dtype=I32, device=bit.device)
    total = torch.empty((), dtype=I32, device=bit.device)
    with torch.cuda.device(bit.device):
        code = lib.tpq_split1(
            _build.ptr_array(planes), _build.ptr_array(outs), len(planes),
            bit.data_ptr(), n, block_zeros.data_ptr(),
            block_offsets.data_ptr(), total.data_ptr(), _build.stream_of(bit))
    _build.check(code, "_split1")
    _split1.launches += 1
    return outs


_split1.launches = 0


def lsd_radix_sort_bits(planes, bit_specs) -> list[torch.Tensor]:
    """Stable LSD radix sort of all planes by an arbitrary bit sequence:
    bit_specs is [(plane_index, bit_index), ...], least significant
    first. Unsigned bit order: callers bias signed planes."""
    planes = [p.to(I32) for p in planes]
    for pi, b in bit_specs:
        planes = _split1(planes, (planes[pi] >> b) & 1)
    return planes


def lsd_radix_sort(key_planes, val_planes, num_rows, key_bits: int):
    """Stable LSD radix sort of all planes by the u32 key planes
    (little-endian: key_planes[0] holds bits 0..31), over the low
    `key_bits` bits. Rows >= num_rows stay last (one final pass on the
    live flag). Returns [key planes..., val planes...] sorted."""
    nk = len(key_planes)
    if key_bits > 32 * nk:
        raise ValueError(f"key_bits {key_bits} > {32 * nk} bits of key planes")
    n = key_planes[0].shape[0]
    notlive = (torch.arange(n, device=key_planes[0].device) >= num_rows).to(I32)
    planes = [p.to(I32) for p in key_planes] + [p.to(I32) for p in val_planes]
    planes.append(notlive)
    specs = [(b // 32, b % 32) for b in range(key_bits)]
    specs.append((len(planes) - 1, 0))
    return lsd_radix_sort_bits(planes, specs)[:-1]


def radix_sort_perm(keys: torch.Tensor, num_valid=None) -> torch.Tensor:
    """Permutation (int64) that stably sorts `keys` ascending; rows >=
    num_valid order last."""
    if num_valid is not None:
        keys = torch.where(torch.arange(keys.shape[0], device=keys.device)
                           < num_valid, keys, torch.iinfo(keys.dtype).max)
    return torch.sort(keys, stable=True).indices


def sort_rows(t: Table, key: str = "key") -> Table:
    """Co-sort every column of t by `key`, padding last; the key column
    holds the dtype's max in the padding rows, as tpq's does."""
    k = t.col(key)
    k = torch.where(t.valid_mask(), k, torch.iinfo(k.dtype).max)
    ks, perm = torch.sort(k, stable=True)
    cols = {key: ks}
    cols.update({n: t.col(n)[perm] for n in t.names if n != key})
    return Table(cols, t.num_rows)


def msd_partition(keys: torch.Tensor, num_valid, bits: int, part_cap: int):
    """Partition rows by the TOP `bits` of the (sign-biased) key: output
    partitions are contiguous, ordered key ranges (MSD radix). Returns
    (rowid2d [2^bits, part_cap], valid2d, overflow). tpq biases in
    uint64; torch on the CPU has no uint64 shift, so the top bits come
    from an int64 shift, masked, with the sign bit flipped after."""
    from tpq_torch.kernels.radix_partition import partition_padded

    npart = 1 << bits
    k = keys.to(I64)
    bucket = ((k >> (64 - bits)) & (npart - 1)) ^ (npart >> 1)
    live = torch.arange(k.shape[0], device=k.device) < num_valid
    bucket = torch.where(live, bucket, npart).to(I32)
    rowid2d, valid2d, _, overflow = partition_padded(bucket, npart, part_cap)
    return rowid2d, valid2d, overflow
