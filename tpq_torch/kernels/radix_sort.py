"""LSD radix sort for the merge path (port of tpq/kernels/radix_sort.py).

  * split_digit(planes, specs): one stable pass by the digit of up to 8
    bit specs (plane index, bit index), spec i giving digit bit i: the
    group's one-bit splits in one pass. It runs
    tpq_torch/csrc/radix_sort.cu on CUDA tensors and `split_digit_ref`,
    its plain torch version (the splits one by one), on CPU tensors.
  * _split1(planes, bit): tpq's one stable 1-bit split: bit-0 rows first,
    then bit-1 rows, each group in order (tpq's takes n0, the zero
    count, from its caller; the kernel counts it). On the card it is the
    digit kernel with a 1-bit digit; `split1_ref` is its plain version.
  * lsd_radix_sort_bits: an arbitrary bit sequence, least significant
    first, in passes of DIGIT_BITS specs; lsd_radix_sort: over the low
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
MAX_DIGIT_BITS = 8  # kMaxBits in csrc/radix_sort.cu
DIGIT_TILE = 4096  # kTile in csrc/radix_sort.cu (the kernel checks the scratch size)
# specs per pass of lsd_radix_sort_bits (chip_smoke.py times the widths
# 4 to 8 over the radix merge's sort; PERF.md)
DIGIT_BITS = 8


def _check_planes(planes, n: int, what: str) -> list[torch.Tensor]:
    if not planes:
        raise ValueError(f"{what}: at least one plane")
    for p in planes:
        if p.dtype != I32 or p.dim() != 1 or p.shape[0] != n:
            raise ValueError(f"{what}: planes must be int32[{n}], got "
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


def split_digit_ref(planes, specs) -> list[torch.Tensor]:
    """Plain torch digit pass: defines the contract the kernel is held
    to. The group's one-bit splits in order, each bit read from the
    planes as the splits before it left them."""
    for pi, b in specs:
        planes = split1_ref(planes, (planes[pi] >> b) & 1)
    return planes


def digit_runs(bits) -> list[list]:
    """[source, first bit, length] runs of a digit given bit by bit as
    (source, bit): consecutive bits of one source make one run."""
    runs = []
    for src, b in bits:
        last = runs[-1] if runs else None
        if last is not None and last[0] is src and last[1] + last[2] == b:
            last[2] += 1
        else:
            runs.append([src, b, 1])
    return runs


def _digit_pass(planes, bits, nonzero: bool = False) -> list[torch.Tensor]:
    """Launches the digit kernel: digit bit i is bit bits[i][1] of the
    int32 plane bits[i][0] (with nonzero, the one digit bit is
    bits[0][0] != 0); planes are int32 CUDA tensors of one length."""
    n = planes[0].shape[0]
    if n >= 2**31:
        raise ValueError("split: int32 row counts need n < 2^31")
    dev = planes[0].device
    for t, _ in bits:
        if t.device != dev or t.dtype != I32 or t.shape[0] != n:
            raise ValueError(f"split: digit planes must be int32[{n}] on {dev}")
    runs = digit_runs(bits)
    outs = [torch.empty_like(p) for p in planes]
    words = (-(-n // DIGIT_TILE) + 1) << len(bits)
    scratch = torch.empty(words, dtype=I32, device=dev)
    with _build.on_device(scratch):
        code = _build.lib().tpq_split_digit(
            _build.ptr_array(planes), _build.ptr_array(outs), len(planes),
            _build.ptr_array([r[0] for r in runs]), _build.int_array([r[1] for r in runs]),
            _build.int_array([r[2] for r in runs]), len(runs), int(nonzero), n,
            scratch.data_ptr(), words, _build.stream_of(scratch))
    _build.check(code, "split")
    return outs


def split_digit(planes, specs) -> list[torch.Tensor]:
    """One stable LSD pass by the digit of `specs`, [(plane index, bit
    index)] of at most MAX_DIGIT_BITS, spec i giving digit bit i (later
    specs more significant). Launches counted in `.launches`."""
    n = planes[0].shape[0] if planes else 0
    planes = _check_planes(planes, n, "split_digit")
    specs = [(int(pi), int(b)) for pi, b in specs]
    if not 1 <= len(specs) <= MAX_DIGIT_BITS:
        raise ValueError(f"split_digit: 1..{MAX_DIGIT_BITS} bit specs, got {len(specs)}")
    if not all(0 <= pi < len(planes) and 0 <= b < 32 for pi, b in specs):
        raise ValueError(f"split_digit: specs {specs} outside {len(planes)} int32 planes")
    dev = planes[0].device
    if dev.type == "cpu":
        return split_digit_ref(planes, specs)
    if dev.type != "cuda":
        raise RuntimeError(f"split_digit: no kernel for device {dev}")
    outs = _digit_pass(planes, [(planes[pi], b) for pi, b in specs])
    split_digit.launches += 1
    return outs


split_digit.launches = 0


def _split1(planes, bit: torch.Tensor) -> list[torch.Tensor]:
    """One stable LSD pass: the planes reordered so that bit == 0 rows
    precede bit != 0 rows, order kept within each class. Launches
    counted in `.launches`."""
    n = bit.shape[0]
    planes = _check_planes(planes, n, "_split1")
    if bit.device.type == "cpu":
        return split1_ref(planes, bit)
    if bit.device.type != "cuda":
        raise RuntimeError(f"_split1: no kernel for device {bit.device}")
    if bit.dtype != I32:  # a cast could make a nonzero value 0
        bit = (bit != 0).to(I32)
    outs = _digit_pass(planes, [(bit.contiguous(), 0)], nonzero=True)
    _split1.launches += 1
    return outs


_split1.launches = 0


def digit_passes(n_specs: int, digit_bits: int = DIGIT_BITS) -> int:
    """The passes lsd_radix_sort_bits makes for n_specs bit specs."""
    return -(-n_specs // digit_bits)


def lsd_radix_sort_bits(planes, bit_specs, digit_bits: int = DIGIT_BITS
                        ) -> list[torch.Tensor]:
    """Stable LSD radix sort of all planes by an arbitrary bit sequence:
    bit_specs is [(plane_index, bit_index), ...], least significant
    first, sorted digit_bits specs a pass. Unsigned bit order: callers
    bias signed planes."""
    planes = [p.to(I32) for p in planes]
    specs = list(bit_specs)
    for g in range(0, len(specs), digit_bits):
        planes = split_digit(planes, specs[g:g + digit_bits])
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
