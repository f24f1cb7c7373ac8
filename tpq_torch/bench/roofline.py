"""Per-operator speed-of-light accounting (port of tpq/bench/roofline.py).

  * measure_hbm_bw(): the card's sustained device-memory bandwidth, from
    a streaming copy kernel (csrc/copy.cu) timed with CUDA events;
  * analytic per-operator byte models (tpq's, unchanged): the least
    device-memory traffic each operator must move given relation
    shapes. Models take static capacities, so padding is charged.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tpq_torch.kernels import _build


def measure_hbm_bw(size_mb: int = 256, iters: int = 10, device="cuda") -> float:
    """Sustained read+write GB/s of a device-to-device copy of `size_mb`
    MiB, timed over `iters` launches after one warm-up. Needs a card."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise RuntimeError("measure_hbm_bw times a CUDA kernel: it needs a card")
    nbytes = size_mb * 1024 * 1024
    src = torch.ones(nbytes // 8, dtype=torch.int64, device=dev)
    dst = torch.empty_like(src)
    lib = _build.lib()
    stream = _build.stream_of(src)

    def launch():
        _build.check(lib.tpq_copy(src.data_ptr(), dst.data_ptr(), nbytes, stream),
                     "copy")

    with torch.cuda.device(dev):
        launch()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            launch()
        end.record()
        torch.cuda.synchronize(dev)
    if not torch.equal(src, dst):
        raise RuntimeError("copy kernel produced wrong bytes")
    sec = start.elapsed_time(end) / 1e3 / iters
    return 2 * nbytes / sec / 1e9  # read + write


@dataclass(frozen=True)
class OpBytes:
    """Minimum device-memory bytes one operator execution must move."""

    read: int
    write: int

    @property
    def total(self) -> int:
        return self.read + self.write


def row_bytes(ncols: int, itemsize: int = 8) -> int:
    return ncols * itemsize


def filter_bytes(cap_in: int, ncols: int) -> OpBytes:
    # read every column once, write the compacted copy once
    b = row_bytes(ncols)
    return OpBytes(read=cap_in * b, write=cap_in * b)


def probe_bytes(cap_probe: int, ncols_probe: int, cap_out: int, ncols_out: int) -> OpBytes:
    """The probe streams the probe side once (the table stays on chip)
    and writes the output once."""
    return OpBytes(read=cap_probe * row_bytes(ncols_probe), write=cap_out * row_bytes(ncols_out))


def partition_bytes(cap: int, ncols: int, passes: int = 1) -> OpBytes:
    """Each radix pass reads and rewrites every column."""
    b = cap * row_bytes(ncols) * passes
    return OpBytes(read=b, write=b)


def sort_bytes(cap: int, ncols: int, passes: int) -> OpBytes:
    """Radix sort = `passes` full read+write sweeps over (key + permuted
    columns)."""
    b = cap * row_bytes(ncols) * passes
    return OpBytes(read=b, write=b)


def hash_join_bytes(cap_r: int, ncols_r: int, cap_s: int, ncols_s: int,
                    cap_out: int, partition_passes: int = 1) -> dict[str, OpBytes]:
    """Per-phase byte model of the partitioned hash join: partition both
    sides, build (read R once), probe (stream S, write out)."""
    ncols_out = 1 + (ncols_r - 1) + (ncols_s - 1)
    return {
        "partition_r": partition_bytes(cap_r, ncols_r, partition_passes),
        "partition_s": partition_bytes(cap_s, ncols_s, partition_passes),
        "build": OpBytes(read=cap_r * row_bytes(ncols_r), write=0),
        "probe": probe_bytes(cap_s, ncols_s, cap_out, ncols_out),
    }


def merge_join_bytes(cap_r: int, ncols_r: int, cap_s: int, ncols_s: int,
                     cap_out: int, sort_passes: int = 6) -> dict[str, OpBytes]:
    ncols_out = 1 + (ncols_r - 1) + (ncols_s - 1)
    return {
        "sort_r": sort_bytes(cap_r, ncols_r, sort_passes),
        "merge": OpBytes(read=cap_s * row_bytes(ncols_s) + cap_r * row_bytes(ncols_r),
                         write=cap_out * row_bytes(ncols_out)),
    }


def aggregate_bytes(cap: int, ncols: int) -> OpBytes:
    # read input once; output (groups) bounded by input capacity
    b = cap * row_bytes(ncols)
    return OpBytes(read=b, write=cap * row_bytes(ncols + 1))


@dataclass
class RooflineResult:
    op: str
    elapsed_s: float
    bytes_model: int
    hbm_bw_gbps: float
    rows: int

    @property
    def achieved_gbps(self) -> float:
        return self.bytes_model / self.elapsed_s / 1e9

    @property
    def roofline_frac(self) -> float:
        return self.achieved_gbps / self.hbm_bw_gbps

    @property
    def sol_time_s(self) -> float:
        return self.bytes_model / (self.hbm_bw_gbps * 1e9)

    def row(self) -> dict:
        return {
            "op": self.op,
            "elapsed_ms": self.elapsed_s * 1e3,
            "sol_ms": self.sol_time_s * 1e3,
            "model_bytes": self.bytes_model,
            "achieved_gbps": self.achieved_gbps,
            "hbm_bw_gbps": self.hbm_bw_gbps,
            "roofline_pct": 100.0 * self.roofline_frac,
            "rows": self.rows,
            "rows_per_sec": self.rows / self.elapsed_s if self.elapsed_s else 0.0,
        }
