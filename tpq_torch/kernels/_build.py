"""Builds the port's CUDA kernels at first use and binds them with ctypes.

`nvcc` compiles every source under tpq_torch/csrc/ into one shared
library with a plain C interface (no PyTorch headers, so the build takes
seconds), in tpq_torch/build/ (git-ignored). The library is rebuilt when
a source is newer than it. Each C entry point returns cudaGetLastError();
`check` raises on anything but 0.

Nothing here runs at import: the CPU tests import every module, and
`nvcc` is needed only once a CUDA tensor reaches a kernel.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"
SO = BUILD / "libtpq_torch_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

P, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    # name: argtypes (restype is int: the cudaError_t of the launch)
    "tpq_pad": [P, P, P, I32, P, P, I64, I64, P, P],
    "tpq_pack": [P, P, P, I32, P, I64, P, P, P, P],
    "tpq_walk_emit": [P, P, I32, P, I32, I32, I32, I32, P, P, P, P, I32, P, P,
                      P, P, P, I64, P, P, P, P],
    "tpq_copy": [P, P, I64, P],
}

_lib = None  # the loaded library, shared by every caller in the process


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build(force: bool = False) -> float:
    """Compiles the library if it is missing or stale. Returns the seconds
    spent compiling (0.0 when it was up to date)."""
    srcs = sources() + sorted(CSRC.glob("*.cuh"))
    if (not force and SO.exists()
            and all(SO.stat().st_mtime >= s.stat().st_mtime for s in srcs)):
        return 0.0
    BUILD.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # build into a temporary name, then rename: a concurrent loader sees
    # either the old library or the complete new one
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    try:
        res = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *map(str, sources())],
            capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
        os.replace(tmp, SO)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return time.perf_counter() - t0


def lib() -> ctypes.CDLL:
    """The bound kernel library, built on first call."""
    global _lib
    if _lib is None:
        build()
        so = ctypes.CDLL(str(SO))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(so, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        so.tpq_error_string.argtypes = [ctypes.c_int]
        so.tpq_error_string.restype = ctypes.c_char_p
        so.tpq_pack_tile.argtypes = []
        so.tpq_pack_tile.restype = ctypes.c_int64
        _lib = so
    return _lib


def check(code: int, what: str) -> None:
    if code != 0:
        msg = lib().tpq_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def ptr_array(tensors) -> ctypes.Array:
    """A host array of device pointers, for an entry point's column list."""
    return (ctypes.c_void_p * max(1, len(tensors)))(*[t.data_ptr() for t in tensors])


def int_array(values) -> ctypes.Array:
    return (ctypes.c_int * max(1, len(values)))(*values)


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
