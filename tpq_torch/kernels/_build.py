"""Builds the port's CUDA kernels at first use and binds them with ctypes.

`nvcc` compiles every source under tpq_torch/csrc/ into one shared
library with a plain C interface (no PyTorch headers, so the build takes
seconds), in tpq_torch/build/ (git-ignored): one `nvcc -c` per source,
all started together, then one link. The library is rebuilt when a
source is newer than it. Each C entry point returns cudaGetLastError();
`check` raises on anything but 0.

Nothing here runs at import: the CPU tests import every module, and
`nvcc` is needed only once a CUDA tensor reaches a kernel.
"""

from __future__ import annotations

import contextlib
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
              "-Xcompiler", "-fPIC"]

P, I32, I64, U32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint32
_SIGNATURES = {
    # name: argtypes (restype is int: the cudaError_t of the launch)
    "tpq_pad": [P, P, P, I32, P, P, I32, I64, I64, P, P],
    "tpq_pack": [P, P, P, I32, P, I64, P, I64, P, P],
    "tpq_walk_emit": [P, P, I32, P, I32, I32, I32, I32, I32, P, P, P, P, I32, P,
                      P, P, P, P, I64, P, I64, P, P],
    "tpq_walk_emit_smem": [I32, I32, I32],
    "tpq_walk_emit_slots": [I32, I32, I32],
    "tpq_probe_walk": [P, P, I32, P, I32, I32, I32, I32, I32, P, P, P, P, P, P, P],
    "tpq_probe_walk_slots": [I32],
    "tpq_split_digit": [P, P, I32, P, P, P, I32, I32, I64, P, I64, P],
    "tpq_radix_histogram": [P, I64, I32, P, P, I64, P],
    "tpq_hash_keys": [P, I64, I32, U32, P, P],
    "tpq_probe_layout": [P, P, I32, P, P, I32, I64, I32, I64, U32, P, P, P, P, P, P, I64,
                         P],
    "tpq_probe_layout2": [P, P, I32, P, P, I32, I64, I32, I64, U32, P, P, P, P, P, P, I64, P,
                          I64, P],
    "tpq_probe_layout2_scratch": [I64, I32],
    "tpq_lane_build": [P, P, I32, P, I32, I64, I32, I32, U32, U32, P, P, P, P, P, P],
    "tpq_copy": [P, P, I64, P],
    "tpq_stamp": [P, P],
    "tpq_aggregate_runs": [P, I32, P, P, I32, P, I32, I64, P, P, P, P, I64, P, P],
    "tpq_group_insert": [P, I32, P, P, I32, P, I32, I64, P, P, P, I64, I64, P],
    "tpq_group_write": [P, P, P, P, I32, P, P, I32, P, I64, I64, P, P],
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
    nvcc = nvcc_path()
    # build into temporary names, then rename: a concurrent loader sees
    # either the old library or the complete new one
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in sources()]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
                 for src, obj in zip(sources(), objs)]
        errors = []
        for src, proc in zip(sources(), procs):
            out, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{src.name} ({proc.returncode}):\n{out}")
        if errors:
            raise RuntimeError("nvcc failed: " + "\n".join(errors))
        so = os.path.join(tmp, SO.name)
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", so, *objs],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr}")
        os.replace(so, SO)
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


def on_device(t):
    """The device guard a launch on t's card needs: none when that card
    is already the current one."""
    import torch

    if t.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)


def stream_of(t) -> int:
    """The handle of the current stream of t's card (what
    torch.cuda.current_stream(t.device).cuda_stream gives, without making
    a Stream object: a few microseconds less per launch)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.device.index)


# (owner, device index, stream) -> the device buffer a kernel keeps across
# its launches on that stream: the decoupled look-back state of PACK and
# the walk/emit (one owner), of the run-end pass (one owner a record
# width), the histogram's accumulator. Made zero; the kernels leave it
# fit for their next launch. A CUDA graph takes its stream's buffers at
# capture (take_stream_state), so no two graphs share one.
_stream_states: dict = {}
STATE_MIN_WORDS = 1024


def stream_state(owner, device, stream: int, words: int, dtype):
    """The buffer of `owner` for `stream` on `device`, with at least
    `words` elements: reused while it fits, else replaced by a zeroed one
    of max(words, twice the old, STATE_MIN_WORDS)."""
    import torch

    key = (owner, device.index, stream)
    st = _stream_states.get(key)
    if st is None or st.numel() < words:
        size = max(words, 2 * st.numel() if st is not None else 0, STATE_MIN_WORDS)
        st = _stream_states[key] = torch.zeros(size, dtype=dtype, device=device)
    return st


def take_stream_state(device, stream: int) -> list:
    """Removes every owner's buffer of `stream` on `device` and returns
    them: a graph keeps the ones it was captured with, and the next user
    of a stream of the same handle starts from new ones."""
    keys = [k for k in _stream_states if k[1:] == (device.index, stream)]
    return [_stream_states.pop(k) for k in keys]
