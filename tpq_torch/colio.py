"""Binary columnar dump/load shared with the C++ oracle (port of
tpq/colio.py, byte-compatible with it and with oracle/common.h). The
format is deliberately plain:

  magic   "TPQC"                    4 bytes
  version u32 = 1
  ncols   u32
  per column:
    name_len u32, name bytes (utf-8, no NUL)
    dtype    u32   (1=int64, 2=int32, 3=float32, 4=uint64, 5=float64)
    nrows    u64
    data     nrows * itemsize bytes, little-endian, contiguous

All columns must share nrows. Integers little-endian.
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = b"TPQC"
VERSION = 1

_DTYPES = {1: np.int64, 2: np.int32, 3: np.float32, 4: np.uint64, 5: np.float64}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def dump(path: str, columns: dict[str, np.ndarray]) -> None:
    nrows = {len(v) for v in columns.values()}
    if len(nrows) > 1:
        raise ValueError(f"ragged columns: {nrows}")
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<II", VERSION, len(columns)))
        for name, col in columns.items():
            col = np.ascontiguousarray(col)
            code = _CODES.get(col.dtype)
            if code is None:
                raise ValueError(f"unsupported dtype {col.dtype} for column {name}")
            nb = name.encode("utf-8")
            f.write(struct.pack("<I", len(nb)))
            f.write(nb)
            f.write(struct.pack("<IQ", code, len(col)))
            f.write(col.astype(col.dtype.newbyteorder("<"), copy=False).tobytes())


def load(path: str) -> dict[str, np.ndarray]:
    with open(path, "rb") as f:
        if f.read(4) != MAGIC:
            raise ValueError(f"{path}: bad magic")
        version, ncols = struct.unpack("<II", f.read(8))
        if version != VERSION:
            raise ValueError(f"{path}: version {version}")
        out = {}
        for _ in range(ncols):
            (name_len,) = struct.unpack("<I", f.read(4))
            name = f.read(name_len).decode("utf-8")
            code, nrows = struct.unpack("<IQ", f.read(12))
            dt = np.dtype(_DTYPES[code]).newbyteorder("<")
            data = f.read(nrows * dt.itemsize)
            out[name] = np.frombuffer(data, dtype=dt).astype(_DTYPES[code])
        return out
