"""Binary serialization with a fixed little-endian wire format.

A copy of ``dmlc_core_tpu/serializer.py`` (the checkpoint's bytes depend
on it). Equivalent of reference ``include/dmlc/serializer.h`` (410 L) +
``include/dmlc/endian.h``: PODs are written fixed-width **little-endian on
disk** regardless of host order (the reference's DMLC_IO_NO_ENDIAN_SWAP
choice, endian.h:39-51), containers as ``uint64 size`` + elements, strings as
``uint64 size`` + raw bytes, maps as ``uint64 size`` + key/value pairs.

The C++ native core (cpp/src/serializer.h) writes the *same* wire format, so
row-block caches and serialized containers round-trip across languages; tests
assert this cross-language compatibility (the reference validates the
equivalent property via its big-endian s390x CI lane,
scripts/test_script.sh:60-65).
"""

from __future__ import annotations

import struct
from typing import Any, BinaryIO, Dict, List

import numpy as np

from dmlc_core_tpu_torch.base import DMLCError

__all__ = ["BinaryWriter", "BinaryReader"]

# struct format chars for supported POD types (always little-endian '<')
_POD = {
    "int8": "b", "uint8": "B",
    "int16": "h", "uint16": "H",
    "int32": "i", "uint32": "I",
    "int64": "q", "uint64": "Q",
    "float32": "f", "float64": "d",
    "bool": "?",
}


class BinaryWriter:
    """Typed little-endian writer over a binary file-like object."""

    def __init__(self, stream: BinaryIO):
        self.stream = stream

    def write_scalar(self, value: Any, dtype: str) -> None:
        """Write one POD scalar of the given dtype (LE on disk)."""
        self.stream.write(struct.pack("<" + _POD[dtype], value))

    def write_bytes(self, data: bytes) -> None:
        """Write a length-prefixed byte string."""
        self.write_scalar(len(data), "uint64")
        self.stream.write(data)

    def write_string(self, s: str) -> None:
        """Write a length-prefixed UTF-8 string."""
        self.write_bytes(s.encode("utf-8"))

    def write_array(self, arr: np.ndarray) -> None:
        """Vector of PODs: uint64 count + packed little-endian elements."""
        arr = np.ascontiguousarray(arr)
        if arr.dtype.name not in _POD:
            raise DMLCError(f"unsupported array dtype {arr.dtype}")
        self.write_scalar(arr.size, "uint64")
        le = arr.astype(arr.dtype.newbyteorder("<"), copy=False)
        self.stream.write(le.tobytes())

    def write_str_list(self, items: List[str]) -> None:
        """Write a length-prefixed list of strings."""
        self.write_scalar(len(items), "uint64")
        for s in items:
            self.write_string(s)

    def write_str_map(self, d: Dict[str, str]) -> None:
        """Write a length-prefixed str->str mapping."""
        self.write_scalar(len(d), "uint64")
        for k, v in d.items():
            self.write_string(k)
            self.write_string(v)


class BinaryReader:
    """Typed little-endian reader; raises on truncated input."""

    def __init__(self, stream: BinaryIO):
        self.stream = stream

    def _read_exact(self, n: int) -> bytes:
        data = self.stream.read(n)
        if len(data) != n:
            raise DMLCError(
                f"truncated stream: wanted {n} bytes, got {len(data)}")
        return data

    def read_scalar(self, dtype: str) -> Any:
        """Read one POD scalar of the given dtype (LE on disk)."""
        fmt = "<" + _POD[dtype]
        return struct.unpack(fmt, self._read_exact(struct.calcsize(fmt)))[0]

    def read_bytes(self) -> bytes:
        """Read a length-prefixed byte string."""
        n = self.read_scalar("uint64")
        return self._read_exact(n)

    def read_string(self) -> str:
        """Read a length-prefixed UTF-8 string."""
        return self.read_bytes().decode("utf-8")

    def read_array(self, dtype: str) -> np.ndarray:
        """Read a length-prefixed numpy array of the given dtype."""
        n = self.read_scalar("uint64")
        np_dt = np.dtype(dtype).newbyteorder("<")
        raw = self._read_exact(n * np_dt.itemsize)
        # always copy: frombuffer views are read-only, and callers get the
        # mutable-container contract of the reference's Load
        return np.frombuffer(raw, dtype=np_dt).astype(np.dtype(dtype))

    def read_str_list(self) -> List[str]:
        """Read a length-prefixed list of strings."""
        return [self.read_string() for _ in range(self.read_scalar("uint64"))]

    def read_str_map(self) -> Dict[str, str]:
        """Read a length-prefixed str->str mapping."""
        n = self.read_scalar("uint64")
        out: Dict[str, str] = {}
        for _ in range(n):
            k = self.read_string()
            out[k] = self.read_string()
        return out
