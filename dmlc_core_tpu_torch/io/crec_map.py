"""``.crec`` batches filled in place from a read-only mapping of the file
(ctypes binding to ``csrc/crec_fill.cc``).

The port's own copy of the shared core's ``.crec`` fill
(``cpp/src/csr_rec.cc`` ``CsrRecBatcher::FillPacked``, which the JAX
package's native library also builds, so it stays as it is): the file is
mapped once, each record's planes are copied from the mapping straight into
the packed batch, and a pooled buffer's padding is written only where its
previous fill left useful entries, its row ids only from the first row
whose length differs from that fill's. The planes are FillPacked's, bit
for bit. It serves one local file, whole or as one of ``npart`` byte-range
parts cut as the shared RecordIO split cuts them (:func:`mappable`);
every other ``.crec`` URI (a list, a directory, a remote store, a chunk
cache) keeps :class:`~dmlc_core_tpu_torch.io.native.NativeCsrRecBatcher`.

The library is compiled with ``g++`` into ``_build/`` at first use, under
the package's build lock, with the native core's flags (a private
libstdc++, so it loads beside the CUDA build of torch). Calls release the
GIL (ctypes), so a fill runs beside the training loop's thread.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import numpy as np

from dmlc_core_tpu_torch.base import (BUILD_DIR, PACKAGE_DIR, DMLCError,
                                      build_if_stale)

__all__ = ["MappedCsrRecBatcher", "BufferState", "mappable", "build"]

SOURCE = os.path.join(PACKAGE_DIR, "csrc", "crec_fill.cc")
LIB_PATH = os.path.join(BUILD_DIR, "libcrec_fill.so")

_vp = ctypes.c_void_p
_u64, _i32, _u32 = ctypes.c_uint64, ctypes.c_int32, ctypes.c_uint32
# The library's C boundary, one row a function: name -> (restype,
# [argtypes]); the QA lane holds it against csrc/crec_fill.cc.
_SIGNATURES = {
    "dct_crec_map_last_error": (ctypes.c_char_p, []),
    "dct_crec_map_open": (ctypes.c_int, [ctypes.c_char_p, _u64, _u32, _u64,
                                         _u32, _u32, ctypes.POINTER(_vp)]),
    "dct_crec_map_meta": (ctypes.c_int, [_vp, ctypes.POINTER(_u64),
                                         ctypes.POINTER(_i32),
                                         ctypes.POINTER(_i32),
                                         ctypes.POINTER(_i32)]),
    "dct_crec_map_fill": (ctypes.c_int, [_vp, _vp, _i32, _vp, _i32, _vp,
                                         _vp, _vp, ctypes.POINTER(_u64),
                                         ctypes.POINTER(_u64)]),
    "dct_crec_map_before_first": (ctypes.c_int, [_vp]),
    "dct_crec_map_bytes_read": (ctypes.c_int, [_vp, ctypes.POINTER(_u64)]),
    "dct_crec_map_free": (ctypes.c_int, [_vp]),
}

_lib = None
_lib_lock = threading.Lock()


def build() -> Optional[str]:
    """Compile the library if missing or stale; returns the compiler's
    output when it built, None when the library was current."""
    return build_if_stale(
        LIB_PATH, [SOURCE],
        lambda tmp: ["g++", "-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra",
                     "-fno-gnu-unique", "-shared", "-static-libstdc++",
                     "-static-libgcc", "-Wl,--exclude-libs,ALL", "-o", tmp,
                     SOURCE])


def lib() -> ctypes.CDLL:
    """Load (building if needed) the library."""
    global _lib
    with _lib_lock:
        if _lib is None:
            build()
            cdll = ctypes.CDLL(LIB_PATH)
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(cdll, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = cdll
        return _lib


def _check(status: int) -> None:
    if status != 0:
        raise DMLCError(
            lib().dct_crec_map_last_error().decode("utf-8", "replace"))


def mappable(uri: str) -> Optional[str]:
    """The local path to map for a ``.crec`` URI: a plain or ``file://``
    path to a regular file, with no chunk cache (``#``) and no query but
    ``format=``. None for any other URI."""
    if "#" in uri or ";" in uri:
        return None
    path, _, query = uri.partition("?")
    if query and not all(arg.startswith("format=")
                         for arg in query.split("&")):
        return None
    if path.startswith("file://"):
        path = path[len("file://"):]
    elif "://" in path:
        return None
    return path if os.path.isfile(path) else None


class BufferState:
    """What one pooled buffer holds from its last fill, per shard: the
    index from which its nonzero planes hold padding (``clean`` [D]
    uint64, the bucket for a fresh buffer) and its rows' lengths (``lens``
    [D, R] uint32, all ones-bits for a row it does not hold)."""

    def __init__(self, num_shards: int, rows_per_shard: int, bucket: int):
        self.clean = np.full(num_shards, bucket, np.uint64)
        self.lens = np.full((num_shards, rows_per_shard), 0xFFFFFFFF,
                            np.uint32)


def _ptr(a: np.ndarray, dtype, n: int) -> int:
    if a.dtype != dtype or not a.flags.c_contiguous or a.size != n:
        raise DMLCError(f"crec fill: a {dtype} C-contiguous array of {n} "
                        f"elements is needed, got {a.dtype} {a.shape}")
    return a.ctypes.data


class MappedCsrRecBatcher:
    """Part ``part`` of ``npart`` of the ``.crec`` file at ``path`` as
    packed batches of ``batch_rows`` rows over ``num_shards`` shards (the
    interface of :class:`~dmlc_core_tpu_torch.io.native.NativeCsrRecBatcher`,
    with the buffer's padded extent passed to :meth:`fill_packed`)."""

    def __init__(self, path: str, part: int = 0, npart: int = 1,
                 batch_rows: int = 65536, num_shards: int = 1,
                 min_nnz_bucket: int = 4096):
        self._h = ctypes.c_void_p()
        self._batch_rows = batch_rows
        self._num_shards = num_shards
        self._bucket = 0
        _check(lib().dct_crec_map_open(path.encode(), batch_rows, num_shards,
                                       min_nnz_bucket, part, npart,
                                       ctypes.byref(self._h)))

    def meta(self) -> Tuple[int, bool, bool, bool]:
        """(bucket, has_weight, has_qid, has_field), static for the
        file."""
        bucket = _u64()
        hw, hq, hf = _i32(), _i32(), _i32()
        _check(lib().dct_crec_map_meta(self._h, ctypes.byref(bucket),
                                       ctypes.byref(hw), ctypes.byref(hq),
                                       ctypes.byref(hf)))
        self._bucket = bucket.value
        return bucket.value, bool(hw.value), bool(hq.value), bool(hf.value)

    def fill_packed(self, big: np.ndarray, aux: np.ndarray,
                    nrows: np.ndarray, held: BufferState
                    ) -> Tuple[int, int]:
        """Fill one batch into ``big`` [D, kb, bucket] and ``aux`` [D, ka,
        R] int32 (FillPacked's planes) and ``nrows`` [D]; ``held``
        describes what ``big`` holds from its last fill and is updated.
        Returns (the true row count, 0 at the end; the padding entries
        written)."""
        if self._bucket == 0:
            self.meta()
        D = self._num_shards
        R = self._batch_rows // D
        kb, ka = big.shape[1], aux.shape[1]
        take, pad = _u64(), _u64()
        _check(lib().dct_crec_map_fill(
            self._h, _ptr(big, np.int32, D * kb * self._bucket), kb,
            _ptr(aux, np.int32, D * ka * R), ka, _ptr(nrows, np.int32, D),
            _ptr(held.clean, np.uint64, D),
            _ptr(held.lens, np.uint32, D * R), ctypes.byref(pad),
            ctypes.byref(take)))
        return int(take.value), int(pad.value)

    def before_first(self) -> None:
        """Restart from the first record (new epoch)."""
        _check(lib().dct_crec_map_before_first(self._h))

    def set_epoch(self, epoch: int) -> bool:
        """False: a part is read in order, as the shared ``.crec`` split
        reads it (it does not shuffle)."""
        return False

    def bytes_read(self) -> int:
        """Record bytes consumed from the file so far."""
        out = _u64()
        _check(lib().dct_crec_map_bytes_read(self._h, ctypes.byref(out)))
        return out.value

    def close(self) -> None:
        """Unmap the file (idempotent)."""
        if self._h:
            h, self._h = self._h, ctypes.c_void_p()
            _check(lib().dct_crec_map_free(h))

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
