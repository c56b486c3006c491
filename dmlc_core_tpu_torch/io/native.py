"""ctypes binding to the port's own build of the shared C++ core (cpp/).

The port never loads the JAX package's library: it builds ``cpp/`` into
``dmlc_core_tpu_torch/_build/libdmlc_core_tpu_torch.so`` with
``make -C cpp OUT=<that path>`` (which writes nothing into ``cpp/``), under
the package's build lock, and rebuilds only when a ``cpp/src`` file is
newer than the library. The binding covers what the device path calls:
the threaded text parser (:class:`NativeParser`) and the fused padded-batch
assembler (:class:`NativeBatcher`).

bfloat16 planes are carried as ``uint16`` numpy arrays of bf16 bits; torch
reads them with ``.view(torch.bfloat16)``. The port needs no ``ml_dtypes``.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Iterator, Optional

import numpy as np

from dmlc_core_tpu_torch.base import (BUILD_DIR, REPO_ROOT, DMLCError,
                                      build_if_stale)

__all__ = ["lib", "build", "LIB_PATH", "NativeParser", "NativeBatcher",
           "RowBlock", "BF16_STORAGE"]

LIB_PATH = os.path.join(BUILD_DIR, "libdmlc_core_tpu_torch.so")
_CPP_DIR = os.path.join(REPO_ROOT, "cpp")
# numpy dtype of bf16 storage bits (the native fills write raw bf16)
BF16_STORAGE = np.dtype(np.uint16)

# cpp/Makefile's flags plus two changes that keep the library to itself
# inside a process shared with other C++ code:
# - -fno-gnu-unique: g++ marks function-local statics of inline functions
#   (the parser registry, parameter managers) as GNU-unique symbols, which
#   the dynamic linker shares across every library in the process; with
#   the reference's build of the same core loaded too (as in the tests,
#   which run both packages), the second library's parsers would register
#   into the first one's registry and abort.
# - a private, hidden copy of libstdc++/libgcc: on the H100 machine the
#   library linked against the shared libstdc++ crashed the process
#   (SIGSEGV) as soon as it and the CUDA build of torch were both loaded,
#   in either order; linked this way it loads beside torch.
_CXXFLAGS = ("-O3 -std=c++17 -fPIC -Wall -Wextra -Wno-unused-parameter "
             "-pthread -fno-gnu-unique")
_LDFLAGS = ("-shared -pthread -static-libstdc++ -static-libgcc "
            "-Wl,--exclude-libs,ALL")

_lib = None
_lib_lock = threading.Lock()


class RowBlockC(ctypes.Structure):
    """Mirror of dct_rowblock_t in cpp/src/capi.cc."""
    _fields_ = [
        ("num_rows", ctypes.c_uint64),
        ("nnz", ctypes.c_uint64),
        ("offset", ctypes.POINTER(ctypes.c_uint64)),
        ("label", ctypes.POINTER(ctypes.c_float)),
        ("weight", ctypes.POINTER(ctypes.c_float)),
        ("qid", ctypes.POINTER(ctypes.c_uint64)),
        ("field", ctypes.POINTER(ctypes.c_uint32)),
        ("index", ctypes.c_void_p),
        ("value", ctypes.POINTER(ctypes.c_float)),
        ("max_index", ctypes.c_uint64),
        ("max_field", ctypes.c_uint32),
        ("index_is_64", ctypes.c_int32),
        ("value_i32", ctypes.POINTER(ctypes.c_int32)),
        ("value_i64", ctypes.POINTER(ctypes.c_int64)),
        ("value_dtype", ctypes.c_int32),
    ]


def build() -> Optional[str]:
    """Build the native core if it is missing or stale; returns the
    compiler's output when it built, None when the library was current."""
    src_dir = os.path.join(_CPP_DIR, "src")
    sources = [os.path.join(src_dir, f) for f in os.listdir(src_dir)]
    return build_if_stale(
        LIB_PATH, sources,
        lambda tmp: ["make", "-C", _CPP_DIR, f"OUT={tmp}",
                     f"CXXFLAGS={_CXXFLAGS}", f"LDFLAGS={_LDFLAGS}"])


def lib() -> ctypes.CDLL:
    """Load (building if needed) the port's native library."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            build()
            cdll = ctypes.CDLL(LIB_PATH)
            _declare_signatures(cdll)
            _lib = cdll
        return _lib


def _declare_signatures(cdll: ctypes.CDLL) -> None:
    """Pin (restype, argtypes) of every function the port calls, so sizes
    and pointers survive the 64-bit ABI (cpp/src/capi.cc declarations)."""
    c = ctypes
    vp, sz, i, u = c.c_void_p, c.c_size_t, c.c_int, c.c_uint
    sigs = {
        "dct_last_error": (c.c_char_p, []),
        "dct_parser_create_ex": (i, [c.c_char_p, u, u, c.c_char_p, i, i,
                                     i, i, c.c_char_p, c.c_char_p,
                                     c.POINTER(vp)]),
        "dct_parser_next_block": (i, [vp, c.POINTER(RowBlockC),
                                      c.POINTER(i)]),
        "dct_parser_before_first": (i, [vp]),
        "dct_parser_set_epoch": (i, [vp, u, c.POINTER(c.c_int32)]),
        "dct_parser_bytes_read": (i, [vp, c.POINTER(sz)]),
        "dct_parser_free": (i, [vp]),
        "dct_batcher_create": (i, [c.c_char_p, u, u, c.c_char_p, i, i,
                                   c.c_uint64, c.c_uint32, c.c_uint64,
                                   c.POINTER(vp)]),
        "dct_batcher_next_meta": (i, [vp, c.POINTER(c.c_uint64),
                                      c.POINTER(c.c_uint64),
                                      c.POINTER(c.c_uint64), c.POINTER(i),
                                      c.POINTER(i), c.POINTER(i)]),
        "dct_batcher_fill_packed": (i, [vp, vp, c.c_int32, vp, c.c_int32,
                                        vp, c.c_int32, vp]),
        "dct_batcher_fill_dense_packed": (i, [vp, vp, c.c_int32,
                                              c.c_uint64, vp, c.c_int32,
                                              vp]),
        "dct_batcher_before_first": (i, [vp]),
        "dct_batcher_set_epoch": (i, [vp, u, c.POINTER(c.c_int32)]),
        "dct_batcher_bytes_read": (i, [vp, c.POINTER(sz)]),
        "dct_batcher_free": (i, [vp]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(cdll, name)
        fn.argtypes = argtypes
        fn.restype = restype


def _check(status: int) -> None:
    if status != 0:
        raise DMLCError(lib().dct_last_error().decode("utf-8", "replace"))


class RowBlock:
    """A parsed CSR block (reference RowBlock, data.h:174-236): zero-copy
    views into native memory, valid until the parser's next call."""

    __slots__ = ("offset", "label", "weight", "qid", "field", "index",
                 "value", "max_index")

    def __init__(self, c: RowBlockC):
        n, nnz = c.num_rows, c.nnz
        self.offset = np.ctypeslib.as_array(c.offset, (n + 1,))
        self.label = np.ctypeslib.as_array(c.label, (n,))
        self.weight = (np.ctypeslib.as_array(c.weight, (n,))
                       if c.weight else None)
        self.qid = np.ctypeslib.as_array(c.qid, (n,)) if c.qid else None
        self.field = (np.ctypeslib.as_array(c.field, (nnz,))
                      if (c.field and nnz) else None)
        idx_type = ctypes.c_uint64 if c.index_is_64 else ctypes.c_uint32
        self.index = (np.ctypeslib.as_array(
            ctypes.cast(c.index, ctypes.POINTER(idx_type)), (nnz,)) if nnz
            else np.empty(0, np.uint64 if c.index_is_64 else np.uint32))
        # only float32 values (value_dtype 0) reach this slice's path
        self.value = (np.ctypeslib.as_array(c.value, (nnz,))
                      if (c.value and nnz) else None)
        self.max_index = c.max_index

    @property
    def num_rows(self) -> int:
        return len(self.label)

    @property
    def nnz(self) -> int:
        return len(self.index)


class NativeParser:
    """Multithreaded text parser producing :class:`RowBlock` views
    (reference Parser<I,D>::Create, data.h:307). The port uses it to walk
    a file once, e.g. to find its feature count."""

    def __init__(self, uri: str, part: int = 0, npart: int = 1,
                 fmt: str = "auto", nthread: int = 0, threaded: bool = True):
        self._h = ctypes.c_void_p()
        _check(lib().dct_parser_create_ex(
            uri.encode(), part, npart, fmt.encode(), nthread,
            1 if threaded else 0, 0, 0, b"", b"", ctypes.byref(self._h)))

    def next_block(self) -> Optional[RowBlock]:
        """Next parsed block, or None at end of data."""
        c = RowBlockC()
        has = ctypes.c_int()
        _check(lib().dct_parser_next_block(self._h, ctypes.byref(c),
                                           ctypes.byref(has)))
        return RowBlock(c) if has.value else None

    def __iter__(self) -> Iterator[RowBlock]:
        while True:
            b = self.next_block()
            if b is None:
                return
            yield b

    def num_features(self) -> int:
        """Largest feature index + 1 over the rest of the stream."""
        mx = -1
        for b in self:
            if b.nnz:
                mx = max(mx, int(b.max_index) or int(b.index.max()))
        return mx + 1

    def before_first(self) -> None:
        """Restart parsing from the first row."""
        _check(lib().dct_parser_before_first(self._h))

    def bytes_read(self) -> int:
        """Bytes consumed from the source so far."""
        out = ctypes.c_size_t()
        _check(lib().dct_parser_bytes_read(self._h, ctypes.byref(out)))
        return out.value

    def close(self) -> None:
        """Free the native handle (idempotent)."""
        if self._h:
            _check(lib().dct_parser_free(self._h))
            self._h = ctypes.c_void_p()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeBatcher:
    """Static-shape padded-batch assembly in C++ (cpp/src/batcher.h).

    next_meta() stages a batch and reports its shape; the caller allocates
    buffers of exactly that shape and fill_packed()/fill_dense_packed()
    write them in one native pass with the GIL released."""

    def __init__(self, uri: str, part: int = 0, npart: int = 1,
                 fmt: str = "auto", nthread: int = 0, threaded: bool = True,
                 batch_rows: int = 65536, num_shards: int = 1,
                 min_nnz_bucket: int = 4096):
        self._h = ctypes.c_void_p()
        self._batch_rows = batch_rows
        self._num_shards = num_shards
        self._bucket = 0
        _check(lib().dct_batcher_create(
            uri.encode(), part, npart, fmt.encode(), nthread,
            1 if threaded else 0, batch_rows, num_shards, min_nnz_bucket,
            ctypes.byref(self._h)))

    def next_meta(self):
        """(take, bucket, max_index, has_qid, has_field) for the staged
        batch, or None at end."""
        take, bucket, max_index = (ctypes.c_uint64() for _ in range(3))
        has_qid, has_field, has = (ctypes.c_int() for _ in range(3))
        _check(lib().dct_batcher_next_meta(
            self._h, ctypes.byref(take), ctypes.byref(bucket),
            ctypes.byref(max_index), ctypes.byref(has_qid),
            ctypes.byref(has_field), ctypes.byref(has)))
        if not has.value:
            return None
        self._bucket = bucket.value
        return (take.value, bucket.value, max_index.value,
                bool(has_qid.value), bool(has_field.value))

    @staticmethod
    def _ptr(arr: np.ndarray, dtype, size: int) -> ctypes.c_void_p:
        # hard checks: the native side bulk-writes through this pointer
        if (arr.dtype != dtype or not arr.flags["C_CONTIGUOUS"]
                or arr.size != size):
            raise DMLCError(
                f"fill buffer must be C-contiguous {np.dtype(dtype).name} "
                f"of {size} elements, got {arr.dtype.name} size={arr.size} "
                f"contiguous={arr.flags['C_CONTIGUOUS']}")
        return ctypes.c_void_p(arr.ctypes.data)

    def fill_packed(self, big: np.ndarray, aux: np.ndarray,
                    nrows: np.ndarray) -> None:
        """Fused shard-major fill (batcher.h FillPacked): ``big`` is
        [D, kb, bucket] int32 (row, col, val f32 bits, [field]), ``aux``
        is [D, ka, R] int32 (label bits, weight bits, [qid], nrows plane)."""
        D = self._num_shards
        R = self._batch_rows // D
        kb, ka = big.shape[1], aux.shape[1]
        _check(lib().dct_batcher_fill_packed(
            self._h, self._ptr(big, np.int32, D * kb * self._bucket), kb,
            None, 0, self._ptr(aux, np.int32, D * ka * R), ka,
            self._ptr(nrows, np.int32, D)))

    def fill_dense_packed(self, x: np.ndarray, aux: np.ndarray,
                          nrows: np.ndarray) -> None:
        """Fused dense fill (batcher.h FillDensePacked): ``x`` is
        [rows, F] float32, or uint16 holding bf16 bits; label/weight/[qid]/
        nrows go into the shard-major aux pack."""
        if x.dtype == np.float32:
            x_dtype = 0
        elif x.dtype == BF16_STORAGE:
            x_dtype = 1
        else:
            raise DMLCError(f"dense fill dtype must be float32 or bf16 "
                            f"bits (uint16), got {x.dtype}")
        F = x.shape[-1]
        D = self._num_shards
        R = self._batch_rows // D
        ka = aux.shape[1]
        _check(lib().dct_batcher_fill_dense_packed(
            self._h, self._ptr(x, x.dtype, self._batch_rows * F), x_dtype,
            F, self._ptr(aux, np.int32, D * ka * R), ka,
            self._ptr(nrows, np.int32, D)))

    def before_first(self) -> None:
        """Restart batching from the first row."""
        _check(lib().dct_batcher_before_first(self._h))

    def set_epoch(self, epoch: int) -> bool:
        """Pin the shuffle permutation the next before_first() samples;
        False when nothing in the split chain shuffles."""
        supported = ctypes.c_int32()
        _check(lib().dct_batcher_set_epoch(self._h, epoch,
                                           ctypes.byref(supported)))
        return bool(supported.value)

    def bytes_read(self) -> int:
        """Bytes consumed from the source so far."""
        out = ctypes.c_size_t()
        _check(lib().dct_batcher_bytes_read(self._h, ctypes.byref(out)))
        return out.value

    def close(self) -> None:
        """Free the native handle (idempotent)."""
        if self._h:
            _check(lib().dct_batcher_free(self._h))
            self._h = ctypes.c_void_p()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
