"""ctypes binding to the port's own build of the shared C++ core (cpp/).

The port never loads the JAX package's library: it builds ``cpp/`` into
``dmlc_core_tpu_torch/_build/libdmlc_core_tpu_torch.so`` with
``make -C cpp OUT=<that path>`` (which writes nothing into ``cpp/``), under
the package's build lock, and rebuilds only when a ``cpp/src`` file is
newer than the library. The binding covers what the port calls: the
threaded text parser (:class:`NativeParser`, 32- or 64-bit feature
ids, its pipeline knobs and counters, and the shard cache), the fused
padded-batch assembler (:class:`NativeBatcher`), the
binary lanes' batch fills (:class:`NativeCsrRecBatcher` for ``.crec``,
:class:`NativeDenseRecBatcher` for ``.drec``), RecordIO framing
(:class:`NativeRecordIOWriter`, :class:`NativeRecordIOReader`), the
float32 -> bfloat16 conversion of the fills and its exact inverse
(:func:`bf16_bits`, :func:`bf16_convert`, :func:`bf16_upcast`),
URI-dispatched byte streams
(:class:`NativeStream`, :func:`path_info`, :func:`list_directory`),
record-aligned partitioned reads (:class:`NativeInputSplit`, and
:class:`LeasedSplit` over shard leases), the native half of the
local-filesystem fault plan (:func:`set_fs_fault_plan`), the remote-I/O
fault plan, timeout and WebHDFS credentials, and the native telemetry and
trace documents with the remote-I/O counters read from them
(:func:`io_retry_stats`).

The native HTTP client speaks plain HTTP. An ``https://`` origin (and
``s3://``/``azure://``/``hdfs://`` whose endpoint is https or unset) is
reached through a local TLS-terminating helper
(:mod:`dmlc_core_tpu_torch.io.tls_proxy`), started on first use unless
``DCT_TLS_PROXY`` names one or ``DCT_TLS_AUTO=0``, as in the reference.

bfloat16 planes are carried as ``uint16`` numpy arrays of bf16 bits; torch
reads them with ``.view(torch.bfloat16)``. The port needs no ``ml_dtypes``.
"""

from __future__ import annotations

import ctypes
import json
import os
import threading
from typing import Iterator, List, Optional, Tuple

import numpy as np

from dmlc_core_tpu_torch.base import (BUILD_DIR, REPO_ROOT, DMLCError,
                                      build_if_stale)

__all__ = ["lib", "build", "LIB_PATH", "NativeParser", "NativeBatcher",
           "NativeCsrRecBatcher", "NativeDenseRecBatcher",
           "NativeRecordIOWriter", "NativeRecordIOReader", "NativeStream",
           "RowBlock", "BF16_STORAGE", "bf16_bits", "bf16_convert",
           "bf16_upcast", "path_info",
           "set_fs_fault_plan", "native_telemetry_snapshot",
           "native_trace_snapshot", "io_retry_stats",
           "reset_io_retry_stats", "NativeInputSplit", "LeasedSplit",
           "list_directory", "parser_formats_doc", "set_io_fault_plan",
           "set_io_timeout_ms", "set_webhdfs_delegation_token",
           "set_webhdfs_auth_header", "native_telemetry_reset",
           "native_telemetry_enable", "native_trace_reset",
           "native_flight_dump"]

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


class IoRetryStatsC(ctypes.Structure):
    """Mirror of dct_io_retry_stats_t in cpp/src/capi.cc."""
    _fields_ = [
        ("requests", ctypes.c_uint64),
        ("retries", ctypes.c_uint64),
        ("backoff_ms_total", ctypes.c_uint64),
        ("timeouts", ctypes.c_uint64),
        ("faults_injected", ctypes.c_uint64),
        ("giveups", ctypes.c_uint64),
        ("deadline_exhausted", ctypes.c_uint64),
    ]


class ParsePipelineStatsC(ctypes.Structure):
    """Mirror of dct_parse_pipeline_stats_t in cpp/src/capi.cc."""
    _fields_ = [
        ("chunks_read", ctypes.c_uint64),
        ("blocks_delivered", ctypes.c_uint64),
        ("reader_waits", ctypes.c_uint64),
        ("worker_waits", ctypes.c_uint64),
        ("consumer_waits", ctypes.c_uint64),
        ("inflight_now", ctypes.c_uint64),
        ("inflight_peak", ctypes.c_uint64),
        ("inflight_sum", ctypes.c_uint64),
        ("capacity", ctypes.c_uint64),
        ("workers", ctypes.c_uint64),
        # structural-scan lane: 0 scalar, 1 swar, 2 sse2, 3 avx2
        ("simd_tier", ctypes.c_uint64),
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
        "dct_str_free": (i, [c.c_char_p]),
        "dct_stream_create": (i, [c.c_char_p, c.c_char_p, c.POINTER(vp)]),
        "dct_stream_read": (i, [vp, vp, sz, c.POINTER(sz)]),
        "dct_stream_write": (i, [vp, c.c_char_p, sz]),
        "dct_stream_free": (i, [vp]),
        "dct_fs_path_info": (i, [c.c_char_p, c.POINTER(sz), c.POINTER(i)]),
        "dct_fs_list": (i, [c.c_char_p, i, c.POINTER(c.c_char_p)]),
        "dct_fs_set_fault_plan": (i, [c.c_char_p]),
        "dct_split_create": (i, [c.c_char_p, u, u, c.c_char_p, i,
                                 c.POINTER(vp)]),
        "dct_split_create_ex": (i, [c.c_char_p, c.c_char_p, u, u,
                                    c.c_char_p, i, i, i, sz, c.c_char_p,
                                    u, i, c.POINTER(vp)]),
        "dct_split_next_record": (i, [vp, c.POINTER(vp), c.POINTER(sz),
                                      c.POINTER(i)]),
        "dct_split_next_chunk": (i, [vp, c.POINTER(vp), c.POINTER(sz),
                                     c.POINTER(i)]),
        "dct_split_before_first": (i, [vp]),
        "dct_split_reset_partition": (i, [vp, u, u]),
        "dct_split_total_size": (i, [vp, c.POINTER(sz)]),
        "dct_split_hint_chunk_size": (i, [vp, sz]),
        "dct_split_free": (i, [vp]),
        "dct_webhdfs_set_delegation_token": (i, [c.c_char_p]),
        "dct_webhdfs_set_auth_header": (i, [c.c_char_p]),
        "dct_set_tls_proxy": (i, [c.c_char_p]),
        "dct_trace_reset": (i, []),
        "dct_flight_dump": (i, [c.c_char_p, c.POINTER(i)]),
        "dct_io_set_fault_plan": (i, [c.c_char_p]),
        "dct_io_set_timeout_ms": (i, [i]),
        "dct_parser_formats_doc": (i, [c.POINTER(c.c_char_p)]),
        "dct_telemetry_snapshot": (i, [c.POINTER(c.c_char_p)]),
        "dct_telemetry_reset": (i, []),
        "dct_telemetry_enable": (i, [i]),
        "dct_trace_snapshot": (i, [c.POINTER(c.c_char_p)]),
        "dct_parser_create": (i, [c.c_char_p, u, u, c.c_char_p, i, i, i,
                                  c.POINTER(vp)]),
        "dct_parser_create_ex": (i, [c.c_char_p, u, u, c.c_char_p, i, i,
                                     i, i, c.c_char_p, c.c_char_p,
                                     c.POINTER(vp)]),
        "dct_parser_next_block": (i, [vp, c.POINTER(RowBlockC),
                                      c.POINTER(i)]),
        "dct_parser_before_first": (i, [vp]),
        "dct_parser_set_epoch": (i, [vp, u, c.POINTER(c.c_int32)]),
        "dct_parser_bytes_read": (i, [vp, c.POINTER(sz)]),
        "dct_parser_free": (i, [vp]),
        "dct_parser_pipeline_stats": (i, [vp,
                                          c.POINTER(ParsePipelineStatsC),
                                          c.POINTER(i)]),
        "dct_io_retry_stats": (i, [c.POINTER(IoRetryStatsC)]),
        "dct_io_stats_reset": (i, []),
        "dct_batcher_create": (i, [c.c_char_p, u, u, c.c_char_p, i, i,
                                   c.c_uint64, c.c_uint32, c.c_uint64,
                                   c.POINTER(vp)]),
        "dct_batcher_next_meta": (i, [vp, c.POINTER(c.c_uint64),
                                      c.POINTER(c.c_uint64),
                                      c.POINTER(c.c_uint64), c.POINTER(i),
                                      c.POINTER(i), c.POINTER(i)]),
        "dct_batcher_fill_csr": (i, [vp, vp, vp, vp, vp, vp, vp, vp, vp]),
        "dct_batcher_fill_dense": (i, [vp, vp, c.c_int32, c.c_uint64, vp,
                                       vp, vp, vp]),
        "dct_batcher_fill_packed": (i, [vp, vp, c.c_int32, vp, c.c_int32,
                                        vp, c.c_int32, vp]),
        "dct_batcher_fill_dense_packed": (i, [vp, vp, c.c_int32,
                                              c.c_uint64, vp, c.c_int32,
                                              vp]),
        "dct_batcher_before_first": (i, [vp]),
        "dct_batcher_set_epoch": (i, [vp, u, c.POINTER(c.c_int32)]),
        "dct_batcher_bytes_read": (i, [vp, c.POINTER(sz)]),
        "dct_batcher_free": (i, [vp]),
        "dct_recordio_writer_create": (i, [c.c_char_p, c.POINTER(vp)]),
        "dct_recordio_write": (i, [vp, c.c_char_p, sz]),
        "dct_recordio_writer_free": (i, [vp]),
        "dct_recordio_reader_create": (i, [c.c_char_p, c.POINTER(vp)]),
        "dct_recordio_read": (i, [vp, c.POINTER(vp), c.POINTER(sz),
                                  c.POINTER(i)]),
        "dct_recordio_reader_free": (i, [vp]),
        "dct_denserec_create": (i, [c.c_char_p, u, u, c.c_uint64,
                                    c.c_uint32, c.POINTER(vp)]),
        "dct_denserec_meta": (i, [vp, c.POINTER(c.c_uint64),
                                  c.POINTER(c.c_int32),
                                  c.POINTER(c.c_int32)]),
        "dct_denserec_fill": (i, [vp, vp, c.c_int32, c.c_uint64, vp, vp,
                                  vp, c.POINTER(c.c_uint64)]),
        "dct_denserec_fill_packed": (i, [vp, vp, c.c_int32, c.c_uint64, vp,
                                         c.c_int32, vp,
                                         c.POINTER(c.c_uint64)]),
        "dct_denserec_before_first": (i, [vp]),
        "dct_denserec_set_epoch": (i, [vp, u, c.POINTER(c.c_int32)]),
        "dct_denserec_bytes_read": (i, [vp, c.POINTER(sz)]),
        "dct_denserec_free": (i, [vp]),
        "dct_csrrec_create": (i, [c.c_char_p, u, u, c.c_uint64, c.c_uint32,
                                  c.c_uint64, c.POINTER(vp)]),
        "dct_csrrec_meta": (i, [vp, c.POINTER(c.c_uint64),
                                c.POINTER(c.c_int32), c.POINTER(c.c_int32),
                                c.POINTER(c.c_int32)]),
        "dct_csrrec_fill": (i, [vp, vp, vp, vp, vp, vp, vp, vp, vp,
                                c.POINTER(c.c_uint64)]),
        "dct_csrrec_fill_packed": (i, [vp, vp, c.c_int32, vp, c.c_int32,
                                       vp, c.POINTER(c.c_uint64)]),
        "dct_csrrec_before_first": (i, [vp]),
        "dct_csrrec_set_epoch": (i, [vp, u, c.POINTER(c.c_int32)]),
        "dct_csrrec_bytes_read": (i, [vp, c.POINTER(sz)]),
        "dct_csrrec_free": (i, [vp]),
        "dct_bf16_convert": (i, [vp, vp, c.c_uint64]),
        "dct_bf16_upcast": (i, [vp, vp, c.c_uint64]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(cdll, name)
        fn.argtypes = argtypes
        fn.restype = restype


def _check(status: int) -> None:
    if status != 0:
        raise DMLCError(lib().dct_last_error().decode("utf-8", "replace"))


def _uri_needs_tls(uri: str) -> bool:
    """Whether any member of this (possibly ';'-separated) URI reaches an
    https origin under the native clients' env rules: https:// directly;
    s3:// and azure:// whenever their endpoint env is https or unset (the
    no-endpoint default is the real TLS-only cloud service,
    cpp/src/{s3,azure}_filesys.cc ResolveTarget); hdfs:// under an https
    WEBHDFS_NAMENODE (secure WebHDFS).

    Matching is per-';'-member startswith on the scheme: a local path
    whose query string merely embeds "https://" must not start the TLS
    helper."""

    def env(*names: str) -> str:
        for n in names:
            v = os.environ.get(n)
            if v:
                return v
        return ""

    for member in uri.split(";"):
        member = member.strip()
        if member.startswith("https://"):
            return True
        if member.startswith("s3://"):
            ep = env("S3_ENDPOINT", "AWS_ENDPOINT")
            if not ep or ep.startswith("https://"):
                return True
        elif member.startswith("azure://"):
            ep = env("AZURE_ENDPOINT")
            if not ep or ep.startswith("https://"):
                return True
        elif member.startswith(("hdfs://", "viewfs://")):
            if env("WEBHDFS_NAMENODE").startswith("https://"):
                return True
    return False


def _route_https(uri: str) -> str:
    """Make https-origin URIs reachable before handing them to the native
    core, whose client is plain HTTP: they route through the local
    TLS-terminating helper (:mod:`dmlc_core_tpu_torch.io.tls_proxy`).

    With no helper configured (``DCT_TLS_PROXY`` unset) the in-process
    singleton starts and its address is published to the native router
    through the C-ABI setter ``dct_set_tls_proxy``, never by mutating
    ``os.environ``: native request threads may be reading the environment
    (glibc setenv/getenv race). With a helper configured, or with
    ``DCT_TLS_AUTO=0``, an earlier override is cleared so the environment
    (or the native guidance error) decides. Returns the uri unchanged."""
    if not _uri_needs_tls(uri):
        return uri
    if (os.environ.get("DCT_TLS_PROXY")
            or os.environ.get("DCT_TLS_AUTO") == "0"):
        _check(lib().dct_set_tls_proxy(b""))
        return uri
    from dmlc_core_tpu_torch.io.tls_proxy import ensure_tls_proxy
    addr = ensure_tls_proxy(export_env=False)
    _check(lib().dct_set_tls_proxy(addr.encode()))
    return uri


class RowBlock:
    """A parsed CSR block (reference RowBlock, data.h:174-236): zero-copy
    views into native memory, valid until the parser's next call."""

    __slots__ = ("offset", "label", "weight", "qid", "field", "index",
                 "value", "max_index", "max_field")

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
        # typed csv values: value_dtype 0=float32, 1=int32, 2=int64; one
        # array is populated
        vptr = {1: c.value_i32, 2: c.value_i64}.get(c.value_dtype, c.value)
        self.value = (np.ctypeslib.as_array(vptr, (nnz,))
                      if (vptr and nnz) else None)
        self.max_index = c.max_index
        self.max_field = c.max_field

    @property
    def num_rows(self) -> int:
        return len(self.label)

    @property
    def nnz(self) -> int:
        return len(self.index)


class NativeParser:
    """Multithreaded text parser producing :class:`RowBlock` views
    (reference Parser<I,D>::Create, data.h:307). ``index64`` parses
    feature ids as uint64 (the ``index64`` device lane and the converter
    read blocks through it).

    With ``threaded=True`` a native reader keeps up to
    ``chunks_in_flight`` chunks outstanding (0 = auto) for a pool of
    ``nthread`` workers, and blocks come out in input order
    (cpp/src/parser.h PipelinedParser); :meth:`pipeline_stats` reads its
    counters. ``cache_dir`` and ``cache`` (never|auto|refresh) opt into
    the shard cache: the first pass tees parsed blocks into a binary shard
    under ``cache_dir``, later epochs replay it. Both also come from URI
    sugar (``#cachefile=<dir>``, ``?cache=``) and the environment
    (``DMLC_DATA_CACHE_DIR``, ``DMLC_DATA_CACHE``), read by the native
    core."""

    def __init__(self, uri: str, part: int = 0, npart: int = 1,
                 fmt: str = "auto", nthread: int = 0, threaded: bool = True,
                 index64: bool = False, chunks_in_flight: int = 0,
                 cache_dir: str = "", cache: str = ""):
        # the native core refuses the same values; this fails earlier
        # with the same vocabulary
        if cache not in ("", "never", "auto", "refresh"):
            raise DMLCError(
                f"cache must be one of never|auto|refresh, got {cache!r}")
        uri = _route_https(uri)
        self._h = ctypes.c_void_p()
        _check(lib().dct_parser_create_ex(
            uri.encode(), part, npart, fmt.encode(), nthread,
            1 if threaded else 0, 1 if index64 else 0, chunks_in_flight,
            cache_dir.encode(), cache.encode(), ctypes.byref(self._h)))

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

    def set_epoch(self, epoch: int) -> bool:
        """Pin the shuffle permutation the next before_first() samples;
        False when nothing in the split chain shuffles."""
        supported = ctypes.c_int32()
        _check(lib().dct_parser_set_epoch(self._h, epoch,
                                          ctypes.byref(supported)))
        return bool(supported.value)

    def bytes_read(self) -> int:
        """Bytes consumed from the source so far."""
        out = ctypes.c_size_t()
        _check(lib().dct_parser_bytes_read(self._h, ctypes.byref(out)))
        return out.value

    def pipeline_stats(self) -> Optional[dict]:
        """The parse pipeline's counters (cpp/src/parser.h
        ParsePipelineStats), or None for a ``threaded=False`` parser:
        ``occupancy_avg`` is the mean chunks in flight at each admit, many
        ``reader_waits`` mean the consumer binds, many ``consumer_waits``
        that parsing binds; ``simd_lane`` names the scan's tier. The same
        counters add up process-wide in the telemetry registry
        (``parse_*_total``, ``parse_stage_*_us``)."""
        s = ParsePipelineStatsC()
        has = ctypes.c_int()
        _check(lib().dct_parser_pipeline_stats(self._h, ctypes.byref(s),
                                               ctypes.byref(has)))
        if not has.value:
            return None
        out = {name: int(getattr(s, name)) for name, _ in s._fields_}
        out["occupancy_avg"] = (round(s.inflight_sum / s.chunks_read, 3)
                                if s.chunks_read else 0.0)
        out["simd_lane"] = {0: "scalar", 1: "swar", 2: "sse2",
                            3: "avx2"}.get(int(s.simd_tier), "scalar")
        return out

    def io_stats(self) -> dict:
        """The process-wide remote-I/O counters (:func:`io_retry_stats`;
        local files never touch them)."""
        return io_retry_stats()

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
    buffers of exactly that shape and one fill writes them in one native
    pass with the GIL released: fill_packed()/fill_dense_packed() into
    the shard-major transfer packs the device lane ships,
    fill_csr()/fill_dense() into separate planes."""

    def __init__(self, uri: str, part: int = 0, npart: int = 1,
                 fmt: str = "auto", nthread: int = 0, threaded: bool = True,
                 batch_rows: int = 65536, num_shards: int = 1,
                 min_nnz_bucket: int = 4096):
        uri = _route_https(uri)
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
                    nrows: np.ndarray,
                    val: Optional[np.ndarray] = None) -> None:
        """Fused shard-major fill (batcher.h FillPacked): ``big`` is
        [D, kb, bucket] int32 (row, col, [val f32 bits], [field]), ``aux``
        is [D, ka, R] int32 (label bits, weight bits, [qid], nrows plane).
        A separate ``val`` plane [D, bucket] of bf16 bits (uint16) makes
        the fill convert the values (round to nearest even) and drops
        big's val plane."""
        D = self._num_shards
        R = self._batch_rows // D
        kb, ka = big.shape[1], aux.shape[1]
        _check(lib().dct_batcher_fill_packed(
            self._h, self._ptr(big, np.int32, D * kb * self._bucket), kb,
            None if val is None
            else self._ptr(val, BF16_STORAGE, D * self._bucket),
            0 if val is None else 1,
            self._ptr(aux, np.int32, D * ka * R), ka,
            self._ptr(nrows, np.int32, D)))

    def fill_dense_packed(self, x: np.ndarray, aux: np.ndarray,
                          nrows: np.ndarray) -> None:
        """Fused dense fill (batcher.h FillDensePacked): ``x`` is
        [rows, F] float32, or uint16 holding bf16 bits; label/weight/[qid]/
        nrows go into the shard-major aux pack."""
        F = x.shape[-1]
        D = self._num_shards
        R = self._batch_rows // D
        ka = aux.shape[1]
        _check(lib().dct_batcher_fill_dense_packed(
            self._h, self._ptr(x, x.dtype, self._batch_rows * F),
            _x_dtype_code(x), F, self._ptr(aux, np.int32, D * ka * R), ka,
            self._ptr(nrows, np.int32, D)))

    def fill_csr(self, row: np.ndarray, col: np.ndarray, val: np.ndarray,
                 label: np.ndarray, weight: np.ndarray, nrows: np.ndarray,
                 qid: Optional[np.ndarray] = None,
                 field: Optional[np.ndarray] = None) -> None:
        """Write the staged batch into separate CSR planes (batcher.h
        FillCSR): ``row``/``col``/``val`` [D, bucket] int32/int32/float32,
        ``label``/``weight`` [rows] float32, ``nrows`` [D] int32, and the
        optional ``qid`` [rows] / ``field`` [D, bucket] int32, with the GIL
        released."""
        nz = self._num_shards * self._bucket
        _check(lib().dct_batcher_fill_csr(
            self._h, self._ptr(row, np.int32, nz),
            self._ptr(col, np.int32, nz), self._ptr(val, np.float32, nz),
            self._ptr(label, np.float32, self._batch_rows),
            self._ptr(weight, np.float32, self._batch_rows),
            self._ptr(nrows, np.int32, self._num_shards),
            None if qid is None
            else self._ptr(qid, np.int32, self._batch_rows),
            None if field is None else self._ptr(field, np.int32, nz)))

    def fill_dense(self, x: np.ndarray, label: np.ndarray,
                   weight: np.ndarray, nrows: np.ndarray,
                   qid: Optional[np.ndarray] = None) -> None:
        """Write the staged batch into a dense [rows, F] buffer (float32, or
        uint16 holding bf16 bits; batcher.h FillDense) and separate
        ``label``/``weight`` [rows], ``nrows`` [D] and optional ``qid``
        [rows] planes, with the GIL released."""
        F = x.shape[-1]
        _check(lib().dct_batcher_fill_dense(
            self._h, self._ptr(x, x.dtype, self._batch_rows * F),
            _x_dtype_code(x), F,
            self._ptr(label, np.float32, self._batch_rows),
            self._ptr(weight, np.float32, self._batch_rows),
            self._ptr(nrows, np.int32, self._num_shards),
            None if qid is None
            else self._ptr(qid, np.int32, self._batch_rows)))

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


class _Handle:
    """Owner of one native handle, freed by ``_FREE`` on close."""

    _FREE = ""

    def close(self) -> None:
        """Free the native handle (idempotent)."""
        if self._h:
            h, self._h = self._h, ctypes.c_void_p()
            _check(getattr(lib(), self._FREE)(h))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeCsrRecBatcher(_Handle):
    """Zero-rearrangement CSR ingest of ``.crec`` files (cpp/src/
    csr_rec.h): records hold col/val/row-length planes in device batch
    layout, so a fill is bulk memcpy plus run-length row-id expansion with
    the GIL released. meta() reports the STATIC per-shard nnz bucket (from
    the file's global window table); fill_packed() returns the true row
    count (0 at end)."""

    _FREE = "dct_csrrec_free"

    def __init__(self, uri: str, part: int = 0, npart: int = 1,
                 batch_rows: int = 65536, num_shards: int = 1,
                 min_nnz_bucket: int = 4096):
        uri = _route_https(uri)
        self._h = ctypes.c_void_p()
        self._batch_rows = batch_rows
        self._num_shards = num_shards
        self._bucket = 0
        _check(lib().dct_csrrec_create(uri.encode(), part, npart,
                                       batch_rows, num_shards,
                                       min_nnz_bucket,
                                       ctypes.byref(self._h)))

    def meta(self):
        """(bucket, has_weight, has_qid, has_field), static for the
        epoch."""
        bucket = ctypes.c_uint64()
        hw, hq, hf = (ctypes.c_int32() for _ in range(3))
        _check(lib().dct_csrrec_meta(self._h, ctypes.byref(bucket),
                                     ctypes.byref(hw), ctypes.byref(hq),
                                     ctypes.byref(hf)))
        self._bucket = bucket.value
        return bucket.value, bool(hw.value), bool(hq.value), bool(hf.value)

    def fill(self, row: np.ndarray, col: np.ndarray, val: np.ndarray,
             label: np.ndarray, weight: np.ndarray, nrows: np.ndarray,
             qid: Optional[np.ndarray] = None,
             field: Optional[np.ndarray] = None) -> int:
        """Fill one batch into separate planes (csr_rec.h Fill): ``row``/
        ``col``/``val`` [D, bucket], ``label``/``weight`` [rows], ``nrows``
        [D] and the optional ``qid`` / ``field``. Returns the true row
        count (0 = end)."""
        if self._bucket == 0:
            self.meta()  # plane sizing needs the static bucket
        nz = self._num_shards * self._bucket
        take = ctypes.c_uint64()
        ptr = NativeBatcher._ptr
        _check(lib().dct_csrrec_fill(
            self._h, ptr(row, np.int32, nz), ptr(col, np.int32, nz),
            ptr(val, np.float32, nz),
            None if field is None else ptr(field, np.int32, nz),
            ptr(label, np.float32, self._batch_rows),
            ptr(weight, np.float32, self._batch_rows),
            None if qid is None else ptr(qid, np.int32, self._batch_rows),
            ptr(nrows, np.int32, self._num_shards), ctypes.byref(take)))
        return int(take.value)

    def fill_packed(self, big: np.ndarray, aux: np.ndarray,
                    nrows: np.ndarray) -> int:
        """Fused shard-major fill (csr_rec.h FillPacked): ``big`` is
        [D, kb, bucket] int32 (row, col, val f32 bits, [field]), ``aux``
        [D, ka, R] int32 (label bits, weight bits, [qid], nrows plane).
        Returns the true row count (0 = end)."""
        if self._bucket == 0:
            self.meta()  # plane sizing needs the static bucket
        D = self._num_shards
        R = self._batch_rows // D
        kb, ka = big.shape[1], aux.shape[1]
        take = ctypes.c_uint64()
        ptr = NativeBatcher._ptr
        _check(lib().dct_csrrec_fill_packed(
            self._h, ptr(big, np.int32, D * kb * self._bucket), kb,
            ptr(aux, np.int32, D * ka * R), ka, ptr(nrows, np.int32, D),
            ctypes.byref(take)))
        return int(take.value)

    def before_first(self) -> None:
        """Restart from the first record (new epoch)."""
        _check(lib().dct_csrrec_before_first(self._h))

    def set_epoch(self, epoch: int) -> bool:
        """Pin the shuffle permutation the next before_first() samples."""
        supported = ctypes.c_int32()
        _check(lib().dct_csrrec_set_epoch(self._h, epoch,
                                          ctypes.byref(supported)))
        return bool(supported.value)

    def bytes_read(self) -> int:
        """Record bytes consumed from the source so far."""
        out = ctypes.c_size_t()
        _check(lib().dct_csrrec_bytes_read(self._h, ctypes.byref(out)))
        return out.value


class NativeDenseRecBatcher(_Handle):
    """Zero-parse dense ingest of ``.drec`` files (cpp/src/dense_rec.h):
    records hold [rows, F] matrices in device layout, so a fill is record
    framing plus bulk memcpy with the GIL released. meta() reports the
    static shape; fill_packed() returns the true row count (0 at end)."""

    _FREE = "dct_denserec_free"

    def __init__(self, uri: str, part: int = 0, npart: int = 1,
                 batch_rows: int = 65536, num_shards: int = 1):
        uri = _route_https(uri)
        self._h = ctypes.c_void_p()
        self._batch_rows = batch_rows
        self._num_shards = num_shards
        _check(lib().dct_denserec_create(uri.encode(), part, npart,
                                         batch_rows, num_shards,
                                         ctypes.byref(self._h)))

    def meta(self):
        """(num_features, x_dtype, has_weight) pinned by the first record;
        x_dtype 0 = float32, 1 = bfloat16."""
        F = ctypes.c_uint64()
        dt, hw = ctypes.c_int32(), ctypes.c_int32()
        _check(lib().dct_denserec_meta(self._h, ctypes.byref(F),
                                       ctypes.byref(dt), ctypes.byref(hw)))
        return F.value, dt.value, bool(hw.value)

    def fill_packed(self, x: np.ndarray, aux: np.ndarray,
                    nrows: np.ndarray) -> int:
        """Fused shard-major fill (dense_rec.h FillPacked): ``x`` is
        [rows, F] float32 or uint16 bf16 bits (the file's values converted
        to it); label/weight/nrows go into ``aux`` [D, 3, R] int32.
        Returns the true row count (0 = end)."""
        F = x.shape[-1]
        D = self._num_shards
        R = self._batch_rows // D
        ka = aux.shape[1]
        take = ctypes.c_uint64()
        ptr = NativeBatcher._ptr
        _check(lib().dct_denserec_fill_packed(
            self._h, ptr(x, x.dtype, self._batch_rows * F), _x_dtype_code(x),
            F, ptr(aux, np.int32, D * ka * R), ka, ptr(nrows, np.int32, D),
            ctypes.byref(take)))
        return int(take.value)

    def fill(self, x: np.ndarray, label: np.ndarray, weight: np.ndarray,
             nrows: np.ndarray) -> int:
        """Fill one batch into separate planes (dense_rec.h Fill): ``x``
        [rows, F] float32 or uint16 bf16 bits (its dtype picks the
        storage), ``label``/``weight`` [rows], ``nrows`` [D]. Returns the
        true row count (0 = end)."""
        F = x.shape[-1]
        take = ctypes.c_uint64()
        ptr = NativeBatcher._ptr
        _check(lib().dct_denserec_fill(
            self._h, ptr(x, x.dtype, self._batch_rows * F), _x_dtype_code(x),
            F,  # checked natively against the file's feature width
            ptr(label, np.float32, self._batch_rows),
            ptr(weight, np.float32, self._batch_rows),
            ptr(nrows, np.int32, self._num_shards), ctypes.byref(take)))
        return int(take.value)

    def before_first(self) -> None:
        """Restart from the first record (new epoch)."""
        _check(lib().dct_denserec_before_first(self._h))

    def set_epoch(self, epoch: int) -> bool:
        """Pin the shuffle permutation the next before_first() samples
        (the dense-rec split does not shuffle: always False)."""
        supported = ctypes.c_int32()
        _check(lib().dct_denserec_set_epoch(self._h, epoch,
                                            ctypes.byref(supported)))
        return bool(supported.value)

    def bytes_read(self) -> int:
        """Record bytes consumed from the source so far."""
        out = ctypes.c_size_t()
        _check(lib().dct_denserec_bytes_read(self._h, ctypes.byref(out)))
        return out.value


class NativeRecordIOWriter(_Handle):
    """RecordIO writer (reference RecordIOWriter, recordio.h:38)."""

    _FREE = "dct_recordio_writer_free"

    def __init__(self, uri: str):
        uri = _route_https(uri)
        self._h = ctypes.c_void_p()
        _check(lib().dct_recordio_writer_create(uri.encode(),
                                                ctypes.byref(self._h)))

    def write_record(self, data: bytes) -> None:
        """Append one record (< 2^29 bytes; embedded aligned magics are
        escaped)."""
        _check(lib().dct_recordio_write(self._h, data, len(data)))


class NativeRecordIOReader(_Handle):
    """RecordIO reader (reference RecordIOReader, recordio.h:119)."""

    _FREE = "dct_recordio_reader_free"

    def __init__(self, uri: str):
        uri = _route_https(uri)
        self._h = ctypes.c_void_p()
        _check(lib().dct_recordio_reader_create(uri.encode(),
                                                ctypes.byref(self._h)))

    def next_record(self) -> Optional[bytes]:
        """Next record payload, or None at end of stream."""
        data = ctypes.c_void_p()
        size = ctypes.c_size_t()
        has = ctypes.c_int()
        _check(lib().dct_recordio_read(self._h, ctypes.byref(data),
                                       ctypes.byref(size), ctypes.byref(has)))
        if not has.value:
            return None
        return ctypes.string_at(data, size.value) if size.value else b""

    def __iter__(self) -> Iterator[bytes]:
        while True:
            rec = self.next_record()
            if rec is None:
                return
            yield rec


def _x_dtype_code(x: np.ndarray) -> int:
    """The native fills' dense storage code: 0 float32, 1 bf16 bits."""
    if x.dtype == np.float32:
        return 0
    if x.dtype == BF16_STORAGE:
        return 1
    raise DMLCError(f"dense fill dtype must be float32 or bf16 bits "
                    f"(uint16), got {x.dtype}")


def bf16_convert(src: np.ndarray, dst: np.ndarray) -> None:
    """Native float32 -> bfloat16 bulk conversion (cpp/src/bf16.h) into
    ``dst``, a C-contiguous uint16 array of ``src.size`` bf16 bits: the
    round-to-nearest-even the batch fills use (NaN stays NaN)."""
    ptr = NativeBatcher._ptr
    _check(lib().dct_bf16_convert(ptr(src, np.float32, src.size),
                                  ptr(dst, BF16_STORAGE, src.size),
                                  src.size))


def bf16_upcast(src: np.ndarray, dst: np.ndarray) -> None:
    """Native bfloat16 -> float32 bulk upcast (cpp/src/bf16.h) of the
    uint16 bf16 bits ``src`` into float32 ``dst``: exact, the widening
    ``tensor.view(torch.bfloat16).float()`` performs on the device."""
    ptr = NativeBatcher._ptr
    _check(lib().dct_bf16_upcast(ptr(src, BF16_STORAGE, src.size),
                                 ptr(dst, np.float32, src.size),
                                 src.size))


def bf16_bits(src: np.ndarray) -> np.ndarray:
    """bfloat16 bits (uint16, same shape) of float32 ``src``, rounded to
    nearest even by the native core's conversion (cpp/src/bf16.h), the one
    the batch fills use."""
    src = np.ascontiguousarray(src, np.float32)
    out = np.empty(src.shape, BF16_STORAGE)
    if src.size:
        bf16_convert(src, out)
    return out


class NativeStream:
    """URI-dispatched byte stream (reference Stream::Create, io.h:57):
    local paths, ``file://`` and the remote schemes of the native core,
    ``https://`` through the TLS helper."""

    def __init__(self, uri: str, mode: str = "r"):
        uri = _route_https(uri)
        self._h = ctypes.c_void_p()
        _check(lib().dct_stream_create(uri.encode(), mode.encode(),
                                       ctypes.byref(self._h)))

    def read(self, size: int = 1 << 20) -> bytes:
        """Read up to ``size`` bytes (empty bytes at end of stream)."""
        buf = ctypes.create_string_buffer(size)
        nread = ctypes.c_size_t()
        _check(lib().dct_stream_read(self._h, buf, size,
                                     ctypes.byref(nread)))
        return buf.raw[: nread.value]

    def read_all(self) -> bytes:
        """Read the remainder of the stream into one bytes object."""
        chunks = []
        while True:
            c = self.read()
            if not c:
                break
            chunks.append(c)
        return b"".join(chunks)

    def write(self, data: bytes) -> None:
        """Write all of ``data`` to the stream."""
        _check(lib().dct_stream_write(self._h, data, len(data)))

    def close(self) -> None:
        """Finish and free the native stream (idempotent; raises if the
        final flush fails)."""
        if self._h:
            # the handle is freed even when Finish fails; drop it before
            # raising so a later close/__del__ cannot double-free
            h, self._h = self._h, ctypes.c_void_p()
            _check(lib().dct_stream_free(h))

    def __enter__(self) -> "NativeStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def path_info(uri: str) -> Tuple[int, bool]:
    """(size, is_dir) of ``uri``."""
    uri = _route_https(uri)
    size = ctypes.c_size_t()
    is_dir = ctypes.c_int()
    _check(lib().dct_fs_path_info(uri.encode(), ctypes.byref(size),
                                  ctypes.byref(is_dir)))
    return size.value, bool(is_dir.value)


def list_directory(uri: str, recursive: bool = False
                   ) -> List[Tuple[str, int, str]]:
    """List (path, size, 'f'|'d') entries (reference FileSystem, io.h:591)."""
    uri = _route_https(uri)
    out = ctypes.c_char_p()
    _check(lib().dct_fs_list(uri.encode(), 1 if recursive else 0,
                             ctypes.byref(out)))
    try:
        text = ctypes.string_at(out).decode()
    finally:
        lib().dct_str_free(out)
    entries = []
    for line in text.splitlines():
        path, size, ftype = line.rsplit("\t", 2)
        entries.append((path, int(size), ftype))
    return entries


def parser_formats_doc() -> str:
    """Markdown documentation of every registered native data format and
    its reflection parameters (``dct_parser_formats_doc``)."""
    out = ctypes.c_char_p()
    _check(lib().dct_parser_formats_doc(ctypes.byref(out)))
    try:
        return ctypes.string_at(out).decode()
    finally:
        lib().dct_str_free(out)


def set_fs_fault_plan(plan: str) -> None:
    """Install a local-filesystem fault plan inside the native syscall
    wrappers (cpp/src/fs_fault.h), in the grammar of
    :mod:`dmlc_core_tpu_torch.utils.fs_fault`. "" clears; an explicit
    clear beats ``DMLC_FS_FAULT_PLAN``. Raises on bad grammar. Drives the
    native half only; the Python file ops have their own setter."""
    _check(lib().dct_fs_set_fault_plan(plan.encode()))


def _json_doc(fn) -> dict:
    out = ctypes.c_char_p()
    _check(fn(ctypes.byref(out)))
    try:
        return json.loads(ctypes.string_at(out).decode())
    finally:
        lib().dct_str_free(out)


def native_telemetry_snapshot() -> dict:
    """The native registry's snapshot document
    (``dct_telemetry_snapshot``, cpp/src/telemetry.h): ``{"version",
    "enabled", "anchor", "counters", "gauges", "histograms"}``."""
    return _json_doc(lib().dct_telemetry_snapshot)


def native_trace_snapshot() -> dict:
    """The native span ring's document (``dct_trace_snapshot``)."""
    return _json_doc(lib().dct_trace_snapshot)


def native_telemetry_reset() -> None:
    """Zero every metric in the native registry (``dct_telemetry_reset``)."""
    _check(lib().dct_telemetry_reset())


def native_telemetry_enable(on: bool) -> None:
    """Gate the native side's timed spans at run time
    (``dct_telemetry_enable``; overrides ``DMLC_TELEMETRY``). Counters
    count either way."""
    _check(lib().dct_telemetry_enable(1 if on else 0))


def native_trace_reset() -> None:
    """Drop every buffered native span and restart the trace sequence
    (``dct_trace_reset``)."""
    _check(lib().dct_trace_reset())


def native_flight_dump(reason: str) -> bool:
    """Best-effort native flight-recorder dump (``dct_flight_dump``) into
    the ``DMLC_TRACE_DUMP`` directory. True only when a file landed."""
    written = ctypes.c_int(0)
    _check(lib().dct_flight_dump(reason.encode(), ctypes.byref(written)))
    return written.value != 0


# io_retry_stats() key -> the telemetry counter it reads
_LEGACY_IO_STAT_NAMES = (
    ("requests", "io_requests_total"),
    ("retries", "io_retries_total"),
    ("backoff_ms_total", "io_backoff_ms_total"),
    ("timeouts", "io_timeouts_total"),
    ("faults_injected", "io_faults_injected_total"),
    ("giveups", "io_giveups_total"),
    ("deadline_exhausted", "io_deadline_exhausted_total"),
)


def io_retry_stats() -> dict:
    """The process-wide remote-I/O counters of every native stream
    (cpp/src/retry.h IoStats) under the reference's keys: ``requests``,
    ``retries`` (backoff sleeps), ``backoff_ms_total``, ``timeouts``,
    ``faults_injected``, ``giveups`` and ``deadline_exhausted``. A view of
    the native registry's ``io_*_total`` counters."""
    counters = {c["name"]: c["value"]
                for c in native_telemetry_snapshot().get("counters", [])}
    return {legacy: int(counters.get(name, 0))
            for legacy, name in _LEGACY_IO_STAT_NAMES}


def reset_io_retry_stats() -> None:
    """Zero the :func:`io_retry_stats` counters."""
    _check(lib().dct_io_stats_reset())


def set_io_fault_plan(plan: str) -> None:
    """Install a deterministic fault plan inside the native HTTP client,
    below every backend (cpp/src/retry.h grammar, rules ';'-separated)::

        reset:every=3;stall:every=5,ms=80;5xx:every=7,status=503

    ``every=N`` fires on every Nth request, ``p=0.1`` with seeded
    probability (``DMLC_IO_FAULT_SEED``). "" clears; bad grammar raises."""
    _check(lib().dct_io_set_fault_plan(plan.encode()))


def set_io_timeout_ms(ms: int) -> None:
    """Per-attempt socket timeout (connect/recv/send, milliseconds) of all
    native remote I/O; ``ms <= 0`` reverts to ``DMLC_IO_TIMEOUT_MS`` / the
    60 s default. A ``?io_timeout_ms=`` URI arg overrides it per stream."""
    _check(lib().dct_io_set_timeout_ms(ms))


def set_webhdfs_delegation_token(token: str) -> None:
    """Rotate the hdfs:// delegation token: later WebHDFS ops carry
    ``delegation=<token>`` and omit ``user.name``; "" reverts to
    ``user.name`` auth (initial value: ``WEBHDFS_DELEGATION_TOKEN``)."""
    _check(lib().dct_webhdfs_set_delegation_token(token.encode()))


def set_webhdfs_auth_header(header: str) -> None:
    """Set a verbatim Authorization header for hdfs:// ops (the
    SPNEGO/Kerberos hook, e.g. ``Negotiate <token>``); "" reverts
    (initial value: ``WEBHDFS_AUTH_HEADER``)."""
    _check(lib().dct_webhdfs_set_auth_header(header.encode()))


class NativeInputSplit(_Handle):
    """Record-aligned partitioned reader (reference InputSplit,
    io.h:155-302): each ``(part, nsplit)`` yields a disjoint set of whole
    records, and the parts together cover the source exactly once.
    ``split_type`` is ``text`` or ``recordio`` (or ``indexed_recordio``
    with ``index_uri``)."""

    _FREE = "dct_split_free"

    def __init__(self, uri: str, part: int = 0, nsplit: int = 1,
                 split_type: str = "text", threaded: bool = True,
                 index_uri: str = "", shuffle: bool = False, seed: int = 0,
                 batch_size: int = 256, cache_file: str = "",
                 shuffle_parts: int = 0, recurse: bool = False):
        uri = _route_https(uri)
        self._h = ctypes.c_void_p()
        if (index_uri or shuffle or cache_file or shuffle_parts or recurse
                or split_type == "indexed_recordio"):
            _check(lib().dct_split_create_ex(
                uri.encode(), index_uri.encode(), part, nsplit,
                split_type.encode(), 1 if threaded else 0,
                1 if shuffle else 0, seed, batch_size, cache_file.encode(),
                shuffle_parts, 1 if recurse else 0, ctypes.byref(self._h)))
        else:
            _check(lib().dct_split_create(uri.encode(), part, nsplit,
                                          split_type.encode(),
                                          1 if threaded else 0,
                                          ctypes.byref(self._h)))

    def _next(self, fn) -> Optional[bytes]:
        data = ctypes.c_void_p()
        size = ctypes.c_size_t()
        has = ctypes.c_int()
        _check(fn(self._h, ctypes.byref(data), ctypes.byref(size),
                  ctypes.byref(has)))
        if not has.value:
            return None
        return ctypes.string_at(data, size.value) if size.value else b""

    def next_record(self) -> Optional[bytes]:
        """Next whole record, or None at the end of the part."""
        return self._next(lib().dct_split_next_record)

    def next_chunk(self) -> Optional[bytes]:
        """Next record-aligned chunk of raw bytes, or None at the end."""
        return self._next(lib().dct_split_next_chunk)

    def __iter__(self) -> Iterator[bytes]:
        while True:
            rec = self.next_record()
            if rec is None:
                return
            yield rec

    def before_first(self) -> None:
        """Restart this part from its first record."""
        _check(lib().dct_split_before_first(self._h))

    def reset_partition(self, part: int, nsplit: int) -> None:
        """Re-point the split at another ``(part, nsplit)`` without
        reopening the source (reference ResetPartition)."""
        _check(lib().dct_split_reset_partition(self._h, part, nsplit))

    def total_size(self) -> int:
        """Byte size of the whole source, across all parts."""
        out = ctypes.c_size_t()
        _check(lib().dct_split_total_size(self._h, ctypes.byref(out)))
        return out.value

    def hint_chunk_size(self, nbytes: int) -> None:
        """Suggest the chunk granularity of :meth:`next_chunk`."""
        _check(lib().dct_split_hint_chunk_size(self._h, nbytes))


class LeasedSplit:
    """Elastic InputSplit: the records of shard leases granted at run time
    instead of one static ``(part, nsplit)``. One
    :class:`NativeInputSplit` is re-pointed at each granted shard with
    ``reset_partition(shard, num_shards)``. ``leases`` is a
    ``tracker.client.HeartbeatMonitor`` or a ``data.LocalLeases``; a shard
    is completed only after its last record was yielded, so a worker that
    dies mid-shard leaves it to another."""

    def __init__(self, uri: str, leases, num_shards: int,
                 split_type: str = "text", epoch: int = 0,
                 acquire_timeout: Optional[float] = None, **split_kwargs):
        if num_shards <= 0:
            raise DMLCError("LeasedSplit needs num_shards > 0")
        self._split = NativeInputSplit(uri, 0, num_shards, split_type,
                                       **split_kwargs)
        self._leases = leases
        self.num_shards = num_shards
        self.epoch = epoch
        self._acquire_timeout = acquire_timeout
        self.consumed: list = []

    def __iter__(self) -> Iterator[bytes]:
        """Records of every shard this worker wins, shard by shard."""
        while True:
            shard = self._leases.acquire_lease(self.epoch,
                                               self._acquire_timeout)
            if shard is None:
                return
            self._split.reset_partition(shard, self.num_shards)
            while True:
                rec = self._split.next_record()
                if rec is None:
                    break
                yield rec
            self._leases.complete_lease(self.epoch, shard)
            self.consumed.append(shard)

    def set_epoch(self, epoch: int) -> None:
        """Move to another epoch's lease pool."""
        self.epoch = epoch
        self.consumed = []

    def close(self) -> None:
        """Free the native split (idempotent)."""
        self._split.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
