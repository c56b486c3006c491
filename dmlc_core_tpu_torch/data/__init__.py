"""Host-side data layer: the reference's L5 API (port of
``dmlc_core_tpu/data/__init__.py``).

Counterpart of reference ``include/dmlc/data.h`` (Row / RowBlock /
RowBlockIter / Parser, data.h:74-312) and ``src/data/row_block.h``
(RowBlockContainer), for learners that want CSR blocks on the host —
feature engineering, sketching, a consumer of its own. The device path is
``dmlc_core_tpu_torch.device.device_iter.DeviceRowBlockIter``.

As in the reference:
- rows are numpy slices of struct-of-arrays storage; ``Row.sdot`` is a
  vectorized dot;
- ``RowBlockContainer.save/load`` write and read the C++ core's
  little-endian wire format (cpp/src/rowblock.h Save/Load) through the
  port's ``serializer.py``, so the two packages read each other's files;
- custom formats register with ``@register_parser``; libsvm, csv and
  libfm go to the port's native multithreaded parsers, whose shard cache
  (``cache_dir``/``cache``, ``#cachefile=<dir>``) tees parsed blocks into
  binary shards in epoch 1 and replays them from epoch 2 on;
- ``ElasticRowBlockIter`` iterates shard leases instead of a static part
  (``DMLC_ELASTIC_SHARDS=1`` or ``?elastic=1`` through
  ``RowBlockIter.create``), with the same shard order for the same
  ``(num_shards, shuffle_window, run_id, epoch)``. Its lease source is
  the process's tracker heartbeat monitor
  (``tracker.client.current_monitor()``, opened by
  ``RendezvousClient.start(heartbeat=True)``) unless ``leases=`` names
  another, such as a :class:`LocalLeases` for one host.
"""

from __future__ import annotations

import threading
import time
from typing import BinaryIO, Callable, Dict, Iterator, List, Optional

import numpy as np

from dmlc_core_tpu_torch import telemetry
from dmlc_core_tpu_torch.base import DMLCError, log_info, log_warning
from dmlc_core_tpu_torch.io.native import (NativeParser, RowBlock,
                                           io_retry_stats)
from dmlc_core_tpu_torch.registry import Registry
from dmlc_core_tpu_torch.serializer import BinaryReader, BinaryWriter
from dmlc_core_tpu_torch.tracker.wire import env_int

__all__ = ["Row", "RowBlock", "RowBlockContainer", "Parser", "RowBlockIter",
           "ElasticRowBlockIter", "LocalLeases", "register_parser",
           "PARSER_REGISTRY"]


class Row:
    """One CSR row view (reference Row, data.h:74-162)."""

    __slots__ = ("label", "weight", "qid", "index", "value", "field")

    def __init__(self, label, weight, qid, index, value, field):
        self.label = label
        self.weight = weight
        self.qid = qid
        self.index = index
        self.value = value
        self.field = field

    @property
    def length(self) -> int:
        return len(self.index)

    def get_value(self, i: int) -> float:
        """value of the i-th nonzero (implicit 1.0 when values absent)."""
        return 1.0 if self.value is None else float(self.value[i])

    def sdot(self, weights: np.ndarray) -> float:
        """Sparse dot with a dense weight vector (reference Row::SDot,
        data.h:124-136) — vectorized, not the reference's scalar loop."""
        w = weights[self.index]
        return float(w.sum() if self.value is None
                     else np.dot(w, self.value.astype(np.float64)))


class RowBlockContainer:
    """Owning, growable CSR block (reference src/data/row_block.h:26-215).

    Struct-of-arrays numpy storage; the wire format of save/load matches
    cpp/src/rowblock.h Save/Load byte for byte."""

    def __init__(self, index64: bool = False):
        self.offset = np.zeros(1, dtype=np.uint64)
        self.label = np.empty(0, dtype=np.float32)
        self.weight = np.empty(0, dtype=np.float32)
        self.qid = np.empty(0, dtype=np.uint64)
        self.field = np.empty(0, dtype=np.uint32)
        self.index = np.empty(0, dtype=np.uint64 if index64 else np.uint32)
        self.value = np.empty(0, dtype=np.float32)
        self.value_i32 = np.empty(0, dtype=np.int32)
        self.value_i64 = np.empty(0, dtype=np.int64)
        self.value_dtype = 0  # 0=float32, 1=int32, 2=int64
        self.max_index = 0
        self.max_field = 0

    # -- size/introspection ---------------------------------------------------
    @property
    def size(self) -> int:
        return len(self.label)

    @property
    def nnz(self) -> int:
        return len(self.index)

    @property
    def num_col(self) -> int:
        """max feature index + 1 (reference RowBlockIter::NumCol)."""
        return int(self.max_index) + 1 if self.nnz else 0

    def mem_cost_bytes(self) -> int:
        """reference RowBlock::MemCostBytes (data.h:198-214)."""
        return sum(a.nbytes for a in (
            self.offset, self.label, self.weight, self.qid, self.field,
            self.index, self.value, self.value_i32, self.value_i64))

    def _values_view(self) -> Optional[np.ndarray]:
        if self.value_dtype == 1:
            return self.value_i32
        if self.value_dtype == 2:
            return self.value_i64
        return self.value if len(self.value) else None

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, i: int) -> Row:
        """Row view (reference RowBlock::operator[], data.h:364-394)."""
        if not 0 <= i < self.size:
            raise IndexError(i)
        lo, hi = int(self.offset[i]), int(self.offset[i + 1])
        vals = self._values_view()
        return Row(
            label=float(self.label[i]),
            weight=float(self.weight[i]) if len(self.weight) else 1.0,
            qid=int(self.qid[i]) if len(self.qid) else None,
            index=self.index[lo:hi],
            value=None if vals is None else vals[lo:hi],
            field=self.field[lo:hi] if len(self.field) else None)

    def __iter__(self) -> Iterator[Row]:
        for i in range(self.size):
            yield self[i]

    def slice(self, begin: int, end: int) -> "RowBlockContainer":
        """Copy rows [begin, end) (reference RowBlock::Slice, data.h:216)."""
        if not 0 <= begin <= end <= self.size:
            raise DMLCError(f"bad slice [{begin}, {end}) of {self.size}")
        out = RowBlockContainer()
        lo, hi = int(self.offset[begin]), int(self.offset[end])
        out.offset = (self.offset[begin:end + 1] - lo).astype(np.uint64)
        out.label = self.label[begin:end].copy()
        if len(self.weight):
            out.weight = self.weight[begin:end].copy()
        if len(self.qid):
            out.qid = self.qid[begin:end].copy()
        if len(self.field):
            out.field = self.field[lo:hi].copy()
        out.index = self.index[lo:hi].copy()
        for name in ("value", "value_i32", "value_i64"):
            arr = getattr(self, name)
            if len(arr):
                setattr(out, name, arr[lo:hi].copy())
        out.value_dtype = self.value_dtype
        if out.nnz:
            out.max_index = int(out.index.max())
            if len(out.field):
                out.max_field = int(out.field.max())
        return out

    def take(self, rows) -> "RowBlockContainer":
        """Gather the given row ids (any order, repeats allowed) into a
        new container — the windowed-shuffle primitive of the elastic
        iterator. Vectorized: one fancy-index gather per array, no
        per-row Python loop."""
        rows = np.asarray(rows, dtype=np.int64)
        if rows.size and (rows.min() < 0 or rows.max() >= self.size):
            raise DMLCError(f"take rows out of range [0, {self.size})")
        out = RowBlockContainer(index64=self.index.dtype == np.uint64)
        starts = self.offset[rows].astype(np.int64)
        lens = (self.offset[rows + 1] - self.offset[rows]).astype(np.int64)
        total = int(lens.sum())
        if total:
            # per selected row i: starts[i] + [0, lens[i]) — expressed as
            # one repeat + arange re-basing, no loop
            ends = np.cumsum(lens)
            gather = (np.repeat(starts, lens)
                      + np.arange(total, dtype=np.int64)
                      - np.repeat(ends - lens, lens))
        else:
            gather = np.empty(0, np.int64)
        out.offset = np.concatenate(
            [np.zeros(1, np.uint64), np.cumsum(lens).astype(np.uint64)])
        out.label = self.label[rows]
        if len(self.weight):
            out.weight = self.weight[rows]
        if len(self.qid):
            out.qid = self.qid[rows]
        if len(self.field):
            out.field = self.field[gather]
        out.index = self.index[gather]
        for name in ("value", "value_i32", "value_i64"):
            arr = getattr(self, name)
            if len(arr):
                setattr(out, name, arr[gather])
        out.value_dtype = self.value_dtype
        if out.nnz:
            out.max_index = int(out.index.max())
        if len(out.field):
            out.max_field = int(out.field.max())
        return out

    # -- growth ---------------------------------------------------------------
    @classmethod
    def from_blocks(cls, blocks, index64: bool = False
                    ) -> "RowBlockContainer":
        """Build one container from RowBlock views / containers in a single
        pass (one concatenate per array — the eager-load path is O(n), not
        the O(n²) of repeated appends).

        Presence is reconciled across blocks: when only some blocks carry
        weights/values/qids/fields, the absent ones are filled with their
        implicit defaults (weight 1, value 1, qid 0, field 0) so all arrays
        stay aligned with offset/index."""
        parts = []       # (n, off_u64, nnz, label, w|None, q|None, f|None,
                         #  idx, v|None)
        any_w = any_q = any_f = any_v = False
        vdt: Optional[int] = None
        for b in blocks:
            n = b.num_rows if hasattr(b, "num_rows") else b.size
            off = np.asarray(b.offset, dtype=np.uint64)
            nnz = int(off[-1])

            def opt(arr):
                return arr if arr is not None and len(arr) else None

            w = opt(getattr(b, "weight", None))
            q = opt(getattr(b, "qid", None))
            f = opt(getattr(b, "field", None))
            if isinstance(b, RowBlockContainer):
                v = opt(b._values_view())
            else:
                v = opt(getattr(b, "value", None))
            if v is not None:
                dt = {np.dtype(np.int32): 1, np.dtype(np.int64): 2}.get(
                    np.asarray(v).dtype, 0)
                if vdt is None:
                    vdt = dt
                elif vdt != dt:
                    raise DMLCError(
                        "cannot merge row blocks of different value dtypes")
            any_w |= w is not None
            any_q |= q is not None
            any_f |= f is not None
            any_v |= v is not None
            parts.append((n, off, nnz, np.asarray(b.label, np.float32),
                          w, q, f, np.asarray(b.index), v))
        c = cls(index64)
        if not parts:
            return c
        offs = [c.offset]
        base = 0
        for n, off, nnz, *_ in parts:
            offs.append(off[1:] + base)
            base += nnz
        c.offset = np.concatenate(offs).astype(np.uint64)
        c.label = np.concatenate([p[3] for p in parts])
        if any_w:
            c.weight = np.concatenate([
                p[4] if p[4] is not None else np.ones(p[0], np.float32)
                for p in parts]).astype(np.float32)
        if any_q:
            c.qid = np.concatenate([
                p[5] if p[5] is not None else np.zeros(p[0], np.uint64)
                for p in parts]).astype(np.uint64)
        if any_f:
            c.field = np.concatenate([
                p[6] if p[6] is not None else np.zeros(p[2], np.uint32)
                for p in parts]).astype(np.uint32)
        c.index = np.concatenate(
            [p[7] for p in parts]).astype(c.index.dtype)
        if any_v:
            c.value_dtype = vdt or 0
            name = {0: "value", 1: "value_i32", 2: "value_i64"}[c.value_dtype]
            dtype = {0: np.float32, 1: np.int32, 2: np.int64}[c.value_dtype]
            setattr(c, name, np.concatenate([
                p[8] if p[8] is not None else np.ones(p[2], dtype)
                for p in parts]).astype(dtype))
        if c.nnz:
            c.max_index = int(c.index.max())
        if len(c.field):
            c.max_field = int(c.field.max())
        return c

    def append_block(self, b) -> None:
        """Append all rows of a RowBlock view or another container
        (reference Push(RowBlock), row_block.h). For many blocks prefer
        from_blocks (single concatenate)."""
        merged = RowBlockContainer.from_blocks(
            [self, b], index64=self.index.dtype == np.uint64)
        self.__dict__.update(merged.__dict__)

    # -- binary io (cross-language wire format) -------------------------------
    def save(self, stream: BinaryIO) -> None:
        """Serialize to the cross-language wire format (reference row_block.h
        Save)."""
        w = BinaryWriter(stream)
        w.write_array(self.offset)
        w.write_array(self.label)
        w.write_array(self.weight)
        w.write_array(self.qid)
        w.write_array(self.field)
        w.write_array(self.index)
        w.write_array(self.value)
        w.write_array(self.value_i32)
        w.write_array(self.value_i64)
        w.write_scalar(self.value_dtype, "int32")
        w.write_scalar(self.max_index, "uint64")
        w.write_scalar(self.max_field, "uint32")

    def load(self, stream: BinaryIO) -> bool:
        """Read one block; False at a clean end of stream."""
        head = stream.read(8)
        if len(head) < 8:
            return False
        r = BinaryReader(stream)
        n = int(np.frombuffer(head, "<u8")[0])
        raw = stream.read(8 * n)
        if len(raw) != 8 * n:  # checked like BinaryReader._read_exact
            raise DMLCError(
                f"truncated stream: wanted {8 * n} bytes, got {len(raw)}")
        self.offset = np.frombuffer(raw, "<u8").copy()
        self.label = r.read_array("float32")
        self.weight = r.read_array("float32")
        self.qid = r.read_array("uint64")
        self.field = r.read_array("uint32")
        self.index = r.read_array(
            "uint64" if self.index.dtype == np.uint64 else "uint32")
        self.value = r.read_array("float32")
        self.value_i32 = r.read_array("int32")
        self.value_i64 = r.read_array("int64")
        self.value_dtype = int(r.read_scalar("int32"))
        self.max_index = int(r.read_scalar("uint64"))
        self.max_field = int(r.read_scalar("uint32"))
        return True


# -- parser factory -----------------------------------------------------------
# reference DMLC_REGISTER_DATA_PARSER (data.h:358) + CreateParser_
# (src/data.cc:62-85). Builtin formats dispatch to the native multithreaded
# parsers; Python callables can register additional formats.
PARSER_REGISTRY: Registry = Registry.get("data_parser")

_NATIVE_FORMATS = ("libsvm", "csv", "libfm")

# batch-path metric objects resolved ONCE (the registry contract: resolve,
# keep the pointer — per-batch re-resolution would take the registry lock
# on every pull); lazy so importing this module registers nothing
_batch_metrics = None


def _get_batch_metrics():
    global _batch_metrics
    if _batch_metrics is None:
        _batch_metrics = (telemetry.histogram("rowblock_batch_us"),
                          telemetry.counter("rowblock_batches_total"),
                          telemetry.counter("rowblock_skipped_batches_total"))
    return _batch_metrics


def register_parser(name: str) -> Callable:
    """Register a custom format: factory(uri, part, npart, **kwargs) ->
    parser with next_block()/before_first()/bytes_read()."""
    return PARSER_REGISTRY.register(name)


class Parser:
    """Format-dispatched parser factory (reference Parser<I,D>::Create,
    data.h:307). Iterating the result yields RowBlock views."""

    @staticmethod
    def create(uri: str, part: int = 0, npart: int = 1, fmt: str = "auto",
               nthread: int = 0, index64: bool = False,
               chunks_in_flight: int = 0, cache_dir: str = "",
               cache: str = "", **kwargs):
        """Instantiate a parser for `uri` by format name via the registry
        (reference Parser<I>::Create, data.h:307).

        ``nthread`` sizes the native parse worker pool and
        ``chunks_in_flight`` bounds the chunks the pipelined reader keeps
        outstanding (0 = auto; native formats only — see
        cpp/src/parser.h PipelinedParser). The returned native parser
        exposes ``pipeline_stats()`` with per-stage occupancy counters.

        ``cache_dir``/``cache`` opt into the transcoding shard cache
        ([caching.md](caching.md)): the first pass tees parsed row blocks
        into a manifest-keyed binary shard under ``cache_dir``, later
        epochs replay it zero-copy via mmap. ``cache`` is
        never|auto|refresh; both also ride URI sugar
        (``#cachefile=<dir>``, ``?cache=``) and env
        (DMLC_DATA_CACHE_DIR, DMLC_DATA_CACHE)."""
        args = _uri_query_args(uri)
        resolved = args.get("format", "libsvm") if fmt == "auto" else fmt
        if resolved in _NATIVE_FORMATS:
            if kwargs:
                # native parser options travel as ?k=v URI args (reference
                # URISpec → param_.Init); don't silently drop kwargs
                raise DMLCError(
                    f"native format {resolved!r} takes options as URI args "
                    f"(e.g. ?label_column=0), got kwargs {sorted(kwargs)}")
            return NativeParser(uri, part=part, npart=npart, fmt=fmt,
                                nthread=nthread, index64=index64,
                                chunks_in_flight=chunks_in_flight,
                                cache_dir=cache_dir, cache=cache)
        entry = PARSER_REGISTRY.find(resolved)
        if entry is None:
            raise DMLCError(
                f"unknown data format {resolved!r}; known: "
                f"{list(_NATIVE_FORMATS) + PARSER_REGISTRY.list_names()}")
        uri_cache = args.get("cache", "")
        frag = uri.split("#", 1)[1] if "#" in uri else ""
        if (cache_dir or (cache and cache != "never")
                or frag.startswith("cachefile=")
                or (uri_cache and uri_cache != "never")):
            # a cache knob a lane does not implement must error, not
            # silently parse text every epoch (the URI-sugar no-op rule)
            # — via kwargs AND via ?cache=/#cachefile= URI sugar alike;
            # "never" explicitly asks for no caching, which this lane
            # already delivers
            raise DMLCError(
                f"format {resolved!r} is a Python-registered parser; the "
                f"shard cache covers the native formats only")
        return entry(uri, part, npart, **kwargs)


class RowBlockIter:
    """Host row-block iterator (reference RowBlockIter<I,D>::Create,
    data.h:267).

    Without caching sugar this is the BasicRowIter shape: the whole
    split is loaded eagerly into ONE RowBlockContainer and iteration
    yields that single block (reference src/data/basic_row_iter.h). A
    ``#cachefile=<dir>`` suffix (or ``cache_dir=``) opts into the
    transcoding shard cache — epoch 1 parses text and tees binary
    shards, epoch 2+ replays them zero-copy via mmap
    ([caching.md](caching.md)); a legacy ``#<path>`` fragment selects
    the native DiskCacheParser single-file cache, page-at-a-time
    (reference disk_row_iter.h). For the device path use
    dmlc_core_tpu_torch.device.device_iter.DeviceRowBlockIter instead.

    ``on_error`` is the graceful-degradation knob for remote sources that
    stay broken past the native retry budget (cpp/src/retry.h): ``"raise"``
    (default) propagates, ``"skip"`` logs the error, counts it in
    ``skipped_batches``, and keeps pulling blocks — after
    ``_MAX_CONSECUTIVE_ERRORS`` consecutive failures the shard is treated
    as exhausted so a training loop rides through a transiently bad shard
    instead of dying mid-epoch. ``io_stats()`` exposes the retry/fault
    counters plus the skip count (see doc/robustness.md)."""

    _MAX_CONSECUTIVE_ERRORS = 3

    def __init__(self, parser, eager: bool, on_error: str = "raise"):
        if on_error not in ("raise", "skip"):
            raise DMLCError(
                f"on_error must be 'raise' or 'skip', got {on_error!r}")
        self._parser = parser
        self._eager = eager
        self._on_error = on_error
        self._block: Optional[RowBlockContainer] = None
        self.skipped_batches = 0
        self.last_error: Optional[str] = None

    @staticmethod
    def create(uri: str, part: int = 0, npart: int = 1, fmt: str = "auto",
               nthread: int = 0, index64: bool = False,
               chunks_in_flight: int = 0,
               on_error: str = "raise", elastic: Optional[bool] = None,
               leases=None, num_shards: int = 0, shuffle_window: int = 0,
               run_id: Optional[int] = None, epoch: int = 0,
               cache_dir: str = "", cache: str = ""):
        """Factory matching reference RowBlockIter<I>::Create (data.h:267);
        ``on_error="skip"`` enables graceful degradation (class doc).

        ``cache_dir``/``cache`` (never|auto|refresh) opt into the
        transcoding shard cache ([caching.md](caching.md)): epoch 1
        parses text and tees binary shards, epoch 2+ replays them
        zero-copy via mmap. Also reachable via ``#cachefile=<dir>`` /
        ``?cache=`` URI sugar and the DMLC_DATA_CACHE_DIR /
        DMLC_DATA_CACHE env knobs.

        Elastic opt-in (doc/robustness.md "Elastic data-plane"):
        ``DMLC_ELASTIC_SHARDS=1`` in the environment (exported by an
        elastic tracker's ``worker_envs``) or a ``?elastic=1`` URI arg
        switches to lease-driven iteration and returns an
        :class:`ElasticRowBlockIter` consuming granted shards
        (``num_shards`` / ``?num_shards=`` / ``DMLC_TRACKER_NUM_SHARDS``)
        with ``leases`` defaulting to the process's active
        HeartbeatMonitor. The env opt-in only applies to calls with the
        default ``part=0, npart=1`` — an explicit static split (a side
        dataset opened with its own ``part``/``npart``) stays static
        rather than silently joining the tracker's one shard pool; the
        ``?elastic=1`` URI arg always wins. The legacy static
        ``(part, npart)`` contract is the untouched default. Elastic
        composes with the SHARD cache (each leased shard is keyed as its
        own ``(shard, num_shards)`` unit, so a reassigned shard replays
        from binary on any worker sharing the cache dir) but not with
        the legacy single-file ``#<path>`` cache."""
        uri_args = _uri_query_args(uri)
        if elastic is None:
            if uri_args.get("elastic", "") not in ("", "0"):
                elastic = True
            elif part == 0 and npart == 1:
                elastic = env_int("DMLC_ELASTIC_SHARDS", 0) > 0
            else:
                # an explicit static (part, npart) split beats the
                # process-wide env opt-in: a side dataset (validation
                # set, feature file) opened with its own split must not
                # silently join the tracker's ONE shard pool and have
                # part/npart ignored
                elastic = False
        if not elastic:
            parser = Parser.create(uri, part, npart, fmt, nthread=nthread,
                                   index64=index64,
                                   chunks_in_flight=chunks_in_flight,
                                   cache_dir=cache_dir, cache=cache)
            eager = "#" not in uri and not (
                cache_dir and cache != "never")
            return RowBlockIter(parser, eager=eager, on_error=on_error)
        frag = uri.split("#", 1)[1] if "#" in uri else ""
        if frag and not frag.startswith("cachefile="):
            raise DMLCError(
                "elastic mode does not compose with the legacy `#<path>` "
                "row-block cache (it is keyed by a static part index); "
                "use the `#cachefile=<dir>` shard cache, which keys "
                "each leased shard independently")
        num_shards = num_shards or _uri_int(uri_args, "num_shards") or \
            env_int("DMLC_TRACKER_NUM_SHARDS", 0)
        if num_shards <= 0:
            raise DMLCError(
                "elastic mode needs num_shards > 0 (argument, ?num_shards= "
                "URI arg, or DMLC_TRACKER_NUM_SHARDS)")
        shuffle_window = shuffle_window or _uri_int(uri_args,
                                                    "shuffle_window")
        if run_id is None and "run_id" in uri_args:
            run_id = _uri_int(uri_args, "run_id")
        if leases is None:
            from dmlc_core_tpu_torch.tracker.client import current_monitor
            leases = current_monitor()
            if leases is None:
                raise DMLCError(
                    "elastic mode needs a lease source: join a rendezvous "
                    "with heartbeats (RendezvousClient.start) or pass "
                    "leases=LocalLeases(num_shards)")
        return ElasticRowBlockIter(
            _strip_uri_args(uri, _ELASTIC_URI_KEYS), leases, num_shards,
            fmt=fmt, nthread=nthread, index64=index64, epoch=epoch,
            run_id=run_id, shuffle_window=shuffle_window, on_error=on_error,
            cache_dir=cache_dir, cache=cache)

    def _next_block_degradable(self):
        """next_block() honoring on_error: with "skip", a failing pull is
        retried on the next block up to _MAX_CONSECUTIVE_ERRORS times
        before the source counts as exhausted (returns None). Each pull
        feeds the unified telemetry plane: ``rowblock_batch_us`` latency,
        ``rowblock_batches_total``, ``rowblock_skipped_batches_total``
        (doc/observability.md)."""
        consecutive = 0
        batch_us, batches, skips = _get_batch_metrics()
        while True:
            try:
                t0 = time.perf_counter() if telemetry.enabled() else None
                b = self._parser.next_block()
                if t0 is not None:
                    dur_us = (time.perf_counter() - t0) * 1e6
                    batch_us.observe(dur_us)
                    # same measurement, second surface: the span ring
                    # (doc/observability.md "Distributed tracing")
                    telemetry.emit_span(
                        "rowblock.next", t0 * 1e6, dur_us,
                        rows=getattr(b, "num_rows", 0) if b is not None
                        else 0)
                if b is not None:
                    batches.inc()
                return b
            except DMLCError as e:
                if self._on_error != "skip":
                    raise
                self.skipped_batches += 1
                skips.inc()
                self.last_error = str(e)
                consecutive += 1
                log_warning(
                    "row-block pull failed (%d consecutive, %d skipped "
                    "total); on_error=skip: %s",
                    consecutive, self.skipped_batches, e)
                if consecutive >= self._MAX_CONSECUTIVE_ERRORS:
                    return None  # shard is gone; end the epoch cleanly

    def _load_eager(self) -> RowBlockContainer:
        if self._block is None:
            # native block views are only valid until the next next_block()
            # call, so snapshot each into a single-block container, then
            # merge once (O(n) total)
            blocks = []
            t0 = time.time()
            next_log = 10 << 20  # MB/s every 10 MB (basic_row_iter.h:70-73)
            while True:
                b = self._next_block_degradable()
                if b is None:
                    break
                blocks.append(RowBlockContainer.from_blocks([b]))
                nread = self._parser.bytes_read()
                if nread >= next_log:
                    dt = max(time.time() - t0, 1e-9)
                    log_info("%.0f MB read, %.2f MB/sec",
                             nread / 1e6, nread / 1e6 / dt)
                    next_log += 10 << 20
            self._block = RowBlockContainer.from_blocks(blocks)
        return self._block

    def __iter__(self) -> Iterator[RowBlockContainer]:
        if self._eager:
            yield self._load_eager()
            return
        self._parser.before_first()
        while True:
            b = self._next_block_degradable()
            if b is None:
                return
            yield RowBlockContainer.from_blocks([b])

    def before_first(self) -> None:
        """Restart iteration from the first row block (reference
        DataIter::BeforeFirst)."""
        if not self._eager:
            self._parser.before_first()

    @property
    def num_col(self) -> int:
        """reference RowBlockIter::NumCol (data.h:276) — eager mode loads
        on demand."""
        if self._eager:
            return self._load_eager().num_col
        raise DMLCError("num_col requires eager (non-cached) mode")

    def bytes_read(self) -> int:
        """Bytes consumed from the underlying source so far (reference
        Parser::BytesRead)."""
        return self._parser.bytes_read()

    def pipeline_stats(self) -> Optional[dict]:
        """Per-stage occupancy counters of the native parse pipeline
        (NativeParser.pipeline_stats), or None for python-registered
        formats / unpipelined parsers."""
        stats = getattr(self._parser, "pipeline_stats", None)
        return stats() if stats is not None else None

    def io_stats(self) -> dict:
        """Remote-I/O resilience counters (io.native.io_retry_stats —
        process-global retries/timeouts/faults across all native streams)
        plus this iterator's ``skipped_batches`` from on_error="skip"."""
        out = io_retry_stats()
        out["skipped_batches"] = self.skipped_batches
        return out

    def close(self) -> None:
        """Release the native parser handle (idempotent)."""
        close = getattr(self._parser, "close", None)
        if close is not None:
            close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# -- elastic data-plane (doc/robustness.md "Elastic data-plane") --------------
_ELASTIC_URI_KEYS = ("elastic", "num_shards", "shuffle_window", "run_id")


def _uri_query_args(uri: str) -> Dict[str, str]:
    base = uri.split("#", 1)[0]
    args: Dict[str, str] = {}
    if "?" in base:
        for kv in base.split("?", 1)[1].split("&"):
            if kv:
                k, _, v = kv.partition("=")
                args[k] = v
    return args


def _uri_int(args: Dict[str, str], key: str) -> int:
    raw = args.get(key, "")
    if raw == "":
        return 0
    try:
        return int(raw)
    except ValueError:
        raise DMLCError(f"?{key}={raw!r} is not an integer")


def _strip_uri_args(uri: str, keys) -> str:
    """Drop the given query keys from `uri` (the elastic sugar must not
    reach the native parser, which would reject unknown parameters)."""
    base, sep, frag = uri.partition("#")
    path, qmark, q = base.partition("?")
    if not qmark:
        return uri
    kept = [kv for kv in q.split("&")
            if kv and kv.partition("=")[0] not in keys]
    return path + ("?" + "&".join(kept) if kept else "") + sep + frag


class LocalLeases:
    """In-process lease source mirroring the tracker's pool/held/done
    accounting — the single-host / test-harness counterpart of
    ``HeartbeatMonitor.acquire_lease``.

    ``completed`` seeds every epoch's done set: that is how a resumed run
    skips the shards an interrupted run already checked out (shard-
    granular resume — the distributed equivalent is the tracker's own
    done set, which survives worker churn). Thread-safe; concurrent
    local workers (threads) share one instance."""

    def __init__(self, num_shards: int, completed=()):
        if num_shards <= 0:
            raise DMLCError("num_shards must be > 0")
        self.num_shards = num_shards
        self._completed0 = set(completed)
        self._cond = threading.Condition()
        self._epochs: Dict[int, dict] = {}

    def _epoch(self, epoch: int) -> dict:
        ep = self._epochs.get(epoch)
        if ep is None:
            done = set(self._completed0)
            ep = self._epochs[epoch] = {
                "pool": [s for s in range(self.num_shards)
                         if s not in done],
                "held": set(), "done": done}
        return ep

    def acquire_lease(self, epoch: int,
                      timeout: Optional[float] = None) -> Optional[int]:
        """Lowest free shard of `epoch`; None once every shard is done.
        Blocks while the pool is empty but undrained (another worker may
        release), up to `timeout` → TimeoutError."""
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        with self._cond:
            while True:
                ep = self._epoch(epoch)
                if ep["pool"]:
                    shard = ep["pool"].pop(0)
                    ep["held"].add(shard)
                    return shard
                if len(ep["done"]) >= self.num_shards:
                    return None
                left = None if deadline is None \
                    else deadline - time.monotonic()
                if left is not None and left <= 0:
                    raise TimeoutError(
                        "lease pool stayed empty past the deadline "
                        "(a shard is held but never completed/released)")
                self._cond.wait(0.05 if left is None else min(left, 0.05))

    def complete_lease(self, epoch: int, shard: int) -> None:
        """Mark a fully-consumed shard done (exactly-once checkout)."""
        with self._cond:
            ep = self._epoch(epoch)
            ep["held"].discard(shard)
            ep["done"].add(shard)
            self._cond.notify_all()

    def release_lease(self, epoch: int, shard: int) -> None:
        """Return an unfinished shard to the pool."""
        with self._cond:
            ep = self._epoch(epoch)
            if shard in ep["held"]:
                ep["held"].discard(shard)
                ep["pool"].append(shard)
                self._cond.notify_all()


class ElasticRowBlockIter:
    """Elastic mode of RowBlockIter (doc/robustness.md "Elastic
    data-plane"): instead of a static ``(part_index, num_parts)`` fixed at
    open time, iteration consumes tracker-granted SHARD LEASES — the
    dataset is pre-split into ``num_shards`` logical shards (S >> world
    size), each worker pulls the next free shard from the lease source,
    parses it, and checks it out. A dead worker's shards return to the
    pool and are absorbed by the survivors, so the epoch completes without
    a relaunch; a late-joining worker simply starts acquiring.

    Determinism contract: each shard's batch stream depends only on the
    source bytes, ``num_shards``, and the shard id — the windowed shuffle
    is seeded by ``(run_id, epoch, shard_id)``, NEVER by the rank that
    happens to consume it — so the global batch stream (the shard-ordered
    union) is byte-identical for ANY worker set, including sets that
    change mid-epoch. ``leases`` is a ``HeartbeatMonitor`` (distributed)
    or :class:`LocalLeases` (single-host / tests)."""

    def __init__(self, uri: str, leases, num_shards: int, fmt: str = "auto",
                 nthread: int = 0, index64: bool = False, epoch: int = 0,
                 run_id: Optional[int] = None, shuffle_window: int = 0,
                 on_error: str = "raise",
                 acquire_timeout: Optional[float] = None,
                 cache_dir: str = "", cache: str = ""):
        if num_shards <= 0:
            raise DMLCError("elastic mode needs num_shards > 0")
        if on_error not in ("raise", "skip"):
            raise DMLCError(
                f"on_error must be 'raise' or 'skip', got {on_error!r}")
        if run_id is None:
            run_id = env_int("DMLC_RUN_ID", 0)
        if run_id < 0 or epoch < 0:
            raise DMLCError("run_id and epoch must be non-negative "
                            "(they seed the windowed shuffle)")
        self._uri = uri
        self._leases = leases
        self.num_shards = num_shards
        self._fmt = fmt
        self._nthread = nthread
        self._index64 = index64
        self.epoch = epoch
        self.run_id = run_id
        self.shuffle_window = shuffle_window
        self._on_error = on_error
        self._acquire_timeout = acquire_timeout
        # shard-cache knobs: each leased shard parses as its own
        # (shard, num_shards) unit, so the cache keys shards
        # independently — after a lease reassignment the new holder
        # replays the dead worker's shards from binary when the cache
        # dir is shared (or re-transcodes them once when it is not)
        self._cache_dir = cache_dir
        self._cache = cache
        self.consumed: List[int] = []
        self.skipped_shards = 0
        self.last_error: Optional[str] = None
        self._bytes = 0

    def set_epoch(self, epoch: int) -> None:
        """Advance to a new epoch: subsequent acquires lease the new
        epoch's pool and the shuffle reseeds on (run_id, epoch, shard)."""
        if epoch < 0:
            raise DMLCError("epoch must be non-negative")
        self.epoch = epoch
        self.consumed = []

    def _load_shard(self, shard: int) -> RowBlockContainer:
        parser = Parser.create(self._uri, part=shard,
                               npart=self.num_shards, fmt=self._fmt,
                               nthread=self._nthread, index64=self._index64,
                               cache_dir=self._cache_dir, cache=self._cache)
        try:
            blocks = []
            while True:
                b = parser.next_block()
                if b is None:
                    break
                blocks.append(RowBlockContainer.from_blocks([b]))
            self._bytes += parser.bytes_read()
            return RowBlockContainer.from_blocks(blocks)
        finally:
            close = getattr(parser, "close", None)
            if close is not None:
                close()

    def _shard_batches(self, shard: int,
                       block: RowBlockContainer) -> List[RowBlockContainer]:
        """The shard's batch list: the whole shard as one batch, or — with
        ``shuffle_window`` — fixed windows of rows, each permuted by an
        rng seeded by (run_id, epoch, shard_id). Deterministic in the
        shard, never in the consuming rank."""
        if block.size == 0:
            return []
        if self.shuffle_window <= 0:
            return [block]
        w = self.shuffle_window
        rng = np.random.default_rng([self.run_id, self.epoch, shard])
        order = np.arange(block.size)
        for s in range(0, block.size, w):
            rng.shuffle(order[s:s + w])
        return [block.take(order[s:s + w])
                for s in range(0, block.size, w)]

    def shards(self) -> Iterator[tuple]:
        """Generator of ``(shard_id, [batch containers])`` in grant order.
        The lease is checked out (complete) only after the consumer
        advances PAST the shard — a worker dying mid-shard leaves it in
        the pool for another worker, preserving exactly-once coverage."""
        while True:
            shard = self._leases.acquire_lease(self.epoch,
                                               self._acquire_timeout)
            if shard is None:
                return
            try:
                batches = self._shard_batches(shard,
                                              self._load_shard(shard))
            except DMLCError as e:
                if self._on_error != "skip":
                    # hand the shard back: this worker is failing on it,
                    # but another worker (or a retry) may still manage
                    try:
                        self._leases.release_lease(self.epoch, shard)
                    except Exception:
                        pass
                    raise
                self.skipped_shards += 1
                self.last_error = str(e)
                log_warning(
                    "shard %d failed (%d skipped total); on_error=skip: %s",
                    shard, self.skipped_shards, e)
                # consumed-with-errors: completing (not releasing) avoids
                # an infinite regrant loop on a genuinely bad shard
                self._leases.complete_lease(self.epoch, shard)
                continue
            yield shard, batches
            self._leases.complete_lease(self.epoch, shard)
            self.consumed.append(shard)

    def __iter__(self) -> Iterator[RowBlockContainer]:
        for _shard, batches in self.shards():
            for b in batches:
                yield b

    def state(self) -> dict:
        """Shard-granular resume state: feed ``completed`` into
        ``LocalLeases(num_shards, completed=...)`` (single-host) — the
        distributed equivalent is the tracker's own per-epoch done set,
        which survives worker churn."""
        return {"epoch": self.epoch, "num_shards": self.num_shards,
                "run_id": self.run_id, "completed": sorted(self.consumed)}

    def bytes_read(self) -> int:
        """Bytes consumed across every shard leased so far."""
        return self._bytes

    def io_stats(self) -> dict:
        """Remote-I/O resilience counters plus this iterator's
        ``skipped_shards`` (on_error="skip")."""
        out = io_retry_stats()
        out["skipped_shards"] = self.skipped_shards
        return out

    def close(self) -> None:
        """Per-shard parsers are closed as each shard completes; kept for
        RowBlockIter context-manager parity."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
