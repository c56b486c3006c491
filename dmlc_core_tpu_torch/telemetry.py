"""Process-wide counters, gauges, log2 histograms, events and spans.

The part of ``dmlc_core_tpu/telemetry.py`` that the port calls, with the
same metric names and the same histogram buckets (bucket *i* counts
observations ``v <= 2**i``, plus one +Inf overflow bucket), so the two
packages' numbers read alike:

- the registry, the event ring and the span ring (with explicit-parent
  spans for request chains that cross threads, :func:`new_span_id`);
- collectors (:func:`register_collector`) that refresh derived gauges at
  every :func:`snapshot`, which merges this registry with the port's own
  native core's registry when that library is loaded and appends the
  derived gauges ``stall_stage_occupancy{stage=}``,
  ``stall_verdict_code`` (:func:`stall_attribution`) and
  ``device_overlap_ratio`` (:func:`device_overlap_ratio`, -1 before any
  transfer); its renderings :func:`prometheus_text` (byte for byte the
  reference's for the same document), :func:`events_jsonl` and
  :func:`trace_json`;
- the cluster half the tracker serves: :func:`rank_export`, a rank's
  document, and the pure functions over such documents
  :func:`cluster_prometheus_text` (per-rank series plus ``job:`` sums),
  :func:`cluster_trace_json` (one lane a rank) and
  :func:`straggler_attribution`;
- the SLO plane the scoring server runs: :class:`WindowedView`
  (rolling-window rates and quantiles), :class:`SloMonitor` (multi-window
  burn-rate pages) and :func:`slo_page_active`;
- :func:`flight_dump`, the postmortem file under ``DMLC_TRACE_DUMP``, and
  :class:`HostResourceSampler`, the ``/proc`` envelope of a run.

The reference also observes XLA compilations (``device_compile_us``,
through a ``jax.monitoring`` hook). Eager torch compiles nothing, so the
port has no such hook: ``device_compile_us`` is never observed here and
``compile_bound`` is never the port's verdict. The device's own timeline
comes from ``device/device_iter.py::torch_profiler_capture`` instead.
"""

from __future__ import annotations

import json
import math
import os
import re
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "HIST_BUCKETS",
           "SNAPSHOT_VERSION", "SPANS_MAX", "METRIC_HELP", "counter",
           "gauge", "histogram", "register_collector",
           "unregister_collector", "enabled", "enable", "reset",
           "emit_event", "events", "new_span_id", "emit_span", "span",
           "spans", "clock_anchor", "trace_snapshot", "trace_json",
           "snapshot", "prometheus_text", "events_jsonl",
           "quantile_from_buckets", "VERDICT_CODES", "stall_attribution",
           "device_overlap_ratio", "straggler_attribution", "flight_dump",
           "rank_export", "cluster_prometheus_text", "cluster_trace_json",
           "WindowedView", "SloMonitor", "start_windowed_view",
           "stop_windowed_view", "windowed_view", "slo_page_active",
           "HostResourceSampler"]

SNAPSHOT_VERSION = 1
# must match cpp/src/telemetry.h kHistBuckets (le 2^0..2^27, then +Inf)
HIST_BUCKETS = 28
SPANS_MAX = 8192
_EVENTS_MAX = 4096

_lock = threading.Lock()
_counters: Dict[Tuple[str, tuple], "Counter"] = {}
_gauges: Dict[Tuple[str, tuple], "Gauge"] = {}
_hists: Dict[Tuple[str, tuple], "Histogram"] = {}
_collectors: List[Callable[[], None]] = []
_events: List[dict] = []
_spans: List[dict] = []
_spans_dropped = 0
_span_seq = 0
_tids: Dict[int, int] = {}
_enabled: Optional[bool] = None
_tls = threading.local()


def _labels_key(labels: Optional[Dict[str, str]]) -> tuple:
    return tuple(sorted((labels or {}).items()))


class Counter:
    """A monotonically increasing value."""

    __slots__ = ("name", "labels", "_v", "_mu")

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = dict(labels)
        self._v = 0
        self._mu = threading.Lock()

    def inc(self, n: int = 1) -> None:
        """Add ``n`` (default 1)."""
        with self._mu:
            self._v += n

    @property
    def value(self) -> int:
        """Current count."""
        return self._v

    def zero(self) -> None:
        """Reset to 0."""
        with self._mu:
            self._v = 0


class Gauge:
    """A point-in-time value."""

    __slots__ = ("name", "labels", "_v")

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = dict(labels)
        self._v = 0.0

    def set(self, v: float) -> None:
        """Set the current value."""
        self._v = v

    @property
    def value(self) -> float:
        """Current value."""
        return self._v

    def zero(self) -> None:
        """Reset to 0."""
        self._v = 0.0


class Histogram:
    """Fixed-bucket log2 histogram; observe integer microseconds for
    ``*_us`` metrics."""

    __slots__ = ("name", "labels", "count", "sum", "buckets", "exemplars",
                 "_mu")

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = dict(labels)
        self.count = 0
        self.sum = 0
        self.buckets = [0] * (HIST_BUCKETS + 1)
        # bucket index -> trace id of the last sampled observation there
        # (None until the first exemplar, so unsampled histograms pay
        # nothing); exported in the JSON snapshot only
        self.exemplars: Optional[Dict[int, int]] = None
        self._mu = threading.Lock()

    @staticmethod
    def bucket_of(v: int) -> int:
        """Index of the first bucket whose bound ``2**i`` holds ``v``."""
        if v <= 1:
            return 0
        w = int(v - 1).bit_length()
        return w if w < HIST_BUCKETS else HIST_BUCKETS

    def observe(self, v: float, trace_id: Optional[int] = None) -> None:
        """Record one non-negative observation; ``trace_id`` (a span id of
        a sampled request chain) becomes its bucket's exemplar."""
        v = max(v, 0)
        with self._mu:
            self.count += 1
            self.sum += v
            b = self.bucket_of(int(v))
            self.buckets[b] += 1
            if trace_id:
                if self.exemplars is None:
                    self.exemplars = {}
                self.exemplars[b] = trace_id

    def zero(self) -> None:
        """Reset all counts."""
        with self._mu:
            self.count = 0
            self.sum = 0
            self.buckets = [0] * (HIST_BUCKETS + 1)
            self.exemplars = None

    def quantile(self, q: float) -> float:
        """Upper bound ``2**i`` of the bucket holding the ``q``-quantile
        (0.0 when empty, ``inf`` in the overflow bucket)."""
        with self._mu:
            return quantile_from_buckets(self.buckets, self.count, q)

    def summary(self) -> dict:
        """count, sum, mean, p50 and p99 of the recorded observations."""
        return {"count": self.count, "sum": self.sum,
                "mean": self.sum / self.count if self.count else 0.0,
                "p50_le": self.quantile(0.5), "p99_le": self.quantile(0.99)}


def quantile_from_buckets(buckets, count: int, q: float) -> float:
    """The :meth:`Histogram.quantile` estimate over any bucket list."""
    if not 0.0 < q <= 1.0:
        raise ValueError(f"quantile {q} outside (0, 1]")
    if count <= 0:
        return 0.0
    need = max(1, math.ceil(q * count))
    cum = 0
    for i, n in enumerate(buckets):
        cum += n
        if cum >= need:
            return math.inf if i >= HIST_BUCKETS else float(1 << i)
    return math.inf


def _resolve(table: dict, cls, name: str, labels):
    key = (name, _labels_key(labels))
    with _lock:
        m = table.get(key)
        if m is None:
            m = table[key] = cls(name, dict(key[1]))
        return m


def counter(name: str, labels: Optional[Dict[str, str]] = None) -> Counter:
    """Resolve-or-register the counter ``(name, labels)``."""
    return _resolve(_counters, Counter, name, labels)


def gauge(name: str, labels: Optional[Dict[str, str]] = None) -> Gauge:
    """Resolve-or-register the gauge ``(name, labels)``."""
    return _resolve(_gauges, Gauge, name, labels)


def histogram(name: str, labels: Optional[Dict[str, str]] = None
              ) -> Histogram:
    """Resolve-or-register the histogram ``(name, labels)``."""
    return _resolve(_hists, Histogram, name, labels)


def register_collector(fn: Callable[[], None]) -> None:
    """Register a callback that :func:`snapshot` runs before it reads the
    registry, so a component refreshes derived gauges lazily instead of
    on a timer. A collector that raises is skipped: one broken collector
    must not sink a scrape."""
    with _lock:
        if fn not in _collectors:
            _collectors.append(fn)


def unregister_collector(fn: Callable[[], None]) -> None:
    """Remove a collector (no-op when absent), on the component's
    shutdown."""
    with _lock:
        if fn in _collectors:
            _collectors.remove(fn)


def enabled() -> bool:
    """Whether timed spans are on: ``DMLC_TELEMETRY`` at first use
    (default on), overridable with :func:`enable`. Counters always count."""
    global _enabled
    if _enabled is None:
        _enabled = os.environ.get("DMLC_TELEMETRY", "1") not in ("0", "off")
    return _enabled


def enable(on: bool) -> None:
    """Set the span gate for this registry and, when the port's native
    library is loaded, for the native one."""
    global _enabled
    _enabled = bool(on)
    lib = _native_lib_if_loaded()
    if lib is not None:
        lib.dct_telemetry_enable(1 if on else 0)


def reset(native: bool = True) -> None:
    """Zero every metric, drop buffered events and spans, and stop the
    process :class:`WindowedView` (a ticker leaked by one test must not
    publish into the next); with ``native`` also zero the native registry
    when its library is loaded."""
    global _spans_dropped
    stop_windowed_view(force=True)
    with _lock:
        for table in (_counters, _gauges, _hists):
            for m in table.values():
                m.zero()
        del _events[:]
        del _spans[:]
        _spans_dropped = 0
    if native:
        lib = _native_lib_if_loaded()
        if lib is not None:
            lib.dct_telemetry_reset()


def emit_event(event: str, **fields) -> None:
    """Append one ``{"ts", "event", **fields}`` record to the event ring
    and bump ``telemetry_events_total{event=...}``."""
    rec = {"ts": fields.pop("ts", None) or time.time(), "event": event}
    rec.update(fields)
    with _lock:
        _events.append(rec)
        if len(_events) > _EVENTS_MAX:
            del _events[: len(_events) - _EVENTS_MAX]
    counter("telemetry_events_total", {"event": event}).inc()


def events() -> List[dict]:
    """A copy of the buffered event stream."""
    with _lock:
        return list(_events)


# -- spans -------------------------------------------------------------------
def _thread_lane() -> int:
    """Small stable lane id for the calling thread (Chrome-trace tid)."""
    ident = threading.get_ident()
    with _lock:
        lane = _tids.get(ident)
        if lane is None:
            lane = _tids[ident] = len(_tids) + 1
        return lane


def _perf_us() -> float:
    return time.perf_counter() * 1e6


def clock_anchor() -> Dict[str, float]:
    """One (wall, monotonic) clock pair sampled back to back:
    ``wall_us`` (``time.time()``) and ``perf_us`` (``time.perf_counter()``),
    both in microseconds."""
    return {"wall_us": time.time() * 1e6, "perf_us": _perf_us()}


def _append_span(name: str, span_id: int, parent: int, start_us: float,
                 dur_us: float, args: Optional[dict]) -> None:
    global _spans_dropped
    lane = _thread_lane()
    rec = {"name": name, "id": span_id, "parent": parent, "tid": lane,
           "ts": int(start_us), "dur": int(dur_us)}
    if args:
        rec["args"] = args
    with _lock:
        _spans.append(rec)
        if len(_spans) > SPANS_MAX:
            drop = len(_spans) - SPANS_MAX
            del _spans[:drop]
            _spans_dropped += drop


def new_span_id() -> int:
    """Allocate one span id without emitting a span: the handle a sampled
    request carries across threads, so its child spans can name an
    explicit ``parent=`` and its root be emitted later under
    ``span_id=``."""
    global _span_seq
    with _lock:
        _span_seq += 1
        return _span_seq


def emit_span(name: str, start_us: float, dur_us: float,
              parent: Optional[int] = None, span_id: Optional[int] = None,
              **args) -> None:
    """Append one completed span (``time.perf_counter()`` microseconds).
    It is parented under the thread's open :func:`span` unless ``parent=``
    is given (0 for an explicit root); ``span_id=`` reuses an id from
    :func:`new_span_id`. No-op when disabled."""
    if not enabled():
        return
    if span_id is None:
        span_id = new_span_id()
    if parent is None:
        parent = getattr(_tls, "open_span", 0)
    _append_span(name, span_id, parent, start_us, dur_us, args or None)


class _Span:
    """Context manager behind :func:`span`."""

    __slots__ = ("name", "args", "_start", "_id", "_parent", "_active")

    def __init__(self, name: str, args: Optional[dict]):
        self.name = name
        self.args = args

    def set_arg(self, key: str, value) -> None:
        """Attach one key/value to the span's args."""
        if self.args is None:
            self.args = {}
        self.args[key] = value

    def __enter__(self) -> "_Span":
        self._active = enabled()
        if self._active:
            self._id = new_span_id()
            self._parent = getattr(_tls, "open_span", 0)
            _tls.open_span = self._id
            self._start = _perf_us()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._active:
            _tls.open_span = self._parent
            _append_span(self.name, self._id, self._parent, self._start,
                         _perf_us() - self._start, self.args)


def span(name: str, **args) -> _Span:
    """Context manager recording one span at scope exit."""
    return _Span(name, args or None)


def spans() -> List[dict]:
    """A copy of the buffered span ring."""
    with _lock:
        return list(_spans)


# -- the port's native core --------------------------------------------------
def _native_lib_if_loaded():
    """The port's loaded native library, or None; never builds it."""
    from dmlc_core_tpu_torch.io import native
    return native._lib


def _native_doc(fn_name: str) -> Optional[dict]:
    lib = _native_lib_if_loaded()
    if lib is None:
        return None
    from dmlc_core_tpu_torch.io import native
    return getattr(native, fn_name)()


def trace_snapshot() -> dict:
    """``{"version", "pid", "anchor", "spans", "dropped", "native"}``:
    this registry's spans (perf-counter clock) and the native ring's
    document (steady clock) when the library is loaded, each with its own
    clock anchor."""
    return {"version": 1, "pid": os.getpid(), "anchor": clock_anchor(),
            "spans": spans(), "dropped": _spans_dropped,
            "native": _native_doc("native_trace_snapshot")}


def _wall_spans(snap: dict) -> List[dict]:
    """Both halves' spans on one wall-clock microsecond timeline, each
    shifted by its own (wall, monotonic) anchor pair."""
    out = []
    a = snap.get("anchor") or {}
    shift = float(a.get("wall_us", 0)) - float(a.get("perf_us", 0))
    for s in snap.get("spans", ()):
        rec = dict(s)
        rec["ts"] = int(s["ts"] + shift)
        rec["cat"] = "python"
        out.append(rec)
    nat = snap.get("native")
    if nat:
        na = nat.get("anchor") or {}
        nshift = float(na.get("wall_us", 0)) - float(na.get("steady_us", 0))
        for s in nat.get("spans", ()):
            rec = {"name": s["name"], "id": s["id"], "parent": s["parent"],
                   # native lanes get their own tid namespace
                   "tid": 1000 + int(s["tid"]),
                   "ts": int(s["ts"] + nshift), "dur": int(s["dur"]),
                   "cat": "native"}
            if s.get("arg"):
                rec["args"] = {"arg": s["arg"]}
            out.append(rec)
    out.sort(key=lambda r: r["ts"])
    return out


def _chrome_events(wall_spans: List[dict], pid, label: str) -> List[dict]:
    """Chrome-trace events of one process lane: the ``process_name``
    record, then one complete ("X") event a span."""
    evs = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": label}}]
    for s in wall_spans:
        evs.append({"ph": "X", "name": s["name"], "pid": pid,
                    "tid": s["tid"], "ts": s["ts"],
                    "dur": max(int(s["dur"]), 0),
                    "cat": s.get("cat", "python"),
                    "args": dict(s.get("args") or {}, span_id=s["id"],
                                 parent=s["parent"])})
    return evs


def trace_json(snap: Optional[dict] = None) -> str:
    """The process trace (default: :func:`trace_snapshot` now) as
    Chrome-trace JSON, loadable in Perfetto."""
    if snap is None:
        snap = trace_snapshot()
    pid = snap.get("pid", 0)
    evs = _chrome_events(_wall_spans(snap), pid, f"pid {pid}")
    return json.dumps({"traceEvents": evs, "displayTimeUnit": "ms"})


# -- stall attribution -------------------------------------------------------
# verdict -> stall_verdict_code gauge value
VERDICT_CODES = {"unknown": -1, "fill_bound": 0, "parse_bound": 1,
                 "consumer_bound": 2, "transfer_bound": 3,
                 "stage_bound": 4, "compile_bound": 5,
                 "straggler_bound": 6}

# the consumer binds when it waited on the head-of-line chunk for less
# than this fraction of the pipeline's busy time
_STARVED_WAIT_FRACTION = 0.05


def stall_attribution(snap: Optional[dict] = None) -> dict:
    """Per-stage occupancy and a verdict naming the stage that binds the
    batch path, from the unlabeled stage histograms of one snapshot
    (default: take one now). Device lane first: compilation
    (``device_compile_us``, never observed by the port) dominating every
    other stage is ``compile_bound``; the net host batch assembly
    (``device_stage_us`` less the fill, parse and pipeline wait nested in
    it) dominating is ``stage_bound``; ``device_transfer_us`` above both
    fill and parse is ``transfer_bound``. Host side, a pipeline wait under
    5 % of fill + parse means the pipeline kept up (``consumer_bound``);
    else the larger of fill (source read and shard-cache replay) and parse
    (scan and decode) names it. Nothing observed is ``unknown``. Returns
    ``{"verdict", "stage_us", "occupancy"}``, the reference's result."""
    if snap is None:
        snap = snapshot()
    sums: Dict[str, float] = {}
    for h in snap.get("histograms", ()):
        if not h.get("labels"):
            sums[h["name"]] = sums.get(h["name"], 0.0) + float(h["sum"])
    fill = sums.get("parse_stage_fill_us", 0.0) + \
        sums.get("cache_read_us", 0.0)
    parse = sums.get("parse_stage_parse_us", 0.0) + \
        sums.get("parse_stage_scan_us", 0.0)
    wait = sums.get("parse_stage_reassemble_wait_us", 0.0)
    transfer = sums.get("device_transfer_us", 0.0)
    stage = max(sums.get("device_stage_us", 0.0) - fill - parse - wait,
                0.0)
    compile_t = sums.get("device_compile_us", 0.0)
    dev_wait = sums.get("device_wait_us", 0.0)
    busy = fill + parse
    stage_us = {"fill": fill, "parse": parse, "pipeline_wait": wait,
                "transfer": transfer, "stage": stage,
                "compile": compile_t, "device_wait": dev_wait}
    total = busy + transfer + stage + compile_t
    occupancy = {k: (stage_us[k] / total if total > 0 else 0.0)
                 for k in ("fill", "parse", "transfer", "stage",
                           "compile")}
    occupancy["pipeline_wait"] = wait / total if total > 0 else 0.0
    if total <= 0:
        verdict = "unknown"
    elif compile_t > max(transfer, stage, fill, parse):
        verdict = "compile_bound"
    elif stage > max(transfer, fill, parse):
        verdict = "stage_bound"
    elif transfer > max(fill, parse):
        verdict = "transfer_bound"
    elif wait <= _STARVED_WAIT_FRACTION * busy:
        verdict = "consumer_bound"
    elif fill > parse:
        verdict = "fill_bound"
    else:
        verdict = "parse_bound"
    return {"verdict": verdict, "stage_us": stage_us,
            "occupancy": occupancy}


def device_overlap_ratio(span_list: Optional[List[dict]] = None
                         ) -> Optional[float]:
    """Fraction of host->device transfer time hidden behind the consumer's
    compute, from the span ring (default: read it now): each
    ``device.put`` interval less its overlap with the merged
    ``device.wait`` intervals (time the consumer waited through is
    exposed). All spans share the ``perf_counter`` clock. A value in
    [0, 1], or None when the ring holds no ``device.put`` span."""
    if span_list is None:
        span_list = spans()
    xfer = [(s["ts"], s["ts"] + s["dur"]) for s in span_list
            if s["name"] == "device.put"]
    if not xfer:
        return None
    waits = sorted((s["ts"], s["ts"] + s["dur"]) for s in span_list
                   if s["name"] == "device.wait")
    merged: List[List[float]] = []
    for a, b in waits:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    total = exposed = 0.0
    for a, b in xfer:
        total += b - a
        for wa, wb in merged:
            if wa >= b:
                break
            lo, hi = max(a, wa), min(b, wb)
            if hi > lo:
                exposed += hi - lo
    if total <= 0:
        return None
    return min(max((total - exposed) / total, 0.0), 1.0)


def straggler_attribution(step_durs_by_rank: Dict[int, List[float]],
                          factor: float = 2.0,
                          min_steps: int = 3) -> dict:
    """Name the straggler from per-rank step durations: a rank is
    ``straggler_bound`` when its median step exceeds ``factor`` times the
    median of the other ranks' medians. Ranks with fewer than
    ``min_steps`` durations abstain; fewer than two voting ranks is
    ``unknown``. Returns ``{"verdict", "rank", "ratio", "median_us"}``
    (``rank`` None and ``ratio`` 0.0 when no rank is bound)."""
    medians: Dict[int, float] = {}
    for rank, durs in step_durs_by_rank.items():
        if len(durs) >= max(1, int(min_steps)):
            s = sorted(durs)
            medians[rank] = float(s[len(s) // 2])
    out = {"verdict": "unknown", "rank": None, "ratio": 0.0,
           "median_us": medians}
    if len(medians) < 2:
        return out
    worst_rank, worst_ratio = None, 0.0
    for rank, med in medians.items():
        peers = sorted(m for r, m in medians.items() if r != rank)
        peer_med = peers[len(peers) // 2]
        if peer_med <= 0:
            continue
        ratio = med / peer_med
        if ratio > worst_ratio:
            worst_rank, worst_ratio = rank, ratio
    if worst_rank is not None and worst_ratio > factor:
        out["verdict"] = "straggler_bound"
        out["rank"] = worst_rank
        out["ratio"] = worst_ratio
    return out


# -- cluster aggregation -----------------------------------------------------
def rank_export(max_spans: int = 2048) -> dict:
    """The document a rank ships to its tracker: the merged metric
    snapshot and the most recent ``max_spans`` spans on the wall clock
    (each half shifted by its own anchor pair, so ranks merge without
    knowing each other's monotonic clocks)."""
    snap = snapshot()
    wall = _wall_spans(trace_snapshot())
    if len(wall) > max_spans:
        wall = wall[-max_spans:]
    return {"pid": os.getpid(), "anchor": snap["anchor"],
            "metrics": {"counters": snap["counters"],
                        "gauges": snap["gauges"],
                        "histograms": snap["histograms"]},
            "spans": wall}


def _aggregate_ranks(per_rank: Dict[int, dict]) -> dict:
    """Job sums over rank documents: counters by (name, labels),
    histograms by (name, labels) bucket by bucket."""
    counters: Dict[tuple, float] = {}
    hists: Dict[tuple, dict] = {}
    for doc in per_rank.values():
        m = doc.get("metrics", {})
        for c in m.get("counters", ()):
            key = (c["name"], _labels_key(c.get("labels")))
            counters[key] = counters.get(key, 0) + c["value"]
        for h in m.get("histograms", ()):
            key = (h["name"], _labels_key(h.get("labels")))
            agg = hists.get(key)
            if agg is None:
                hists[key] = {"count": h["count"], "sum": h["sum"],
                              "buckets": list(h["buckets"])}
            else:
                agg["count"] += h["count"]
                agg["sum"] += h["sum"]
                agg["buckets"] = [a + b for a, b in
                                  zip(agg["buckets"], h["buckets"])]
    return {"counters": counters, "histograms": hists}


def cluster_prometheus_text(per_rank: Dict[int, dict],
                            local_snap: Optional[dict] = None) -> str:
    """The job-wide exposition: this process's snapshot (default: take one
    now) as it is, every rank's series with a ``rank="<r>"`` label, and
    ``job:<name>`` sums over the ranks (counters by value, histograms
    bucket by bucket), one ``# HELP`` / ``# TYPE`` pair a family."""
    if local_snap is None:
        local_snap = snapshot()
    fams: Dict[str, dict] = {}
    _collect_doc(fams, local_snap)
    for rank in sorted(per_rank):
        _collect_doc(fams, per_rank[rank].get("metrics", {}),
                     extra=f'rank="{rank}"')
    agg = _aggregate_ranks(per_rank)
    for (name, labels), value in sorted(agg["counters"].items()):
        f = fams.setdefault("job:" + name, {
            "kind": "counter",
            "help": f"job-wide sum of {name} across ranks", "lines": []})
        f["lines"].append(f"job:{name}{_fmt_labels(dict(labels))} "
                          f"{_fmt_value(value)}")
    for (name, labels), h in sorted(agg["histograms"].items()):
        f = fams.setdefault("job:" + name, {
            "kind": "histogram",
            "help": f"job-wide bucket-wise sum of {name} across ranks",
            "lines": []})
        _render_hist_series(f["lines"], "job:" + name, dict(labels), h)
    return _emit_families(fams)


def cluster_trace_json(per_rank: Dict[int, dict],
                       local_trace: Optional[dict] = None,
                       meta: Optional[dict] = None) -> str:
    """The merged job timeline: one Chrome-trace lane a rank (``pid`` is
    the rank) from each rank's wall-clock spans, this process's lane
    (``pid`` 999999, default: :func:`trace_snapshot` now), and ``meta``
    (a straggler verdict, say) as one metadata event on that lane."""
    evs: List[dict] = []
    for rank in sorted(per_rank):
        doc = per_rank[rank]
        evs += _chrome_events(doc.get("spans", ()), rank,
                              f"rank {rank} (pid {doc.get('pid', '?')})")
    if local_trace is None:
        local_trace = trace_snapshot()
    evs += _chrome_events(_wall_spans(local_trace), 999999,
                          f"tracker (pid {local_trace.get('pid', '?')})")
    if meta:
        evs.append({"ph": "M", "name": "job_meta", "pid": 999999,
                    "tid": 0, "args": dict(meta)})
    return json.dumps({"traceEvents": evs, "displayTimeUnit": "ms"})


# -- snapshot and Prometheus text --------------------------------------------
def snapshot(native: Optional[bool] = None) -> dict:
    """The merged telemetry document every surface serves.

    ``native``: None merges the native registry only when the port's
    library is already loaded (never builds it); True loads or builds it;
    False leaves it out. Schema (the reference's version 1): ``{"version",
    "enabled", "anchor", "native", "native_anchor", "counters": [{"name",
    "labels", "value"}], "gauges": [...], "histograms": [{"name",
    "labels", "count", "sum", "buckets", ["exemplars"]}], "events"}``.
    The registered collectors run first; the gauge list ends with the
    derived ``stall_stage_occupancy{stage=}``, ``stall_verdict_code`` and
    ``device_overlap_ratio`` (-1 before any transfer), computed from the
    document itself and the span ring."""
    with _lock:
        collectors = list(_collectors)
    for fn in collectors:
        try:
            fn()
        except Exception:
            pass  # a broken collector must not sink the scrape
    doc = {"version": SNAPSHOT_VERSION, "enabled": enabled(),
           "anchor": clock_anchor(), "native": False,
           "native_anchor": None, "counters": [], "gauges": [],
           "histograms": [], "events": []}
    if native is not False:
        if native:
            from dmlc_core_tpu_torch.io import native as native_mod
            native_mod.lib()
        nat = _native_doc("native_telemetry_snapshot")
        if nat is not None:
            doc["native"] = True
            doc["native_anchor"] = nat.get("anchor")
            doc["counters"] += nat.get("counters", [])
            doc["gauges"] += nat.get("gauges", [])
            doc["histograms"] += nat.get("histograms", [])
    with _lock:
        for c in _counters.values():
            doc["counters"].append({"name": c.name, "labels": c.labels,
                                    "value": c.value})
        for g in _gauges.values():
            doc["gauges"].append({"name": g.name, "labels": g.labels,
                                  "value": g.value})
        for h in _hists.values():
            rec = {"name": h.name, "labels": h.labels, "count": h.count,
                   "sum": h.sum, "buckets": list(h.buckets)}
            if h.exemplars:
                rec["exemplars"] = dict(h.exemplars)
            doc["histograms"].append(rec)
        doc["events"] = list(_events)
        # labeled so it never collides with the native half's sample
        doc["counters"].append({"name": "spans_dropped_total",
                                "labels": {"half": "python"},
                                "value": _spans_dropped})
    # derived from the document, not by a collector (which would recurse)
    att = stall_attribution(doc)
    for stage, frac in att["occupancy"].items():
        doc["gauges"].append({"name": "stall_stage_occupancy",
                              "labels": {"stage": stage}, "value": frac})
    doc["gauges"].append({"name": "stall_verdict_code", "labels": {},
                          "value": VERDICT_CODES[att["verdict"]]})
    # -1 keeps 0 meaningful: a lane whose transfers were all exposed
    ratio = device_overlap_ratio()
    doc["gauges"].append({"name": "device_overlap_ratio", "labels": {},
                          "value": -1.0 if ratio is None else ratio})
    return doc


# One-line HELP text per metric name the port or its native core emits:
# the reference's catalog (doc/observability.md) less the rows the port has
# no counterpart for (qa/contracts.py NO_COUNTERPART, each with its
# reason), word for word except serve_forward_us (the port's forward is
# eager, not jitted). `python -m dmlc_core_tpu_torch.qa.analyze` holds
# this table to both.
METRIC_HELP: Dict[str, str] = {
    "io_requests_total": "HTTP requests sent",
    "io_retries_total": "backoff sleeps taken",
    "io_backoff_ms_total": "total milliseconds slept in backoff",
    "io_timeouts_total": "per-attempt socket timeout expiries",
    "io_faults_injected_total": "DMLC_IO_FAULT_PLAN firings",
    "io_giveups_total": "retry loops that exhausted their budget",
    "io_deadline_exhausted_total": "giveups caused by the per-op deadline",
    "io_connect_us": "TCP connect latency per request (us)",
    "io_ttfb_us": "request-sent to first response byte (us)",
    "io_recv_us": "one response-body pull (us)",
    "io_range_issued_total": "range fetches issued",
    "io_range_retried_total": "per-range retry attempts",
    "io_range_degraded_200_total":
        "streams degraded to the sequential lane (origin ignored Range)",
    "io_range_bytes": "completed range sizes (bytes)",
    "io_range_wait_us": "consumer head-of-line wait (us)",
    "io_range_sched_bytes": "scheduler's current range size",
    "io_range_sched_concurrency": "scheduler's current worker credit",
    "parse_chunks_read_total": "chunks admitted by reader stages",
    "parse_blocks_delivered_total": "row blocks handed to consumers",
    "parse_reader_waits_total": "reader blocked on the in-flight bound",
    "parse_worker_waits_total": "worker slept with no claimable slice",
    "parse_consumer_waits_total":
        "consumer slept on the head-of-line chunk",
    "parse_stage_fill_us": "one ReadChunk, source to owned bytes (us)",
    "parse_stage_scan_us": "one TileCuts slice pre-tiling (us)",
    "parse_stage_parse_us": "one worker slice decode (us)",
    "parse_stage_reassemble_wait_us":
        "one consumer head-of-line wait (us)",
    "cache_hits_total": "epochs served from a validated binary shard",
    "cache_misses_total": "epochs served from the text lane",
    "cache_transcodes_total": "completed atomically-published transcodes",
    "cache_write_errors_total":
        "transcode passes lost to local-I/O failure (quarantined)",
    "cache_read_us": "one replay block hand-out (us)",
    "cache_write_us": "one transcoded block append (us)",
    "fs_fault_injected_total": "DMLC_FS_FAULT_PLAN firings per op",
    "ckpt_save_failures_total": "checkpoint saves that raised",
    "event_log_dropped_total":
        "tracker event-log lines dropped by a contained I/O failure",
    "rowblock_batch_us": "one RowBlockIter native block pull (us)",
    "rowblock_batches_total": "row blocks served",
    "rowblock_skipped_batches_total": "on_error=skip skips",
    "device_transfer_us": "one device_put, submit to arrays ready (us)",
    "device_put_submit_us": "the device_put dispatch alone (us)",
    "device_put_block_us": "dispatch-to-ready DMA wait (us)",
    "device_batches_total": "batches dispatched to the device",
    "device_transfer_bytes_total": "host bytes handed to device_put",
    "device_stage_us":
        "one host batch assembly (parse+pad+bucket+pack) on the staging "
        "thread (us)",
    "device_wait_us":
        "consumer head-of-line wait for the next device batch (us)",
    "device_put_failures_total": "device_put calls that raised",
    "device_host_q_depth": "staged host batches queued for transfer",
    "device_ready_q_depth": "device batches queued for the consumer",
    "device_zero_copy_batches_total":
        "batches transferred by the zero-copy device_put path (staging "
        "buffers aliased/DMA'd in place, no host copy)",
    "device_recycle_skipped":
        "aliased host staging buffers dropped from the deferred-recycle "
        "parking lot because the consumer held more batches than its "
        "depth (zero-copy backends)",
    "device_overlap_ratio":
        "fraction of transfer time hidden behind consumer compute "
        "(-1 before any transfer)",
    "telemetry_events_total": "events per kind",
    # the job tracker, its shard leases and the elastic world
    "tracker_num_workers": "workers the tracker expects",
    "tracker_alive": "1 while the tracker thread is serving",
    "tracker_finished": "1 once every worker checked out",
    "tracker_aborted": "1 after the job was aborted",
    "tracker_rank_phase_code":
        "0 assigned, 1 alive, 2 dead, 3 shutdown, 4 lost",
    "tracker_rank_heartbeat_age_seconds":
        "seconds since the rank's last beat (-1 before the first)",
    "tracker_rank_restarts": "recover count per rank",
    "tracker_rank_attempts": "assignment handshakes served per rank",
    "tracker_lease_pool": "shards free for acquisition",
    "tracker_lease_held": "shards currently leased to a rank",
    "tracker_lease_done": "shards checked out exactly once",
    "tracker_lease_reassigned": "leases reclaimed this epoch",
    "tracker_lease_reassigned_total": "reclaim events across the job",
    "lease_renew_us": "tracker-side implicit lease renewal on a ping (us)",
    "lease_acquire_us": "worker-side acquire round trip (us)",
    "tracker_world_relaunches_total":
        "whole-world relaunches after a mesh abort (run_job mesh mode)",
    "mesh_step_aborts_total":
        "structured step aborts on this rank (between-steps raise or "
        "step-deadline watchdog)",
    "device_abort_drains_total":
        "device-pipeline abort drains (staging/transfer stopped, parked "
        "buffers dropped)",
    "tracker_straggler_rank":
        "rank bound as the mesh straggler (-1 when none)",
    "stall_stage_occupancy":
        "fraction of instrumented batch-path time in the stage",
    "stall_verdict_code":
        "-1 unknown, 0 fill, 1 parse, 2 consumer, 3 transfer, 4 stage, "
        "5 compile, 6 straggler bound",
    "spans_dropped_total":
        "span-ring records overwritten by wrap, per half",
    "window_rate":
        "per-second counter rate over the rolling window, summed across "
        "label sets",
    "window_quantile":
        "delta-histogram quantile over the rolling window (overflow "
        "clamped to the top bucket bound)",
    "slo_burn_rate":
        "error-budget burn multiple per objective and window",
    "slo_page": "1 while any SLO objective is paging (latched)",
    "slo_page_trips_total": "SLO page activations per objective",
    # measurement rig (bench/loadrig.py, the port of scripts/loadrig.py)
    "rig_requests_total": "open/closed-loop requests completed",
    "rig_errors_total": "load-generator requests that failed",
    "rig_shed_total":
        "open-loop arrivals shed past the lateness budget",
    "rig_intended_us":
        "request latency from the INTENDED start time (us; "
        "coordinated-omission-safe)",
    "rig_service_us":
        "request latency from the actual send time (us; hides queueing "
        "behind a stalled origin — kept for the divergence itself)",
    "host_cpu_busy_frac": "whole-host CPU busy fraction, last interval",
    "host_rss_bytes": "sampling process RSS, last sample",
    "serve_requests_total": "HTTP requests parsed by the front end",
    "serve_admitted_total": "score requests admitted to the queue",
    "serve_scored_total": "score requests answered 200 with scores",
    "serve_shed_total":
        "requests shed by reason: queue_full, late (intended-time "
        "lateness budget), draining, breaker, slo_burn",
    "serve_rejects_total":
        "error responses by HTTP status code (sheds are additionally "
        "counted by reason in serve_shed_total)",
    "serve_errors_total": "5xx server-side failures (forward/internal)",
    "serve_queue_depth": "admission queue occupancy (bounded)",
    "serve_inflight": "admitted requests awaiting their response",
    "serve_batches_total": "micro-batches run through the forward",
    "serve_batch_rows": "real (pre-padding) rows per micro-batch",
    "serve_batch_fill":
        "percent of the padded rows bucket holding real rows",
    "serve_parse_us": "micro-batch native parse time (us)",
    "serve_forward_us": "padded-batch forward time, host to scores on the host (us)",
    "serve_request_us":
        "admit-to-reply latency on the INTENDED-time clock (us; queue "
        "wait included, coordinated-omission-safe)",
    "serve_model_reloads_total": "model reloads that swapped params in",
    "serve_model_reload_failures_total":
        "failed reloads (last-good model kept serving)",
    "serve_breaker_state": "0 closed, 1 open, 2 half-open",
    "serve_draining": "1 while draining shutdown runs",
    "serve_distinct_shapes":
        "distinct padded (kind, rows, nnz) forward shapes this process",
    "serve_access_log_dropped_total":
        "access-log lines dropped by a contained I/O failure",
}


def _escape_label(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
                 .replace("\n", "\\n")


def _fmt_labels(labels: Dict[str, str], extra: str = "") -> str:
    parts = [f'{k}="{_escape_label(v)}"' for k, v in sorted(labels.items())]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt_value(v) -> str:
    if isinstance(v, float) and not v.is_integer():
        return repr(v)
    return str(int(v))


def _escape_help(text: str) -> str:
    """HELP-line escaping: backslash and newline."""
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _render_hist_series(lines: List[str], name: str, labels: Dict[str, str],
                        h: dict) -> None:
    """One histogram's cumulative ``_bucket{le=}``, ``_sum`` and
    ``_count`` lines."""
    cum = 0
    for i, n in enumerate(h["buckets"]):
        cum += n
        le = "+Inf" if i == len(h["buckets"]) - 1 else str(1 << i)
        le_label = 'le="' + le + '"'
        lines.append(f"{name}_bucket{_fmt_labels(labels, le_label)} {cum}")
    lines.append(f"{name}_sum{_fmt_labels(labels)} "
                 f"{_fmt_value(h['sum'])}")
    lines.append(f"{name}_count{_fmt_labels(labels)} "
                 f"{_fmt_value(h['count'])}")


def _family(fams: Dict[str, dict], name: str, kind: str) -> List[str]:
    """The sample lines of one family (first-seen order and kind)."""
    f = fams.get(name)
    if f is None:
        f = fams[name] = {"kind": kind, "lines": []}
    return f["lines"]


def _collect_doc(fams: Dict[str, dict], doc: dict, extra: str = "") -> None:
    """One document's counters, gauges and histograms by family, with an
    optional extra label (``rank="0"``) on every sample."""
    for c in doc.get("counters", ()):
        _family(fams, c["name"], "counter").append(
            f"{c['name']}{_fmt_labels(c['labels'], extra)} "
            f"{_fmt_value(c['value'])}")
    for g in doc.get("gauges", ()):
        _family(fams, g["name"], "gauge").append(
            f"{g['name']}{_fmt_labels(g['labels'], extra)} "
            f"{_fmt_value(g['value'])}")
    for h in doc.get("histograms", ()):
        labels = dict(h["labels"])
        if extra:
            k, v = extra.split("=", 1)
            labels[k] = v.strip('"')
        _render_hist_series(_family(fams, h["name"], "histogram"),
                            h["name"], labels, h)


def _emit_families(fams: Dict[str, dict]) -> str:
    """Families as exposition text: each family's lines together behind
    one ``# HELP`` (from :data:`METRIC_HELP`) and ``# TYPE`` pair."""
    lines: List[str] = []
    for name, f in fams.items():
        help_text = f.get("help") or METRIC_HELP.get(name)
        if help_text:
            lines.append(f"# HELP {name} {_escape_help(help_text)}")
        lines.append(f"# TYPE {name} {f['kind']}")
        lines += f["lines"]
    return "\n".join(lines) + "\n"


def prometheus_text(snap: Optional[dict] = None) -> str:
    """A snapshot (default: take one now) in the Prometheus text format
    0.0.4: each family's samples together behind one ``# HELP`` and
    ``# TYPE`` pair, histograms as cumulative ``_bucket{le=...}`` series
    ending in ``le="+Inf"`` plus ``_sum`` and ``_count``."""
    if snap is None:
        snap = snapshot()
    fams: Dict[str, dict] = {}
    _collect_doc(fams, snap)
    return _emit_families(fams)


def events_jsonl(snap: Optional[dict] = None) -> str:
    """A snapshot's event stream (default: take one now) as JSONL, one
    ``{"ts", "event", ...}`` object a line."""
    if snap is None:
        snap = snapshot()
    return "".join(json.dumps(rec) + "\n" for rec in snap.get("events", []))


# -- flight recorder ---------------------------------------------------------
_flight_seq = 0


def flight_dump(reason: str, rank: Optional[int] = None) -> Optional[str]:
    """Record a postmortem: a ``flight-dump`` event, and, when
    ``DMLC_TRACE_DUMP`` names a directory, the span rings, the event ring
    and a full snapshot written to ``flight_<pid>_<n>.json`` there, with
    ``rank`` (the world rank, or None). Returns the file's path, else
    None. A failure to write is swallowed: a postmortem must never mask
    the failure it records. The file appears whole or not at all."""
    emit_event("flight-dump", reason=reason)
    out_dir = os.environ.get("DMLC_TRACE_DUMP")
    if not out_dir:
        return None
    global _flight_seq
    try:
        with _lock:
            _flight_seq += 1
            seq = _flight_seq
        doc = {"reason": reason, "rank": rank, "pid": os.getpid(),
               "wall_ts": time.time(),
               "anchor": clock_anchor(), "trace": trace_snapshot(),
               "metrics": snapshot()}
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"flight_{os.getpid()}_{seq}.json")
        # written aside and renamed: a dying process (another thread's
        # os._exit, a SIGKILL) leaves at most a .tmp file, never a
        # truncated dump under the name readers look for
        with open(path + ".tmp", "w") as f:
            json.dump(doc, f)
            f.write("\n")
        os.replace(path + ".tmp", path)
        return path
    except Exception:
        return None


# -- rolling windows and the SLO plane ---------------------------------------
# Every registry series is cumulative over the process's life; "is it bad
# NOW" needs rates and quantiles over the last minutes. WindowedView
# snapshots the merged registry on a cadence and publishes per-window
# gauges; SloMonitor turns those windows into burn rates against declared
# objectives and latches a page with hysteresis.

# cardinality ceiling on the per-(name, labels) state one tick keeps
_MAX_SERIES = 4096


def _compact_snapshot(snap: dict) -> Tuple[Dict[tuple, float],
                                           Dict[tuple, tuple]]:
    """Per-(name, labels) counter values and histogram (count, sum,
    buckets) of one snapshot; gauges carry no delta meaning and drop."""
    counters: Dict[tuple, float] = {}
    hists: Dict[tuple, tuple] = {}
    for c in snap.get("counters", ()):
        if len(counters) >= _MAX_SERIES:
            break
        key = (c["name"], _labels_key(c.get("labels")))
        counters[key] = counters.get(key, 0.0) + float(c["value"])
    for h in snap.get("histograms", ()):
        if len(hists) >= _MAX_SERIES:
            break
        key = (h["name"], _labels_key(h.get("labels")))
        prev = hists.get(key)
        if prev is None:
            hists[key] = (int(h["count"]), float(h["sum"]),
                          tuple(h["buckets"]))
        else:
            hists[key] = (prev[0] + int(h["count"]),
                          prev[1] + float(h["sum"]),
                          tuple(a + b for a, b in
                                zip(prev[2], h["buckets"])))
    return counters, hists


class SloMonitor:
    """Multi-window burn-rate monitor over a :class:`WindowedView`.

    Two objectives on the serving plane's series: availability (share of
    answers that are neither errors nor sheds,
    ``DMLC_SLO_AVAILABILITY_TARGET``) and latency (share of answers under
    ``DMLC_SLO_LATENCY_TARGET_MS`` on the intended-time clock,
    ``DMLC_SLO_LATENCY_TARGET``). Each objective's burn — bad share over
    the window divided by the error budget — is published per window as
    ``slo_burn_rate{slo=,window=}``. A page latches when every window
    burns at ``DMLC_SLO_FAST_BURN`` or above and clears when the fastest
    window drops under ``DMLC_SLO_CLEAR_BURN``; it sets ``slo_page``,
    bumps ``slo_page_trips_total{slo=}`` and lands a flight dump. Sheds
    taken because of the page (``reason="slo_burn"``) are not counted as
    bad, or the page could never clear."""

    def __init__(self):
        from dmlc_core_tpu_torch.tracker.wire import env_float, env_int
        self.availability_target = env_float(
            "DMLC_SLO_AVAILABILITY_TARGET", 0.999)
        self.latency_target_ms = env_int("DMLC_SLO_LATENCY_TARGET_MS", 250)
        self.latency_target = env_float("DMLC_SLO_LATENCY_TARGET", 0.99)
        self.fast_burn = env_float("DMLC_SLO_FAST_BURN", 14.4)
        self.slow_burn = env_float("DMLC_SLO_SLOW_BURN", 6.0)
        self.clear_burn = env_float("DMLC_SLO_CLEAR_BURN", 1.0)
        self._paging: set = set()
        self._page_gauge = gauge("slo_page")

    @property
    def paging(self) -> bool:
        """Whether any objective is paging (latched)."""
        return bool(self._paging)

    @staticmethod
    def _availability_burn(dcounters: Dict[tuple, float],
                           budget: float) -> float:
        good = bad = 0.0
        for (name, labels), v in dcounters.items():
            v = max(v, 0.0)
            if name == "serve_scored_total":
                good += v
            elif name == "serve_errors_total":
                bad += v
            elif name == "serve_shed_total":
                if dict(labels).get("reason") != "slo_burn":
                    bad += v
        total = good + bad
        if total <= 0:
            return 0.0
        return (bad / total) / budget

    def _latency_burn(self, dhists: Dict[tuple, tuple],
                      budget: float) -> float:
        count = 0
        buckets = [0] * (HIST_BUCKETS + 1)
        for (name, _labels), (dc, _ds, db) in dhists.items():
            if name != "serve_request_us":
                continue
            count += max(dc, 0)
            for i, n in enumerate(db):
                buckets[i] += max(n, 0)
        if count <= 0:
            return 0.0
        target_us = self.latency_target_ms * 1000
        good = sum(n for i, n in enumerate(buckets)
                   if i < HIST_BUCKETS and (1 << i) <= target_us)
        return (max(count - good, 0) / count) / budget

    def evaluate(self, deltas: Dict[str, tuple]) -> None:
        """Evaluate both objectives over one tick's per-window deltas
        (``{window: (elapsed_s, dcounters, dhists)}``), publish the burn
        gauges and run the page/clear latch."""
        if not deltas:
            return
        burns: Dict[str, Dict[str, float]] = {"availability": {},
                                              "latency": {}}
        avail_budget = max(1.0 - self.availability_target, 1e-9)
        lat_budget = max(1.0 - self.latency_target, 1e-9)
        for label, (_elapsed, dcounters, dhists) in deltas.items():
            burns["availability"][label] = self._availability_burn(
                dcounters, avail_budget)
            burns["latency"][label] = self._latency_burn(dhists, lat_budget)
        # the clear reads the window spanning the least elapsed time
        fastest = min(deltas, key=lambda lb: deltas[lb][0])
        for slo, per_window in burns.items():
            for label, burn in per_window.items():
                gauge("slo_burn_rate", {"slo": slo, "window": label}).set(
                    round(burn, 4))
            if slo not in self._paging:
                if per_window and min(per_window.values()) >= \
                        self.fast_burn:
                    self._paging.add(slo)
                    counter("slo_page_trips_total", {"slo": slo}).inc()
                    detail = ", ".join(f"{lb}={b:.1f}x" for lb, b in
                                       sorted(per_window.items()))
                    emit_event("slo-page", slo=slo, burns=detail)
                    flight_dump(f"slo-page: {slo} burn [{detail}] >= "
                                f"{self.fast_burn}x budget")
            elif per_window.get(fastest, 0.0) < self.clear_burn:
                self._paging.discard(slo)
                emit_event("slo-page-clear", slo=slo)
        self._page_gauge.set(1.0 if self._paging else 0.0)


class WindowedView:
    """Rolling-window view over the cumulative registry.

    A daemon ticker (every ``DMLC_SLO_TICK_MS``) takes compact snapshots
    and keeps enough of them to serve deltas for each window (``fast`` =
    ``DMLC_SLO_WINDOW_FAST_S``, ``slow`` = ``DMLC_SLO_WINDOW_SLOW_S``).
    Each tick publishes ``window_rate{name=,window=}`` (counter delta per
    second, summed across label sets) and
    ``window_quantile{name=,window=,q=}`` (p50/p99 of the window's delta
    buckets, overflow clamped to the top bucket bound) as ordinary gauges,
    and feeds an attached :class:`SloMonitor`. Use
    :func:`start_windowed_view` / :func:`stop_windowed_view`; :meth:`tick`
    takes ``now=`` so tests can drive the clock."""

    def __init__(self, windows: Optional[Dict[str, float]] = None):
        from dmlc_core_tpu_torch.tracker.wire import env_int
        self.tick_s = max(env_int("DMLC_SLO_TICK_MS", 5000), 10) / 1000.0
        if windows is None:
            windows = {"fast": float(env_int("DMLC_SLO_WINDOW_FAST_S",
                                             300)),
                       "slow": float(env_int("DMLC_SLO_WINDOW_SLOW_S",
                                             3600))}
        self.windows = dict(windows)
        self.slo: Optional[SloMonitor] = None
        self._snaps: List[tuple] = []   # (t, counters, hists)
        self._mu = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def tick(self, now: Optional[float] = None) -> None:
        """Take one compact snapshot at ``now`` (default: the monotonic
        clock), prune history past the longest window, publish the window
        gauges, and feed the SLO monitor."""
        if now is None:
            now = time.monotonic()
        counters, hists = _compact_snapshot(snapshot())
        horizon = max(self.windows.values()) + 2 * self.tick_s
        with self._mu:
            self._snaps.append((now, counters, hists))
            while len(self._snaps) > 2 and self._snaps[1][0] < \
                    now - horizon:
                self._snaps.pop(0)
            deltas = self._deltas_locked(now)
        self._publish(deltas)
        if self.slo is not None:
            self.slo.evaluate(deltas)

    def _baseline_locked(self, now: float, seconds: float):
        base = None
        for rec in self._snaps:
            if rec[0] <= now - seconds:
                base = rec           # newest snap at/before window start
            else:
                break
        return base or self._snaps[0]

    def _deltas_locked(self, now: float) -> Dict[str, tuple]:
        out: Dict[str, tuple] = {}
        if len(self._snaps) < 2:
            return out
        cur_t, cur_c, cur_h = self._snaps[-1]
        for label, seconds in self.windows.items():
            base_t, base_c, base_h = self._baseline_locked(now, seconds)
            elapsed = cur_t - base_t
            if elapsed <= 0:
                continue
            dcounters = {k: v - base_c.get(k, 0.0)
                         for k, v in cur_c.items()}
            dhists = {}
            for k, (c, s, b) in cur_h.items():
                bc, bs, bb = base_h.get(k, (0, 0.0, (0,) * len(b)))
                dhists[k] = (c - bc, s - bs,
                             tuple(x - y for x, y in zip(b, bb)))
            out[label] = (elapsed, dcounters, dhists)
        return out

    def deltas(self) -> Dict[str, tuple]:
        """This instant's per-window ``(elapsed_s, dcounters, dhists)``."""
        with self._mu:
            return self._deltas_locked(time.monotonic())

    def _publish(self, deltas: Dict[str, tuple]) -> None:
        top = float(1 << HIST_BUCKETS)
        for label, (elapsed, dcounters, dhists) in deltas.items():
            rates: Dict[str, float] = {}
            for (name, _labels), v in dcounters.items():
                rates[name] = rates.get(name, 0.0) + max(v, 0.0)
            for name, total in rates.items():
                gauge("window_rate", {"name": name, "window": label}).set(
                    round(total / elapsed, 4))
            per_name: Dict[str, tuple] = {}
            for (name, _labels), (dc, _ds, db) in dhists.items():
                pc, pb = per_name.get(name, (0, (0,) * (HIST_BUCKETS + 1)))
                per_name[name] = (pc + max(dc, 0),
                                  tuple(x + max(y, 0)
                                        for x, y in zip(pb, db)))
            for name, (dc, db) in per_name.items():
                if dc <= 0:
                    continue
                for q in (0.5, 0.99):
                    val = quantile_from_buckets(list(db), dc, q)
                    gauge("window_quantile",
                          {"name": name, "window": label,
                           "q": str(q)}).set(min(val, top))

    def start(self) -> "WindowedView":
        """Start the ticker thread (idempotent)."""
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="windowed-view")
            self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the ticker thread (idempotent, joins briefly)."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.tick_s):
            try:
                self.tick()
            except Exception:
                pass  # a broken tick must not kill the view


_view_lock = threading.Lock()
_view: Optional[WindowedView] = None
_view_refs = 0


def start_windowed_view(slo: bool = False) -> WindowedView:
    """Start (or take one more reference on) the process
    :class:`WindowedView`; ``slo=True`` attaches the :class:`SloMonitor`.
    Pair every call with :func:`stop_windowed_view`."""
    global _view, _view_refs
    with _view_lock:
        if _view is None:
            _view = WindowedView().start()
        if slo and _view.slo is None:
            _view.slo = SloMonitor()
        _view_refs += 1
        return _view


def stop_windowed_view(force: bool = False) -> None:
    """Drop one reference on the process view; the last one (or
    ``force=True``) stops the ticker and clears the singleton."""
    global _view, _view_refs
    with _view_lock:
        if _view is None:
            _view_refs = 0
            return
        _view_refs = 0 if force else max(_view_refs - 1, 0)
        if _view_refs:
            return
        v, _view = _view, None
    v.stop()


def windowed_view() -> Optional[WindowedView]:
    """The live process :class:`WindowedView`, or None."""
    return _view


def slo_page_active() -> bool:
    """Whether the process SLO monitor is paging: the burn signal the
    scoring server's admission gate and ``/readyz`` read."""
    v = _view
    return v is not None and v.slo is not None and v.slo.paging


# ---------------------------------------------------------------------------
# Host resource sampler, a copy of the reference's: the CPU, RSS, page
# cache, network and disk envelope a measured run went through, per
# section() when one run holds several.
# ---------------------------------------------------------------------------
class HostResourceSampler:
    """Lightweight /proc-based host sampler for bench lanes.

    A daemon thread samples per-core CPU jiffies (``/proc/stat``), this
    process's RSS (``/proc/self/statm``), the host page cache
    (``/proc/meminfo`` Cached), and cumulative network/disk bytes
    (``/proc/net/dev``, ``/proc/diskstats``) every ``interval_s``.
    :meth:`summary` reduces any time window to an envelope — mean/max
    per-core busy fraction, peak RSS, byte deltas — and
    :meth:`section` names a window after the lane that ran inside it,
    so a remote-lane verdict can say *which* cores were saturated
    (client parse vs origin serve) instead of guessing.

    Degrades to ``{"unavailable": reason}`` summaries on hosts without
    /proc.  Overhead: one thread, a handful of small file reads per
    tick — nothing on the measured path.
    """

    def __init__(self, interval_s: float = 0.25):
        self.interval_s = max(0.05, float(interval_s))
        self.samples: List[dict] = []   # append-only; GIL-safe reads
        self.sections: Dict[str, dict] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._page = os.sysconf("SC_PAGESIZE") if hasattr(
            os, "sysconf") else 4096
        self._tick = os.sysconf("SC_CLK_TCK") if hasattr(
            os, "sysconf") else 100
        self._err: Optional[str] = None
        # label -> [pids]: per-process CPU attribution (sandboxed /proc
        # implementations zero the aggregate per-core jiffies while
        # per-pid clocks still tick — and the remote-lane verdict needs
        # the client-vs-origin CPU split either way)
        self._watch: Dict[str, List[int]] = {"self": [os.getpid()]}
        self._pid_last: Dict[int, int] = {}

    def watch(self, label: str, *pids: int) -> None:
        """Attribute the CPU of ``pids`` (e.g. a rig origin's workers, a
        client subprocess) to ``label`` in every later summary."""
        self._watch.setdefault(label, []).extend(int(p) for p in pids)

    # -- raw readers (each guarded: a missing file disables, not crashes) --
    def _read_cpu(self):
        out = []
        with open("/proc/stat") as f:
            for line in f:
                if not line.startswith("cpu") or line.startswith("cpu "):
                    continue
                parts = line.split()
                vals = [int(x) for x in parts[1:11]]
                idle = vals[3] + (vals[4] if len(vals) > 4 else 0)
                out.append((sum(vals) - idle, sum(vals)))
        return out

    def _read_rss(self):
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self._page

    def _read_cached(self):
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("Cached:"):
                    return int(line.split()[1]) * 1024
        return 0

    def _read_net(self):
        total = 0
        with open("/proc/net/dev") as f:
            for line in f.readlines()[2:]:
                _, _, rest = line.partition(":")
                if not rest:
                    continue
                v = rest.split()
                total += int(v[0]) + int(v[8])  # rx + tx bytes
        return total

    # whole PHYSICAL devices only: partitions (sda1, nvme0n1p1) would
    # double-count their disk, and stacked devices (dm-*, md*) would
    # double-count their member disks
    _DISK_RE = re.compile(
        r"^(?:sd[a-z]+|vd[a-z]+|xvd[a-z]+|hd[a-z]+|nvme\d+n\d+"
        r"|mmcblk\d+)$")

    def _read_disk(self):
        total = 0
        with open("/proc/diskstats") as f:
            for line in f:
                v = line.split()
                if len(v) < 14:
                    continue
                if not self._DISK_RE.match(v[2]):
                    continue
                total += (int(v[5]) + int(v[9])) * 512  # sectors r+w
        return total

    def _read_pid_cpu(self, pid: int) -> int:
        # utime+stime jiffies; field 2 (comm) may contain spaces — split
        # after the closing paren
        with open(f"/proc/{pid}/stat") as f:
            rest = f.read().rsplit(")", 1)[1].split()
        return int(rest[11]) + int(rest[12])

    def _sample(self) -> dict:
        s = {"t": time.monotonic()}
        s["cpu"] = self._read_cpu()
        s["rss"] = self._read_rss()
        s["cached"] = self._read_cached()
        pids = {}
        for label, plist in list(self._watch.items()):
            total = 0
            for p in plist:
                try:
                    v = self._read_pid_cpu(p)
                    self._pid_last[p] = v
                except (OSError, IndexError, ValueError):
                    # pid exited: charge its last-seen cumulative so the
                    # label's total never drops mid-window
                    v = self._pid_last.get(p, 0)
                total += v
            pids[label] = total
        s["pids"] = pids
        try:
            s["net"] = self._read_net()
        except OSError:
            s["net"] = 0
        try:
            s["disk"] = self._read_disk()
        except OSError:
            s["disk"] = 0
        return s

    def _loop(self):
        cpu_gauge = gauge("host_cpu_busy_frac")
        rss_gauge = gauge("host_rss_bytes")
        prev = None
        while not self._stop.is_set():
            try:
                s = self._sample()
            except OSError as e:  # /proc went away: disable, don't spin
                self._err = str(e)
                return
            self.samples.append(s)
            if prev is not None:
                db = sum(b for b, _ in s["cpu"]) - sum(
                    b for b, _ in prev["cpu"])
                dt = sum(t for _, t in s["cpu"]) - sum(
                    t for _, t in prev["cpu"])
                if dt > 0:
                    cpu_gauge.set(round(db / dt, 4))
            rss_gauge.set(s["rss"])
            prev = s
            self._stop.wait(self.interval_s)

    def start(self) -> "HostResourceSampler":
        """Take a first sample and start the sampling thread (no-op off
        Linux: the first failed /proc read records the reason and every
        summary reports ``unavailable``)."""
        try:
            self.samples.append(self._sample())
        except OSError as e:
            self._err = str(e)
            return self
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="host-resource-sampler")
        self._thread.start()
        return self

    def stop(self) -> dict:
        """Stop sampling (one final sample) and return the whole-run
        summary."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            try:
                self.samples.append(self._sample())
            except OSError:
                pass
        return self.summary()

    def summary(self, t0: Optional[float] = None,
                t1: Optional[float] = None) -> dict:
        """Reduce the samples in ``[t0, t1]`` (monotonic; default: all)
        to the envelope dict bench lanes record."""
        if self._err is not None:
            return {"unavailable": self._err}
        window = [s for s in list(self.samples)
                  if (t0 is None or s["t"] >= t0)
                  and (t1 is None or s["t"] <= t1)]
        if len(window) < 2:
            return {"unavailable": "fewer than 2 samples in window"}
        a, b = window[0], window[-1]
        wall = b["t"] - a["t"]
        ncores = max(len(a["cpu"]), 1)
        per_core = []
        for (b0, t0_), (b1, t1_) in zip(a["cpu"], b["cpu"]):
            dt = t1_ - t0_
            per_core.append(round((b1 - b0) / dt, 4) if dt > 0 else 0.0)
        # peak = busiest consecutive interval (overall, all cores)
        peak = 0.0
        for p, s in zip(window, window[1:]):
            db = sum(x for x, _ in s["cpu"]) - sum(x for x, _ in p["cpu"])
            dt = sum(x for _, x in s["cpu"]) - sum(
                x for _, x in p["cpu"])
            if dt > 0:
                peak = max(peak, db / dt)
        # watched-process CPU seconds over the window
        proc_cpu = {}
        for label in b.get("pids", {}):
            d = b["pids"].get(label, 0) - a.get("pids", {}).get(label, 0)
            proc_cpu[label] = round(max(d, 0) / self._tick, 3)
        out = {
            "wall_s": round(wall, 3),
            "samples": len(window),
            "cpu_source": "stat",
            "cpu_busy_frac": round(sum(per_core) / max(len(per_core), 1),
                                   4),
            "cpu_busy_frac_peak": round(peak, 4),
            "cpu_per_core": per_core,
            "ncores": ncores,
            "proc_cpu_s": proc_cpu,
            "rss_max_bytes": max(s["rss"] for s in window),
            "page_cache_delta_bytes": b["cached"] - a["cached"],
            "net_bytes": b["net"] - a["net"],
            "net_bytes_per_sec": round((b["net"] - a["net"]) / wall, 1)
            if wall > 0 else 0.0,
            "disk_bytes": b["disk"] - a["disk"],
        }
        total_jiffies = (sum(t for _, t in b["cpu"])
                         - sum(t for _, t in a["cpu"]))
        if total_jiffies <= 0 and wall > 0:
            # sandboxed /proc: the aggregate per-core clocks are zeroed
            # while per-pid clocks tick — derive the busy fraction from
            # the watched processes instead of reporting a false idle
            out["cpu_source"] = "pids"
            out["cpu_busy_frac"] = round(
                min(sum(proc_cpu.values()) / (wall * ncores), 1.0), 4)
            out.pop("cpu_per_core")
            out.pop("cpu_busy_frac_peak")
        return out

    def section(self, name: str):
        """Context manager: summarize the samples taken while the body
        ran and stash the envelope under ``sections[name]``."""
        sampler = self

        class _Section:
            def __enter__(self):
                self.t0 = time.monotonic()
                return sampler

            def __exit__(self, *exc):
                sampler.sections[name] = sampler.summary(
                    self.t0, time.monotonic())
                return False

        return _Section()
