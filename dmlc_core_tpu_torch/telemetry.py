"""Process-wide counters, gauges, log2 histograms, events and spans.

The subset of ``dmlc_core_tpu/telemetry.py`` that the device iterator
calls, with the same metric names and the same histogram buckets (bucket
*i* counts observations ``v <= 2**i``, plus one +Inf overflow bucket), so
the two packages' numbers read alike. The merged native snapshot, the
exporters, the SLO plane and the flight recorder's file dump are a later
slice; here :func:`flight_dump` records a plain event.
"""

from __future__ import annotations

import math
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "HIST_BUCKETS", "counter",
           "gauge", "histogram", "enabled", "enable", "reset", "emit_event",
           "events", "emit_span", "span", "spans", "flight_dump"]

HIST_BUCKETS = 28
SPANS_MAX = 8192
_EVENTS_MAX = 4096

_lock = threading.Lock()
_counters: Dict[Tuple[str, tuple], "Counter"] = {}
_gauges: Dict[Tuple[str, tuple], "Gauge"] = {}
_hists: Dict[Tuple[str, tuple], "Histogram"] = {}
_events: List[dict] = []
_spans: List[dict] = []
_span_seq = 0
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

    __slots__ = ("name", "labels", "count", "sum", "buckets", "_mu")

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = dict(labels)
        self.count = 0
        self.sum = 0
        self.buckets = [0] * (HIST_BUCKETS + 1)
        self._mu = threading.Lock()

    @staticmethod
    def bucket_of(v: int) -> int:
        """Index of the first bucket whose bound ``2**i`` holds ``v``."""
        if v <= 1:
            return 0
        w = int(v - 1).bit_length()
        return w if w < HIST_BUCKETS else HIST_BUCKETS

    def observe(self, v: float) -> None:
        """Record one non-negative observation."""
        v = max(v, 0)
        with self._mu:
            self.count += 1
            self.sum += v
            self.buckets[self.bucket_of(int(v))] += 1

    def zero(self) -> None:
        """Reset all counts."""
        with self._mu:
            self.count = 0
            self.sum = 0
            self.buckets = [0] * (HIST_BUCKETS + 1)

    def quantile(self, q: float) -> float:
        """Upper bound ``2**i`` of the bucket holding the ``q``-quantile
        (0.0 when empty, ``inf`` in the overflow bucket)."""
        if not 0.0 < q <= 1.0:
            raise ValueError(f"quantile {q} outside (0, 1]")
        with self._mu:
            if self.count <= 0:
                return 0.0
            need = max(1, math.ceil(q * self.count))
            cum = 0
            for i, n in enumerate(self.buckets):
                cum += n
                if cum >= need:
                    return math.inf if i >= HIST_BUCKETS else float(1 << i)
        return math.inf

    def summary(self) -> dict:
        """count, sum, mean, p50 and p99 of the recorded observations."""
        return {"count": self.count, "sum": self.sum,
                "mean": self.sum / self.count if self.count else 0.0,
                "p50_le": self.quantile(0.5), "p99_le": self.quantile(0.99)}


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


def enabled() -> bool:
    """Whether timed spans are on: ``DMLC_TELEMETRY`` at first use
    (default on), overridable with :func:`enable`. Counters always count."""
    global _enabled
    if _enabled is None:
        _enabled = os.environ.get("DMLC_TELEMETRY", "1") not in ("0", "off")
    return _enabled


def enable(on: bool) -> None:
    """Set the span gate."""
    global _enabled
    _enabled = bool(on)


def reset() -> None:
    """Zero every metric and drop buffered events and spans."""
    with _lock:
        for table in (_counters, _gauges, _hists):
            for m in table.values():
                m.zero()
        del _events[:]
        del _spans[:]


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


def _next_id() -> int:
    global _span_seq
    with _lock:
        _span_seq += 1
        return _span_seq


def _append_span(name: str, span_id: int, parent: int, start_us: float,
                 dur_us: float, args: Optional[dict]) -> None:
    rec = {"name": name, "id": span_id, "parent": parent,
           "ts": int(start_us), "dur": int(dur_us)}
    if args:
        rec["args"] = args
    with _lock:
        _spans.append(rec)
        if len(_spans) > SPANS_MAX:
            del _spans[: len(_spans) - SPANS_MAX]


def emit_span(name: str, start_us: float, dur_us: float, **args) -> None:
    """Append one completed span (``time.perf_counter()`` microseconds),
    parented under the thread's open :func:`span`. No-op when disabled."""
    if not enabled():
        return
    _append_span(name, _next_id(), getattr(_tls, "open_span", 0), start_us,
                 dur_us, args or None)


class _Span:
    __slots__ = ("name", "args", "_start", "_id", "_parent", "_active")

    def __init__(self, name: str, args: Optional[dict]):
        self.name = name
        self.args = args

    def __enter__(self) -> "_Span":
        self._active = enabled()
        if self._active:
            self._id = _next_id()
            self._parent = getattr(_tls, "open_span", 0)
            _tls.open_span = self._id
            self._start = time.perf_counter() * 1e6
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._active:
            _tls.open_span = self._parent
            _append_span(self.name, self._id, self._parent, self._start,
                         time.perf_counter() * 1e6 - self._start, self.args)


def span(name: str, **args) -> _Span:
    """Context manager recording one span at scope exit."""
    return _Span(name, args or None)


def spans() -> List[dict]:
    """A copy of the buffered span ring."""
    with _lock:
        return list(_spans)


def flight_dump(reason: str) -> None:
    """Record a postmortem marker as a ``flight-dump`` event."""
    emit_event("flight-dump", reason=reason)

