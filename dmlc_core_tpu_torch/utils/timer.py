"""Timing and trace-span utilities (port of ``dmlc_core_tpu/utils/
timer.py``).

Counterpart of reference include/dmlc/timer.h (``GetTime``, timer.h:27),
plus named spans that aggregate wall time and, when asked, also appear in
``torch.profiler`` traces through ``torch.profiler.record_function`` (the
reference's ``jax.profiler.TraceAnnotation``), so host stages line up
with the device's rows in the profiler's timeline.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator, Optional

__all__ = ["get_time", "Timer", "trace_span", "span_totals",
           "reset_span_totals"]


def get_time() -> float:
    """Seconds from a monotonic high-resolution clock (reference
    timer.h:27 GetTime)."""
    return time.monotonic()


class Timer:
    """Accumulating stopwatch: start/stop many times, read the total."""

    def __init__(self) -> None:
        self._total = 0.0
        self._started: Optional[float] = None

    def start(self) -> "Timer":
        """Begin (or resume) timing."""
        self._started = get_time()
        return self

    def stop(self) -> float:
        """Stop timing and add the elapsed span to the total."""
        if self._started is not None:
            self._total += get_time() - self._started
            self._started = None
        return self._total

    @property
    def total(self) -> float:
        running = (get_time() - self._started
                   if self._started is not None else 0.0)
        return self._total + running

    def __enter__(self) -> "Timer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


_totals: Dict[str, float] = {}
_counts: Dict[str, int] = {}
_lock = threading.Lock()


@contextlib.contextmanager
def trace_span(name: str, profiler: bool = False) -> Iterator[None]:
    """Named span: aggregates into span_totals(); with profiler=True the
    span is also a ``torch.profiler.record_function`` row of any running
    profiler capture."""
    ctx = contextlib.nullcontext()
    if profiler:
        import torch.profiler
        ctx = torch.profiler.record_function(name)
    t0 = get_time()
    try:
        with ctx:
            yield
    finally:
        # a stage that raises still spent the time
        dt = get_time() - t0
        with _lock:
            _totals[name] = _totals.get(name, 0.0) + dt
            _counts[name] = _counts.get(name, 0) + 1


def span_totals() -> Dict[str, Dict[str, float]]:
    """{name: {"total_s": ..., "count": ...}} aggregated across threads."""
    with _lock:
        return {k: {"total_s": _totals[k], "count": _counts[k]}
                for k in _totals}


def reset_span_totals() -> None:
    """Zero the global named-span accumulators."""
    with _lock:
        _totals.clear()
        _counts.clear()
