"""Step-deadline watchdog for elastic mesh training.

The death-mid-step problem (doc/robustness.md "Elastic mesh training"):
when a mesh rank is SIGKILL'd, its survivors are usually parked INSIDE a
collective — a gloo or NCCL transfer, a store
wait — that Python cannot interrupt from another
thread. The tracker's heartbeat abort reaches the survivor's
:class:`~dmlc_core_tpu_torch.tracker.client.HeartbeatMonitor`, but a raise can
only surface *between* steps; a survivor blocked mid-step would hang
until the collective's own (much longer) timeout.

:class:`StepWatchdog` closes that gap with two paths to one outcome — a
structured abort, never a hung collective:

- **Between steps** (the common case): ``step_begin``/``step_end`` call
  ``monitor.check()``, which raises :class:`TrackerAbortedError` the
  moment the tracker broadcast lands. The caller runs its drains and
  exits with :data:`STEP_ABORT_EXIT`.
- **Mid-step** (the hung-collective case): a poll thread notices the
  abort flag while a step has been running past the step deadline
  (``DMLC_STEP_DEADLINE_MS``, default 2× ``DMLC_TRACKER_DEAD_AFTER_MS``),
  runs the registered drains (device-pipeline ``abort_drain``, lease
  release), writes the abort record, ships a flight dump, and hard-exits
  the process with :data:`STEP_ABORT_EXIT` — ``os._exit``, because the
  blocked step thread cannot be unwound.

Either way the supervisor sees the same exit code and relaunches the
world from the last committed job checkpoint.

The port's own copy of ``dmlc_core_tpu/parallel/elastic.py`` (it imports nothing of
the JAX package): the same names, env variables, CLI flags and wire
bytes, so a worker of either package joins the other's tracker.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Iterable, Optional

from dmlc_core_tpu_torch import telemetry
from dmlc_core_tpu_torch.tracker.wire import env_int

__all__ = ["STEP_ABORT_EXIT", "StepWatchdog", "structured_abort"]

# the exit code every structured mesh abort uses — survivors killed by
# the watchdog and survivors that raised cleanly between steps are
# indistinguishable to the supervisor, which is the point: both mean
# "relaunch the world from the last committed checkpoint"
STEP_ABORT_EXIT = 41


def structured_abort(reason: str,
                     drains: Iterable[Callable[[], None]] = (),
                     record_path: Optional[str] = None,
                     rank: Optional[int] = None) -> None:
    """Run the drains, write the abort record, ship the flight dump —
    everything a dying survivor owes the postmortem, WITHOUT exiting
    (the caller picks ``sys.exit(STEP_ABORT_EXIT)`` or ``os._exit``).

    Counted in ``mesh_step_aborts_total``. ``record_path`` (default env
    ``DMLC_ABORT_RECORD``) gets one JSON line naming the reason, rank,
    and pid — the artifact the chaos suite asserts on."""
    telemetry.counter("mesh_step_aborts_total").inc()
    for drain in drains:
        try:
            drain()
        except Exception:
            pass  # drains are best-effort: the abort must still complete
    path = record_path or os.environ.get("DMLC_ABORT_RECORD")
    if path:
        try:
            rec = {"ts": time.time(), "reason": reason, "rank": rank,
                   "pid": os.getpid()}
            with open(path, "a") as f:
                f.write(json.dumps(rec) + "\n")
                f.flush()
                os.fsync(f.fileno())
        except OSError:
            pass  # the record is observability, not correctness
    telemetry.flight_dump(f"mesh-abort: {reason}",
                          **({} if rank is None else {"rank": rank}))


class StepWatchdog:
    """Bounded-wall-clock abort for training-step loops under the tracker
    heartbeat (see module docstring).

    Usage::

        wd = StepWatchdog(drains=[it.abort_drain]).start()
        try:
            for step in range(steps):
                wd.step_begin(step)   # raises TrackerAbortedError on abort
                ...train...
                wd.step_end()         # ditto, right after the step lands
        except TrackerAbortedError as e:
            wd.drain()
            structured_abort(str(e), record_path=..., rank=rank)
            sys.exit(STEP_ABORT_EXIT)
        finally:
            wd.stop()

    ``monitor=None`` resolves the process's active
    :func:`~dmlc_core_tpu_torch.tracker.client.current_monitor` at every use,
    so construction order vs rendezvous does not matter. With no monitor
    and no deadline the watchdog is inert — single-process runs pay one
    no-op call per step."""

    def __init__(self, monitor=None,
                 step_deadline_ms: Optional[int] = None,
                 drains: Iterable[Callable[[], None]] = (),
                 abort_record: Optional[str] = None,
                 rank: Optional[int] = None):
        self._monitor = monitor
        dead_after = env_int("DMLC_TRACKER_DEAD_AFTER_MS", 0)
        self.step_deadline_ms = step_deadline_ms \
            if step_deadline_ms is not None \
            else env_int("DMLC_STEP_DEADLINE_MS",
                         2 * dead_after if dead_after > 0 else 0)
        self._drains = list(drains)
        self._abort_record = abort_record
        self._rank = rank
        self._lock = threading.Lock()
        self._step: Optional[int] = None
        self._step_started: Optional[float] = None
        self._step_begin_us: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _mon(self):
        if self._monitor is not None:
            return self._monitor
        from dmlc_core_tpu_torch.tracker.client import current_monitor
        return current_monitor()

    def add_drain(self, fn: Callable[[], None]) -> None:
        """Register a drain to run on abort (device-pipeline abort_drain,
        lease release, ...)."""
        self._drains.append(fn)

    def start(self) -> "StepWatchdog":
        """Start the mid-step poll thread (no-op when no step deadline is
        configured — the between-steps check() path still works)."""
        if self.step_deadline_ms > 0 and self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._poll, daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the watchdog thread and wait for it (idempotent)."""
        self._stop.set()
        th, self._thread = self._thread, None
        if th is not None:
            th.join(timeout=2.0)

    def step_begin(self, step: int) -> None:
        """Call at the top of every step: surfaces a pending tracker
        abort as TrackerAbortedError BETWEEN steps, then arms the
        mid-step deadline clock."""
        mon = self._mon()
        if mon is not None:
            mon.check()
        with self._lock:
            self._step = step
            self._step_started = time.monotonic()
            self._step_begin_us = time.time() * 1e6

    def step_end(self) -> None:
        """Call right after the step's results land: disarms the deadline
        clock, then surfaces a pending abort immediately (instead of at
        the NEXT step_begin, which may never come)."""
        with self._lock:
            self._step_started = None
            step, begin_us = self._step, self._step_begin_us
            self._step_begin_us = None
        if begin_us is not None and step is not None:
            # a `mesh.step` span per completed step: rides TELEMETRY_PULL
            # to the tracker, which derives per-rank step durations and
            # the straggler_bound verdict from it (doc/observability.md
            # "Step timelines")
            telemetry.emit_span("mesh.step", begin_us,
                                time.time() * 1e6 - begin_us, step=step)
        mon = self._mon()
        if mon is not None:
            mon.check()

    def drain(self) -> None:
        """Run the registered drains once (best-effort, idempotent by
        contract of the drains themselves)."""
        for fn in self._drains:
            try:
                fn()
            except Exception:
                pass

    def _poll(self) -> None:
        while not self._stop.wait(0.02):
            mon = self._mon()
            if mon is None or mon.aborted is None:
                continue
            with self._lock:
                started, step = self._step_started, self._step
            if started is None:
                continue  # between steps: step_begin/step_end will raise
            overdue_ms = (time.monotonic() - started) * 1000.0
            if overdue_ms < self.step_deadline_ms:
                continue
            # the step thread is parked in a collective it will never
            # finish (a dead peer cannot contribute); Python cannot
            # unwind it, so drain + record + hard-exit is the only
            # bounded way out
            reason = (f"step {step} blocked {overdue_ms:.0f} ms past the "
                      f"{self.step_deadline_ms} ms step deadline after "
                      f"tracker abort: {mon.aborted}")
            structured_abort(reason, drains=self._drains,
                            record_path=self._abort_record,
                            rank=self._rank)
            os._exit(STEP_ABORT_EXIT)
