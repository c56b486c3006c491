"""The size-capped JSONL sink that drops and counts failed lines.

A copy of ``_EventLog`` from ``dmlc_core_tpu/tracker/rendezvous.py``
(class name kept so a reader finds its counterpart). The reference's
tracker writes its event log through it; in the port it is the scoring
server's access log.
"""

from __future__ import annotations

import logging
import os

from dmlc_core_tpu_torch import telemetry
from dmlc_core_tpu_torch.base import DMLCError
from dmlc_core_tpu_torch.utils import fs_fault

__all__ = ["_EventLog"]

logger = logging.getLogger("dmlc_core_tpu_torch.tracker")


class _EventLog:
    """A JSONL sink with size-capped rotation (the current file moves to
    ``<path>.1`` at the cap, so a long-running process holds at most ~2x
    the cap on disk).

    A write or rotation failure — full disk, EIO, torn rename — is
    contained here: the line is dropped and counted (``dropped``, by
    default ``event_log_dropped_total``), the caller never sees the
    exception. Every file op is injectable through the Python fault plan
    (:mod:`dmlc_core_tpu_torch.utils.fs_fault`)."""

    def __init__(self, path: str, max_bytes: int, dropped=None):
        self._path = path
        self._max_bytes = max_bytes  # 0 = rotation off
        self._dropped = dropped if dropped is not None else \
            telemetry.counter("event_log_dropped_total")
        self._warned_bad_plan = False
        self._fp = open(path, "a", buffering=1)
        try:
            self._size = os.path.getsize(path)
        except OSError:
            self._size = 0

    def write(self, line: str) -> None:
        """Append one JSONL line, rotating first when it would cross the
        cap. I/O errors drop the line and bump the counter. A malformed
        ``DMLC_FS_FAULT_PLAN`` (a DMLCError from the lazy env parse on the
        first probe) is contained the same way and warned once."""
        try:
            fs_fault.maybe_inject("write", self._path)
            if self._max_bytes > 0 and self._size + len(line) > \
                    self._max_bytes and self._size > 0:
                self._fp.close()
                fs_fault.checked_replace(self._path, self._path + ".1")
                self._fp = open(self._path, "a", buffering=1)
                self._size = 0
            self._fp.write(line)
            self._size += len(line)
        except (OSError, ValueError, DMLCError) as e:
            self._dropped.inc()
            if isinstance(e, DMLCError) and not self._warned_bad_plan:
                self._warned_bad_plan = True
                logger.warning("event log fault-plan error contained: %s",
                               e)
            # a failed rotation may have closed the handle: reopen once so
            # one bad rename does not silence the log forever, and re-stat
            # the size (a failed rename leaves the cap-sized file in place)
            try:
                if self._fp.closed:
                    self._fp = open(self._path, "a", buffering=1)
                    try:
                        self._size = os.path.getsize(self._path)
                    except OSError:
                        self._size = 0
            except (OSError, ValueError):
                pass

    def close(self) -> None:
        try:
            self._fp.close()
        except OSError:
            pass
