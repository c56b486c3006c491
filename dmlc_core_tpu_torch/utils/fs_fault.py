"""Local-filesystem fault injection — the Python half of the durability
plane (native half: ``cpp/src/fs_fault.h``, setter
``io.native.set_fs_fault_plan``). A copy of
``dmlc_core_tpu/utils/fs_fault.py`` over the port's own telemetry.

The pure-Python write paths — ``checkpoint.py``'s atomic save and the
``_EventLog`` JSONL sink (the server's access log) — fail in ways no unit
test could otherwise provoke: a full disk at the fsync, a torn
rename under a crash, an EIO mid-append. This module shares the NATIVE
plan grammar (checked parse, deterministic selectors) so one
``DMLC_FS_FAULT_PLAN`` string drives both halves of the stack:

    <op>:fault=<kind>,(every=N | p=<prob>) [; more rules]

ops ``open|read|write|fsync|rename|mmap``; faults ``eio`` (any op),
``enospc`` (open/write/fsync), ``short_write`` (write — HALF the bytes
really land, then ENOSPC), ``fsync_fail`` (fsync), ``torn_rename``
(rename — the destination receives a truncated half-copy, the source is
gone). ``every=N`` fires on every Nth observed op of that kind;
``p=`` draws from one RNG seeded by ``DMLC_FS_FAULT_SEED`` (default 1).
A typo'd plan raises (the checked-parse rule) instead of silently
injecting nothing. Every firing bumps
``fs_fault_injected_total{op=...}`` (doc/observability.md).

Injected failures surface as ``OSError`` with the fault's errno — the
exact exception class the real failure raises — so the call sites under
test cannot tell injection from a genuinely sick disk.
"""

from __future__ import annotations

import errno
import os
import random
import threading
from typing import Callable, List, Optional

from dmlc_core_tpu_torch import telemetry
from dmlc_core_tpu_torch.base import DMLCError
from dmlc_core_tpu_torch.tracker.wire import env_int

__all__ = ["OPS", "FAULTS", "FsFaultRule", "parse_plan",
           "set_fs_fault_plan", "maybe_inject", "checked_write",
           "checked_fsync", "checked_replace", "plan_active"]

OPS = ("open", "read", "write", "fsync", "rename", "mmap")
FAULTS = ("eio", "enospc", "short_write", "fsync_fail", "torn_rename")

_ERRNO = {"eio": errno.EIO, "enospc": errno.ENOSPC,
          "short_write": errno.ENOSPC, "fsync_fail": errno.EIO,
          "torn_rename": errno.EIO}
# the op/fault validity matrix (mirrors fs_fault.cc CheckCombo): a plan
# that could never fire must error at parse, not no-op mid-gauntlet
_VALID_OPS = {"eio": set(OPS),
              "enospc": {"open", "write", "fsync"},
              "short_write": {"write"},
              "fsync_fail": {"fsync"},
              "torn_rename": {"rename"}}


class FsFaultRule:
    """One parsed plan rule; ``maybe_fire`` is thread-safe."""

    __slots__ = ("op", "fault", "every", "p", "_count", "_mu")

    def __init__(self, op: str, fault: str, every: int, p: float):
        self.op = op
        self.fault = fault
        self.every = every
        self.p = p
        self._count = 0
        self._mu = threading.Lock()

    def maybe_fire(self, rng: random.Random) -> bool:
        """Tick this rule for one observed op; True when it fires."""
        with self._mu:
            if self.every > 0:
                self._count += 1
                return self._count % self.every == 0
            return rng.random() < self.p


def parse_plan(text: str) -> List[FsFaultRule]:
    """Parse a plan string into rules; raises :class:`DMLCError` on bad
    grammar or an impossible op/fault combination (empty text → [])."""
    rules: List[FsFaultRule] = []
    for rule_text in text.split(";"):
        rule_text = rule_text.strip()
        if not rule_text:
            continue
        op, colon, params = rule_text.partition(":")
        if not colon:
            raise DMLCError(
                f"fs fault plan: rule '{rule_text}' needs "
                f"<op>:fault=<kind>,every=N|p=<prob>")
        if op not in OPS:
            raise DMLCError(
                f"fs fault plan: unknown op '{op}' (known: "
                f"{', '.join(OPS)}) in '{text}'")
        fault = ""
        every = 0
        p = 0.0
        for kv in params.split(","):
            if not kv:
                continue
            key, eq, val = kv.partition("=")
            if not eq:
                raise DMLCError(
                    f"fs fault plan: malformed param '{kv}' in '{text}'")
            if key == "fault":
                if val not in FAULTS:
                    raise DMLCError(
                        f"fs fault plan: unknown fault '{val}' (known: "
                        f"{', '.join(FAULTS)}) in '{text}'")
                fault = val
            elif key == "every":
                try:
                    every = int(val)
                except ValueError:
                    raise DMLCError(
                        f"fs fault plan: every must be an integer, got "
                        f"'{val}'") from None
                if every < 1:
                    raise DMLCError(
                        f"fs fault plan: every must be >= 1, got {every}")
            elif key == "p":
                try:
                    p = float(val)
                except ValueError:
                    raise DMLCError(
                        f"fs fault plan: p must be a float, got "
                        f"'{val}'") from None
                if not 0.0 <= p <= 1.0:
                    raise DMLCError(
                        f"fs fault plan: p must be in [0,1], got {val}")
            else:
                raise DMLCError(
                    f"fs fault plan: unknown param '{key}' in '{text}'")
        if not fault:
            raise DMLCError(
                f"fs fault plan: rule '{rule_text}' needs fault=<kind>")
        if every == 0 and p == 0.0:
            raise DMLCError(
                f"fs fault plan: rule '{rule_text}' needs every=N or "
                f"p=<prob>")
        if every != 0 and p != 0.0:
            # only one selector can drive a rule; silently preferring
            # every= would inject differently than written
            raise DMLCError(
                f"fs fault plan: rule '{rule_text}' has BOTH every=N "
                f"and p= — pick one selector")
        if op not in _VALID_OPS[fault]:
            raise DMLCError(
                f"fs fault plan: fault '{fault}' cannot apply to op "
                f"'{op}' in '{text}'")
        rules.append(FsFaultRule(op, fault, every, p))
    return rules


_lock = threading.Lock()
_rules: Optional[List[FsFaultRule]] = None  # None = env not yet consulted
_rng: Optional[random.Random] = None
# fast-path gate (the fs_fault.cc g_plan_active rule): probes sit on the
# tracker's per-event-line and the checkpoint's per-write paths, so the
# no-plan case must be one attribute read, not a mutex acquisition
_active = False


def set_fs_fault_plan(plan: str) -> None:
    """Install/replace the PYTHON-side plan ("" clears; an explicit clear
    beats ``DMLC_FS_FAULT_PLAN``, the same rule as the native setter).
    Raises on bad grammar. The native half is driven separately via
    ``io.native.set_fs_fault_plan`` — tests that span both halves set
    both."""
    global _rules, _rng, _active
    rules = parse_plan(plan)
    with _lock:
        _rules = rules
        _rng = random.Random(_seed())
        _active = bool(rules)


def _seed() -> int:
    return env_int("DMLC_FS_FAULT_SEED", 1)


def _active_rules() -> List[FsFaultRule]:
    global _rules, _rng, _active
    if _rules is not None:
        return _rules
    with _lock:
        if _rules is None:  # lazy env install, explicit set wins forever
            _rules = parse_plan(os.environ.get("DMLC_FS_FAULT_PLAN", ""))
            _rng = random.Random(_seed())
            _active = bool(_rules)
        return _rules


def plan_active() -> bool:
    """True when any rule is installed (env or explicit)."""
    _active_rules()  # resolve the env plan on first use
    return _active


def _probe(op: str) -> Optional[str]:
    """Tick every matching rule; return the first fired fault kind (and
    count it into ``fs_fault_injected_total{op=}``), else None. The
    no-plan fast path is one attribute read."""
    rules = _active_rules()
    if not _active:
        return None
    fired: Optional[str] = None
    for rule in rules:
        if rule.op != op:
            continue
        if rule.maybe_fire(_rng) and fired is None:
            fired = rule.fault
    if fired is not None:
        telemetry.counter("fs_fault_injected_total", {"op": op}).inc()
    return fired


def maybe_inject(op: str, path: str = "") -> None:
    """Evaluate the plan for one ``op``; raise ``OSError(errno)`` when a
    simple fault fires. The side-effectful kinds have dedicated helpers:
    :func:`checked_write` (short_write) and :func:`checked_replace`
    (torn_rename)."""
    fault = _probe(op)
    if fault is not None:
        raise OSError(_ERRNO[fault],
                      f"dct fs fault-injection: {fault} on {op}"
                      + (f" ({path})" if path else ""))


def checked_write(write_fn: Callable[[bytes], object], data: bytes,
                  path: str = "") -> None:
    """Drive one logical write through the plan: ``short_write`` REALLY
    writes the first half before raising ENOSPC (the torn-bytes artifact
    crash-consistent writers must clean up), ``enospc``/``eio`` raise
    without writing, no fault passes ``data`` through."""
    fault = _probe("write")
    if fault is None:
        write_fn(data)
        return
    if fault == "short_write" and len(data) > 1:
        write_fn(data[: len(data) // 2])
    raise OSError(_ERRNO[fault],
                  f"dct fs fault-injection: {fault} on write"
                  + (f" ({path})" if path else ""))


def checked_fsync(fd: int, path: str = "") -> None:
    """``os.fsync`` through the plan (fsync_fail/eio/enospc raise)."""
    maybe_inject("fsync", path)
    os.fsync(fd)


def checked_replace(src: str, dst: str) -> None:
    """``os.replace`` through the plan. ``torn_rename`` performs the
    crash-mid-rename artifact for real — ``dst`` receives a TRUNCATED
    half-copy, ``src`` is gone — then raises EIO, so the caller's cleanup
    and the next reader's validation face exactly what a non-atomic
    filesystem could expose."""
    fault = _probe("rename")
    if fault is None:
        os.replace(src, dst)
        return
    if fault == "torn_rename":
        try:
            size = os.path.getsize(src)
            with open(src, "rb") as f:
                half = f.read(size // 2)
            with open(dst, "wb") as f:
                f.write(half)
        except OSError:
            pass  # the tear is best-effort; the failure below is the point
        try:
            os.unlink(src)
        except OSError:
            pass
    raise OSError(_ERRNO[fault],
                  f"dct fs fault-injection: {fault} on rename "
                  f"({src} -> {dst})")
