"""Diagnostics, environment helpers, device resolution and the locked
build of native code.

The port's copy of ``dmlc_core_tpu/base.py``: :class:`DMLCError`, the
package logger with its date-stamped stderr handler, the CHECK family and
the typed env accessors (the reference's ``include/dmlc/logging.h`` and
``parameter.h:50-61``), with the same signatures, values and error text.
Two helpers are the port's own: the device rule every entry point
follows, and :func:`build_if_stale`, which builds the native core and the
CUDA kernels into ``_build/`` at first use. This module imports neither
torch nor numpy at import time.
"""

from __future__ import annotations

import fcntl
import logging
import os
import subprocess
import sys
from typing import (Any, Callable, List, Optional, Sequence, Type,
                    TypeVar)

T = TypeVar("T")

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(PACKAGE_DIR)
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")


class DMLCError(RuntimeError):
    """Fatal-check failure. Equivalent of ``dmlc::Error`` (logging.h:29)."""


# every dmlc_core_tpu_torch.* logger propagates to this one; installed once
# per process, on the stderr current at first import (reference
# logging.h:280-338)
_LOGGER = logging.getLogger("dmlc_core_tpu_torch")
if not _LOGGER.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter(
        "[%(asctime)s] %(levelname)s %(message)s", "%H:%M:%S"))
    _LOGGER.addHandler(_h)
    _LOGGER.setLevel(logging.INFO)


def logger() -> logging.Logger:
    """Return the package-wide logger instance."""
    return _LOGGER


def log_info(msg: str, *args: Any) -> None:
    """Log at INFO through the package logger (reference LOG(INFO))."""
    _LOGGER.info(msg, *args)


def log_warning(msg: str, *args: Any) -> None:
    """Log at WARNING through the package logger (reference LOG(WARNING))."""
    _LOGGER.warning(msg, *args)


def check(cond: Any, msg: str = "") -> None:
    """``CHECK(cond)`` — raise :class:`DMLCError` when ``cond`` is falsy."""
    if not cond:
        raise DMLCError(f"Check failed: {msg}")


def check_eq(a: Any, b: Any, msg: str = "") -> None:
    """Raise DMLCError unless a == b (reference CHECK_EQ, base.h)."""
    if a != b:
        raise DMLCError(f"Check failed: {a!r} == {b!r} {msg}")


def check_ne(a: Any, b: Any, msg: str = "") -> None:
    """Raise DMLCError unless a != b (reference CHECK_NE)."""
    if a == b:
        raise DMLCError(f"Check failed: {a!r} != {b!r} {msg}")


def check_lt(a: Any, b: Any, msg: str = "") -> None:
    """Raise DMLCError unless a < b (reference CHECK_LT)."""
    if not a < b:
        raise DMLCError(f"Check failed: {a!r} < {b!r} {msg}")


def check_le(a: Any, b: Any, msg: str = "") -> None:
    """Raise DMLCError unless a <= b (reference CHECK_LE)."""
    if not a <= b:
        raise DMLCError(f"Check failed: {a!r} <= {b!r} {msg}")


def check_gt(a: Any, b: Any, msg: str = "") -> None:
    """Raise DMLCError unless a > b (reference CHECK_GT)."""
    if not a > b:
        raise DMLCError(f"Check failed: {a!r} > {b!r} {msg}")


def check_ge(a: Any, b: Any, msg: str = "") -> None:
    """Raise DMLCError unless a >= b (reference CHECK_GE)."""
    if not a >= b:
        raise DMLCError(f"Check failed: {a!r} >= {b!r} {msg}")


def get_env(key: str, default: T, dtype: Optional[Type[T]] = None) -> T:
    """Typed env lookup — reference ``dmlc::GetEnv`` (parameter.h:1122+).

    Booleans accept 0/1/true/false/yes/on (case-insensitive); any other
    value reads False. Other types convert the raw string with
    ``dtype``, else with the type of ``default``."""
    raw = os.environ.get(key)
    if raw is None:
        return default
    ty: Type = dtype if dtype is not None else type(default)
    if ty is bool:
        on = raw.strip().lower() in ("1", "true", "yes", "on")
        return on  # type: ignore[return-value]
    return ty(raw)  # type: ignore[return-value]


def set_env(key: str, value: Any) -> None:
    """Reference ``dmlc::SetEnv`` (parameter.h:50-61): booleans are
    written as 0/1, everything else as ``str(value)``."""
    if isinstance(value, bool):
        value = int(value)
    os.environ[key] = str(value)


def resolve_device(device: "str | torch.device | None") -> torch.device:
    """The device an entry point runs on: ``device`` when given, else
    ``cuda``. Without CUDA and without an explicit device this raises —
    the port never falls back to the CPU on its own."""
    # imported here: processes that use only the native core (the bench's
    # parse clients and origins) start without torch
    import torch
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise DMLCError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return torch.device("cuda")


def build_if_stale(out: str, sources: Sequence[str],
                   command: Callable[[str], List[str]]) -> Optional[str]:
    """Build ``out`` when it is missing or older than any of ``sources``.

    ``command(tmp)`` returns the argv that writes the artifact to ``tmp``;
    the result is moved into place with ``os.replace``, so a reader never
    sees a half-written library. Every build of the package holds one
    exclusive ``fcntl`` lock on ``_build/build.lock``: test workers that
    import the port at the same time wait for the first to build instead of
    compiling over each other. Returns the compiler's output when it
    built, None when ``out`` was already current."""

    def stale() -> bool:
        if not os.path.exists(out):
            return True
        built = os.path.getmtime(out)
        return any(os.path.getmtime(s) > built for s in sources)

    if not stale():
        return None
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not stale():  # another process built it while we waited
            return None
        tmp = f"{out}.tmp{os.getpid()}"
        proc = subprocess.run(command(tmp), capture_output=True, text=True)
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise DMLCError(f"building {os.path.basename(out)} failed "
                            f"(exit {proc.returncode}):\n"
                            f"{(proc.stdout + proc.stderr)[-4000:]}")
        os.replace(tmp, out)
        return proc.stdout + proc.stderr
