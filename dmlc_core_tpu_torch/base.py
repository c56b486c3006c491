"""Errors, device resolution and the locked build of native code.

A copy of what the port needs from ``dmlc_core_tpu/base.py``
(:class:`DMLCError`), plus two helpers of its own: the
device rule every entry point follows, and :func:`build_if_stale`, which
builds the native core and the CUDA kernels into ``_build/`` at first use.
"""

from __future__ import annotations

import fcntl
import os
import subprocess
from typing import Callable, List, Optional, Sequence

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(PACKAGE_DIR)
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")


class DMLCError(RuntimeError):
    """Fatal-check failure. Equivalent of ``dmlc::Error`` (logging.h:29)."""


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
