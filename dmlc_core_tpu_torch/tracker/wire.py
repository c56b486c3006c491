"""Checked environment parses.

A copy of the env helpers of ``dmlc_core_tpu/tracker/wire.py`` that the
port reads its knobs through: ``env_int_opt`` (the device path),
``env_int``/``env_float``/``env_str`` (the scoring server's
``DMLC_SERVE_*`` settings, the SLO plane, the checkpoint's retry budget).
The wire protocol itself is a later slice.
"""

from __future__ import annotations

import os
from typing import Optional

__all__ = ["env_int_opt", "env_int", "env_float", "env_str"]


def env_int_opt(name: str, env=None) -> Optional[int]:
    """Presence-gated checked parse: None when ``name`` is unset, but a set
    value that is not an integer — empty text included — raises."""
    e = os.environ if env is None else env
    if name not in e:
        return None
    try:
        return int(e[name])
    except ValueError:
        raise RuntimeError(f"{name}={e[name]!r} is not an integer")


def env_int(name: str, default: int, env=None) -> int:
    """Checked int parse: unset or empty gives ``default``; garbage text
    raises instead of silently becoming a value that disables a knob."""
    raw = (os.environ if env is None else env).get(name)
    if raw is None or raw == "":
        return default
    try:
        return int(raw)
    except ValueError:
        raise RuntimeError(f"{name}={raw!r} is not an integer")


def env_float(name: str, default: float, env=None) -> float:
    """Checked float parse (the :func:`env_int` rule for float knobs)."""
    raw = (os.environ if env is None else env).get(name)
    if raw is None or raw == "":
        return default
    try:
        return float(raw)
    except ValueError:
        raise RuntimeError(f"{name}={raw!r} is not a number")


def env_str(name: str, default: Optional[str] = None,
            env=None) -> Optional[str]:
    """String knob: unset or empty returns ``default`` (path-valued knobs
    like ``DMLC_SERVE_ACCESS_LOG`` treat "" as off)."""
    raw = (os.environ if env is None else env).get(name)
    if raw is None or raw == "":
        return default
    return raw
