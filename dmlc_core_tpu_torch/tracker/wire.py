"""Checked environment parse.

A copy of the one name the device path uses from
``dmlc_core_tpu/tracker/wire.py`` (``env_int_opt``); the wire protocol
itself is a later slice.
"""

from __future__ import annotations

import os
from typing import Optional

__all__ = ["env_int_opt"]


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
