"""Carry parameters over from the reference package.

The reference's parameters are passed as numpy arrays (``np.asarray`` of
each leaf), so this module needs nothing of JAX.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from dmlc_core_tpu_torch.base import resolve_device
from dmlc_core_tpu_torch.models.linear import LinearParams

__all__ = ["linear_params_from_numpy"]


def linear_params_from_numpy(params: Mapping[str, np.ndarray],
                             device=None) -> LinearParams:
    """LinearParams from ``{"w": [F], "b": []}`` numpy arrays, copied as
    float32 onto ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    return LinearParams(
        w=torch.tensor(np.asarray(params["w"], np.float32), device=dev),
        b=torch.tensor(np.asarray(params["b"], np.float32), device=dev))
