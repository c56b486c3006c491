"""Carry parameters between numpy arrays and the port's parameter types.

The reference's parameters are passed as numpy arrays (``np.asarray`` of
each leaf), so this module needs nothing of JAX; the way back gives the
``{"w", "b"}`` / ``{"b", "w", "v"}`` dict that ``serving.model.save_model``
takes and that the reference's parameter types are built from.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from dmlc_core_tpu_torch.base import resolve_device
from dmlc_core_tpu_torch.models.fm import FMParams
from dmlc_core_tpu_torch.models.linear import LinearParams

__all__ = ["linear_params_from_numpy", "linear_params_to_numpy",
           "fm_params_from_numpy", "fm_params_to_numpy"]


def _f32(a, dev) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), device=dev)


def linear_params_from_numpy(params: Mapping[str, np.ndarray],
                             device=None) -> LinearParams:
    """LinearParams from ``{"w": [F], "b": []}`` numpy arrays, copied as
    float32 onto ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    return LinearParams(w=_f32(params["w"], dev), b=_f32(params["b"], dev))


def linear_params_to_numpy(params: LinearParams) -> Dict[str, np.ndarray]:
    """``{"w": [F], "b": []}`` float32 numpy arrays on the host."""
    return {"w": params.w.detach().cpu().numpy(),
            "b": params.b.detach().cpu().numpy()}


def fm_params_from_numpy(params: Mapping[str, np.ndarray],
                         device=None) -> FMParams:
    """FMParams from ``{"b": [], "w": [F], "v": [F, K]}`` numpy arrays,
    copied as float32 onto ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    return FMParams(b=_f32(params["b"], dev), w=_f32(params["w"], dev),
                    v=_f32(params["v"], dev))


def fm_params_to_numpy(params: FMParams) -> Dict[str, np.ndarray]:
    """``{"b": [], "w": [F], "v": [F, K]}`` float32 numpy arrays on the
    host."""
    return {name: getattr(params, name).detach().cpu().numpy()
            for name in FMParams._fields}
