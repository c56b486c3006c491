"""Factorization machine forward (port of ``models/fm.py``, forward only).

Margin (Rendle's O(NNZ·K) identity):

    y(x) = b + Σ_i w_i x_i + ½ Σ_f [ (Σ_i V_{i,f} x_i)² − Σ_i V_{i,f}² x_i² ]

over one CSR shard: one gather ``V[col]`` and two segment-sums over the
row ids, the layout of ``ops/sparse.py``; padding nonzeros (value 0,
row id == num_rows) vanish. The scoring server's ``fm`` kind calls
:func:`_fm_margin_csr`. Training (``FMLearner``) is a later slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dmlc_core_tpu_torch.base import DMLCError
from dmlc_core_tpu_torch.ops.sparse import _segment_sum, csr_matvec

__all__ = ["FMParams", "FMLearner"]


class FMParams(NamedTuple):
    b: torch.Tensor   # []
    w: torch.Tensor   # [F]
    v: torch.Tensor   # [F, K] interaction factors


def _fm_margin_csr(params: FMParams, row: torch.Tensor, col: torch.Tensor,
                   val: torch.Tensor, num_rows: int) -> torch.Tensor:
    """FM margins [num_rows] of one CSR shard."""
    linear = csr_matvec(row, col, val, params.w, num_rows)
    vx = params.v.index_select(0, col) * val[:, None]   # [NNZ, K]
    s1 = _segment_sum(vx, row, num_rows)                # Σ V x   [R, K]
    s2 = _segment_sum(vx * vx, row, num_rows)           # Σ V²x²  [R, K]
    inter = 0.5 * torch.sum(s1 * s1 - s2, dim=-1)
    return params.b + linear + inter


class FMLearner:
    """Not ported yet: constructing one raises and names the ROADMAP item
    that ports it."""

    def __init__(self, *args, **kwargs):
        raise DMLCError("FMLearner is not ported yet (ROADMAP.md queue 1, "
                        "'FM + ranking')")
