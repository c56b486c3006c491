"""Factorization machine (port of ``models/fm.py``).

Margin (Rendle's O(NNZ·K) identity):

    y(x) = b + Σ_i w_i x_i + ½ Σ_f [ (Σ_i V_{i,f} x_i)² − Σ_i V_{i,f}² x_i² ]

CSR shards go to ``ops/hopper_kernels.py::fm_csr_kernel``: on the card
its hand-written kernel pair (``csrc/fm_csr.cu``), for any rank, walks
each row's own nonzeros of the row plane and never the padding (row id ==
num_rows) when the rows are in order with the padding at the tail, as
every batcher lays them out, and adds nonzero by nonzero, with the same
result, when they are not; on the CPU its plain version computes the two inner sums with
one gather ``V[col]`` and two segment-sums over the row ids, the layout of
``ops/sparse.py``, where the padding (value 0) vanishes. With telemetry
on, the learner counts each shard whose margin took the kernel
(``fm_kernel_steps``), on the host. Dense batches compute them
as ``x @ V`` and ``x² @ V²``, two plain matrix products. The loss is the
shared ``objective_loss`` (logistic, squared, pairwise), and the update is
SGD with decoupled L2 on ``w`` and ``v``. The scoring server's ``fm`` kind
calls :func:`_fm_margin_csr`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dmlc_core_tpu_torch import telemetry
from dmlc_core_tpu_torch.base import resolve_device
from dmlc_core_tpu_torch.device.device_iter import (to_device_batch,
                                                    unpack_tree)
from dmlc_core_tpu_torch.device.sharding import check_mesh
from dmlc_core_tpu_torch.models._dp import DataParallelModel
from dmlc_core_tpu_torch.models.linear import objective_loss
from dmlc_core_tpu_torch.ops.hopper_kernels import fm_csr_kernel

__all__ = ["FMParams", "FMLearner"]


class FMParams(NamedTuple):
    b: torch.Tensor   # []
    w: torch.Tensor   # [F]
    v: torch.Tensor   # [F, K] interaction factors


def _fm_margin_csr(params: FMParams, row: torch.Tensor, col: torch.Tensor,
                   val: torch.Tensor, num_rows: int) -> torch.Tensor:
    """FM margins [num_rows] of one CSR shard, in the kernel's types:
    int64 ids (below 2^31) and bf16 values are cast to int32 and float32,
    which changes no value."""
    return fm_csr_kernel(params.b, params.w, params.v,
                         row.to(torch.int32).contiguous(),
                         col.to(torch.int32).contiguous(),
                         val.float().contiguous(), num_rows)


def _fm_margin_dense(params: FMParams, x: torch.Tensor) -> torch.Tensor:
    """FM margins [..., R] of dense rows x [..., R, F] (f32 or bf16)."""
    xf = x.float()
    linear = xf @ params.w
    s1 = xf @ params.v                          # [R, K]
    s2 = (xf * xf) @ (params.v * params.v)      # [R, K]
    inter = 0.5 * torch.sum(s1 * s1 - s2, dim=-1)
    return params.b + linear + inter


def _margin(params: FMParams, shard, num_rows: int) -> torch.Tensor:
    if "x" in shard:
        return _fm_margin_dense(params, shard["x"])
    if params.v.is_cuda and telemetry.enabled():
        telemetry.counter("fm_kernel_steps").inc()
    return _fm_margin_csr(params, shard["row"], shard["col"], shard["val"],
                          num_rows)


class FMLearner(DataParallelModel):
    """Second-order factorization machine on one device, or on every rank
    of a ``DataMesh`` (``mesh=``).

    Usage::

        learner = FMLearner(num_features=1 << 20, k=8)
        params = learner.init(seed=0)
        for batch in DeviceRowBlockIter(uri, layout="csr"):
            params, loss = learner.step(params, batch)

    ``device`` defaults to the mesh's device, else ``cuda`` (raises
    without CUDA); pass ``device="cpu"`` to run on the CPU."""

    def __init__(self, num_features: int, k: int = 8, mesh=None,
                 objective: str = "logistic", learning_rate: float = 0.05,
                 l2: float = 0.0, init_scale: float = 0.01, device=None):
        if k <= 0:
            raise ValueError(f"factor rank k must be positive, got {k}")
        check_mesh(mesh)
        self.mesh = mesh
        self.num_features = num_features
        self.k = k
        self.objective = objective
        self.learning_rate = learning_rate
        self.l2 = l2
        self.init_scale = init_scale
        self.device = (mesh.device if device is None and mesh is not None
                       else resolve_device(device))

    def init(self, seed: int = 0) -> FMParams:
        """Zero linear part and small normal factors (an all-zero V has
        zero interaction gradient), drawn on the CPU from a
        ``torch.Generator`` seeded with ``seed``, then moved to the
        learner's device. The stream is torch's, not JAX's: parity runs
        start both packages from the same numpy parameters instead."""
        v = self.init_scale * torch.randn(
            (self.num_features, self.k),
            generator=torch.Generator().manual_seed(seed),
            dtype=torch.float32)
        return FMParams(
            b=torch.zeros((), dtype=torch.float32, device=self.device),
            w=torch.zeros((self.num_features,), dtype=torch.float32,
                          device=self.device),
            v=v.to(self.device))

    def _shard_loss(self, params, shard, rows_per_shard):
        return objective_loss(_margin(params, shard, rows_per_shard), shard,
                              rows_per_shard, self.objective)

    def _apply(self, params, grads, denom):
        lr, l2 = self.learning_rate, self.l2
        return FMParams(
            b=params.b - lr * grads.b / denom,
            w=params.w - lr * (grads.w / denom + l2 * params.w),
            v=params.v - lr * (grads.v / denom + l2 * params.v))

    @torch.no_grad()
    def predict(self, params: FMParams, batch) -> torch.Tensor:
        """Margins [D, R] (apply sigmoid for probabilities) of a device
        or host batch."""
        R = batch.rows_per_shard
        tree = unpack_tree(to_device_batch(batch, params.w.device).tree())
        if "x" in tree:
            return _fm_margin_dense(params, tree["x"])
        return torch.stack([
            _fm_margin_csr(params, row, col, val, R)
            for row, col, val in zip(tree["row"], tree["col"],
                                     tree["val"])])
