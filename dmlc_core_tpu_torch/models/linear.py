"""Sparse linear learner (port of ``models/linear.py``).

Logistic, squared or pairwise (RankNet over qid groups) loss over
PaddedBatch/DenseBatch shards; parameters and math stay float32.
``margin_path="dense"`` materializes the shard
through ``ops.sparse.csr_to_dense`` — with ``DCT_CSR_TO_DENSE=pallas``
that is the hand-written Hopper kernel, once per step — and takes one
matmul; the default ``"segment"`` path gathers and segment-sums.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from dmlc_core_tpu_torch.base import resolve_device
from dmlc_core_tpu_torch.device.device_iter import (to_device_batch,
                                                    unpack_tree)
from dmlc_core_tpu_torch.device.sharding import check_mesh
from dmlc_core_tpu_torch.models._dp import DataParallelModel
from dmlc_core_tpu_torch.ops.ranking import pairwise_logistic_loss
from dmlc_core_tpu_torch.ops.sparse import csr_matvec, csr_to_dense

__all__ = ["LinearParams", "LinearLearner", "objective_loss"]


class LinearParams(NamedTuple):
    w: torch.Tensor  # [F]
    b: torch.Tensor  # []


def objective_loss(margin: torch.Tensor, shard: Dict[str, torch.Tensor],
                   num_rows: int, objective: str
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weighted loss sum, weight sum) of a shard given its margins: the
    objectives shared by every margin model (linear here, the
    factorization machine in models/fm.py). For ``pairwise`` the second
    value is the summed pair weight."""
    y = shard["label"]
    wgt = shard["weight"]  # 0 on padding rows
    if objective == "logistic":
        # stable log-sigmoid cross-entropy, with the reference's gradients
        # at margin == 0 (every row at zero init): jnp.maximum splits the
        # tie in half, as torch.maximum does, and jnp.abs has slope +1
        # there, which torch's abs (slope 0) does not — so |m| is written
        # as a where. The loss gradient at 0 is then -y, not 0.5 - y; a
        # quirk of the reference (ROADMAP.md section 3), mirrored here
        abs_m = torch.where(margin >= 0, margin, -margin)
        per_row = torch.maximum(margin, torch.zeros_like(margin)) - \
            margin * y + torch.log1p(torch.exp(-abs_m))
    elif objective == "squared":
        per_row = 0.5 * (margin - y) ** 2
    elif objective == "pairwise":
        if "qid" not in shard:
            raise ValueError(
                "objective='pairwise' needs qid-grouped data (libsvm "
                "`qid:` column; carried to the device as the qid plane)")
        # the pair mining is an [R, R] broadcast: refuse a shard whose
        # temporaries would not fit (the reference's ceiling)
        if num_rows > 8192:
            raise ValueError(
                f"objective='pairwise' mines pairs in [R, R] space; "
                f"R={num_rows} rows per shard would materialize "
                f"{num_rows * num_rows * 4 / 1e9:.1f} GB temporaries. Use "
                f"batch_rows <= 8192 * num_shards for ranking workloads")
        return pairwise_logistic_loss(margin, y, shard["qid"], wgt)
    else:
        raise ValueError(f"unknown objective {objective!r}")
    return torch.sum(per_row * wgt), torch.sum(wgt)


def _shard_loss(params: LinearParams, shard: Dict[str, torch.Tensor],
                num_rows: int, objective: str, margin_path: str = "segment"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weighted loss sum, weight sum) of one shard. L2 is decoupled weight
    decay in the update, not part of the loss. The dense materialization
    depends only on batch data, so autograd never differentiates through
    the kernel."""
    if "x" in shard:
        margin = shard["x"].float() @ params.w + params.b
    elif margin_path == "dense":
        dense = csr_to_dense(shard["row"], shard["col"], shard["val"],
                             num_rows, params.w.shape[0])
        # bf16 values give a bf16 dense shard; jnp promotes it to f32 in
        # the product, torch needs the cast
        margin = dense.float() @ params.w + params.b
    else:
        margin = csr_matvec(shard["row"], shard["col"], shard["val"],
                            params.w, num_rows) + params.b
    return objective_loss(margin, shard, num_rows, objective)


class LinearLearner(DataParallelModel):
    """Sparse linear model on one device, or on every rank of a
    ``DataMesh`` (``mesh=``: one all_reduce a step, see ``models/_dp.py``).

    Usage::

        learner = LinearLearner(num_features=28, margin_path="dense")
        params = learner.init()
        for batch in DeviceRowBlockIter(uri, layout="csr"):
            params, loss = learner.step(params, batch)

    ``device`` defaults to the mesh's device, else ``cuda`` (raises
    without CUDA); pass ``device="cpu"`` to run on the CPU."""

    def __init__(self, num_features: int, mesh=None,
                 objective: str = "logistic", learning_rate: float = 0.1,
                 l2: float = 0.0, margin_path: str = "segment",
                 device=None):
        check_mesh(mesh)
        self.mesh = mesh
        self.num_features = num_features
        self.objective = objective
        self.learning_rate = learning_rate
        self.l2 = l2
        self.margin_path = margin_path
        self.device = (mesh.device if device is None and mesh is not None
                       else resolve_device(device))

    def init(self, seed: int = 0) -> LinearParams:
        """Zero parameters on the learner's device (zero init is canonical
        for a linear model, so ``seed`` is unused)."""
        del seed
        return LinearParams(
            w=torch.zeros((self.num_features,), dtype=torch.float32,
                          device=self.device),
            b=torch.zeros((), dtype=torch.float32, device=self.device))

    def _shard_loss(self, params, shard, rows_per_shard):
        return _shard_loss(params, shard, rows_per_shard, self.objective,
                           self.margin_path)

    def _apply(self, params, grads, denom):
        lr, l2 = self.learning_rate, self.l2
        return LinearParams(
            w=params.w - lr * (grads.w / denom + l2 * params.w),
            b=params.b - lr * grads.b / denom)

    @torch.no_grad()
    def predict(self, params: LinearParams, batch) -> torch.Tensor:
        """Margins [D, R] (apply sigmoid for probabilities) of a device
        or host batch."""
        R = batch.rows_per_shard
        tree = unpack_tree(to_device_batch(batch, params.w.device).tree())
        if "x" in tree:
            return tree["x"].float() @ params.w + params.b
        return torch.stack([
            csr_matvec(row, col, val, params.w, R) + params.b
            for row, col, val in zip(tree["row"], tree["col"],
                                     tree["val"])])
