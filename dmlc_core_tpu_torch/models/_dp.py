"""Shared single-device step harness for the margin models (port of
``models/_dp.py``).

A step unpacks the batch's one shard, takes the loss and gradients with
autograd, divides by ``max(weight_sum, 1)``, applies the model's update,
and returns the mean loss. The cross-device reduction of the reference's
mesh branch comes with the multi-device slice.

Subclasses implement:
  _shard_loss(params, shard, rows_per_shard) -> (loss_sum, weight_sum)
  _apply(params, grads, denom) -> new params
"""

from __future__ import annotations

from typing import Tuple

import torch

from dmlc_core_tpu_torch.device.device_iter import unpack_shard
from dmlc_core_tpu_torch.device.sharding import local_device_count

__all__ = ["DataParallelModel"]


class DataParallelModel:
    """Mixin: the step over packed or named batch trees. Parameters are a
    NamedTuple of tensors."""

    mesh = None

    def _shard_loss(self, params, shard, rows_per_shard: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def _apply(self, params, grads, denom):
        raise NotImplementedError

    def step(self, params, batch):
        """One training step on a device batch; returns (params, loss)."""
        tree = batch.tree()
        D = (tree["aux"].shape[0] if "aux" in tree
             else tree["label"].shape[0])
        n_dev = local_device_count(self.mesh)
        if D != n_dev:
            # the step reads shard [0] only; a mismatch would silently
            # train on 1/D of the rows
            raise ValueError(
                f"batch device axis D={D} != mesh size {n_dev}; "
                f"build the batch with num_shards={n_dev}")
        shard = unpack_shard({k: v[0] for k, v in tree.items()})
        cls = type(params)
        leaves = [p.detach().requires_grad_(True) for p in params]
        loss_sum, wsum = self._shard_loss(cls(*leaves), shard,
                                          batch.rows_per_shard)
        grads = torch.autograd.grad(loss_sum, leaves)
        with torch.no_grad():
            denom = torch.clamp(wsum.detach(), min=1.0)
            new = self._apply(cls(*(p.detach() for p in params)),
                              cls(*grads), denom)
        return new, loss_sum.detach() / denom
