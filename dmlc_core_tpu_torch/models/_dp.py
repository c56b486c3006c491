"""Shared data-parallel step harness for the margin models (port of
``models/_dp.py``).

A step unpacks the batch's one shard and takes the local loss sum, weight
sum and gradients with autograd. Without a mesh it divides by
``max(weight_sum, 1)`` and applies the model's update. With a mesh (a
``DataMesh``: one device per rank) every rank packs (loss_sum, wsum, the
number of ranks that had a batch, the gradients in the params' field
order) into ONE flat float32 buffer, sums it over the world with ONE
``all_reduce`` — the reference's psum over its mesh, the Rabit allreduce
equivalent — and applies the same update to the same reduced bits, so the
ranks' parameters stay bit-identical. The update uses the global weight
sum, so a world steps exactly as one process on the union of its shards
does: the reference's mesh branch, which steps with D times the learning
rate on a mesh of D devices, is not copied (ROADMAP.md section 3).

A rank whose part has no batch left steps with ``batch=None``: it adds
zeros (loss, weight, gradients) to the reduction, so the ranks issue the
same collectives and the global mean stays the mean over real rows. When
no rank had a batch the step applies nothing and :attr:`last_active` is
0, which ends the epoch everywhere at once.

Subclasses implement:
  _shard_loss(params, shard, rows_per_shard) -> (loss_sum, weight_sum)
  _apply(params, grads, denom) -> new params
"""

from __future__ import annotations

from typing import Tuple

import torch

from dmlc_core_tpu_torch.device.device_iter import unpack_shard
from dmlc_core_tpu_torch.device.sharding import local_device_count
from dmlc_core_tpu_torch.parallel.distributed import allreduce_sum_

__all__ = ["DataParallelModel"]


class DataParallelModel:
    """Mixin: the step over packed or named batch trees. Parameters are a
    NamedTuple of float32 tensors."""

    mesh = None
    # ranks that stepped on a batch in the last mesh step
    last_active = None

    def _shard_loss(self, params, shard, rows_per_shard: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def _apply(self, params, grads, denom):
        raise NotImplementedError

    def _local(self, params, batch):
        """(loss_sum, weight_sum, grads) of this rank's batch."""
        tree = batch.tree()
        D = (tree["aux"].shape[0] if "aux" in tree
             else tree["label"].shape[0])
        n_dev = local_device_count(self.mesh)
        if D != n_dev:
            # the step reads shard [0] only; a mismatch would silently
            # train on 1/D of the rows
            raise ValueError(
                f"batch device axis D={D} != devices per rank {n_dev}; "
                f"build the batch with num_shards={n_dev}")
        shard = unpack_shard({k: v[0] for k, v in tree.items()})
        cls = type(params)
        leaves = [p.detach().requires_grad_(True) for p in params]
        loss_sum, wsum = self._shard_loss(cls(*leaves), shard,
                                          batch.rows_per_shard)
        grads = torch.autograd.grad(loss_sum, leaves)
        return loss_sum.detach(), wsum.detach(), grads

    def _reduce(self, loss_sum, wsum, grads, active: float):
        """Sum (loss_sum, wsum, active, grads) over the mesh in one
        all_reduce of one flat float32 buffer."""
        head = torch.stack([loss_sum.float(), wsum.float(),
                            torch.full_like(wsum, active,
                                            dtype=torch.float32)])
        flat = torch.cat([head] + [g.reshape(-1) for g in grads])
        if self.mesh.group is not None:
            allreduce_sum_(flat, self.mesh.group)
        parts = torch.split(flat, [3] + [g.numel() for g in grads])
        grads = tuple(p.view_as(g) for p, g in zip(parts[1:], grads))
        return parts[0][0], parts[0][1], int(parts[0][2]), grads

    def step(self, params, batch):
        """One training step on a device batch; returns (params, loss).
        With a mesh, ``batch=None`` is the zero-weight step of a rank
        whose part ran out."""
        cls = type(params)
        if batch is None:
            if self.mesh is None:
                raise ValueError("batch=None is the zero-weight step of a "
                                 "mesh rank whose part ran out; without a "
                                 "mesh there is nothing to step")
            zero = torch.zeros((), dtype=torch.float32,
                               device=params[0].device)
            loss_sum, wsum, active = zero, zero, 0.0
            grads = tuple(torch.zeros_like(p) for p in params)
        else:
            loss_sum, wsum, grads = self._local(params, batch)
            active = 1.0
        if self.mesh is not None:
            loss_sum, wsum, self.last_active, grads = self._reduce(
                loss_sum, wsum, grads, active)
            if self.last_active == 0:  # every rank is out of batches
                return params, loss_sum
        with torch.no_grad():
            denom = torch.clamp(wsum, min=1.0)
            new = self._apply(cls(*(p.detach() for p in params)),
                              cls(*grads), denom)
        return new, loss_sum / denom
