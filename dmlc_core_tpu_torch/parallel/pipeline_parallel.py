"""Pipeline parallelism: a GPipe microbatch schedule over a mesh axis.

Port of ``dmlc_core_tpu/parallel/pipeline_parallel.py``. Every rank of
the axis runs the same schedule with its own stage's parameters;
activations move stage to stage with one :func:`~.axis.ppermute` a tick,
and ``M + P - 1`` ticks drain M microbatches through P stages.

The backward pipeline is autograd through the ticks: the transpose of a
ppermute is the reverse ppermute. The last stage's outputs leave through
:func:`~.axis.psum_bcast`, whose backward is the identity: each rank's
loss is the same replicated function of the outputs, so its cotangent is
already the whole cotangent. A summing backward there (JAX's transpose of
``lax.psum`` without varying types, the failure the reference's docstring
records) would hand every stage P times its gradient.
"""

from __future__ import annotations

from typing import Callable

import torch

from dmlc_core_tpu_torch.parallel.axis import (axis_index, axis_size,
                                               ppermute, psum_bcast)

__all__ = ["pipeline_apply"]


def pipeline_apply(stage_fn: Callable, stage_params, microbatches:
                   torch.Tensor, group) -> torch.Tensor:
    """Drain ``microbatches`` [M, ...] (the same on every rank of the axis)
    through the stages; returns the last stage's [M, ...] outputs on every
    rank.

    ``stage_fn(stage_params, x) -> y`` is this rank's stage, with input
    and output of one shape (GPipe's homogeneous stages). Stage 0 injects
    a microbatch a tick while they last; the other stages take what the
    previous stage handed over on the tick before. The selection is a
    ``torch.where`` on every rank, as is the choice of the last stage's
    output, so every handed-over activation enters every rank's graph and
    each backward ppermute has its peers."""
    num_stages = axis_size(group)
    stage = axis_index(group)
    M = microbatches.shape[0]
    first = torch.tensor(stage == 0, device=microbatches.device)
    last = torch.tensor(stage == num_stages - 1, device=microbatches.device)
    zero = torch.zeros_like(microbatches[0])
    fwd = [(i, (i + 1) % num_stages) for i in range(num_stages)]
    state = zero
    outs = []
    ticks = M + num_stages - 1
    for t in range(ticks):
        inject = microbatches[t] if t < M else zero
        y = stage_fn(stage_params, torch.where(first, inject, state))
        if t >= num_stages - 1:
            # the last stage finishes microbatch t - (P-1) on this tick
            outs.append(torch.where(last, y, zero))
        if t < ticks - 1:
            # the wrap-around edge only carries finished outputs back to
            # stage 0's ignored input
            state = ppermute(y, fwd, group)
    return psum_bcast(torch.stack(outs), group)
