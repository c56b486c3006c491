"""Collectives over one mesh axis, with their transposes written by hand.

The counterpart of ``lax.ppermute``, ``lax.psum`` and ``lax.axis_index``
inside ``shard_map``. In JAX, autodiff transposes these collectives on
its own; ``torch.distributed`` calls carry no gradient, so each one here
is a ``torch.autograd.Function`` whose backward is the transpose, stated
in its docstring. One wrong transpose multiplies a gradient by the axis
size, which is why the parity tests hold gradients, not only values.

An axis is named by its process group (``ProcessMesh.group_of(name)``);
``None`` is an axis of size 1, on which every function is the identity
and no ``torch.distributed`` world is needed. Ranks in a perm are the
axis's own (0 .. size - 1). Under gloo, which moves host tensors,
device tensors are staged through the host, as
``parallel.distributed.allreduce_sum_`` does; under NCCL they stay on the
card. Every rank of the axis must make the same calls in the same order,
forward and backward alike: a rank that uses a result another rank drops
leaves its peers waiting in the backward. A failed call raises a
``torch.distributed.DistError`` (``distributed.collective_call``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from dmlc_core_tpu_torch.parallel.distributed import collective_call

__all__ = ["axis_size", "axis_index", "ppermute", "psum", "psum_bcast",
           "copy_to_group", "all_gather", "shard", "exchange"]

Perm = Sequence[Tuple[int, int]]


def axis_size(group) -> int:
    """The number of ranks on the axis (``lax.psum(1, axis)``)."""
    return 1 if group is None else dist.get_world_size(group)


def axis_index(group) -> int:
    """This rank's position on the axis (``lax.axis_index``)."""
    return 0 if group is None else dist.get_rank(group)


def _comm_device(group, like: torch.Tensor) -> torch.device:
    if dist.get_backend(group) == "nccl":
        return like.device
    return torch.device("cpu")


def exchange(x: torch.Tensor, send_to: Optional[int],
             recv_from: Optional[int], group) -> torch.Tensor:
    """Send ``x`` to axis rank ``send_to`` and receive a tensor shaped like
    it from ``recv_from`` in one batch of point-to-point calls, so a ring
    of exchanges cannot deadlock; zeros where nothing is received."""
    me = axis_index(group)
    if send_to == me and recv_from == me:
        return x.clone()
    comm = _comm_device(group, x)
    out = torch.zeros(x.shape, dtype=x.dtype, device=comm)
    ops = []
    if recv_from is not None:
        ops.append(dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(group, recv_from),
                              group))
    if send_to is not None:
        ops.append(dist.P2POp(dist.isend, x.detach().to(comm).contiguous(),
                              dist.get_global_rank(group, send_to), group))
    if ops:
        with collective_call():
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    return out.to(x.device)


def _permute(x: torch.Tensor, perm: Perm, group) -> torch.Tensor:
    me = axis_index(group)
    send_to = next((d for s, d in perm if s == me), None)
    recv_from = next((s for s, d in perm if d == me), None)
    return exchange(x, send_to, recv_from, group)


class _PPermute(torch.autograd.Function):
    """Forward: the output at ``dst`` is the input at ``src`` for each
    ``(src, dst)`` of ``perm``; zeros on a rank no pair sends to.
    Backward: the same move along the inverse permutation — each
    cotangent goes back to the rank its value came from."""

    @staticmethod
    def forward(ctx, x, perm, group):
        ctx.perm, ctx.group = perm, group
        return _permute(x, perm, group)

    @staticmethod
    def backward(ctx, g):
        inverse = [(d, s) for s, d in ctx.perm]
        return _permute(g, inverse, ctx.group), None, None


def ppermute(x: torch.Tensor, perm: Perm, group) -> torch.Tensor:
    """``lax.ppermute`` over the axis (see :class:`_PPermute`)."""
    if group is None:
        return x if any(s == d == 0 for s, d in perm) else torch.zeros_like(x)
    return _PPermute.apply(x, [tuple(p) for p in perm], group)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    buf = x.detach().to(_comm_device(group, x)).clone()
    with collective_call():
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(x.device)


class _PSum(torch.autograd.Function):
    """Forward: the sum over the axis. Backward: the sum of the
    cotangents over the axis — the transpose of a sum of device-varying
    values, each rank's cotangent being its own."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _PSumBcast(torch.autograd.Function):
    """Forward: the sum over the axis. Backward: the identity. The
    result is replicated, so each rank's cotangent is already the whole
    cotangent; summing them again would multiply the gradient by the axis
    size. This is the transpose varying-typed JAX gives ``lax.psum`` of a
    replicated output, and Megatron's "g" after a row-parallel matmul."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToGroup(torch.autograd.Function):
    """Forward: the identity (a replicated value entering a region where
    each rank computes its own part). Backward: the sum of the cotangents
    over the axis, since each rank's is only its part's. Megatron's "f"
    before a column-parallel matmul."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce sum with a summing backward (:class:`_PSum`): the
    counterpart of ``lax.psum`` of a device-varying value. Neither model
    calls it (their gradients are reduced after the backward, with
    ``distributed.allreduce_sum_``); it is kept for parity with the
    reference's collectives, and the tests hold its transpose."""
    return x if group is None else _PSum.apply(x, group)


def psum_bcast(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce sum with an identity backward (:class:`_PSumBcast`)."""
    return x if group is None else _PSumBcast.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity with an all-reduce backward (:class:`_CopyToGroup`)."""
    return x if group is None else _CopyToGroup.apply(x, group)


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    comm = _comm_device(group, x)
    part = x.detach().to(comm).contiguous()
    parts = [torch.empty_like(part) for _ in range(axis_size(group))]
    with collective_call():
        dist.all_gather(parts, part, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


def _own_chunk(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x.chunk(axis_size(group), dim=dim)[axis_index(group)].contiguous()


class _AllGather(torch.autograd.Function):
    """Forward: the ranks' parts concatenated along ``dim`` in axis
    order, on every rank. Backward: this rank's chunk of the cotangent —
    the result is replicated, so its cotangent is the same on every rank
    and each part's share of it is the chunk at its own place."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _own_chunk(g, ctx.dim, ctx.group), None, None


class _Shard(torch.autograd.Function):
    """Forward: this rank's chunk along ``dim`` of a replicated value.
    Backward: the ranks' chunk cotangents concatenated, so every rank
    holds the whole (replicated) cotangent. The transpose pair of
    :class:`_AllGather`."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _own_chunk(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Concatenate the ranks' parts along ``dim`` (:class:`_AllGather`)."""
    return x if group is None else _AllGather.apply(x, dim, group)


def shard(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's chunk of a replicated value along ``dim``
    (:class:`_Shard`)."""
    return x if group is None else _Shard.apply(x, dim, group)
