"""Ring collectives and ring attention over a mesh axis.

Port of ``dmlc_core_tpu/parallel/ring.py``. The functions are per-rank
code: each rank of the axis (a process group, see ``parallel/axis.py``)
calls them with its own shard, as the reference's run inside
``shard_map``. The mesh-level wrapper :func:`sequence_parallel_attention`
takes the axis's group where the reference takes a ``Mesh``.

- :func:`ring_allreduce` — reduce-scatter then all-gather, one chunk a
  step to the ring neighbour; equal to a sum over the axis.
- :func:`ring_attention` — K/V blocks rotate around the ring while each
  rank keeps an online-softmax accumulator for its local queries.
- :func:`ring_attention_zigzag` — the causal ring over the balanced
  zigzag layout, computing only the live chunk pairs.

Gradients come from autograd through :func:`~.axis.ppermute`, whose
backward sends each cotangent back around the ring — what JAX's autodiff
derives from ``lax.ppermute``. K and V travel as one stacked tensor, so a
step is one exchange, forward and backward. The last rotation of each
ring, which only brings a block home, is skipped; no number changes.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from dmlc_core_tpu_torch.ops.attention import NEG_INF, online_update
from dmlc_core_tpu_torch.parallel.axis import (all_gather, axis_index,
                                               axis_size, ppermute, shard)

__all__ = ["ring_allreduce", "ring_attention", "ring_attention_zigzag",
           "sequence_parallel_attention", "zigzag_permutation"]


def _ring(p: int):
    return [(i, (i + 1) % p) for i in range(p)]


def ring_allreduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` across the axis with an explicit 2(P-1)-step ring.

    After the reduce-scatter, rank d holds the full sum of chunk
    (d + 1) mod P; the all-gather rotates the finished chunks around."""
    p = axis_size(group)
    if p == 1:
        return x
    me = axis_index(group)
    flat = x.reshape(-1)
    chunk = -(-flat.numel() // p)
    flat = torch.nn.functional.pad(flat, (0, chunk * p - flat.numel()))
    chunks = list(flat.reshape(p, chunk).unbind(0))
    fwd = _ring(p)
    for s in range(p - 1):
        got = ppermute(chunks[(me - s) % p], fwd, group)
        recv = (me - s - 1) % p
        chunks[recv] = chunks[recv] + got
    for s in range(p - 1):
        chunks[(me - s) % p] = ppermute(chunks[(me + 1 - s) % p], fwd,
                                        group)
    return torch.stack(chunks).reshape(-1)[:x.numel()].reshape(x.shape)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group, causal: bool = False,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Blockwise ring attention for sequence-sharded q/k/v.

    Shapes are local: q/k/v [B, L, H, D], the global sequence P*L with
    this rank holding block ``axis_index``. causal=True masks by GLOBAL
    positions: query i attends key j iff global_i >= global_j."""
    p = axis_size(group)
    me = axis_index(group)
    B, L, H, D = q.shape
    if scale is None:
        scale = D ** -0.5
    qf = q.float() * scale
    q_pos = me * L + torch.arange(L, device=q.device)
    m = qf.new_full((B, L, H), NEG_INF)
    s = qf.new_zeros((B, L, H))
    o = torch.zeros_like(qf)
    kv = torch.stack([k, v])
    src = me
    for step in range(p):
        mask = None
        if causal:
            k_pos = src * L + torch.arange(L, device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
        m, s, o = online_update(m, s, o, qf, kv[0], kv[1], mask)
        if step < p - 1:
            # rotate K/V to the next rank; we now hold block src - 1
            kv = ppermute(kv, _ring(p), group)
            src = (src - 1) % p
    out = o / torch.clamp_min(s, 1e-30)[..., None]
    return out.to(q.dtype)


def zigzag_permutation(seq_len: int, num_devices: int,
                       device=None) -> torch.Tensor:
    """Global-index permutation of the zigzag layout: 2P chunks, rank d
    holding [C_d, C_{2P-1-d}]; ``perm[i]`` is the global position stored
    at packed slot i (apply with ``index_select`` on the sequence axis,
    invert with ``argsort``)."""
    p = num_devices
    if seq_len % (2 * p):
        raise ValueError(f"seq_len {seq_len} must divide by 2*P={2 * p}")
    lc = seq_len // (2 * p)
    chunks = []
    for d in range(p):
        chunks.append(torch.arange(d * lc, (d + 1) * lc, device=device))
        hi = 2 * p - 1 - d
        chunks.append(torch.arange(hi * lc, (hi + 1) * lc, device=device))
    return torch.cat(chunks)


def ring_attention_zigzag(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, group,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Causal ring attention over the ZIGZAG layout.

    Local rows are the global chunks (d, 2P-1-d), L = 2*Lc. The
    diagonal step computes the two causal in-chunk pairs and the live
    (q_hi, k_lo) pair; every later step computes exactly two full chunk
    pairs with no mask — (q_lo, k_lo) and (q_hi, k_lo) when the held
    block's source is before this rank, (q_hi, k_lo) and (q_hi, k_hi)
    when after — and never the pairs in the masked future. The choice is
    a branch on host integers, where the reference selects arithmetically
    with 0/1 weights; both pick the same values exactly."""
    p = axis_size(group)
    me = axis_index(group)
    B, L, H, D = q.shape
    if L % 2:
        raise ValueError(f"zigzag local length {L} must be even")
    lc = L // 2
    if scale is None:
        scale = D ** -0.5
    qf = q.float() * scale
    q_lo, q_hi = qf[:, :lc], qf[:, lc:]
    acc = {}
    for half in ("lo", "hi"):
        acc[half] = (qf.new_full((B, lc, H), NEG_INF),
                     qf.new_zeros((B, lc, H)), qf.new_zeros((B, lc, H, D)))
    tri = (torch.arange(lc, device=q.device)[:, None]
           >= torch.arange(lc, device=q.device)[None, :])
    acc["lo"] = online_update(*acc["lo"], q_lo, k[:, :lc], v[:, :lc],
                              mask=tri)
    acc["hi"] = online_update(*acc["hi"], q_hi, k[:, lc:], v[:, lc:],
                              mask=tri)
    acc["hi"] = online_update(*acc["hi"], q_hi, k[:, :lc], v[:, :lc])
    kv = torch.stack([k, v])
    src = me
    for _ in range(p - 1):
        kv = ppermute(kv, _ring(p), group)
        src = (src - 1) % p
        k_l, k_h = kv[0][:, :lc], kv[0][:, lc:]
        v_l, v_h = kv[1][:, :lc], kv[1][:, lc:]
        if src < me:
            acc["lo"] = online_update(*acc["lo"], q_lo, k_l, v_l)
            acc["hi"] = online_update(*acc["hi"], q_hi, k_l, v_l)
        else:
            acc["hi"] = online_update(*acc["hi"], q_hi, k_l, v_l)
            acc["hi"] = online_update(*acc["hi"], q_hi, k_h, v_h)
    s = torch.cat([acc["lo"][1], acc["hi"][1]], dim=1)
    o = torch.cat([acc["lo"][2], acc["hi"][2]], dim=1)
    out = o / torch.clamp_min(s, 1e-30)[..., None]
    return out.to(q.dtype)


def sequence_parallel_attention(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, group,
                                causal: bool = False,
                                layout: str = "contiguous") -> torch.Tensor:
    """Ring attention over the axis of ``group`` for GLOBAL q/k/v
    [B, S, H, D] (S divisible by the axis size, by twice that for
    zigzag), the same on every rank; returns the global output on every
    rank.

    Each rank takes its sequence shard (:func:`~.axis.shard`, whose
    backward gathers the shard cotangents), runs the ring, and the
    outputs are all-gathered (:func:`~.axis.all_gather`, whose backward
    keeps this rank's chunk), so gradients through the call are the
    dense program's on every rank. ``layout="zigzag"`` (causal only)
    permutes the sequence into the zigzag layout first and un-permutes
    the output."""
    p = axis_size(group)
    if layout == "zigzag":
        if not causal:
            raise ValueError("layout='zigzag' balances the CAUSAL mask; "
                             "use the plain ring for bidirectional")
        perm = zigzag_permutation(q.shape[1], p, device=q.device)
        q, k, v = (t.index_select(1, perm) for t in (q, k, v))
        fn = ring_attention_zigzag
    elif layout == "contiguous":
        fn = functools.partial(ring_attention, causal=causal)
    else:
        raise ValueError(f"unknown layout {layout!r}")
    local = [shard(t, 1, group) for t in (q, k, v)]
    out = all_gather(fn(*local, group=group), 1, group)
    if layout == "zigzag":
        out = out.index_select(1, torch.argsort(perm))
    return out
