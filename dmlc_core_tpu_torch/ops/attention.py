"""Dense multi-head attention — the single-device oracle the ring path is
checked against, plus a blockwise (flash-style) local variant.

Port of ``dmlc_core_tpu/ops/attention.py`` with its math kept as written:
float32 scores, ``-1e30`` masks (not ``-inf``), the ``max(sum, 1e-30)``
guard, the ``shift``/``alpha`` guards for rows that are fully masked,
and the cast back to ``q.dtype``. ``scaled_dot_product_attention`` is no
substitute: its masking and accumulation differ, and
:func:`mha_reference` is the dense oracle every ring test is held to.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["mha_reference", "blockwise_attention", "NEG_INF"]

NEG_INF = -1e30


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = False,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Exact softmax attention. q [B, L, H, D], k/v [B, S, H, D]."""
    D = q.shape[-1]
    if scale is None:
        scale = D ** -0.5
    scores = torch.einsum("blhd,bshd->blhs", q.float(), k.float()) * scale
    if causal:
        L, S = q.shape[1], k.shape[1]
        mask = (torch.arange(L, device=q.device)[:, None]
                >= torch.arange(S, device=q.device)[None, :])
        scores = torch.where(mask[None, :, None, :], scores,
                             scores.new_tensor(NEG_INF))
    w = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    w = w / torch.clamp_min(w.sum(dim=-1, keepdim=True), 1e-30)
    out = torch.einsum("blhs,bshd->blhd", w, v.float())
    return out.to(q.dtype)


def online_update(m, s, o, qf, k_blk, v_blk, mask=None):
    """One online-softmax accumulation of ``(qf · k_blk) v_blk`` into the
    running (max, denominator, numerator) ``(m, s, o)``.

    qf [B, Lc, H, D] (pre-scaled), k/v [B, Mc, H, D], mask [Lc, Mc] or
    None (every score live). A row whose scores are all masked keeps a
    zero shift, and ``alpha`` is exactly 0 while ``m`` is still
    ``NEG_INF``, so such a row never produces ``exp(-inf - -inf)``."""
    scores = torch.einsum("blhd,bmhd->blhm", qf, k_blk.float())
    neg = scores.new_tensor(NEG_INF)
    if mask is not None:
        scores = torch.where(mask[None, :, None, :], scores, neg)
    m_new = torch.maximum(m, scores.amax(dim=-1))
    shift = torch.where(m_new <= NEG_INF, torch.zeros_like(m_new), m_new)
    pij = torch.exp(scores - shift[..., None])
    if mask is not None:
        pij = torch.where(mask[None, :, None, :], pij,
                          torch.zeros_like(pij))
    alpha = torch.exp(torch.where(m <= NEG_INF, neg, m - shift))
    s = s * alpha + pij.sum(dim=-1)
    o = o * alpha[..., None] + torch.einsum("blhm,bmhd->blhd", pij,
                                            v_blk.float())
    return m_new, s, o


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        block_size: int = 512, causal: bool = False,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Single-device online-softmax attention over key blocks.

    The same math as :func:`mha_reference` without the full [L, S] score
    matrix: keys are padded to whole blocks, padded keys masked out."""
    B, L, H, D = q.shape
    S = k.shape[1]
    if scale is None:
        scale = D ** -0.5
    nblk = -(-S // block_size)
    pad = nblk * block_size - S
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    qf = q.float() * scale
    q_pos = torch.arange(L, device=q.device)
    m = qf.new_full((B, L, H), NEG_INF)
    s = qf.new_zeros((B, L, H))
    o = qf.new_zeros((B, L, H, D))
    for b in range(nblk):
        k_pos = b * block_size + torch.arange(block_size, device=q.device)
        valid = (k_pos < S)[None, :].expand(L, block_size)
        if causal:
            valid = valid & (q_pos[:, None] >= k_pos[None, :])
        blk = slice(b * block_size, (b + 1) * block_size)
        m, s, o = online_update(m, s, o, qf, kp[:, blk], vp[:, blk],
                                mask=valid)
    return (o / torch.clamp_min(s, 1e-30)[..., None]).to(q.dtype)
