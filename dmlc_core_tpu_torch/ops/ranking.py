"""Ranking ops over qid-grouped PaddedBatch shards (port of
``ops/ranking.py``).

The device layout carries qid as a [D, R] int32 plane, and the pairwise
loss is one masked [R, R] broadcast: static shapes, no data-dependent
control flow. Functions work on ONE shard (no leading device axis). Pairs
form only within a shard: a query whose rows straddle a shard or batch
boundary contributes its cross-boundary pairs to neither side.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["pairwise_logistic_loss"]


def pairwise_logistic_loss(margin: torch.Tensor, label: torch.Tensor,
                           qid: torch.Tensor, weight: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RankNet-style pairwise loss for one shard.

    margin/label/qid/weight: [R]. Pair (i, j) counts when qid_i == qid_j,
    label_i > label_j, and both rows are real (weight > 0 and qid >= 0;
    padding rows and qid-less rows never pair). The pair weight is
    w_i * w_j. loss(i, j) = log1p(exp(-(margin_i - margin_j))). Returns
    (weighted loss sum, pair weight sum).

    Gradients at ``diff == 0`` (every pair at zero init) are the
    reference's: ``jnp.maximum`` splits the tie in half, as
    ``torch.maximum`` does, and ``jnp.abs`` has slope +1 at 0, which
    torch's ``abs`` (slope 0) does not, so |diff| is written as a where.
    Each pair's gradient in ``diff`` is then -1.0 there, not -0.5.

    Memory: [R, R] temporaries, R being rows per shard.
    """
    same_q = qid[:, None] == qid[None, :]
    ordered = label[:, None] > label[None, :]
    real = (weight > 0) & (qid >= 0)
    valid = same_q & ordered & real[:, None] & real[None, :]
    diff = margin[:, None] - margin[None, :]
    abs_diff = torch.where(diff >= 0, diff, -diff)
    per_pair = torch.maximum(-diff, torch.zeros_like(diff)) + torch.log1p(
        torch.exp(-abs_diff))
    zero = torch.zeros((), dtype=margin.dtype, device=margin.device)
    pair_w = torch.where(valid, weight[:, None] * weight[None, :], zero)
    # mask with where, not multiplication: a non-finite margin on a masked
    # row would otherwise leak NaN through 0 * inf, and where also zeroes
    # the masked entries' gradients
    return torch.where(valid, per_pair * pair_w, zero).sum(), pair_w.sum()
