"""Plain reference of a linear model trained by SGD (``higgs_lr``).

Plain PyTorch on the host, in float64 (or, for the control, a lower
precision): margins ``x · w + b`` over each row's nonzeros, the
objective's loss summed over the batch and divided by its rows, its
gradient by autograd, and ``p − lr · (g / rows + l2 · p)``. It takes the
generated rows (``label`` [N], ``col`` [N, nnz], ``val`` [N, nnz]) and
the starting parameters as numpy arrays, and nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

LEAVES = ("w", "b")


def loss_sum(margin: torch.Tensor, y: torch.Tensor,
             objective: str) -> torch.Tensor:
    if objective == "logistic":
        # log(1 + e^m) − m·y, written stably
        return (torch.clamp(margin, min=0) - margin * y
                + torch.log1p(torch.exp(-margin.abs()))).sum()
    if objective == "squared":
        return (0.5 * (margin - y) ** 2).sum()
    raise ValueError(f"the reference has no objective {objective!r}")


def margin(p: dict, col: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    return (p["w"][col] * val).sum(dim=1) + p["b"]


def train(arr: dict, p0: dict, batch_rows: int, steps: int, model: dict,
          dtype=torch.float64, margin_fn=margin) -> dict:
    """Losses of ``steps`` SGD steps over consecutive batches of
    ``batch_rows`` rows, and the parameters before and after each."""
    lr, l2 = model["learning_rate"], model.get("l2", 0.0)
    p = {k: torch.as_tensor(np.asarray(v), dtype=dtype) for k, v in p0.items()}
    params = [{k: v.clone() for k, v in p.items()}]
    losses = []
    for s in range(steps):
        lo, hi = s * batch_rows, (s + 1) * batch_rows
        col = torch.as_tensor(np.array(arr["col"][lo:hi]), dtype=torch.long)
        val = torch.as_tensor(arr["val"][lo:hi], dtype=dtype)
        y = torch.as_tensor(arr["label"][lo:hi], dtype=dtype)
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        total = loss_sum(margin_fn(leaves, col, val), y, model["objective"])
        grads = torch.autograd.grad(total, list(leaves.values()))
        rows = hi - lo
        with torch.no_grad():
            p = {k: v - lr * (g / rows + (l2 * v if k != "b" else 0))
                 for (k, v), g in zip(leaves.items(), grads)}
        losses.append(float(total.detach()) / rows)
        params.append({k: v.clone() for k, v in p.items()})
    return {"loss": losses,
            "params": [{k: v.double().numpy() for k, v in q.items()}
                       for q in params]}
