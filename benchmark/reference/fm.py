"""Plain reference of a second-order factorization machine trained by
SGD (``criteo_fm``).

Rendle's identity over each row's nonzeros, in plain PyTorch on the host
(float64, or a lower precision for the control):

    y(x) = b + Σ_i w_i x_i + ½ Σ_f [ (Σ_i V_{i,f} x_i)² − Σ_i V_{i,f}² x_i² ]

with the linear reference's loss, autograd gradients and update (decoupled
L2 on ``w`` and ``v``). It takes the generated rows and the starting
parameters as numpy arrays, and nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import linear

LEAVES = ("b", "w", "v")


def margin(p: dict, col: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    lin = (p["w"][col] * val).sum(dim=1)
    vx = p["v"][col] * val[..., None]          # [rows, nnz, K]
    s1 = vx.sum(dim=1)
    s2 = (vx * vx).sum(dim=1)
    return p["b"] + lin + 0.5 * (s1 * s1 - s2).sum(dim=1)


def train(arr: dict, p0: dict, batch_rows: int, steps: int, model: dict,
          dtype=torch.float64) -> dict:
    return linear.train(arr, p0, batch_rows, steps, model, dtype, margin)


def scores(arr: dict, p: dict, objective: str, dtype=torch.float64,
           block: int = 65536) -> np.ndarray:
    """Scores of every row (``sigmoid`` of the margin for ``logistic``),
    in blocks of rows."""
    q = {k: torch.as_tensor(np.asarray(v), dtype=dtype) for k, v in p.items()}
    out = []
    with torch.no_grad():
        for lo in range(0, len(arr["label"]), block):
            col = torch.as_tensor(np.array(arr["col"][lo:lo + block]),
                                  dtype=torch.long)
            val = torch.as_tensor(arr["val"][lo:lo + block], dtype=dtype)
            m = margin(q, col, val)
            out.append((torch.sigmoid(m) if objective == "logistic"
                        else m).double().numpy())
    return np.concatenate(out) if out else np.zeros(0)
