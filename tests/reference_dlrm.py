"""Plain reference of DLRM-DCNv2 trained by Adagrad, for the port's tests.

Plain ``torch`` in float64 (or a dtype the caller names), TF32 off, with
nothing of either package: the equations of the model (Naumov et al.
2019, arXiv:1906.00091; Wang et al. 2020, DCN V2, arXiv:2008.13535;
MLCommons ``training/recommendation_v2/torchrec_dlrm``), its loss,
autograd's gradients and both Adagrads written out. No batching, no
caching: one call computes one batch of rows from scratch.

Rows come as ``col`` [R, nnz] and ``val`` [R, nnz]: columns under
``num_dense`` are dense values, a column ``c`` above them is row ``c -
num_dense`` of the tables laid end to end, so table ``t`` holds rows
``offset_t .. offset_t + N_t - 1``. Parameters are a dict of the port's
leaf names: ``bottom<i>_w``/``_b`` (``[out, in]``, ``[out]``),
``cross<l>_v`` ``[rank, width]``, ``cross<l>_w`` ``[width, rank]``,
``cross<l>_b``, ``top<i>_w``/``_b`` and ``table``; accumulators
``acc_<leaf>``, the table's one per row.

Departures from the sources, each with no effect on the numbers:

- the tables are one matrix indexed by the column (TorchRec keeps one a
  table; the rows are the same rows);
- each bag sums its ids in the order ``index_add`` takes them (TorchRec
  pools a jagged tensor in its own order);
- the loss is the logistic loss written stably, as the mean of
  ``max(m, 0) − m·y + log1p(exp(−|m|))`` (``BCEWithLogitsLoss``'s value);
- row-wise Adagrad is written for the rows the batch looked up, as
  FBGEMM's fused ``EXACT_ROW_WISE_ADAGRAD`` updates only those;
- one device: the deployment's all-to-all of bags and all-reduce of dense
  gradients are left out, as in the port.
"""

from __future__ import annotations

from typing import Dict, List

import torch

Params = Dict[str, torch.Tensor]


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _depth(p: Params, prefix: str, suffix: str) -> int:
    return sum(1 for k in p if k.startswith(prefix) and k.endswith(suffix))


def margins(p: Params, col: torch.Tensor, val: torch.Tensor,
            table_rows: List[int], num_dense: int) -> torch.Tensor:
    """Margins [R] of the rows ``col``/``val`` (every entry real)."""
    _no_tf32()
    R = col.shape[0]
    T = len(table_rows)
    dtype = p["table"].dtype
    row = torch.arange(R).repeat_interleave(col.shape[1])
    col = col.reshape(-1).long()
    val = val.reshape(-1).to(dtype)
    dense = col < num_dense
    x = torch.zeros((R, num_dense), dtype=dtype)
    x.index_put_((row[dense], col[dense]), val[dense], accumulate=True)
    ids = col[~dense] - num_dense
    ends = torch.tensor(table_rows).cumsum(0)
    t = torch.searchsorted(ends, ids, right=True)
    bags = torch.zeros((R * T, p["table"].shape[1]), dtype=dtype)
    bags = bags.index_add(0, row[~dense] * T + t, p["table"][ids])
    h = x
    for i in range(_depth(p, "bottom", "_w")):
        h = torch.relu(h @ p[f"bottom{i}_w"].T + p[f"bottom{i}_b"])
    x0 = torch.cat([h, bags.view(R, -1)], dim=1)
    xl = x0
    for i in range(_depth(p, "cross", "_v")):
        xl = x0 * ((xl @ p[f"cross{i}_v"].T) @ p[f"cross{i}_w"].T
                   + p[f"cross{i}_b"]) + xl
    n_top = _depth(p, "top", "_w")
    for i in range(n_top):
        xl = xl @ p[f"top{i}_w"].T + p[f"top{i}_b"]
        if i + 1 < n_top:
            xl = torch.relu(xl)
    return xl[:, 0]


def loss(m: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean logistic loss of margins ``m`` against 0/1 labels ``y``."""
    y = y.to(m.dtype)
    return (torch.clamp(m, min=0) - m * y
            + torch.log1p(torch.exp(-m.abs()))).mean()


def loss_and_grads(p: Params, col, val, y, table_rows, num_dense):
    """(mean loss, {leaf: gradient of the mean loss})."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()
              if not k.startswith("acc_")}
    total = loss(margins(leaves, col, val, table_rows, num_dense), y)
    got = torch.autograd.grad(total, list(leaves.values()))
    return total.detach(), dict(zip(leaves, got))


def adagrad_step(p: Params, g: Params, looked_up: torch.Tensor, lr: float,
                 eps: float) -> Params:
    """One Adagrad step: elementwise for the dense leaves
    (``acc += g²``, ``w −= lr · g / (sqrt(acc) + eps)``), row-wise for
    the table's rows ``looked_up`` (``acc[r] += mean(g[r]²)``, ``w[r] −=
    lr / (sqrt(acc[r]) + eps) · g[r]``); a new dict."""
    out = {k: v.clone() for k, v in p.items()}
    for k, gk in g.items():
        if k == "table":
            continue
        acc = p["acc_" + k] + gk * gk
        out["acc_" + k] = acc
        out[k] = p[k] - lr * gk / (acc.sqrt() + eps)
    r = looked_up
    gr = g["table"][r]
    acc = p["acc_table"][r] + (gr * gr).mean(dim=1)
    out["acc_table"][r] = acc
    out["table"][r] = p["table"][r] - (lr / (acc.sqrt() + eps))[:, None] * gr
    return out


def train(p0: Params, batches, table_rows, num_dense, lr: float,
          eps: float, dtype=torch.float64):
    """Losses and parameters of one Adagrad step on each of ``batches``
    (``(col, val, y)`` triples): ``{"loss": [...], "params": [p0, p1,
    ...]}``."""
    p = {k: torch.as_tensor(v).to(dtype) for k, v in p0.items()}
    params, losses = [p], []
    for col, val, y in batches:
        col = torch.as_tensor(col)
        lval, g = loss_and_grads(p, col, torch.as_tensor(val),
                                 torch.as_tensor(y), table_rows, num_dense)
        ids = col.reshape(-1).long()
        looked_up = torch.unique(ids[ids >= num_dense] - num_dense)
        with torch.no_grad():
            p = adagrad_step(p, g, looked_up, lr, eps)
        losses.append(float(lval))
        params.append(p)
    return {"loss": losses, "params": params}
