"""Plain reference of DLRM-DCNv2 trained by Adagrad (``dlrm_dcnv2``): the
benchmark's copy of ``tests/reference_dlrm.py``, working on the table
rows the checked steps look up.

Plain PyTorch in float64 (or a lower precision for the control), TF32
off, on the card where there is one (the host where not); nothing of the
program. Margins (the bottom MLP over the dense values, sum-pooled bags,
the low-rank cross network, the top MLP), the mean logistic loss,
autograd's gradients, elementwise Adagrad for the dense leaves and
row-wise Adagrad (FBGEMM's ``EXACT_ROW_WISE_ADAGRAD``) for the table rows
a batch looked up, from the accumulators given (``acc_<leaf>``). The
tables and their accumulators enter as the rows the first ``steps``
batches look up (``table<t>``, ``acc_table<t>``, ascending): rows outside
them neither enter those steps nor change, so the result is the whole
model's. The accumulators are compared too: after the first step each
holds the square of the gradient that Adagrad's step divides away.
Departures from the sources, none changing a number: the tables laid end
to end, bags summed in ``index_add``'s order, the loss written stably,
one device (no all-to-all, no all-reduce).
"""

from __future__ import annotations

import numpy as np
import torch


def _rows(arr, model, n):
    """Sorted rows of the concatenated tables the first ``n`` rows of
    ``arr`` look up, and each one's table."""
    ids = np.asarray(arr["col"][:n]).ravel() - model["dense_features"]
    ids = np.unique(ids[ids >= 0])
    ends = np.cumsum(model["num_embeddings_per_feature"])
    return ids, np.searchsorted(ends, ids, side="right")


def margins(p, gid, col, val, model):
    """Margins [R]: ``p`` the leaves (``table`` the looked-up rows,
    ``gid`` their sorted row numbers), ``col``/``val`` [R, nnz]."""
    nd = model["dense_features"]
    T = len(model["num_embeddings_per_feature"])
    R, dev, dtype = col.shape[0], col.device, p["table"].dtype
    row = torch.arange(R, device=dev).repeat_interleave(col.shape[1])
    col, val = col.reshape(-1), val.reshape(-1).to(dtype)
    dense = col < nd
    x = torch.zeros((R, nd), dtype=dtype, device=dev)
    x.index_put_((row[dense], col[dense]), val[dense], accumulate=True)
    ids = col[~dense] - nd
    ends = torch.as_tensor(np.cumsum(model["num_embeddings_per_feature"]),
                           device=dev)
    t = torch.searchsorted(ends, ids, right=True)
    emb = p["table"][torch.searchsorted(gid, ids)]
    bags = torch.zeros((R * T, emb.shape[1]), dtype=dtype, device=dev)
    bags = bags.index_add(0, row[~dense] * T + t, emb)
    h = x
    for i in range(len(model["dense_arch_layer_sizes"])):
        h = torch.relu(h @ p[f"bottom{i}_w"].T + p[f"bottom{i}_b"])
    x0 = torch.cat([h, bags.view(R, -1)], dim=1)
    xl = x0
    for i in range(model["dcn_num_layers"]):
        xl = x0 * ((xl @ p[f"cross{i}_v"].T) @ p[f"cross{i}_w"].T
                   + p[f"cross{i}_b"]) + xl
    n_top = len(model["over_arch_layer_sizes"])
    for i in range(n_top):
        xl = xl @ p[f"top{i}_w"].T + p[f"top{i}_b"]
        if i + 1 < n_top:
            xl = torch.relu(xl)
    return xl[:, 0]


def train(arr: dict, p0: dict, batch_rows: int, steps: int, model: dict,
          dtype=torch.float64) -> dict:
    """Losses of ``steps`` Adagrad steps over consecutive batches of
    ``batch_rows`` rows, and the leaves (weights and accumulators) before
    and after each."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    lr, eps = model["learning_rate"], model["adagrad_eps"]
    gid_np, tab = _rows(arr, model, steps * batch_rows)
    T = len(model["num_embeddings_per_feature"])
    counts = np.bincount(tab, minlength=T)
    names = [k for k in p0 if not k.startswith(("table", "acc_"))]

    def leaves(pre):
        out = {k: torch.as_tensor(np.asarray(p0[pre + k])).to(dev, dtype)
               for k in names}
        out["table"] = torch.cat([
            torch.as_tensor(np.asarray(p0[f"{pre}table{t}"]))
            for t in range(T)]).to(dev, dtype)
        return out

    # the weights and the accumulators Adagrad starts from
    p, acc = leaves(""), leaves("acc_")
    if p["table"].shape[0] != len(gid_np):
        raise ValueError("the table leaves hold other rows than the "
                         "checked steps look up")
    gid = torch.as_tensor(gid_np, device=dev)

    def snapshot():
        out = {}
        for pre, src in (("", p), ("acc_", acc)):
            out.update((pre + k, src[k].double().cpu().numpy().copy())
                       for k in names)
            for t, rows in enumerate(torch.split(src["table"],
                                                 counts.tolist())):
                out[f"{pre}table{t}"] = rows.double().cpu().numpy().copy()
        return out

    params, losses = [snapshot()], []
    for s in range(steps):
        lo, hi = s * batch_rows, (s + 1) * batch_rows
        col = torch.as_tensor(np.asarray(arr["col"][lo:hi]), device=dev)
        val = torch.as_tensor(np.asarray(arr["val"][lo:hi]), device=dev)
        y = torch.as_tensor(np.asarray(arr["label"][lo:hi]), device=dev,
                            dtype=dtype)
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        m = margins(leaves, gid, col, val, model)
        loss = (torch.clamp(m, min=0) - m * y
                + torch.log1p(torch.exp(-m.abs()))).mean()
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        ids = col.reshape(-1)
        looked_up = torch.searchsorted(
            gid, torch.unique(ids[ids >= model["dense_features"]]
                              - model["dense_features"]))
        with torch.no_grad():
            for k in names:
                g = grads[k]
                acc[k] = acc[k] + g * g
                p[k] = p[k] - lr * g / (acc[k].sqrt() + eps)
            g = grads["table"][looked_up]
            a = acc["table"][looked_up] + (g * g).mean(dim=1)
            acc["table"][looked_up] = a
            p["table"] = p["table"].clone()
            p["table"][looked_up] -= (lr / (a.sqrt() + eps))[:, None] * g
        losses.append(float(loss.detach()))
        params.append(snapshot())
    return {"loss": losses, "params": params}
