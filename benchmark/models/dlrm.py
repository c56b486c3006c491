"""The program's side of a ``dlrm`` configuration: the port's
``DLRMLearner`` with the configuration's widths and tables, parameters
drawn here from the seed on the learner's device, and the leaves the
check compares.

The tables are tens of GB, so :func:`leaves` holds every dense leaf and
its Adagrad accumulator whole, but of each table and its row-wise
accumulator only the rows the checked steps look up (``table<t>``,
``acc_table<t>``, in ascending row order): rows outside them neither
enter those steps nor change, so the check loses nothing. :func:`init`
finds those rows from the generator's arrays for the seed.

What the check reads of Adagrad (``benchmark/correct.py``):
:func:`gradient` works the first gradient out of the update and the
accumulator after it, :func:`leaf_kind` keeps the weights' and the
accumulators' norms, which differ by orders of magnitude, apart, and
:data:`LOSS_STEPS` and :data:`CHANGE_MEDIAN_LEAF` compare the first
step's loss and the median leaf's change.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

# `drivers/train_epochs.py`'s set-up steps, whose rows the check replays
CHECK_STEPS = 3
# tables larger than this are refused on the CPU (the tests' runs shrink
# them through the configuration)
CPU_TABLE_BYTES = 1 << 30
# the rows each table's checked steps look up, by the table's address
_CHECK_ROWS: dict = {}
# the losses the check compares: the first step's. Adagrad's first step
# moves every entry by about the learning rate whatever its gradient's
# size, so an entry whose gradient is round-off takes a whole step in a
# direction round-off picks, and the later losses of sound float32 runs
# wander from float64's by up to 1e-3 (the first's by 1e-7)
LOSS_STEPS = 1
# change_gap is the median leaf's: for the same reason a few leaves'
# changes (an accumulator of a top bias) wander by up to 2e-2
CHANGE_MEDIAN_LEAF = True


def _generator(config: dict):
    from benchmark import harness
    bench = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    name = config["data"]["generator"]
    return harness.load_module(os.path.join(bench, "datagen", name + ".py"),
                               "bench_datagen_" + name)


def learner(config: dict, device: str):
    from dmlc_core_tpu_torch.models.dlrm import DLRMLearner
    m = config["model"]
    return DLRMLearner(
        m["num_embeddings_per_feature"], m["multi_hot_sizes"],
        embed_dim=m["embedding_dim"], bottom=m["dense_arch_layer_sizes"],
        cross_layers=m["dcn_num_layers"], cross_rank=m["dcn_low_rank_dim"],
        top=m["over_arch_layer_sizes"], num_dense=m["dense_features"],
        learning_rate=m["learning_rate"], eps=m["adagrad_eps"],
        initial_accumulator=m["adagrad_initial_accumulator"],
        objective=m["objective"], device=device)


def check_rows(arr: dict, model: dict, rows: int) -> list:
    """Per table, the sorted rows of the concatenated tables that the
    first ``rows`` rows of ``arr`` look up."""
    ids = np.asarray(arr["col"][:rows]).ravel() - model["dense_features"]
    ids = np.unique(ids[ids >= 0])
    ends = np.cumsum(model["num_embeddings_per_feature"])
    return np.split(ids, np.searchsorted(ids, ends[:-1]))


def init(config: dict, seed: int, device: str):
    """Parameters drawn from the seed by a generator on the device, as
    TorchRec initializes them: each MLP layer ``U(±1/sqrt(fan_in))`` for
    weight and bias (``nn.Linear``), the cross network's ``V`` and ``W``
    Xavier-normal and ``b`` zero, each table ``U(±1/sqrt(N))`` with ``N``
    its published rows; every accumulator at the configuration's
    initial value."""
    m = config["model"]
    size = sum(m["num_embeddings_per_feature"]) * m["embedding_dim"] * 4
    if device == "cpu" and size > CPU_TABLE_BYTES:
        raise ValueError(
            f"the configuration's tables take {size / 1e9:.1f} GB; on the "
            f"CPU give them fewer rows through the configuration")
    g = torch.Generator(device=device).manual_seed(seed % (1 << 63))

    def uniform(shape, bound):
        return torch.empty(shape, device=device).uniform_(
            -bound, bound, generator=g)

    def xavier(rows, cols):
        return torch.empty((rows, cols), device=device).normal_(
            0.0, math.sqrt(2.0 / (rows + cols)), generator=g)

    w = {}

    def mlp(name, fan_in, layers):
        for i, out in enumerate(layers):
            w[f"{name}{i}_w"] = uniform((out, fan_in), fan_in ** -0.5)
            w[f"{name}{i}_b"] = uniform((out,), fan_in ** -0.5)
            fan_in = out

    mlp("bottom", m["dense_features"], m["dense_arch_layer_sizes"])
    width = m["embedding_dim"] * (1 + len(m["multi_hot_sizes"]))
    for i in range(m["dcn_num_layers"]):
        w[f"cross{i}_v"] = xavier(m["dcn_low_rank_dim"], width)
        w[f"cross{i}_w"] = xavier(width, m["dcn_low_rank_dim"])
        w[f"cross{i}_b"] = torch.zeros(width, device=device)
    mlp("top", width, m["over_arch_layer_sizes"])
    rows = m["num_embeddings_per_feature"]
    w["table"] = torch.empty((sum(rows), m["embedding_dim"]), device=device)
    for part, n in zip(w["table"].split(rows),
                       config["published"]["num_embeddings_per_feature"]):
        part.uniform_(-n ** -0.5, n ** -0.5, generator=g)
    a0 = float(m["adagrad_initial_accumulator"])
    acc = {"acc_" + k: torch.full(v.shape[:1] if k == "table" else v.shape,
                                  a0, device=device) for k, v in w.items()}
    params = learner(config, device).params_type(**w, **acc)
    n = CHECK_STEPS * config["batch_rows"]
    arr = _generator(config).arrays(n, seed)
    _CHECK_ROWS.clear()
    _CHECK_ROWS[params.table.data_ptr()] = [
        torch.as_tensor(r, device=params.table.device)
        for r in check_rows(arr, m, n)]
    return params


def leaf_kind(name: str) -> str:
    """``state`` for an accumulator, ``weight`` for every other leaf."""
    return "state" if name.startswith("acc_") else "weight"


def gradient(before: dict, after: dict, model: dict) -> dict:
    """The first gradient of each weight leaf as Adagrad got it, from the
    leaves before and after its step: the step moved the leaf by
    ``lr · g / (√acc + eps)`` with ``acc`` the accumulator after it (a
    table row's one accumulator for the row), so ``g = (before − after) ·
    (√acc + eps) / lr``. (The update alone is ``g / (|g| + eps)`` from an
    accumulator of 0: each entry's sign, whatever the gradient's size,
    and the few entries whose gradient is near ``eps`` weigh the most.)
    The accumulators hold no gradient of their own."""
    lr, eps = model["learning_rate"], model["adagrad_eps"]
    out = {}
    for k, p0 in before.items():
        if leaf_kind(k) != "weight":
            continue
        step = np.sqrt(np.asarray(after["acc_" + k], np.float64)) + eps
        p0 = np.asarray(p0, np.float64)
        out[k] = (p0 - np.asarray(after[k], np.float64)) * \
            step.reshape(step.shape + (1,) * (p0.ndim - step.ndim)) / lr
    return out


def leaves(params) -> dict:
    out = {f: getattr(params, f).detach().cpu().numpy().copy()
           for f in params._fields if f not in ("table", "acc_table")}
    for t, r in enumerate(_CHECK_ROWS[params.table.data_ptr()]):
        out[f"table{t}"] = params.table.index_select(0, r).cpu().numpy()
        out[f"acc_table{t}"] = params.acc_table.index_select(
            0, r).cpu().numpy()
    return out
