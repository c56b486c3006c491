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


def leaves(params) -> dict:
    out = {f: getattr(params, f).detach().cpu().numpy().copy()
           for f in params._fields if f not in ("table", "acc_table")}
    for t, r in enumerate(_CHECK_ROWS[params.table.data_ptr()]):
        out[f"table{t}"] = params.table.index_select(0, r).cpu().numpy()
        out[f"acc_table{t}"] = params.acc_table.index_select(
            0, r).cpu().numpy()
    return out
