"""The least time of one DLRM-DCNv2 training step (``dlrm`` configurations)
by ``benchmark/roofline.py``'s peaks: its float32 operations at 67 TFLOP/s
or its bytes at 3.35 TB/s, whichever is larger.

Operations, forward and backward, from the configuration's widths:

- every matrix product of the bottom MLP, the cross network (``V x``
  then ``W (V x)``, each layer) and the top MLP: 2 a multiply-add
  forward, and as much again for the weights' gradient and for the
  input's gradient, less the first layer's input gradient (the data);
- the elementwise work: a ReLU forward and backward an activation, the
  cross layer's ``x0 ⊙ (u + b) + x`` (3 an element forward, 5 backward),
  each bias's gradient (a row an output), the loss (about 15 a row);
- the bags: an add an id and element forward, and again to sum the
  gradient rows of duplicate ids;
- the update: 6 a dense weight (elementwise Adagrad), and for each
  distinct row looked up 2 an element for the mean of squares and 3 for
  the step, plus 4.

Bytes: the batch's planes read once (row, column, value and field ids a
nonzero, label and weight a row); each distinct looked-up row read and
written with its accumulator; each dense weight and its accumulator read
and written.
"""

from __future__ import annotations

from typing import Tuple

from benchmark import roofline


def _layers(model: dict):
    """(fan_in, fan_out) of every matrix product, in order."""
    D = model["embedding_dim"]
    width = D * (1 + len(model["num_embeddings_per_feature"]))
    bottom = [model["dense_features"]] + model["dense_arch_layer_sizes"]
    top = [width] + model["over_arch_layer_sizes"]
    rank = model["dcn_low_rank_dim"]
    return (list(zip(bottom, bottom[1:]))
            + [(width, rank), (rank, width)] * model["dcn_num_layers"]
            + list(zip(top, top[1:])), width)


def dense_params(model: dict) -> int:
    """Weights and biases of the MLPs and the cross network (whose ``V``
    products carry no bias)."""
    layers, width = _layers(model)
    return (sum(i * o for i, o in layers)
            + sum(model["dense_arch_layer_sizes"])
            + width * model["dcn_num_layers"]
            + sum(model["over_arch_layer_sizes"]))


def step_cost(model: dict, rows: int, nnz: int, ids: int,
              distinct_rows: int) -> Tuple[float, float]:
    """(flops, bytes) of one step over ``rows`` rows and ``nnz`` nonzeros
    that look up ``ids`` ids in ``distinct_rows`` distinct rows."""
    layers, width = _layers(model)
    macs = sum(i * o for i, o in layers)
    first = layers[0][0] * layers[0][1]
    matmul = 2 * rows * (3 * macs - first)
    acts = (sum(model["dense_arch_layer_sizes"])
            + sum(model["over_arch_layer_sizes"][:-1]))
    outs = sum(o for _, o in layers)
    elementwise = rows * (2 * acts + 8 * width * model["dcn_num_layers"]
                          + outs + 15)
    D = model["embedding_dim"]
    bags = 2 * ids * D
    n_dense = dense_params(model)
    update = 6 * n_dense + distinct_rows * (5 * D + 4)
    flops = matmul + elementwise + bags + update
    nbytes = (nnz * 4 * roofline.I32 + rows * 2 * roofline.F32
              + distinct_rows * 2 * (D + 1) * roofline.F32
              + n_dense * 4 * roofline.F32)
    return float(flops), float(nbytes)
