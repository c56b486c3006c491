"""The least time the card could take for a piece of work: the larger of
its operations over the peak rate and its bytes over the peak bandwidth.

Peaks: NVIDIA's data sheet for the H100 SXM (dense, no sparsity): 67
TFLOP/s in float32 outside the tensor cores, 3.35 TB/s of HBM3, at the
700 W power limit (the harness prints the card's own limit on stderr).

Bytes count each input byte read once and each output byte written once,
whatever a kernel reads again; where the work depends on the data, what
these inputs need, not the most they could. Shares built on these counts
are never capped: one over 100 % means the counts or the time are wrong.
"""

from __future__ import annotations

from typing import Tuple

PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12
F32 = 4
I32 = 4


def bound_s(flops: float, nbytes: float) -> Tuple[float, str]:
    """(least seconds, which bound binds: "flops" or "bytes")."""
    tf = flops / PEAK_F32_FLOPS
    tb = nbytes / PEAK_HBM_BYTES_PER_S
    return (tf, "flops") if tf > tb else (tb, "bytes")


def csr_to_dense_cost(row_plane: int, kept_nnz: int, rows: int,
                      features: int) -> Tuple[float, float]:
    """(flops, bytes) of one CSR -> dense f32 materialization: every row id
    of the row plane (padding included: each must be read to be dropped),
    the column id and value of each kept nonzero, the [rows, features]
    output written once; one add a kept nonzero."""
    nbytes = row_plane * I32 + kept_nnz * (I32 + F32) + rows * features * F32
    return float(kept_nnz), float(nbytes)


def batch_bytes(rows: int, nnz: int) -> float:
    """A CSR batch's planes read once: row id, column id and value of each
    nonzero; label and weight of each row."""
    return nnz * (I32 + I32 + F32) + rows * 2 * F32


def linear_step_cost(rows: int, nnz: int, features: int
                     ) -> Tuple[float, float]:
    """(flops, bytes) of one SGD step of a linear model on a CSR batch:
    the margin (a multiply-add a nonzero, the bias a row), the logistic
    loss and its derivative (about 15 a row), the gradient (a
    multiply-add a nonzero, a row for the bias), the update (3 a weight);
    the batch read once and the weights read and written once."""
    flops = 4 * nnz + 17 * rows + 3 * (features + 1)
    nbytes = batch_bytes(rows, nnz) + 2 * (features + 1) * F32
    return float(flops), float(nbytes)


def fm_step_cost(rows: int, nnz: int, distinct_cols: int, k: int
                 ) -> Tuple[float, float]:
    """(flops, bytes) of one SGD step of a second-order factorization
    machine on a CSR batch (Rendle's O(nnz K) identity). Forward: the
    linear term (2 a nonzero), V x (K), its square (K) and both sums (2K)
    a nonzero, then 3K and the loss (about 15) a row. Backward: the
    linear gradient (2) and the factors' (4K) a nonzero, 2K a row. The
    update: 3 a touched parameter. Bytes: the batch once, and the (K + 1)
    parameters of each distinct column read and written once."""
    flops = (nnz * (4 + 8 * k) + rows * (5 * k + 17)
             + 3 * distinct_cols * (k + 1))
    nbytes = batch_bytes(rows, nnz) + 2 * distinct_cols * (k + 1) * F32
    return float(flops), float(nbytes)
