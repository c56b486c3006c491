"""Sparse CSR ops over PaddedBatch shards (port of ``ops/sparse.py``).

Every op works on ONE shard (no leading device axis). Per-nonzero row ids
are segment ids; padding nonzeros carry row == num_rows, a spare segment
that is summed into and then sliced off, so ``index_add_`` over
``num_rows + 1`` segments is the counterpart of the reference's
``segment_sum``.
"""

from __future__ import annotations

import os

import torch

from dmlc_core_tpu_torch.ops import hopper_kernels

__all__ = ["csr_matvec", "csr_matmul_dense", "csr_to_dense", "row_sdot",
           "field_aware_matvec"]


def _segment_sum(contrib: torch.Tensor, row: torch.Tensor,
                 num_rows: int) -> torch.Tensor:
    out = contrib.new_zeros((num_rows + 1,) + tuple(contrib.shape[1:]))
    return out.index_add(0, row, contrib)[:num_rows]


def csr_matvec(row: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
               w: torch.Tensor, num_rows: int) -> torch.Tensor:
    """y[r] = sum over the nonzeros of row r of val * w[col] (reference
    Row::SDot batched). Returns [num_rows]."""
    return _segment_sum(val * w.index_select(0, col), row, num_rows)


def csr_matmul_dense(row: torch.Tensor, col: torch.Tensor,
                     val: torch.Tensor, W: torch.Tensor,
                     num_rows: int) -> torch.Tensor:
    """[num_rows, K] = CSR · W for W [F, K], through a gathered [NNZ, K]
    intermediate."""
    return _segment_sum(val[:, None] * W.index_select(0, col), row,
                        num_rows)


def csr_to_dense(row: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
                 num_rows: int, num_features: int,
                 impl: "str | None" = None) -> torch.Tensor:
    """Materialize a dense [num_rows, num_features] shard.

    impl: "xla" (the kernel's plain torch version, the default, in the
    value dtype), "pallas" (the hand-written Hopper kernel,
    ops/hopper_kernels.py — the name is the reference's, so one switch
    selects the kernel in both packages), or None to read the
    ``DCT_CSR_TO_DENSE`` environment variable. Both drop padding and
    out-of-range ids, negative ones included, as the reference's kernel
    does (its XLA scatter wraps negative ids, which no PaddedBatch holds)."""
    if impl is None:
        impl = os.environ.get("DCT_CSR_TO_DENSE", "xla")
    if impl == "pallas":
        # the kernel accumulates in f32; a silent cast of other dtypes
        # would break the drop-in-switch contract, so refuse instead
        if val.dtype != torch.float32:
            raise ValueError(
                f"csr_to_dense impl='pallas' supports float32 values only "
                f"(got {val.dtype}); use impl='xla'")
        return hopper_kernels.csr_to_dense_kernel(row, col, val, num_rows,
                                                  num_features)
    if impl != "xla":
        raise ValueError(f"unknown csr_to_dense impl {impl!r} "
                         "(expected 'xla' or 'pallas')")
    return hopper_kernels.csr_to_dense_reference(row, col, val, num_rows,
                                                 num_features)


def row_sdot(row: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
             w: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Alias with reference naming (Row::SDot, data.h:124-136)."""
    return csr_matvec(row, col, val, w, num_rows)


def field_aware_matvec(row: torch.Tensor, col: torch.Tensor,
                       field: torch.Tensor, val: torch.Tensor,
                       W: torch.Tensor, num_rows: int) -> torch.Tensor:
    """y[r] = sum over the nonzeros of row r of val * W[field, col], for
    W [num_fields, num_features]. Returns [num_rows]."""
    return _segment_sum(val * W[field.long(), col.long()], row, num_rows)
