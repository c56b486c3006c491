"""Sparse ops and the hand-written Hopper kernels behind them."""

from dmlc_core_tpu_torch.ops.sparse import (csr_matmul_dense,  # noqa: F401
                                            csr_matvec, csr_to_dense,
                                            field_aware_matvec, row_sdot)
