"""Hand-written Hopper kernels of the port and their plain versions.

``csr_to_dense_kernel`` replaces the TPU kernel
``dmlc_core_tpu/ops/pallas_kernels.py::_csr_scatter_kernel`` (reached
through ``csr_to_dense_pallas``). Its CUDA C++ source is
``csrc/csr_to_dense.cu``; it is compiled for ``sm_90a`` with ``nvcc`` into
``_build/`` at first use, under the package's build lock, and bound with
ctypes (a plain C function; pointers and the stream as ``c_void_p``).

Each wrapper launches its kernel for CUDA tensors — it has no size guard
and no fallback — and takes its plain PyTorch version only for tensors on
the CPU. Each keeps a launch count, a plain integer on the wrapper
(``csr_to_dense_kernel.launches``), raised by one per launch and nowhere
else.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import shutil
import threading
from typing import Optional

import torch

from dmlc_core_tpu_torch.base import (BUILD_DIR, PACKAGE_DIR, DMLCError,
                                      build_if_stale)

__all__ = ["csr_to_dense_kernel", "csr_to_dense_reference", "build",
           "KERNELS", "reset_launch_counts"]

CSR_TO_DENSE_SOURCE = os.path.join(PACKAGE_DIR, "csrc", "csr_to_dense.cu")
CSR_TO_DENSE_LIB = os.path.join(BUILD_DIR, "libcsr_to_dense.so")
# what the kernel is compiled for: Hopper, with its arch-specific features
NVCC_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]

# The kernel library's C boundary, one row a function:
# name -> (restype, [argtypes]), the row form of io/native.py's table; the
# QA lane (dmlc_core_tpu_torch.qa.analyze) holds both against their C
# sources. Pointers and the stream cross as c_void_p.
_vp = ctypes.c_void_p
_SIGNATURES = {
    # int dct_csr_to_dense_f32(row, col, val, long long nnz, int num_rows,
    #                          int num_features, out, stream)
    "dct_csr_to_dense_f32": (ctypes.c_int, [_vp, _vp, _vp, ctypes.c_longlong,
                                            ctypes.c_int, ctypes.c_int, _vp,
                                            _vp]),
}

_lib = None
_launch_fn = None  # the library's dct_csr_to_dense_f32, bound once
_lib_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path:
        return path
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise DMLCError("nvcc not found (neither on PATH nor under CUDA_HOME); "
                    "the CUDA toolkit is needed to build the port's kernels")


def build() -> Optional[str]:
    """Compile the kernel library if missing or stale; returns nvcc's
    output (with ``-Xptxas -v``: registers, shared memory, spills) when it
    built, None when the library was current."""
    return build_if_stale(
        CSR_TO_DENSE_LIB, [CSR_TO_DENSE_SOURCE],
        lambda tmp: [_nvcc(), *NVCC_ARCH, "-std=c++17", "-O3", "-shared",
                     "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp,
                     CSR_TO_DENSE_SOURCE])


def _kernel_lib() -> ctypes.CDLL:
    global _lib, _launch_fn
    with _lib_lock:
        if _lib is None:
            build()
            cdll = ctypes.CDLL(CSR_TO_DENSE_LIB)
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(cdll, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _launch_fn, _lib = cdll.dct_csr_to_dense_f32, cdll
        return _lib


def csr_to_dense_reference(row: torch.Tensor, col: torch.Tensor,
                           val: torch.Tensor, num_rows: int,
                           num_features: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: out-of-range ids are masked
    onto a spare row, then one accumulating ``index_put_`` sums every
    nonzero. Returns [num_rows, num_features] in ``val``'s dtype (float32
    for the kernel's inputs); ``csr_to_dense(impl="xla")`` is this
    function."""
    keep = (row >= 0) & (row < num_rows) & (col >= 0) & (col < num_features)
    row = torch.where(keep, row, num_rows).long()
    col = torch.where(keep, col, 0).long()
    val = torch.where(keep, val, 0)
    dense = torch.zeros((num_rows + 1, num_features), dtype=val.dtype,
                        device=val.device)
    dense.index_put_((row, col), val, accumulate=True)
    return dense[:num_rows]


def csr_to_dense_kernel(row: torch.Tensor, col: torch.Tensor,
                        val: torch.Tensor, num_rows: int,
                        num_features: int) -> torch.Tensor:
    """dense[num_rows, num_features] with dense[r, c] += val for every
    nonzero; padding (row == num_rows) and out-of-range ids are dropped,
    duplicates summed.

    row, col: int32 [nnz]; val: float32 [nnz]; contiguous, on one device.
    CUDA tensors go to ``csrc/csr_to_dense.cu`` on the current stream (one
    call: the output is zeroed, then the kernel scatters into it); CPU
    tensors take :func:`csr_to_dense_reference`."""
    devices = {row.device, col.device, val.device}
    if devices == {torch.device("cpu")}:
        return csr_to_dense_reference(row, col, val, num_rows, num_features)
    if len(devices) != 1 or row.device.type != "cuda":
        raise DMLCError(f"csr_to_dense_kernel needs row/col/val on one "
                        f"CUDA device (or all on the CPU), got {devices}")
    if (row.dtype, col.dtype, val.dtype) != (torch.int32, torch.int32,
                                             torch.float32):
        raise DMLCError(
            f"csr_to_dense_kernel takes int32/int32/float32, got "
            f"{row.dtype}/{col.dtype}/{val.dtype}")
    if not (row.dim() == col.dim() == val.dim() == 1
            and row.numel() == col.numel() == val.numel()):
        raise DMLCError(
            f"csr_to_dense_kernel takes three 1-D arrays of one length, "
            f"got {tuple(row.shape)}/{tuple(col.shape)}/{tuple(val.shape)}")
    if not (row.is_contiguous() and col.is_contiguous()
            and val.is_contiguous()):
        raise DMLCError("csr_to_dense_kernel takes contiguous tensors")
    if num_rows < 0 or num_features < 0:
        raise DMLCError(f"bad output shape ({num_rows}, {num_features})")
    # the C function zeroes every cell before the scatter
    out = torch.empty((num_rows, num_features), dtype=torch.float32,
                      device=row.device)
    nnz = row.numel()
    if out.numel() == 0:
        return out
    if _launch_fn is None:
        _kernel_lib()
    device = row.device.index
    with (contextlib.nullcontext() if device == torch.cuda.current_device()
          else torch.cuda.device(device)):
        err = _launch_fn(row.data_ptr(), col.data_ptr(), val.data_ptr(),
                         nnz, int(num_rows), int(num_features),
                         out.data_ptr(),
                         torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise DMLCError(f"csr_to_dense kernel launch failed: CUDA error "
                        f"{err} (nnz={nnz}, out=({num_rows}, "
                        f"{num_features}))")
    if nnz:
        csr_to_dense_kernel.launches += 1
    return out


csr_to_dense_kernel.launches = 0

# every hand-written kernel of the port, by wrapper
KERNELS = {"csr_to_dense": csr_to_dense_kernel}


def reset_launch_counts() -> None:
    """Set every wrapper's launch count to 0."""
    for fn in KERNELS.values():
        fn.launches = 0
