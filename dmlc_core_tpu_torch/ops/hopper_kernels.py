"""Hand-written Hopper kernels of the port and their plain versions.

``csr_to_dense_kernel`` replaces the TPU kernel
``dmlc_core_tpu/ops/pallas_kernels.py::_csr_scatter_kernel`` (reached
through ``csr_to_dense_pallas``); its CUDA C++ source is
``csrc/csr_to_dense.cu``. ``fm_csr_kernel`` computes the factorization
machine's margin of one CSR shard, and through autograd its gradient
(``csrc/fm_csr.cu``, a forward and a backward entry point); it
replaces no TPU kernel, since the JAX package computes that margin with
XLA ops. Both sources are compiled for ``sm_90a`` with ``nvcc`` into one
library under ``_build/`` at first use, under the package's build lock,
and bound with ctypes (plain C functions; pointers and the stream as
``c_void_p``).

Each wrapper launches its kernel for CUDA tensors — it has no size guard
and no fallback — and takes its plain PyTorch version only for tensors on
the CPU. Each keeps a launch count, a plain integer on the wrapper
(``csr_to_dense_kernel.launches``, ``fm_csr_kernel.launches``), raised by
one per launch and nowhere else; the FM pair counts its forward and its
backward entry point, one each.
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

__all__ = ["csr_to_dense_kernel", "csr_to_dense_reference",
           "fm_csr_kernel", "fm_csr_reference", "build", "KERNELS",
           "reset_launch_counts"]

CSR_TO_DENSE_SOURCE = os.path.join(PACKAGE_DIR, "csrc", "csr_to_dense.cu")
FM_CSR_SOURCE = os.path.join(PACKAGE_DIR, "csrc", "fm_csr.cu")
KERNEL_SOURCES = (CSR_TO_DENSE_SOURCE, FM_CSR_SOURCE)
KERNEL_LIB = os.path.join(BUILD_DIR, "libdct_kernels.so")
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
    # int dct_fm_csr_forward_f32(row, col, val, long long nnz, int num_rows,
    #                            int num_features, int k, b, w, v, margin,
    #                            s1, unsorted, stream)
    "dct_fm_csr_forward_f32": (ctypes.c_int, [_vp, _vp, _vp,
                                              ctypes.c_longlong, ctypes.c_int,
                                              ctypes.c_int, ctypes.c_int, _vp,
                                              _vp, _vp, _vp, _vp, _vp, _vp]),
    # int dct_fm_csr_backward_f32(row, col, val, long long nnz, int num_rows,
    #                             int num_features, int k, v, g, s1,
    #                             unsorted, grad_b, grad_w, grad_v, stream)
    "dct_fm_csr_backward_f32": (ctypes.c_int, [_vp, _vp, _vp,
                                               ctypes.c_longlong,
                                               ctypes.c_int, ctypes.c_int,
                                               ctypes.c_int, _vp, _vp, _vp,
                                               _vp, _vp, _vp, _vp, _vp]),
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
        KERNEL_LIB, KERNEL_SOURCES,
        lambda tmp: [_nvcc(), *NVCC_ARCH, "-std=c++17", "-O3", "-shared",
                     "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp,
                     *KERNEL_SOURCES])


def _kernel_lib() -> ctypes.CDLL:
    global _lib, _launch_fn
    with _lib_lock:
        if _lib is None:
            build()
            cdll = ctypes.CDLL(KERNEL_LIB)
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(cdll, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _launch_fn, _lib = cdll.dct_csr_to_dense_f32, cdll
        return _lib


def _on_device(device: torch.device):
    """Make ``device`` current for a launch (a no-op when it is)."""
    return (contextlib.nullcontext()
            if device.index == torch.cuda.current_device()
            else torch.cuda.device(device.index))


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
    with _on_device(row.device):
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

def fm_csr_reference(b: torch.Tensor, w: torch.Tensor, v: torch.Tensor,
                     row: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
                     num_rows: int) -> torch.Tensor:
    """Plain PyTorch version of the FM kernel pair: margins [num_rows] of
    one CSR shard, ``b + sum w[c] x + 0.5 * sum_f ((sum V[c,f] x)^2 -
    sum (V[c,f] x)^2)``, through one gather ``V[col]`` and segment sums
    over the row ids (padding, row == num_rows, sums into a spare segment
    that is sliced off); autograd gives its gradient."""
    from dmlc_core_tpu_torch.ops.sparse import _segment_sum
    linear = _segment_sum(val * w.index_select(0, col), row, num_rows)
    vx = v.index_select(0, col) * val[:, None]   # [NNZ, K]
    s1 = _segment_sum(vx, row, num_rows)         # sum V x    [R, K]
    s2 = _segment_sum(vx * vx, row, num_rows)    # sum V^2x^2 [R, K]
    inter = 0.5 * torch.sum(s1 * s1 - s2, dim=-1)
    return b + linear + inter


def _launch(fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise DMLCError(f"FM kernel launch failed: CUDA error {err}")
    fm_csr_kernel.launches += 1


class _FMCsr(torch.autograd.Function):
    """The kernel pair as one autograd node: the forward writes the margins,
    the per-row sums ``s1`` and whether the row plane was out of order,
    which the backward reads."""

    @staticmethod
    def forward(ctx, b, w, v, row, col, val, num_rows):
        R, (F, K) = int(num_rows), v.shape
        margin = torch.empty(R, dtype=torch.float32, device=v.device)
        s1 = torch.empty((R, K), dtype=torch.float32, device=v.device)
        unsorted = torch.empty(1, dtype=torch.int32, device=v.device)
        if R:
            _launch(_lib.dct_fm_csr_forward_f32, row.data_ptr(),
                    col.data_ptr(), val.data_ptr(), row.numel(), R, F, K,
                    b.data_ptr(), w.data_ptr(), v.data_ptr(),
                    margin.data_ptr(), s1.data_ptr(), unsorted.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
        ctx.save_for_backward(v, row, col, val, s1, unsorted)
        ctx.num_rows = R
        return margin

    @staticmethod
    def backward(ctx, g):
        v, row, col, val, s1, unsorted = ctx.saved_tensors
        R, (F, K) = ctx.num_rows, v.shape
        g = g.contiguous()
        gb = torch.empty((), dtype=torch.float32, device=v.device)
        gw = torch.empty(F, dtype=torch.float32, device=v.device)
        gv = torch.empty((F, K), dtype=torch.float32, device=v.device)
        with _on_device(v.device):
            _launch(_lib.dct_fm_csr_backward_f32, row.data_ptr(),
                    col.data_ptr(), val.data_ptr(), row.numel(), R, F, K,
                    v.data_ptr(), g.data_ptr(), s1.data_ptr(),
                    unsorted.data_ptr(), gb.data_ptr(), gw.data_ptr(),
                    gv.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
        return gb, gw, gv, None, None, None, None


def fm_csr_kernel(b: torch.Tensor, w: torch.Tensor, v: torch.Tensor,
                  row: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
                  num_rows: int) -> torch.Tensor:
    """FM margins [num_rows] of one CSR shard, differentiable in ``b``,
    ``w`` and ``v``.

    b: float32 []; w: float32 [F]; v: float32 [F, K], any K >= 1; row,
    col: int32 [nnz]; val: float32 [nnz]; contiguous, on one device. Row
    ids lie in [0, num_rows], num_rows marking padding, in any order; the
    kernels are fastest in the order every batch of the port has (rows
    ascending, the padding at the tail), and check it on the card: a
    plane out of that order takes a slower path of per-nonzero atomics
    with the same result. Column ids outside [0, F) add nothing. CUDA
    tensors go to ``csrc/fm_csr.cu`` on the current stream: the forward
    here, the backward in autograd's backward. CPU tensors take
    :func:`fm_csr_reference`."""
    tensors = {"b": b, "w": w, "v": v, "row": row, "col": col, "val": val}
    devices = {t.device for t in tensors.values()}
    want = {"b": torch.float32, "w": torch.float32, "v": torch.float32,
            "row": torch.int32, "col": torch.int32, "val": torch.float32}
    bad = {k: t.dtype for k, t in tensors.items() if t.dtype != want[k]}
    if bad:
        raise DMLCError(f"fm_csr_kernel takes float32 b/w/v/val and int32 "
                        f"row/col, got {bad}")
    if not (b.dim() == 0 and w.dim() == 1 and v.dim() == 2
            and v.shape[0] == w.shape[0]
            and row.dim() == col.dim() == val.dim() == 1
            and row.numel() == col.numel() == val.numel()):
        raise DMLCError(
            f"fm_csr_kernel takes b [], w [F], v [F, K] and three 1-D "
            f"arrays of one length, got {tuple(b.shape)}/{tuple(w.shape)}/"
            f"{tuple(v.shape)} and {tuple(row.shape)}/{tuple(col.shape)}/"
            f"{tuple(val.shape)}")
    if not all(t.is_contiguous() for t in tensors.values()):
        raise DMLCError("fm_csr_kernel takes contiguous tensors")
    if v.shape[1] < 1 or num_rows < 0:
        raise DMLCError(f"fm_csr_kernel takes at least 1 factor and "
                        f"num_rows >= 0, got K={v.shape[1]}, "
                        f"num_rows={num_rows}")
    if devices == {torch.device("cpu")}:
        return fm_csr_reference(b, w, v, row, col, val, num_rows)
    device = next(iter(devices))
    if len(devices) != 1 or device.type != "cuda":
        raise DMLCError(f"fm_csr_kernel needs its tensors on one CUDA "
                        f"device (or all on the CPU), got {devices}")
    if _lib is None:
        _kernel_lib()
    with _on_device(device):
        return _FMCsr.apply(b, w, v, row, col, val, int(num_rows))


fm_csr_kernel.launches = 0

# every hand-written kernel of the port, by wrapper
KERNELS = {"csr_to_dense": csr_to_dense_kernel, "fm_csr": fm_csr_kernel}


def reset_launch_counts() -> None:
    """Set every wrapper's launch count to 0."""
    for fn in KERNELS.values():
        fn.launches = 0
