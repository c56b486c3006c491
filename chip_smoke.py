#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one GPU and check what comes out.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA GPU, the
CUDA toolkit (nvcc) and a C++ compiler. Phases, one JSON line each:

1. ``env``     — the card, its power limit, torch and CUDA versions; TF32
                 off for matmuls and cuDNN (the reference asks for full f32).
2. ``build``   — the CUDA kernel (``csrc/*.cu``, sm_90a) and the native core
                 (``cpp/``), both from the checkout's sources into
                 ``dmlc_core_tpu_torch/_build/``; seconds each and ptxas info.
3. ``kernels`` — every hand-written kernel against its plain PyTorch version
                 on the card: the bench probe shape, the training shape
                 (also with its nonzeros permuted), duplicates, padding
                 and out-of-range ids, empty input, uneven libsvm-like
                 rows with empty ones, 27 columns, 20,000 columns;
                 kernel, plain-version and library-call device times
                 (median of 30 runs queued behind a device sleep, L2
                 flushed between runs, CUDA events), and beside them the
                 kernel's previous version (``PREVIOUS_KERNEL_CU``, built
                 and timed in the same run); the wrappers' host time per
                 call, the memory-traffic bound and the kernel's share of
                 it.
4. ``train``   — the main path: a HIGGS-shaped libsvm file (28 features,
                 524,288 rows) through ``DeviceRowBlockIter`` into
                 ``LinearLearner(28, margin_path="dense")`` with
                 ``DCT_CSR_TO_DENSE=pallas``, one epoch of 8 steps of 65,536
                 rows, after one warm-up step on a learner of its own.
                 Kernel launch counts are zeroed just before and read
                 just after. The loss trajectory and final weights must
                 match the segment-sum path on the card and the port's CPU
                 run (plain versions) at rtol 1e-5 (atol 1e-7 on weights).

Then the ``{"kernels": [...]}`` summary line, the card's
``name, power.limit`` line from nvidia-smi, and last
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
the last line; without CUDA the script exits non-zero at once.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from dmlc_core_tpu_torch import telemetry  # noqa: E402
from dmlc_core_tpu_torch.device import device_iter  # noqa: E402
from dmlc_core_tpu_torch.io import native  # noqa: E402
from dmlc_core_tpu_torch.io.native import NativeParser  # noqa: E402
from dmlc_core_tpu_torch.models.linear import LinearLearner  # noqa: E402
from dmlc_core_tpu_torch.ops import hopper_kernels as hk  # noqa: E402

# H100 SXM data sheet peaks (the bound's denominators)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

FEATURES = 28          # HIGGS's published width
BATCH_ROWS = 65536     # the DeviceRowBlockIter default
TRAIN_ROWS = 8 * BATCH_ROWS
TIMED_RUNS = 30
# about 50 ms of device sleep: longer than the host takes to queue the
# timed runs, so they execute back to back
SLEEP_CYCLES = 100_000_000


class CheckFailed(RuntimeError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str, **detail) -> None:
    if not cond:
        raise CheckFailed(f"{what}: {json.dumps(detail, default=str)}")


def card_line() -> str:
    """``name, power.limit`` of GPU 0 as nvidia-smi reports them."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    lines = proc.stdout.strip().splitlines()
    return lines[0].strip() if proc.returncode == 0 and lines else \
        f"nvidia-smi failed (exit {proc.returncode})"


# -- timing ------------------------------------------------------------------
_flush = None


def time_ms(fn) -> float:
    """Median device milliseconds of ``fn`` over TIMED_RUNS runs after a
    warm-up. Each run sits between two CUDA events, with a 256 MB write
    before it that evicts the 50 MB L2 (every run reads its inputs from
    device memory, as a fresh batch would). The device first sleeps while
    the host queues all runs, so the events time the device work alone and
    not the host's launch overhead between them."""
    global _flush
    if _flush is None:
        _flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True)
              for _ in range(TIMED_RUNS)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(TIMED_RUNS)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for start, end in zip(starts, ends):
        _flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def host_us(fn, runs: int = 200) -> float:
    """Median host microseconds of one call of ``fn`` (launch overhead,
    device work not awaited)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


# -- phase 3: kernels against their plain versions --------------------------
def padded_batch_csr(rng, rows: int, bucket: int,
                     features: int = FEATURES):
    """A PaddedBatch-shaped shard: every row holds all ``features`` columns
    (as a dense HIGGS row does), rows in order, then padding nonzeros (row
    == rows, col 0, val 0) up to ``bucket``."""
    nnz = rows * features
    row = np.full(bucket, rows, np.int32)
    col = np.zeros(bucket, np.int32)
    val = np.zeros(bucket, np.float32)
    row[:nnz] = np.repeat(np.arange(rows, dtype=np.int32), features)
    col[:nnz] = np.tile(np.arange(features, dtype=np.int32), rows)
    val[:nnz] = rng.standard_normal(nnz).astype(np.float32)
    return row, col, val


def uneven_csr(rng, lengths, features: int):
    """A PaddedBatch-shaped shard with ``lengths[r]`` distinct columns in
    row r (sorted, as a libsvm line lists them), rows in order, padding
    up to the next power of two."""
    rows, nnz = len(lengths), int(lengths.sum())
    bucket = 1 << max(nnz - 1, 1).bit_length()
    row = np.full(bucket, rows, np.int32)
    col = np.zeros(bucket, np.int32)
    val = np.zeros(bucket, np.float32)
    row[:nnz] = np.repeat(np.arange(rows, dtype=np.int32), lengths)
    # distinct columns per row: the lowest keys of a random draw
    keys = rng.random((rows, features))
    cols = np.argsort(keys, axis=1)
    col[:nnz] = np.concatenate(
        [np.sort(cols[r, :n]) for r, n in enumerate(lengths)]
    ).astype(np.int32)
    val[:nnz] = rng.standard_normal(nnz).astype(np.float32)
    return row, col, val


def kernel_cases(rng):
    """(name, row, col, val, R, F, tolerance, library_ok) on the host.
    Tolerance "exact": no cell gets more than one add, so the kernel must
    equal the plain version bit for bit. A float: rtol = atol against the
    plain version, for about two adds per cell (atomics reorder those
    sums). "bound": many adds per cell, where two f32 orders of the same
    sum differ by several ulps of its partial sums (2.9e-6 at nine adds
    per cell on the H100), so the kernel and the plain version are each
    held to the forward error bound of f32 summation against the exact
    f64 sums instead (see check_against_f64)."""
    cases = []
    row, col, val = padded_batch_csr(rng, 1024, 1024 * FEATURES)
    cases.append(("probe_1024x28", row, col, val, 1024, FEATURES, "exact",
                  True))
    row, col, val = padded_batch_csr(rng, BATCH_ROWS, 1 << 21)
    cases.append(("train_65536x28", row, col, val, BATCH_ROWS, FEATURES,
                  "exact", True))
    n = 1 << 18  # about 2 adds per cell
    row = np.sort(rng.integers(0, 4096, n)).astype(np.int32)
    col = rng.integers(0, FEATURES, n).astype(np.int32)
    val = rng.standard_normal(n).astype(np.float32)
    cases.append(("duplicates_4096x28", row, col, val, 4096, FEATURES, 1e-6,
                  True))
    n = 1 << 20  # about 9 adds per cell
    row = np.sort(rng.integers(0, 4096, n)).astype(np.int32)
    col = rng.integers(0, FEATURES, n).astype(np.int32)
    val = rng.standard_normal(n).astype(np.float32)
    cases.append(("duplicates_9_per_cell_4096x28", row, col, val, 4096,
                  FEATURES, "bound", True))
    # padding rows with non-zero values and out-of-range ids: all dropped
    n = 1 << 16
    row = rng.integers(-3, 1024 + 3, n).astype(np.int32)
    col = rng.integers(-3, FEATURES + 3, n).astype(np.int32)
    val = rng.standard_normal(n).astype(np.float32)
    cases.append(("padding_out_of_range_1024x28", row, col, val, 1024,
                  FEATURES, 1e-6, False))
    # heavy contention: about 36 adds per cell
    n = 1 << 20
    row = rng.integers(0, 1024, n).astype(np.int32)
    col = rng.integers(0, FEATURES, n).astype(np.int32)
    val = rng.standard_normal(n).astype(np.float32)
    cases.append(("heavy_duplicates_1024x28", row, col, val, 1024, FEATURES,
                  "bound", True))
    empty = np.zeros(0, np.int32)
    cases.append(("empty_64x28", empty, empty, np.zeros(0, np.float32), 64,
                  FEATURES, "exact", True))
    # libsvm-like: rows of 0..28 distinct columns, 512 empty rows in the
    # middle, padding up to the bucket
    rows = 8192
    lengths = rng.integers(0, FEATURES + 1, rows)
    lengths[3000:3512] = 0
    row, col, val = uneven_csr(rng, lengths, FEATURES)
    cases.append(("libsvm_uneven_8192x28", row, col, val, rows, FEATURES,
                  "exact", True))
    # 27 columns: a row's span is not a multiple of 16 bytes
    row, col, val = padded_batch_csr(rng, 16384, 1 << 19, features=27)
    cases.append(("f27_16384x27", row, col, val, 16384, 27, "exact", True))
    # wide rows: about 670 zero cells between nonzeros
    lengths = np.full(1024, 30)
    row, col, val = uneven_csr(rng, lengths, 20000)
    cases.append(("wide_1024x20000", row, col, val, 1024, 20000, "exact",
                  True))
    # the training batch with its nonzeros (padding included) permuted
    train = next(c for c in cases if c[0] == "train_65536x28")
    perm = rng.permutation(len(train[1]))
    cases.append(("train_unsorted_65536x28", train[1][perm], train[2][perm],
                  train[3][perm], BATCH_ROWS, FEATURES, "exact", True))
    return cases


def check_against_f64(got, r, c, v, R, F) -> "tuple[bool, float]":
    """Whether ``got`` is within the forward error bound of f32 summation
    in any order, (k - 1) * u * sum|v| per cell for k adds and u = 2^-24
    (plus one rounding of the result), of the exact (f64) sums. Returns
    (ok, largest error as a share of its bound)."""
    keep = (r >= 0) & (r < R) & (c >= 0) & (c < F)
    rk, ck = r[keep].long(), c[keep].long()
    vk = v[keep].double()
    exact = torch.zeros((R, F), dtype=torch.float64, device=v.device)
    exact.index_put_((rk, ck), vk, accumulate=True)
    abs_sum = torch.zeros_like(exact).index_put_((rk, ck), vk.abs(),
                                                 accumulate=True)
    count = torch.zeros_like(exact).index_put_(
        (rk, ck), torch.ones_like(vk), accumulate=True)
    u = 2.0 ** -24
    bound = (count - 1).clamp(min=0) * u * abs_sum + u * exact.abs()
    err = (got.double() - exact).abs()
    share = float((err / bound.clamp(min=1e-300)).max())
    return bool((err <= bound).all()), share


def bound_ms(row, col, rows: int, features: int) -> "tuple[float, str]":
    """Least time for the function on these inputs, from what this data
    needs: every row id read (4 B) to find padding and out-of-range rows,
    the column id of each in-range row (4 B) and the value of each kept
    nonzero (4 B), the f32 output written once; against one f32 add per
    kept nonzero."""
    row_ok = (row >= 0) & (row < rows)
    n_row_ok = int(row_ok.sum())
    kept = int((row_ok & (col >= 0) & (col < features)).sum())
    t_bytes = (4 * (row.numel() + n_row_ok + kept)
               + 4 * rows * features) / HBM_BYTES_PER_S
    t_ops = kept / FP32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_case(got, want, tol, r, c, v, R, F, rec: dict,
               prefix: str = "") -> bool:
    """Whether ``got`` matches the plain version ``want`` at ``tol`` (see
    kernel_cases); notes the error in ``rec`` under ``prefix``."""
    rec[prefix + "max_abs_err"] = (float((got - want).abs().max())
                                   if got.numel() else 0.0)
    if tol == "exact":
        return bool(torch.equal(got, want))
    if tol == "bound":
        ok, rec[prefix + "err_share_of_bound"] = check_against_f64(
            got, r, c, v, R, F)
        return ok
    return bool(torch.allclose(got, want, rtol=tol, atol=tol))


# The kernel's previous version, built and timed beside the current one on
# the same inputs: the output zeroed by torch.zeros, then a grid-stride
# scatter, one thread per nonzero, that loads the column id and value only
# after the row id, and adds with atomicAdd.
PREVIOUS_KERNEL_CU = r"""
#include <cuda_runtime.h>
namespace {
__global__ void scatter(const int* __restrict__ row,
                        const int* __restrict__ col,
                        const float* __restrict__ val, long long nnz,
                        int num_rows, int num_features,
                        float* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < nnz; i += stride) {
    const int r = row[i];
    if ((unsigned)r >= (unsigned)num_rows) continue;
    const int c = col[i];
    if ((unsigned)c < (unsigned)num_features)
      atomicAdd(out + (long long)r * num_features + c, val[i]);
  }
}
}  // namespace
extern "C" int previous_scatter_f32(const void* row, const void* col,
                                    const void* val, long long nnz,
                                    int num_rows, int num_features,
                                    void* out, void* stream) {
  long long blocks = (nnz + 255) / 256;
  if (blocks > 132 * 64) blocks = 132 * 64;
  scatter<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      (const int*)row, (const int*)col, (const float*)val, nnz, num_rows,
      num_features, (float*)out);
  return (int)cudaGetLastError();
}
"""


def start_previous_kernel_build() -> "tuple[subprocess.Popen, str]":
    """Start nvcc on PREVIOUS_KERNEL_CU (in the package's build directory);
    returns the process and the library it writes."""
    os.makedirs(hk.BUILD_DIR, exist_ok=True)
    src = os.path.join(hk.BUILD_DIR, "previous_scatter.cu")
    lib = os.path.join(hk.BUILD_DIR, "libprevious_scatter.so")
    with open(src, "w") as f:
        f.write(PREVIOUS_KERNEL_CU)
    proc = subprocess.Popen(
        [hk._nvcc(), *hk.NVCC_ARCH, "-O3", "-shared", "-Xcompiler", "-fPIC",
         "-o", lib, src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    return proc, lib


_previous_scatter = None


def load_previous_kernel(proc: subprocess.Popen, lib: str) -> None:
    global _previous_scatter
    log = proc.communicate(timeout=600)[0]
    require(proc.returncode == 0, "previous kernel build", log=log[-2000:])
    cdll = ctypes.CDLL(lib)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    cdll.previous_scatter_f32.argtypes = [vp, vp, vp, ctypes.c_longlong,
                                          i32, i32, vp, vp]
    cdll.previous_scatter_f32.restype = i32
    _previous_scatter = cdll.previous_scatter_f32


def previous_kernel(r, c, v, R: int, F: int) -> torch.Tensor:
    """The kernel's previous version on the current stream, as its wrapper
    ran it: torch.zeros, then the scatter."""
    out = torch.zeros((R, F), dtype=torch.float32, device=r.device)
    if r.numel():
        err = _previous_scatter(r.data_ptr(), c.data_ptr(), v.data_ptr(),
                                r.numel(), R, F, out.data_ptr(),
                                torch.cuda.current_stream().cuda_stream)
        require(err == 0, "previous kernel launch", err=err)
    return out


def yardsticks(r, c, v, R, F) -> dict:
    """What this timing method gives two plain PyTorch calls on the card:
    ``floor_ms``, a one-element add (the method's floor: events, launch,
    an idle kernel); ``stream_ms``, one elementwise op over the kept
    nonzeros that reads their row ids, column ids (both viewed as f32)
    and values and writes one f32 each: 3 x 4 B read and 4 B written per
    kept nonzero, the bound's bytes less the padding's row ids, streamed
    in one pass. Neither computes the kernel's function."""
    one = torch.zeros(1, device="cuda")
    kept = R * F  # the training bucket's rows hold every column
    rows, cols, vals = (t[:kept] for t in (r, c, v))
    out = torch.empty(kept, device="cuda")

    def stream():
        torch.addcmul(vals, rows.view(torch.float32),
                      cols.view(torch.float32), out=out)
    return {"floor_ms": time_ms(lambda: one.add_(1)),
            "stream_ms": time_ms(stream),
            "stream_bytes": 16 * kept}


def kernels_phase() -> dict:
    rng = np.random.default_rng(0)
    results = []
    for name, row, col, val, R, F, tol, library_ok in kernel_cases(rng):
        r = torch.from_numpy(row).cuda()
        c = torch.from_numpy(col).cuda()
        v = torch.from_numpy(val).cuda()
        got = hk.csr_to_dense_kernel(r, c, v, R, F)
        want = hk.csr_to_dense_reference(r, c, v, R, F)
        torch.cuda.synchronize()
        require(got.shape == (R, F) and got.device.type == "cuda",
                "kernel output shape/device", case=name,
                shape=tuple(got.shape))
        rec = {"case": name, "rows": R, "features": F, "nnz": len(row),
               "tol": tol}
        ok = check_case(got, want, tol, r, c, v, R, F, rec)
        if tol == "bound":
            plain_ok, rec["plain_err_share_of_bound"] = check_against_f64(
                want, r, c, v, R, F)
            require(plain_ok, "plain version outside the f32 bound", **rec)
        rec["match"] = ok
        require(ok, "kernel disagrees with its plain version", **rec)
        # the previous version on the same inputs
        require(check_case(previous_kernel(r, c, v, R, F), want, tol, r, c,
                           v, R, F, rec, "previous_kernel_"),
                "previous kernel disagrees", **rec)
        if len(row):
            rec["kernel_ms"] = time_ms(
                lambda: hk.csr_to_dense_kernel(r, c, v, R, F))
            rec["previous_kernel_ms"] = time_ms(
                lambda: previous_kernel(r, c, v, R, F))
            rec["kernel_host_us"] = host_us(
                lambda: hk.csr_to_dense_kernel(r, c, v, R, F))
            rec["previous_kernel_host_us"] = host_us(
                lambda: previous_kernel(r, c, v, R, F))
            rec["plain_ms"] = time_ms(
                lambda: hk.csr_to_dense_reference(r, c, v, R, F))
            rec["library_ms"] = None
            if library_ok:
                def library():
                    idx = torch.stack([r.long(), c.long()])
                    return torch.sparse_coo_tensor(
                        idx, v, (R + 1, F),
                        check_invariants=False).to_dense()[:R]
                # the yardstick must compute the same function: within the
                # f32 summation bound of the exact sums (its sort-and-reduce
                # order differs from both the kernel's and the plain one's)
                lib_ok, share = check_against_f64(library(), r, c, v, R, F)
                require(lib_ok, "library call disagrees", case=name,
                        err_share_of_bound=share)
                rec["library_ms"] = time_ms(library)
            b_ms, b_by = bound_ms(r, c, R, F)
            rec["bound_us"] = b_ms * 1e3
            rec["bound_by"] = b_by
            rec["bound_share"] = b_ms / rec["kernel_ms"]
            rec["previous_kernel_bound_share"] = (
                b_ms / rec["previous_kernel_ms"])
            if name == "train_65536x28":
                rec.update(yardsticks(r, c, v, R, F))
        results.append(rec)
    emit({"phase": "kernels", "cases": results})
    return {rec["case"]: rec for rec in results}


# -- phase 4: the main path --------------------------------------------------
def write_higgs_like(path: str, rows: int, seed: int = 0) -> None:
    """A libsvm file shaped like HIGGS: 0/1 labels and FEATURES dense
    features, 0-based ids. Values are seeded normals written with four
    decimals; labels come from a seeded linear rule plus noise, so the
    model has something to learn. Built as one byte matrix (each row has
    the same width), not line by line."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, FEATURES), dtype=np.float32)
    w_true = rng.standard_normal(FEATURES).astype(np.float32)
    y = (x @ w_true + rng.standard_normal(rows, dtype=np.float32)) > 0
    q = np.minimum(np.rint(np.abs(x) * 1e4), 99999).astype(np.int64)
    keys = [f" {j}:".encode() for j in range(FEATURES)]
    width = 1 + sum(len(k) + 7 for k in keys) + 1
    buf = np.empty((rows, width), np.uint8)
    buf[:, 0] = ord("0") + y
    pos = 1
    for j, key in enumerate(keys):
        buf[:, pos:pos + len(key)] = np.frombuffer(key, np.uint8)
        pos += len(key)
        # "-d.dddd" or "0d.dddd": seven characters for every value
        buf[:, pos] = np.where(x[:, j] < 0, ord("-"), ord("0"))
        buf[:, pos + 1] = ord("0") + q[:, j] // 10000
        buf[:, pos + 2] = ord(".")
        for k in range(4):
            buf[:, pos + 3 + k] = ord("0") + (q[:, j] // 10 ** (3 - k)) % 10
        pos += 7
    buf[:, pos] = ord("\n")
    buf.tofile(path)


def train(uri: str, margin_path: str, device: str, batch_rows: int,
          max_steps: "int | None" = None) -> dict:
    """One epoch of the port's main path (or its first ``max_steps``
    steps); per-step losses and timings. ``seconds`` spans the epoch from
    the iterator's start; ``steady_rows_per_s`` counts steps 2..N only,
    from the end of step 1 to the end of step N."""
    learner = LinearLearner(FEATURES, margin_path=margin_path, device=device)
    params = learner.init()
    losses, step_s, step_end, step_rows = [], [], [], []
    t0 = time.perf_counter()
    with device_iter.DeviceRowBlockIter(uri, batch_rows=batch_rows,
                                        layout="csr", device=device) as it:
        for batch in it:
            for k, t in batch.tree().items():
                require(t.device.type == device, "batch leaf off device",
                        leaf=k, device=str(t.device))
            ts = time.perf_counter()
            params, loss = learner.step(params, batch)
            losses.append(float(loss))  # synchronizes the step
            step_end.append(time.perf_counter())
            step_s.append(step_end[-1] - ts)
            step_rows.append(batch.total_rows)
            if max_steps is not None and len(losses) == max_steps:
                break
    total = time.perf_counter() - t0
    steady = (sum(step_rows[1:]) / (step_end[-1] - step_end[0])
              if len(step_end) > 1 else None)
    return {"losses": losses, "w": params.w.cpu().numpy(),
            "b": float(params.b), "step_s": step_s, "rows": sum(step_rows),
            "seconds": total, "steady_rows_per_s": steady}


def compare(a: dict, b: dict, label: str) -> dict:
    la, lb = np.asarray(a["losses"]), np.asarray(b["losses"])
    require(la.shape == lb.shape, f"{label}: step counts differ",
            a=len(la), b=len(lb))
    gap = {"loss_max_rel": float(np.max(np.abs(la - lb) / np.abs(lb))),
           "w_max_abs": float(np.max(np.abs(a["w"] - b["w"]))),
           "w_max_excess": float(np.max(
               np.abs(a["w"] - b["w"]) - (1e-7 + 1e-5 * np.abs(b["w"])))),
           "b_abs": abs(a["b"] - b["b"])}
    ok = (np.allclose(la, lb, rtol=1e-5, atol=0)
          and np.allclose(a["w"], b["w"], rtol=1e-5, atol=1e-7)
          and np.allclose(a["b"], b["b"], rtol=1e-5, atol=1e-7))
    require(ok, f"{label}: trajectories differ beyond rtol 1e-5", **gap)
    return gap


def train_phase(workdir: str, device: str = "cuda", rows: int = TRAIN_ROWS,
                batch_rows: int = BATCH_ROWS) -> dict:
    """Main path on ``device`` (dense margin through the kernel), then the
    segment path on ``device`` and the dense path on the CPU, compared."""
    uri = os.path.join(workdir, "higgs_like.libsvm")
    t0 = time.perf_counter()
    write_higgs_like(uri, rows)
    write_s = time.perf_counter() - t0
    with NativeParser(uri) as parser:
        width = parser.num_features()
    require(width == FEATURES, "data file width", features=width)
    steps = -(-rows // batch_rows)

    os.environ["DCT_CSR_TO_DENSE"] = "pallas"
    # one step on a learner of its own first, so the timed epoch does not
    # carry the process's one-time set-up (autograd, cuBLAS handle)
    warm = train(uri, "dense", device, batch_rows, max_steps=1)
    telemetry.reset()
    hk.reset_launch_counts()
    main = train(uri, "dense", device, batch_rows)
    launches = {k: fn.launches for k, fn in hk.KERNELS.items()}
    hists = {name: telemetry.histogram(name).summary()
             for name in ("device_stage_us", "device_transfer_us",
                          "device_wait_us")}
    counters = {name: telemetry.counter(name).value
                for name in ("device_batches_total",
                             "device_transfer_bytes_total")}
    require(len(main["losses"]) == steps, "step count", steps=steps,
            got=len(main["losses"]))
    require(main["rows"] == rows, "rows consumed", rows=rows,
            got=main["rows"])
    require(np.all(np.isfinite(main["losses"]))
            and np.all(np.isfinite(main["w"]))
            and main["w"].shape == (FEATURES,), "non-finite or misshapen "
            "result", losses=main["losses"])
    if device == "cuda":
        require(launches["csr_to_dense"] == steps,
                "kernel launches on the main path", steps=steps,
                launches=launches)

    os.environ["DCT_CSR_TO_DENSE"] = "xla"
    segment = train(uri, "segment", device, batch_rows)
    os.environ["DCT_CSR_TO_DENSE"] = "pallas"
    cpu = train(uri, "dense", "cpu", batch_rows)
    gaps = {"vs_segment_" + device: compare(main, segment, "dense vs "
                                           "segment"),
            "vs_cpu_plain": compare(main, cpu, f"{device} vs cpu")}
    out = {"phase": "train", "device": device, "rows": rows,
           "batch_rows": batch_rows, "steps": steps,
           "file_write_s": write_s, "losses": main["losses"],
           "warmup_step_s": warm["step_s"][0],
           "epoch_s": main["seconds"], "rows_per_s": rows / main["seconds"],
           "steady_rows_per_s": main["steady_rows_per_s"],
           "step_s": main["step_s"],
           "step_s_median": statistics.median(main["step_s"]),
           "segment_epoch_s": segment["seconds"],
           "cpu_epoch_s": cpu["seconds"], "launches": launches,
           "histograms_us": hists, "counters": counters, "gaps": gaps}
    emit(out)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "env", "card": card, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "capability": list(torch.cuda.get_device_capability(0))})

    t0 = time.perf_counter()
    # every nvcc at once: the kernel's and its previous version's
    previous = start_previous_kernel_build()
    kernel_log = hk.build() or ""
    load_previous_kernel(*previous)
    t1 = time.perf_counter()
    native.build()
    t2 = time.perf_counter()
    emit({"phase": "build", "kernel_s": t1 - t0, "native_s": t2 - t1,
          "ptxas": [ln for ln in kernel_log.splitlines() if "ptxas" in ln]})

    cases = kernels_phase()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        run = train_phase(workdir)

    main_case = cases["train_65536x28"]
    emit({"kernels": [{
        "name": "csr_to_dense", "route": "cuda",
        "source": "dmlc_core_tpu_torch/csrc/csr_to_dense.cu",
        "replaces": "dmlc_core_tpu/ops/pallas_kernels.py:58",
        "launches": run["launches"]["csr_to_dense"],
        "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
        "ms": main_case["kernel_ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_us"] / 1e3,
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"]}]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
