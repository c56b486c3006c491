"""The kernel probe (``bench.py:583-628``): the hand-written CSR to dense
kernel against the library call, at the reference probe's shape.

The inputs are the reference's: 1,024 rows x 28 features, 28 nonzeros a
row, ``default_rng(11)`` column ids and normal values. Before any timing
the kernel's output is held to its plain version
(``csr_to_dense_reference``) at the reference's rtol/atol of 1e-5, and
the library call (``sparse_coo_tensor(...).to_dense()``, the
counterpart of the reference's XLA scatter-add) to it too. The two are
then timed with CUDA events around each call, interleaved, 5 rounds
queued behind a device sleep (the events time the device's work, not
the host's launch gaps): the best of 5 (the reference's figure) and the
median. At this shape the function moves about 0.46 MB, a fraction of a
microsecond at the card's memory rate: the times are the kernels' launch
and scheduling floor, and :func:`bound_ms` says so.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

from dmlc_core_tpu_torch.ops import hopper_kernels as hk

# H100 SXM data sheet peaks (the bound's denominators)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TOL = 1e-5  # the reference probe's rtol and atol
ROUNDS = 5
# about 50 ms of device sleep, far longer than queueing the timed calls
SLEEP_CYCLES = 100_000_000


def bound_ms(row, col, rows: int, features: int) -> "tuple[float, str]":
    """Least time for the function on these inputs, from what this data
    needs: every row id read (4 B) to find padding and out-of-range rows,
    the column id of each in-range row (4 B) and the value of each kept
    nonzero (4 B), the f32 output written once; against one f32 add per
    kept nonzero. Returns (ms, "bytes" or "operations")."""
    row_ok = (row >= 0) & (row < rows)
    n_row_ok = int(row_ok.sum())
    kept = int((row_ok & (col >= 0) & (col < features)).sum())
    t_bytes = (4 * (row.numel() + n_row_ok + kept)
               + 4 * rows * features) / HBM_BYTES_PER_S
    t_ops = kept / FP32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def library_csr_to_dense(r, c, v, rows: int, features: int):
    """One PyTorch call computing the kernel's function (a yardstick the
    port never calls): padding rows land on a spare row, cut off."""
    idx = torch.stack([r.long(), c.long()])
    return torch.sparse_coo_tensor(idx, v, (rows + 1, features),
                                   check_invariants=False).to_dense()[:rows]


def probe_inputs(batch_rows: int = 1024, features: int = 28,
                 nnz_per_row: int = 28):
    """The reference probe's host inputs: (row, col, val) as numpy."""
    rng = np.random.default_rng(11)
    nnz = batch_rows * nnz_per_row
    row = np.repeat(np.arange(batch_rows, dtype=np.int32), nnz_per_row)
    col = rng.integers(0, features, nnz).astype(np.int32)
    val = rng.normal(size=nnz).astype(np.float32)
    return row, col, val


def _rounds_ms(fns, rounds: int) -> list:
    """Device ms of each call of each ``fn``, interleaved for ``rounds``
    rounds: ``[[fn0 round 0, fn1 round 0, ...], ...]``. Every call sits
    between two CUDA events, queued behind a device sleep longer than the
    host takes to queue them all, so each pair times the call's device
    work and not the host's launch gaps between calls."""
    events = [[(torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True)) for _ in fns]
              for _ in range(rounds)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for row in events:
        for fn, (start, end) in zip(fns, row):
            start.record()
            fn()
            end.record()
    torch.cuda.synchronize()
    return [[s.elapsed_time(e) for s, e in row] for row in events]


def kernel_probe(device: torch.device, batch_rows: int = 1024,
                 features: int = 28, nnz_per_row: int = 28) -> dict:
    """``{"kernel_ms", "library_ms", "speedup", "rows_per_sec",
    "launches", ...}`` on a CUDA device; ``{"skipped": ...}`` elsewhere
    (the plain version measures nothing)."""
    if device.type != "cuda":
        return {"skipped": f"device is {device.type}, not cuda"}
    row, col, val = probe_inputs(batch_rows, features, nnz_per_row)
    r, c, v = (torch.from_numpy(a).to(device) for a in (row, col, val))
    R, F = batch_rows, features
    got = hk.csr_to_dense_kernel(r, c, v, R, F)
    want = hk.csr_to_dense_reference(r, c, v, R, F)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    torch.testing.assert_close(library_csr_to_dense(r, c, v, R, F), want,
                               rtol=TOL, atol=TOL)
    max_abs_err = float((got - want).abs().max())
    # launches of the probe's runs, the check's own not counted
    launches0 = hk.csr_to_dense_kernel.launches

    def kernel():
        hk.csr_to_dense_kernel(r, c, v, R, F)

    def library():
        library_csr_to_dense(r, c, v, R, F)

    kernel(), library()  # warm both outside the timed rounds
    torch.cuda.synchronize(device)
    # interleaved A/B rounds: drift charges both sides alike
    l_ms, k_ms = zip(*_rounds_ms((library, kernel), ROUNDS))
    b_ms, b_by = bound_ms(r, c, R, F)
    kernel_ms = min(k_ms)
    return {"rows": R, "features": F, "nnz": int(row.size),
            "check": f"kernel == plain version at rtol=atol={TOL}",
            "max_abs_err": max_abs_err,
            "kernel_ms": kernel_ms, "library_ms": min(l_ms),
            "kernel_ms_median": statistics.median(k_ms),
            "library_ms_median": statistics.median(l_ms),
            "speedup": min(l_ms) / kernel_ms,
            "rows_per_sec": R / (kernel_ms / 1e3),
            "bound_ms": b_ms, "bound_by": b_by,
            "launches": hk.csr_to_dense_kernel.launches - launches0}
