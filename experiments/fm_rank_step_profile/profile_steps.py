#!/usr/bin/env python3
"""Where the time of one FM step and one pairwise step goes, on one GPU.

    python3 experiments/fm_rank_step_profile/profile_steps.py

Run from the root of a checkout on a machine with one CUDA GPU. It needs
no native build: the batches are built in torch at the shapes of
``chip_smoke.py``'s ``fm`` and ``rank`` phases.

- FM (Criteo-shaped, 2^20 features, k = 8): a 65,536-row batch of 39
  nonzeros a row (2,555,904) in its 4,194,304-entry bucket, whose
  1,638,400 padding entries all carry row R and column 0, timed beside
  the same rows in a bucket with no padding. Each padding entry is an
  atomic add onto one row of the segment sums and, in the backward, onto
  row 0 of the gradients of ``w`` and ``v``.
- Pairwise ranking (MSLR-shaped, R = 8192, 136 features, query groups of
  20-220 rows).

Step times are medians of 20 steps between CUDA events (the loss is read
back in each step, as training does); then ``torch.profiler`` over 3 steps
lists the CUDA kernels by total device time. One JSON line each, the
card's ``name, power.limit`` line, and exit 0.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from dmlc_core_tpu_torch.device.device_iter import (DenseBatch,  # noqa: E402
                                                    PaddedBatch)
from dmlc_core_tpu_torch.models.fm import FMLearner  # noqa: E402
from dmlc_core_tpu_torch.models.linear import LinearLearner  # noqa: E402

ROWS = 65536
FIELDS = cs.CRITEO_INT_FIELDS + cs.CRITEO_CAT_FIELDS


def aux_pack(label, weight, qid=None):
    """[1, K, R] int32 aux pack: label bits, weight bits, [qid], nrows."""
    R = len(label)
    planes = [torch.from_numpy(label.astype(np.float32)).view(torch.int32),
              torch.from_numpy(weight.astype(np.float32)).view(torch.int32)]
    if qid is not None:
        planes.append(torch.from_numpy(qid.astype(np.int32)))
    nrows = torch.zeros(R, dtype=torch.int32)
    nrows[0] = R
    return torch.stack(planes + [nrows])[None].cuda()


def fm_batch(bucket: int) -> PaddedBatch:
    """The Criteo-shaped rows in a bucket of ``bucket`` entries; padding
    entries carry row R, column 0 and value 0, as the batchers write."""
    labels, cols, vals = cs.criteo_like(ROWS, seed=3)
    nnz = ROWS * FIELDS
    big = np.zeros((3, bucket), np.int32)
    big[0] = ROWS
    big[0, :nnz] = np.repeat(np.arange(ROWS), FIELDS)
    big[1, :nnz] = cols.reshape(-1)
    big[2, :nnz] = vals.reshape(-1).astype(np.float32).view(np.int32)
    return PaddedBatch(big=torch.from_numpy(big)[None].cuda(),
                       aux=aux_pack(labels, np.ones(ROWS)))


def rank_batch() -> DenseBatch:
    """An MSLR-shaped dense batch of 8192 rows: query groups of 20-220
    rows, labels 0-4, seeded normal features."""
    R = cs.RANK_BATCH_ROWS
    rng = np.random.default_rng(5)
    sizes = []
    while sum(sizes) < R:
        sizes.append(int(rng.integers(20, 221)))
    qid = np.repeat(np.arange(len(sizes)), sizes)[:R]
    x = rng.standard_normal((R, cs.MSLR_FEATURES), dtype=np.float32)
    label = rng.choice(5, R, p=[0.52, 0.32, 0.13, 0.02, 0.01])
    return DenseBatch(x=torch.from_numpy(x)[None].cuda(),
                      aux=aux_pack(label, np.ones(R), qid))


def step_ms(learner, params, batch, runs: int = 20) -> float:
    """Median milliseconds of one step with the loss read back."""
    for _ in range(3):
        learner.step(params, batch)
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        _, loss = learner.step(params, batch)
        float(loss)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_table(learner, params, batch, top: int = 12) -> dict:
    """CUDA kernels by total device time over 3 steps (milliseconds per
    step), from torch.profiler; empty when it saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            _, loss = learner.step(params, batch)
            float(loss)
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0)
        if dev_us and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((ev.key[:90], dev_us / 3 / 1e3, ev.count // 3))
    rows.sort(key=lambda r: -r[1])
    return {"kernels": [{"name": n, "ms_per_step": ms, "calls": c}
                        for n, ms, c in rows[:top]],
            "total_ms_per_step": sum(r[1] for r in rows)}


def main() -> int:
    if not torch.cuda.is_available():
        print("needs one CUDA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    fm = FMLearner(cs.CRITEO_FEATURES, k=cs.FM_RANK, device="cuda")
    params = fm.init(seed=0)
    padded = fm_batch(1 << 22)
    exact = fm_batch(ROWS * FIELDS)
    out = {"what": "fm_step", "rows": ROWS, "nnz": ROWS * FIELDS,
           "padded_bucket": 1 << 22,
           "padded_ms": step_ms(fm, params, padded),
           "unpadded_ms": step_ms(fm, params, exact)}
    out["padded_again_ms"] = step_ms(fm, params, padded)
    out["profile_padded"] = kernel_table(fm, params, padded)
    out["profile_unpadded"] = kernel_table(fm, params, exact)
    print(json.dumps(out), flush=True)

    rank = LinearLearner(cs.MSLR_FEATURES, objective="pairwise",
                         device="cuda")
    rp = rank.init()
    rb = rank_batch()
    print(json.dumps({"what": "rank_step", "rows": cs.RANK_BATCH_ROWS,
                      "step_ms": step_ms(rank, rp, rb),
                      "profile": kernel_table(rank, rp, rb)}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
