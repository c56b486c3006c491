#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one GPU and check what comes out.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA GPU, the
CUDA toolkit (nvcc) and a C++ compiler. Phases, one JSON line each:

1. ``env``     — the card, its power limit, torch and CUDA versions; TF32
                 off for matmuls and cuDNN (the reference asks for full f32).
2. ``build``   — the CUDA kernel (``csrc/*.cu``, sm_90a), the native core
                 (``cpp/``) and the bench's ``bench_pipeline`` (g++ of
                 ``cpp/test/bench_pipeline.cc``), all from the checkout's
                 sources into ``dmlc_core_tpu_torch/_build/`` at once;
                 the kernel's and the native core's seconds, the seconds
                 until the last build finished, and ptxas info.
   ``data``    — the HIGGS-shaped libsvm file (28 features, 524,288 rows)
                 and the port's converter's ``.crec`` and bf16 ``.drec``
                 files of it, as ``bench.py`` converts HIGGS; the text
                 file through ``data.RowBlockIter.create(cache_dir=...)``
                 for two epochs (a parse that tees the shard cache, then
                 its replay, equal bit for bit), a ``RowBlockContainer``
                 save/load round trip, host rows/s of each epoch and
                 ``pipeline_stats()``.
   ``surface`` — the public surface in a fresh interpreter, as a user
                 reaches it: ``import dmlc_core_tpu_torch`` loads neither
                 torch nor numpy (its seconds); every package-level export
                 of the top level, ``io``, ``ops``, ``utils`` and ``device``
                 resolves; one 65,536 x 28 batch of the ``data`` file parsed
                 through ``io``'s exports goes through
                 ``ops.csr_to_dense(impl="pallas")``, equal to
                 ``impl="xla"`` bit for bit with one launch (counted); a
                 loopback ``RabitTracker`` logs ``tracker listening on`` in
                 the reference's ``[HH:MM:SS] INFO`` format on stderr.
   ``qa``      — the port's QA lane on this machine:
                 ``python -m dmlc_core_tpu_torch.qa.analyze`` over the
                 checkout (its struct layout probe compiled by the compiler
                 that builds the native core here) and
                 ``python -m dmlc_core_tpu_torch.qa.lint``; the finding
                 count, the lint's files with problems, whether the probe
                 ran and the seconds. Any finding, lint problem or skipped
                 probe fails the run.
3. ``kernels`` — every hand-written kernel against its plain PyTorch version
                 on the card: the bench probe shape, the training shape
                 (also with its nonzeros permuted), a real ``.crec`` batch
                 at that lane's bucket, duplicates, padding
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
   ``telemetry`` — the same epoch again on a learner of its own under
                 ``torch_profiler_capture`` (``DMLC_TORCH_PROFILE``): the
                 capture ran, the trace lines up with the ``train.step``
                 spans through the clock anchors, it holds a launch of
                 the kernel a step, the losses equal ``train``'s at rtol
                 1e-5. It prints the stall verdict and occupancy, the
                 overlap ratio, the card's busy share over the epoch's
                 wall window (merged kernels, memcpys and memsets), the
                 top device operations with launches, the longest idle
                 gaps with the spans covering them, and the exposition's
                 ``stall_verdict_code`` / ``device_overlap_ratio``, which
                 must equal the values computed in the phase.
5. ``serve``   — the rest of the main path: the trained parameters through
                 ``save_checkpoint``/``restore_checkpoint`` (back on the
                 card bit for bit) and ``save_model``; an in-process
                 ``ScoringServer`` on the default device scoring 256
                 requests of 1-64 held-out HIGGS-like rows, each score
                 held to float64 ``sigmoid(w.x + b)`` at atol 1e-5 and to
                 the port's CPU forward at rtol 1e-6; then
                 ``python -m dmlc_core_tpu_torch.serving`` on the
                 reference's serving-lane configuration (16,384 features,
                 2-8 rows of 16 nonzeros, buckets 16,64,256) warmed with
                 traffic (2 clients, then 8), a 5-s closed loop of 8
                 clients (QPS, client p50/p99, the server's forward,
                 parse and request medians from /metrics), no errors and
                 no new shape after the warm-up, and a SIGTERM drain that
                 exits 0. Kernel launch counts are zeroed before and read
                 after: the serving forward runs no hand-written kernel.
6. ``lanes``   — the ``train`` phase's file through every
                 ``DeviceRowBlockIter`` lane, one epoch of
                 ``LinearLearner(28)`` each: ``.drec`` against the dense
                 bf16 text lane (batches and losses bit for bit); text CSR
                 and ``index64=True`` (batches bit for bit, losses at rtol
                 1e-5: the segment margin sums with atomics); ``.crec``
                 with the dense margin through the kernel (launches
                 counted on this run alone) against the ``train`` run at
                 rtol 1e-5; bf16 CSR values against the CPU run at rtol
                 1e-5. Rows/s and ``device_stage_us`` per lane.
   ``host``    — host batches: the ``train`` phase's text file and its
                 ``.crec`` through ``DeviceRowBlockIter(to_device=False)``,
                 one epoch each: numpy batches bit for bit the same lane's
                 device batches' ``.cpu()``, none pinned, no device
                 counter moved and ``torch.cuda.memory_allocated()``
                 unchanged across the host epoch; 8 ``LinearLearner``
                 steps with the dense margin (the kernel, launches counted
                 on this run alone) on host ``.crec`` batches and
                 ``predict``, against the same run on the device batches
                 at rtol 1e-5; the bench's host-tree probe and replay
                 first pass, now through ``to_device=False``, the same
                 trees as the host batcher gives. Host-epoch rows/s of
                 both lanes and the step median.
7. ``fm``      — a Criteo-shaped factorization machine at full width
                 (39 libfm fields, 2^20 hashed features, k = 8): one epoch
                 of 4 x 65,536 rows after a warm-up step, its first 2
                 steps against the port's CPU run, the dense margin of a
                 ``.drec`` batch against the CSR margin of the same rows,
                 and the trained model served (``save_model``,
                 ``ScoringModel``) against float64 FM math at atol 1e-5.
8. ``rank``    — MSLR-WEB30K-shaped pairwise ranking (136 features, labels
                 0-4, about 120 documents a query): one epoch of
                 ``LinearLearner(136, objective="pairwise")`` at 8 x 8192
                 rows against the CPU run at rtol 1e-5, and the
                 learner's refusals of R = 16,384 and of data without
                 qids.
9. ``dp``      — data-parallel worlds of real processes under the launcher
                 env protocol, each with its own timeout (this script in
                 ``dp-worker`` mode, or the training CLI): (a) the ``train``
                 phase's run in an NCCL world of one rank, bit for bit
                 (else the gap, at most rtol 1e-5); (b) two ranks sharing
                 the card over gloo on the same file, 32,768 rows a rank a
                 step through the kernel, against one process stepping on
                 the union of their batches at rtol 1e-5 (atol 1e-7 on
                 weights), replicas bit-identical, a launch a step on each
                 rank; the Criteo-shaped FM for 2 steps in the same world
                 against its union run at the ``fm`` phase's tolerances;
                 (c) ``python -m dmlc_core_tpu_torch.train`` in a 2-rank
                 world: a job checkpoint each epoch (parts and marker
                 checked), then ``--resume`` from the step committed
                 after epoch 1, equal to the uninterrupted epoch-1 line at
                 rtol 1e-5. Per world: step median, rows/s, bytes reduced
                 a step, a bare all_reduce of that buffer (median of 20,
                 host clock) and the backend. In (b) every rank ships its
                 ``telemetry.rank_export()`` through ``allgather_bytes``;
                 rank 0 renders ``cluster_prometheus_text``, holds every
                 ``job:`` counter to the sum of the ranks' counters and
                 prints the ``straggler_attribution`` verdict over the
                 ranks' step durations. One card: the 2-rank worlds
                 measure the code path, not NCCL between cards.
10. ``job``    — the distributed job under the port's tracker: the
                 ``train`` phase's file uploaded through the native
                 stream to a loopback mock S3 in this process
                 (``tests/mock_s3.py``), then two runs of
                 ``python -m dmlc_core_tpu_torch.tracker.submit --cluster
                 local --num-workers 2 --heartbeat-ms 200 --dead-after-ms
                 2000`` whose workers are this script (``job-*-worker``
                 modes) on the card, reading ``s3://``. Run A
                 (``--num-shards 16``): ``ElasticDeviceRowBlockIter`` at
                 16,384 rows a batch, a dense-margin step a batch; task 0
                 SIGKILLs itself holding its second lease and the
                 supervisor relaunches it; every shard completed exactly
                 once, each shard's batches bit for bit those of the local
                 file's ``part=shard, npart=16`` (sha256 of the planes),
                 the event log showing the victim dead and its shard
                 granted again. Run B (``--mesh``): a gloo world of two
                 ranks, 8 steps of a 65,536-row global batch under a
                 ``StepWatchdog``, job checkpoints on ``s3://`` after steps
                 2, 4, 6; rank 1 SIGKILLs itself in step 5 of attempt 0,
                 the survivor's structured abort (exit 41, abort record)
                 within 2 x dead-after, the world relaunched, attempt 1
                 from step 4; the 8 losses against one process on the
                 union batches at rtol 1e-5, step 4's loss of both attempts
                 bit for bit. Kill -> re-grant, kill -> survivor exit,
                 the relaunch gap, rows/s, shard start cost and the
                 largest heartbeat age the tracker reported.
11. ``lm``     — the LM lane at ``examples/train_lm.py``'s width (vocab
                 256, embed 128, 4 heads, 2 layers, seq 2048; batch 8,
                 lr 0.05, 6 steps of ``byte_windows(seed=0)`` over the
                 repo's text: ``SURVEY.md`` then ``doc/*.md``, size and
                 sha256 printed). (a) The ring model and the TP model
                 with 4 experts on a 1 x 1 mesh of the card against the
                 port's CPU run of the same steps (losses rtol 1e-4,
                 parameters rtol 5e-4, atol 1e-5), the loss falling; step
                 median, tokens/s, peak device bytes, the step's FLOP
                 count and its share of the FP32 peak, and one more step
                 under ``torch.profiler`` (busy share, top device ops).
                 (b) One 2-rank gloo world sharing the card (this script
                 in ``lm-worker`` mode): the ring at ``data=1,seq=2`` and
                 TP + MoE at ``data=1,model=2`` against (a) (the ring's
                 parameters at rtol 5e-4, atol 1e-5 and losses at rtol
                 1e-5; TP losses at rtol 2e-5, atol 2e-5), replicas bit
                 for bit; zigzag ring attention against ``mha_reference``
                 (rtol 2e-4, atol 2e-5); a 2-stage ``pipeline_apply``
                 forward and backward against the sequential program
                 (rtol 1e-5, atol 1e-5); the median of 20 bare host-staged
                 exchanges of one K/V block. (c) ``python -m
                 dmlc_core_tpu_torch.train_lm --mesh data=1,seq=2`` under
                 ``tracker.submit --mesh`` with job checkpoints every 3
                 steps, then resumed from the step-3 commit: the printed
                 losses of steps 3-5 and the step-6 parameters at rtol
                 1e-5. The lane launches no ``csr_to_dense``.
12. ``bench``  — ``python -m dmlc_core_tpu_torch.bench --rows 524288``,
                 the port's counterpart of ``bench.py``, in a process
                 session of its own under its own timeout, on the bench's
                 own seeded HIGGS-shaped file (``bench.py``'s bytes): one
                 JSON line on stdout with the metric
                 ``higgs_libsvm_ingest_rows_per_sec`` and a value above 0,
                 the card's ``name, power.limit`` in ``extras.device``,
                 ``hbm_ingest_bw_util`` in (0, 1] with the pinned-copy
                 probe, not the lane's own best epoch, setting its
                 denominator (headline, ``recd`` lane, device lane), the
                 kernel probe's check (kernel against plain version at
                 1e-5) passed with launches, the device lane's every row
                 counted, the serving lane without errors, an SLO page or
                 a new shape after its warm-up, the mesh lane's
                 ``steps_per_sec`` and ``recovery_s``, and the record line
                 it appended. The kernel's launches are the probe's, less
                 its correctness check.

Each configuration keeps its published widths; row counts are cut, and
each phase's JSON names the cut (``reduced``).

Then the ``{"kernels": [...]}`` summary line, the card's
``name, power.limit`` line from nvidia-smi, and last
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
the last line; without CUDA the script exits non-zero at once.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import gc
import hashlib
import http.client
import io
import json
import math
import os
import random
import re
import select
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from dmlc_core_tpu_torch import telemetry  # noqa: E402
from dmlc_core_tpu_torch.bench import host_lanes  # noqa: E402
from dmlc_core_tpu_torch.bench.kernel_probe import (  # noqa: E402
    FP32_FLOP_PER_S, bound_ms)
from dmlc_core_tpu_torch.bench.record import card_line  # noqa: E402
from dmlc_core_tpu_torch.data import (RowBlockContainer,  # noqa: E402
                                      RowBlockIter)
from dmlc_core_tpu_torch.device import device_iter  # noqa: E402
from dmlc_core_tpu_torch.io import convert, native  # noqa: E402
from dmlc_core_tpu_torch.io.native import NativeParser  # noqa: E402
from dmlc_core_tpu_torch.models.convert import (  # noqa: E402
    fm_params_from_numpy, fm_params_to_numpy, linear_params_to_numpy)
from dmlc_core_tpu_torch.models.fm import FMLearner, FMParams  # noqa: E402
from dmlc_core_tpu_torch.models.linear import (LinearLearner,  # noqa: E402
                                               LinearParams)
from dmlc_core_tpu_torch.ops import hopper_kernels as hk  # noqa: E402
from dmlc_core_tpu_torch.serving import batching  # noqa: E402
from dmlc_core_tpu_torch.serving.model import (ScoringModel,  # noqa: E402
                                               save_model)
from dmlc_core_tpu_torch.serving.server import ScoringServer  # noqa: E402
from dmlc_core_tpu_torch.utils.checkpoint import (  # noqa: E402
    restore_checkpoint, save_checkpoint)
from dmlc_core_tpu_torch.utils.timer import trace_span  # noqa: E402

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


# -- phase 2b: the public surface, standing alone ----------------------------
SURFACE_TIMEOUT_S = 180
SURFACE_TRACKER_LINE = re.compile(
    r"^\[\d\d:\d\d:\d\d\] INFO tracker listening on 127\.0\.0\.1:\d+$", re.M)

# Run in a fresh interpreter (this script has torch and numpy loaded):
# argv = repo, the HIGGS-shaped libsvm file, the device, the batch's rows.
# One JSON line on stdout; the tracker's log lines go to stderr through
# the package handler.
SURFACE_CHILD = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
t0 = time.perf_counter()
import dmlc_core_tpu_torch as dct
out = {"import_s": time.perf_counter() - t0,
       "torch_after_import": "torch" in sys.modules,
       "numpy_after_import": "numpy" in sys.modules}
import dmlc_core_tpu_torch.device as ddevice
import dmlc_core_tpu_torch.io as dio
import dmlc_core_tpu_torch.ops as dops
import dmlc_core_tpu_torch.utils as dutils
exports = {}
for mod in (dct, dio, dops, dutils, ddevice):
    names = getattr(mod, "__all__", None) or [
        a for a in dir(mod) if not a.startswith("_")]
    for name in names:
        getattr(mod, name)
    exports[mod.__name__] = len(names)
out["exports"] = exports
import numpy as np
import torch
from dmlc_core_tpu_torch.ops import hopper_kernels
device, rows, features = sys.argv[3], int(sys.argv[4]), 28
t0 = time.perf_counter()
b = dio.NativeBatcher(sys.argv[2], fmt="libsvm", batch_rows=rows)
try:
    take, bucket, max_index = b.next_meta()[:3]
    row = np.empty(bucket, np.int32)
    col = np.empty(bucket, np.int32)
    val = np.empty(bucket, np.float32)
    label = np.empty(rows, np.float32)
    weight = np.empty(rows, np.float32)
    nrows = np.empty(1, np.int32)
    b.fill_csr(row, col, val, label, weight, nrows)
finally:
    b.close()
out.update(parse_s=time.perf_counter() - t0, rows=int(take),
           bucket=int(bucket), max_index=int(max_index))
r, c, v = (torch.from_numpy(a).to(device) for a in (row, col, val))
before = hopper_kernels.csr_to_dense_kernel.launches
got = dops.csr_to_dense(r, c, v, int(take), features, impl="pallas")
launches = hopper_kernels.csr_to_dense_kernel.launches - before
want = dops.csr_to_dense(r, c, v, int(take), features, impl="xla")
if device == "cuda":
    torch.cuda.synchronize()
out.update(launches=launches, shape=list(got.shape),
           device=got.device.type, equal=bool(torch.equal(got, want)),
           finite=bool(torch.isfinite(got).all()),
           max_abs_err=float((got - want).abs().max()))
from dmlc_core_tpu_torch.tracker.rendezvous import RabitTracker
t = RabitTracker("127.0.0.1", 1)
t.start()
t.stop()
t.join(timeout=30)
print(json.dumps(out), flush=True)
"""


def surface_phase(text_uri: str, device: str = "cuda",
                  rows: int = BATCH_ROWS) -> dict:
    """The package's public surface in a fresh interpreter, as a user
    reaches it: ``import dmlc_core_tpu_torch`` loads neither torch nor
    numpy; every package-level export of the top level, ``io``, ``ops``,
    ``utils`` (its lazy checkpoint names too) and ``device`` resolves; one
    ``rows`` x 28 batch of ``text_uri`` parsed through ``io``'s exports goes
    through ``ops.csr_to_dense(impl="pallas")``, which equals
    ``impl="xla"`` bit for bit (the ``kernels`` phase's tolerance at this
    shape) with one kernel launch on the card; and a loopback
    ``RabitTracker`` logs ``tracker listening on`` in the reference's
    format on the child's stderr."""
    repo = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", SURFACE_CHILD, repo, text_uri, device,
         str(rows)],
        capture_output=True, text=True, timeout=SURFACE_TIMEOUT_S, cwd=repo)
    seconds = time.perf_counter() - t0
    require(proc.returncode == 0, "surface: the child failed",
            rc=proc.returncode, stderr=proc.stderr[-3000:])
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    require(not res["torch_after_import"] and not res["numpy_after_import"],
            "surface: import dmlc_core_tpu_torch loaded torch or numpy",
            **res)
    require(res["rows"] == rows and res["max_index"] < FEATURES,
            "surface: the parsed batch's shape", **res)
    require(res["shape"] == [rows, FEATURES]
            and res["device"] == device and res["finite"],
            "surface: csr_to_dense output shape, device or values", **res)
    require(res["equal"], "surface: the kernel disagrees with its plain "
            "version", **res)
    require(res["launches"] == (1 if device == "cuda" else 0),
            "surface: kernel launches through ops.csr_to_dense", **res)
    tracker_lines = SURFACE_TRACKER_LINE.findall(proc.stderr)
    require(len(tracker_lines) == 1, "surface: the tracker's INFO line in "
            "the reference's format", stderr=proc.stderr[-3000:])
    out = {"phase": "surface", "device": device, "seconds": seconds,
           **{k: res[k] for k in ("import_s", "torch_after_import",
                                  "numpy_after_import", "exports",
                                  "parse_s", "rows", "bucket", "equal",
                                  "max_abs_err")},
           "tracker_line": tracker_lines[0],
           "launches": {"csr_to_dense": res["launches"]}}
    emit(out)
    return out


# -- phase 2c: the port's QA lane -------------------------------------------
QA_TIMEOUT_S = 300


def qa_phase() -> dict:
    """The port's analyzer over this checkout, with the layout probe of
    ``cpp/src/capi.cc``'s structs compiled here, and the port's lint, each
    in a process of its own. Emits the ``qa`` line before its checks: any
    finding, lint problem or skipped probe fails the run."""
    repo = os.path.dirname(os.path.abspath(__file__))

    def run(module: str):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", module],
                              capture_output=True, text=True,
                              timeout=QA_TIMEOUT_S, cwd=repo)
        return proc, time.perf_counter() - t0

    analyze, analyze_s = run("dmlc_core_tpu_torch.qa.analyze")
    lint, lint_s = run("dmlc_core_tpu_torch.qa.lint")
    count = re.search(r"analyze: repo: (\d+) finding\(s\)", analyze.stdout)
    probe = re.search(r"layout probe ran over (\d+) struct", analyze.stdout)
    checked = re.search(r"lint: (\d+) files checked, (\d+) with problems",
                        lint.stdout)
    out = {"phase": "qa",
           "findings": int(count.group(1)) if count else None,
           "layout_probe": "ran" if probe else "skipped",
           "probe_structs": int(probe.group(1)) if probe else 0,
           "lint_files": int(checked.group(1)) if checked else None,
           "lint_files_with_problems":
               int(checked.group(2)) if checked else None,
           "analyze_s": analyze_s, "lint_s": lint_s,
           "seconds": analyze_s + lint_s}
    emit(out)
    require(analyze.returncode == 0 and out["findings"] == 0,
            "qa: the port's analyzer has findings", rc=analyze.returncode,
            stdout=analyze.stdout[-3000:], stderr=analyze.stderr[-3000:])
    require(probe is not None, "qa: the struct layout probe was skipped",
            stdout=analyze.stdout[-3000:])
    require(lint.returncode == 0 and out["lint_files_with_problems"] == 0,
            "qa: the port's lint has problems", rc=lint.returncode,
            stdout=lint.stdout[-3000:], stderr=lint.stderr[-3000:])
    return out


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


def start_bench_pipeline_build() -> "tuple[subprocess.Popen, str]":
    """Start g++ on the bench's engine-level RecordIO program (its
    ``recordio_roundtrip`` lane runs it) beside the other builds; returns
    the process and the file it writes."""
    os.makedirs(hk.BUILD_DIR, exist_ok=True)
    tmp = f"{host_lanes.BENCH_PIPELINE}.tmp{os.getpid()}"
    proc = subprocess.Popen(host_lanes.bench_pipeline_command(tmp),
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def finish_bench_pipeline_build(proc: subprocess.Popen, tmp: str) -> None:
    log = proc.communicate(timeout=900)[0]
    require(proc.returncode == 0, "bench_pipeline build", log=log[-2000:])
    os.replace(tmp, host_lanes.BENCH_PIPELINE)


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


def kernels_phase(extra_cases=()) -> dict:
    rng = np.random.default_rng(0)
    results = []
    for name, row, col, val, R, F, tol, library_ok in (
            kernel_cases(rng) + list(extra_cases)):
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
    fm = fm_kernel_case()
    emit({"phase": "kernels", "cases": results, "fm": fm})
    return {**{rec["case"]: rec for rec in results}, "fm": fm}


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
    the iterator's start (``t0``, ``perf_counter`` seconds) to the last
    loss read back (``t1``); ``steady_rows_per_s`` counts steps 2..N
    only, from the end of step 1 to the end of step N. Each step, loss
    read back included, is a ``train.step`` telemetry span and a
    ``record_function`` row of a running profiler capture."""
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
            with telemetry.span("train.step"), \
                    trace_span("train.step", profiler=True):
                params, loss = learner.step(params, batch)
                losses.append(float(loss))  # synchronizes the step
            step_end.append(time.perf_counter())
            step_s.append(step_end[-1] - ts)
            step_rows.append(batch.total_rows)
            if max_steps is not None and len(losses) == max_steps:
                break
    t1 = time.perf_counter()
    steady = (sum(step_rows[1:]) / (step_end[-1] - step_end[0])
              if len(step_end) > 1 else None)
    return {"losses": losses, "w": params.w.cpu().numpy(),
            "b": float(params.b), "step_s": step_s, "rows": sum(step_rows),
            "seconds": t1 - t0, "t0": t0, "t1": t1,
            "steady_rows_per_s": steady, "params": params}


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


def write_higgs_files(workdir: str, rows: int = TRAIN_ROWS) -> dict:
    """The HIGGS-shaped libsvm file of the ``train`` phase and the port's
    conversions of it, as ``bench.py`` converts HIGGS: ``.crec`` (CSR
    device planes) and ``.drec`` (bf16 row matrices). Paths and seconds."""
    out = {"text": os.path.join(workdir, "higgs_like.libsvm"),
           "crec": os.path.join(workdir, "higgs_like.crec"),
           "drec": os.path.join(workdir, "higgs_like.drec"), "rows": rows}
    t0 = time.perf_counter()
    write_higgs_like(out["text"], rows)
    t1 = time.perf_counter()
    require(convert.rows_to_csr_recordio(out["text"], out["crec"]) == rows,
            "crec conversion row count")
    t2 = time.perf_counter()
    require(convert.rows_to_dense_recordio(out["text"], out["drec"],
                                           dtype="bf16") == rows,
            "drec conversion row count")
    out.update(text_write_s=t1 - t0, crec_convert_s=t2 - t1,
               drec_convert_s=time.perf_counter() - t2,
               bytes={k: os.path.getsize(out[k])
                      for k in ("text", "crec", "drec")})
    return out


def crec_kernel_case(crec_uri: str, batch_rows: int = BATCH_ROWS):
    """A kernel case (see kernel_cases) from the first batch of the
    ``.crec`` lane, at that lane's own static nnz bucket."""
    hb = device_iter.CsrRecHostBatcher(crec_uri, batch_rows=batch_rows)
    try:
        b = hb.next_batch()
    finally:
        hb.close()
    row, col, val = (np.ascontiguousarray(a[0]) for a in (b.row, b.col,
                                                          b.val))
    return (f"crec_batch_{batch_rows}x{FEATURES}", row, col, val,
            batch_rows, FEATURES, "exact", True)


def train_phase(uri: str, device: str = "cuda", rows: int = TRAIN_ROWS,
                batch_rows: int = BATCH_ROWS
                ) -> "tuple[dict, LinearParams]":
    """Main path on ``device`` (dense margin through the kernel) over the
    ``rows``-row HIGGS-shaped file ``uri``, then the segment path on
    ``device`` and the dense path on the CPU, compared. Returns the
    phase's record and the main run's trained parameters."""
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
           "losses": main["losses"],
           "warmup_step_s": warm["step_s"][0],
           "epoch_s": main["seconds"], "rows_per_s": rows / main["seconds"],
           "steady_rows_per_s": main["steady_rows_per_s"],
           "step_s": main["step_s"],
           "step_s_median": statistics.median(main["step_s"]),
           "segment_epoch_s": segment["seconds"],
           "cpu_epoch_s": cpu["seconds"], "launches": launches,
           "histograms_us": hists, "counters": counters, "gaps": gaps}
    emit(out)
    return out, main["params"]


# -- phase 4b: the telemetry plane and the card's own timeline ---------------
KERNEL_SYMBOL = "csr_to_dense_f32_kernel"  # csrc/csr_to_dense.cu
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
GAP_SPANS = ("device.stage", "device.put", "device.wait", "train.step")
TOP_OPS = 8
TOP_GAPS = 5


def trace_clock_shift_us(trace: dict, anchors: dict) -> "tuple[float, str]":
    """The microseconds to add to a Chrome-trace ``ts`` (plus the file's
    ``baseTimeNanoseconds``) to land on the ``perf_counter`` clock of the
    telemetry spans, and the clock the profiler wrote: ``wall`` when the
    trace's times fall inside the capture's wall-clock anchors, ``mono``
    when they fall inside its monotonic ones (``perf_counter`` is
    CLOCK_MONOTONIC on Linux)."""
    base = trace.get("baseTimeNanoseconds", 0) / 1e3
    times = [e["ts"] + base for e in trace["traceEvents"]
             if e.get("ph") == "X"]
    require(bool(times), "profiler trace holds no complete event")
    lo, hi = min(times), max(times)
    slack = 60e6
    a, b = anchors["start"], anchors["stop"]
    if a["wall_us"] - slack <= lo and hi <= b["wall_us"] + slack:
        return base - (a["wall_us"] - a["perf_us"]), "wall"
    if a["perf_us"] - slack <= lo and hi <= b["perf_us"] + slack:
        return base, "mono"
    require(False, "profiler trace on an unknown clock", first_us=lo,
            anchors=anchors)


def merge_intervals(iv: list) -> list:
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def device_timeline(trace: dict, shift_us: float, t0_us: float,
                    t1_us: float, spans: list) -> dict:
    """The card's side of the window [t0_us, t1_us] (``perf_counter``
    microseconds): the busy share (merged kernels, memcpys and memsets
    over the window), the top device operations by total time with their
    launches, and the longest idle gaps, each with the telemetry spans
    that cover it."""
    ops, busy = {}, []
    for e in trace["traceEvents"]:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a = e["ts"] + shift_us
        b = a + e.get("dur", 0)
        rec = ops.setdefault(e["name"], {"cat": e["cat"], "launches": 0,
                                         "total_us": 0.0})
        rec["launches"] += 1
        rec["total_us"] += b - a
        lo, hi = max(a, t0_us), min(b, t1_us)
        if hi > lo:
            busy.append((lo, hi))
    merged = merge_intervals(busy)
    busy_us = sum(b - a for a, b in merged)
    edges = [t0_us] + [x for iv in merged for x in iv] + [t1_us]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2)), reverse=True)
    top_gaps = []
    for dur, a, b in gaps[:TOP_GAPS]:
        cover = {}
        for sp in spans:
            if sp["name"] not in GAP_SPANS:
                continue
            ov = min(b, sp["ts"] + sp["dur"]) - max(a, sp["ts"])
            if ov > 0:
                cover[sp["name"]] = cover.get(sp["name"], 0.0) + ov
        top_gaps.append({"us": dur, "from_epoch_start_us": a - t0_us,
                         "covered_by_us": dict(sorted(
                             cover.items(), key=lambda kv: -kv[1]))})
    top = sorted(ops.items(), key=lambda kv: -kv[1]["total_us"])[:TOP_OPS]
    return {"window_us": t1_us - t0_us, "busy_us": busy_us,
            "busy_share": busy_us / (t1_us - t0_us),
            "device_events": sum(o["launches"] for o in ops.values()),
            "top_ops": [{"name": k, **v} for k, v in top],
            "idle_gaps": top_gaps,
            "kernel_launches": sum(o["launches"] for k, o in ops.items()
                                   if KERNEL_SYMBOL in k)}


def exposition_value(text: str, name: str) -> float:
    """The value of the unlabeled sample ``name`` in exposition text."""
    (line,) = [ln for ln in text.splitlines() if ln.startswith(name + " ")]
    return float(line.split()[1])


def telemetry_phase(uri: str, train_losses: list, workdir: str,
                    device: str = "cuda", rows: int = TRAIN_ROWS,
                    batch_rows: int = BATCH_ROWS) -> dict:
    """The ``train`` phase's epoch again, on a learner of its own, under
    ``torch_profiler_capture``: the stall verdict and occupancy, the
    overlap ratio, the card's busy share over the epoch's wall window,
    the top device operations and the longest idle gaps with the spans
    that cover them, and the exposition's derived gauges against the
    values computed here."""
    steps = -(-rows // batch_rows)
    prof_dir = os.path.join(workdir, "torch_profile")
    os.environ["DCT_CSR_TO_DENSE"] = "pallas"
    os.environ["DMLC_TORCH_PROFILE"] = prof_dir
    try:
        telemetry.reset()
        hk.reset_launch_counts()
        with device_iter.torch_profiler_capture(device) as captured:
            run = train(uri, "dense", device, batch_rows)
    finally:
        del os.environ["DMLC_TORCH_PROFILE"]
    launches = {k: fn.launches for k, fn in hk.KERNELS.items()}
    require(captured, "the profiler capture did not run")
    pid = os.getpid()
    with open(os.path.join(prof_dir, f"torch_trace_{pid}.json")) as f:
        trace = json.load(f)
    with open(os.path.join(prof_dir, f"dmlc_anchor_{pid}.json")) as f:
        anchors = json.load(f)
    shift, clock = trace_clock_shift_us(trace, anchors)
    spans = telemetry.spans()
    # the step spans against their record_function rows on one clock
    rows_ts = sorted(e["ts"] + shift for e in trace["traceEvents"]
                     if e.get("ph") == "X" and e.get("name") == "train.step"
                     and e.get("cat") == "user_annotation")
    span_ts = sorted(s["ts"] for s in spans if s["name"] == "train.step")
    require(len(rows_ts) == len(span_ts) == steps, "train.step rows",
            rows=len(rows_ts), spans=len(span_ts))
    align = max(abs(a - b) for a, b in zip(rows_ts, span_ts))
    require(align < 2000.0, "trace and spans misaligned", max_us=align)
    timeline = device_timeline(trace, shift, run["t0"] * 1e6,
                               run["t1"] * 1e6, spans)
    if device == "cuda":
        require(timeline["kernel_launches"] == steps
                and launches["csr_to_dense"] == steps,
                "kernel launches in the trace", steps=steps,
                trace=timeline["kernel_launches"], counted=launches)
    require(np.allclose(run["losses"], train_losses, rtol=1e-5, atol=0),
            "telemetry epoch's losses differ from train's",
            got=run["losses"], want=train_losses)
    snap = telemetry.snapshot()
    att = telemetry.stall_attribution(snap)
    ratio = telemetry.device_overlap_ratio()
    text = telemetry.prometheus_text(snap)
    code = exposition_value(text, "stall_verdict_code")
    shown_ratio = exposition_value(text, "device_overlap_ratio")
    require(code == telemetry.VERDICT_CODES[att["verdict"]]
            and shown_ratio == (-1.0 if ratio is None else ratio),
            "exposition's derived gauges", code=code, ratio=shown_ratio,
            verdict=att["verdict"], computed_ratio=ratio)
    out = {"phase": "telemetry", "device": device, "rows": rows,
           "batch_rows": batch_rows, "steps": steps,
           "trace_clock": clock, "alignment_max_us": align,
           "epoch_s": run["seconds"], "rows_per_s": rows / run["seconds"],
           "stall_verdict": att["verdict"], "occupancy": att["occupancy"],
           "stage_us": att["stage_us"], "device_overlap_ratio": ratio,
           "device_busy_share": timeline["busy_share"],
           "timeline": timeline, "launches": launches,
           "exposition": {"stall_verdict_code": code,
                          "device_overlap_ratio": shown_ratio},
           "trace_bytes": os.path.getsize(os.path.join(
               prof_dir, f"torch_trace_{pid}.json"))}
    emit(out)
    return out


# -- the host data library: RowBlockIter and the shard cache -----------------
def container_bytes(c) -> bytes:
    buf = io.BytesIO()
    c.save(buf)
    return buf.getvalue()


def rowblock_epochs(uri: str, cache_dir: str) -> dict:
    """The text file through ``RowBlockIter.create(cache_dir=...)`` for two
    epochs, a parse that tees the shard cache and its replay: the blocks
    equal bit for bit, a ``RowBlockContainer`` save/load round trip, host
    rows/s of each epoch and the parser's ``pipeline_stats()``."""
    def cache_counters():
        return {c["name"]: c["value"]
                for c in native.native_telemetry_snapshot()["counters"]
                if c["name"].startswith("cache_")}

    epochs = []
    with RowBlockIter.create(uri, cache_dir=cache_dir) as it:
        for _ in range(2):
            before = cache_counters()
            t0 = time.perf_counter()
            merged = RowBlockContainer.from_blocks(list(it))
            secs = time.perf_counter() - t0
            after = cache_counters()
            epochs.append({"container": merged, "seconds": secs,
                           "rows_per_s": merged.size / secs,
                           "pipeline_stats": it.pipeline_stats(),
                           "cache": {k: after[k] - before.get(k, 0)
                                     for k in after}})
    first, second = (e.pop("container") for e in epochs)
    same = container_bytes(first) == container_bytes(second)
    require(same and first.size > 0, "shard-cache replay differs from the "
            "parse", rows=[first.size, second.size])
    require(epochs[1]["cache"].get("cache_hits_total", 0) >= 1,
            "epoch 2 did not replay the shard cache", **epochs[1]["cache"])
    back = RowBlockContainer()
    require(back.load(io.BytesIO(container_bytes(first)))
            and container_bytes(back) == container_bytes(first),
            "RowBlockContainer save/load round trip")
    return {"rows": first.size, "nnz": first.nnz, "epochs": epochs,
            "replay_bit_equal": same, "save_load_bit_equal": True}


# -- phase 5: checkpoint and serving -----------------------------------------
# the reference's serving-lane configuration (bench.py, serving_lane): a
# linear model of 16,384 features, libsvm requests of 2-8 rows with 16
# nonzeros a row (loadrig corpus "rows=2,rows_max=8,nnz=16,seed=7"), the
# bucket ladder 16,64,256, a 2 ms batching window, a 500 ms lateness budget
LANE_FEATURES = 1 << 14
LANE_ROWS = (2, 8)
LANE_NNZ = 16
LANE_SEED = 7
LANE_ARGS = ["--rows-buckets", "16,64,256", "--batch-delay-ms", "2",
             "--shed-lateness-ms", "500"]
SERVE_REQUESTS = 256
DRAIN_GRACE_S = 5.0   # the server's default DMLC_SERVE_DRAIN_GRACE_S


def lane_payloads(count: int) -> "list[bytes]":
    """``count`` libsvm payloads as the reference lane's generator makes
    them: request i draws from ``random.Random((seed << 20) ^ i)``, has
    ``2 + i % 7`` rows, each of 16 sorted distinct ids out of 16,384 with
    values uniform in [-1, 1] (four decimals) and a 0/1 label."""
    lo, hi = LANE_ROWS
    out = []
    for i in range(count):
        rng = random.Random((LANE_SEED << 20) ^ i)
        lines = []
        for _ in range(lo + i % (hi - lo + 1)):
            ids = rng.sample(range(LANE_FEATURES), LANE_NNZ)
            feats = " ".join(f"{j}:{rng.uniform(-1, 1):.4f}"
                             for j in sorted(ids))
            lines.append(f"{rng.randint(0, 1)} {feats}")
        out.append(("\n".join(lines) + "\n").encode())
    return out


def post_scores(port: int, payloads, workers: int) -> list:
    """POST every payload to ``/score`` from ``workers`` keep-alive
    connections; ``(status, body)`` per payload, in order."""
    results = [None] * len(payloads)

    def worker(k: int) -> None:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            for i in range(k, len(payloads), workers):
                conn.request("POST", "/score", payloads[i],
                             {"Content-Type": "application/x-libsvm"})
                resp = conn.getresponse()
                results[i] = (resp.status, resp.read())
        finally:
            conn.close()

    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        for f in [pool.submit(worker, k) for k in range(workers)]:
            f.result()
    return results


def closed_loop(port: int, payloads, workers: int, seconds: float) -> dict:
    """``workers`` clients, each on its own keep-alive connection, send
    the next payload as soon as the last one is answered, for
    ``seconds``; completed requests, errors, and latencies (ms)."""
    lat, errors, lock = [], [0], threading.Lock()
    nxt = [0]
    stop_at = time.perf_counter() + seconds

    def worker() -> None:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        mine, bad = [], 0
        try:
            while time.perf_counter() < stop_at:
                with lock:
                    body = payloads[nxt[0] % len(payloads)]
                    nxt[0] += 1
                t0 = time.perf_counter()
                try:
                    conn.request("POST", "/score", body,
                                 {"Content-Type": "application/x-libsvm"})
                    resp = conn.getresponse()
                    resp.read()
                    ok = resp.status == 200
                except (OSError, http.client.HTTPException):
                    conn.close()
                    conn = http.client.HTTPConnection("127.0.0.1", port,
                                                      timeout=60)
                    ok = False
                if ok:
                    mine.append((time.perf_counter() - t0) * 1e3)
                else:
                    bad += 1
        finally:
            conn.close()
            with lock:
                lat.extend(mine)
                errors[0] += bad

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker) for _ in range(workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(seconds + 120)
    elapsed = time.perf_counter() - t0
    require(not any(t.is_alive() for t in threads), "load client hung")
    lat.sort()
    return {"completed": len(lat), "errors": errors[0],
            "seconds": elapsed, "qps": len(lat) / elapsed,
            "p50_ms": float(np.percentile(lat, 50)) if lat else None,
            "p99_ms": float(np.percentile(lat, 99)) if lat else None}


def scrape(port: int) -> str:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        body = resp.read().decode()
        require(resp.status == 200, "/metrics", status=resp.status)
        return body
    finally:
        conn.close()


def metric_value(text: str, name: str) -> float:
    """Sum of the unlabelled-or-labelled samples of ``name``."""
    return sum(float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
               if ln.split("{")[0].split(" ")[0] == name)


def hist_buckets(text: str, name: str) -> "tuple[list, float, float]":
    """``([(le, cumulative count)], sum, count)`` of histogram ``name``
    in a Prometheus text scrape."""
    cum, total, count = [], 0.0, 0.0
    for ln in text.splitlines():
        if ln.startswith(name + "_bucket{"):
            le = ln.split('le="')[1].split('"')[0]
            cum.append((float("inf") if le == "+Inf" else float(le),
                        float(ln.rsplit(" ", 1)[1])))
        elif ln.startswith(name + "_sum"):
            total = float(ln.rsplit(" ", 1)[1])
        elif ln.startswith(name + "_count"):
            count = float(ln.rsplit(" ", 1)[1])
    return cum, total, count


def hist_delta(before: str, after: str, name: str) -> dict:
    """Count, mean and median of histogram ``name`` over the observations
    made between two scrapes (the median as its log2 bucket's upper
    bound)."""
    b, bs, bc = hist_buckets(before, name)
    a, as_, ac = hist_buckets(after, name)
    base = dict(b)
    delta = [(le, c - base.get(le, 0.0)) for le, c in a]
    n = ac - bc
    p50 = next((le for le, c in delta if n and c >= 0.5 * n), None)
    return {"count": n, "mean": (as_ - bs) / n if n else None,
            "p50_le": p50}


def parse_libsvm_rows(lines) -> "tuple[np.ndarray, np.ndarray]":
    """(x [n, FEATURES] float64, labels) of HIGGS-like libsvm lines."""
    x = np.zeros((len(lines), FEATURES), np.float64)
    for i, ln in enumerate(lines):
        for tok in ln.split()[1:]:
            j, _, v = tok.partition(":")
            x[i, int(j)] = float(v)
    return x


def serve_phase(workdir: str, params: LinearParams, device: str = "cuda",
                requests: int = SERVE_REQUESTS, warm_s: float = 2.0,
                loop_s: float = 5.0, workers: int = 8) -> dict:
    """Checkpoint round trip of the trained model, the in-process server
    on it, then ``python -m dmlc_core_tpu_torch.serving`` on the lane's
    configuration under closed-loop load, drained by SIGTERM."""
    hk.reset_launch_counts()
    out = {"phase": "serve", "device": device}

    # 1. the trained parameters through the checkpoint, bit for bit
    ck = os.path.join(workdir, "trained.ckpt")
    save_checkpoint(ck, params, step=8, extra={"source": "train phase"})
    back, step, extra = restore_checkpoint(ck, like=params)
    require(isinstance(back, LinearParams) and step == 8,
            "checkpoint restore", step=step)
    for name, got, want in zip(back._fields, back, params):
        require(got.device == want.device and got.dtype == want.dtype
                and torch.equal(got, want), "checkpoint leaf differs",
                leaf=name, device=str(got.device))
    art = os.path.join(workdir, "higgs_model.ckpt")
    save_model(art, "linear", linear_params_to_numpy(params), FEATURES,
               step=8)
    out["checkpoint"] = {"bytes": os.path.getsize(ck), "bit_exact": True,
                         "restored_device": str(back.w.device)}

    # 2. the in-process server (the default device on the card) scoring
    # held-out HIGGS-like rows in requests of 1-64 rows
    rng = np.random.default_rng(11)
    lengths = rng.integers(1, 65, requests)
    held = os.path.join(workdir, "held_out.libsvm")
    write_higgs_like(held, int(lengths.sum()), seed=1)
    with open(held) as f:
        lines = f.read().splitlines()
    starts = np.concatenate([[0], np.cumsum(lengths)])
    payloads = [("\n".join(lines[a:b]) + "\n").encode()
                for a, b in zip(starts[:-1], starts[1:])]
    flat, _, _ = restore_checkpoint(art)
    w64 = flat["['w']"].astype(np.float64)
    b64 = float(flat["['b']"])
    want64 = 1.0 / (1.0 + np.exp(-(parse_libsvm_rows(lines) @ w64 + b64)))
    srv = ScoringServer(model_uri=art, **({} if device == "cuda"
                                          else {"device": device}))
    srv.start()
    try:
        dev_types = {t.device.type for t in srv._model.params}
        require(dev_types == {device}, "served model off device",
                devices=sorted(dev_types))
        t0 = time.perf_counter()
        replies = post_scores(srv.port, payloads, workers=4)
        post_s = time.perf_counter() - t0
    finally:
        srv.stop(drain=True)
    got = []
    for (status, body), n in zip(replies, lengths):
        require(status == 200, "score request failed", status=status,
                body=body[:200].decode("utf-8", "replace"))
        doc = json.loads(body)
        require(doc["rows"] == n and len(doc["scores"]) == n,
                "score count", rows=doc["rows"], want=int(n))
        got += doc["scores"]
    got = np.asarray(got)
    require(got.shape == want64.shape and np.all(np.isfinite(got)),
            "scores shape/finite", shape=got.shape)
    err64 = float(np.max(np.abs(got - want64)))
    require(err64 <= 1e-5, "scores vs float64 sigmoid(w.x + b)",
            max_abs_err=err64)
    cpu = ScoringModel.load(art, device="cpu")
    buckets = srv.config.rows_buckets
    want_cpu = []
    for p in payloads:
        group = batching.parse_group([p], "libsvm", srv.config.tmp_dir)
        row, col, val, rb, _ = batching.pad_to_bucket(
            group, buckets, srv.config.min_nnz_bucket)
        want_cpu.append(cpu.scores(row, col, val, rb)[:group.num_rows])
    want_cpu = np.concatenate(want_cpu)
    rel_cpu = float(np.max(np.abs(got - want_cpu) / np.abs(want_cpu)))
    require(rel_cpu <= 1e-6, "scores vs the port's CPU forward",
            max_rel_err=rel_cpu)
    out["higgs"] = {"requests": requests, "rows": int(lengths.sum()),
                    "model_device": sorted(dev_types)[0],
                    "max_abs_err_vs_f64": err64,
                    "max_rel_err_vs_cpu": rel_cpu, "post_s": post_s}

    # 3. the CLI entry on the lane's configuration
    lrng = np.random.default_rng(LANE_SEED)
    lane_art = os.path.join(workdir, "lane_model.ckpt")
    save_model(lane_art, "linear",
               {"w": lrng.normal(size=LANE_FEATURES).astype(np.float32),
                "b": np.float32(0.0)}, LANE_FEATURES)
    lane_payloads_ = lane_payloads(4096)
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.abspath(__file__)))
    cmd = [sys.executable, "-m", "dmlc_core_tpu_torch.serving",
           "--model-uri", lane_art, "--port", "0", *LANE_ARGS]
    if device != "cuda":
        cmd += ["--device", device]
    t0 = time.perf_counter()
    with open(os.path.join(workdir, "serve_stderr.txt"), "w") as err:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=err,
                                text=True, env=env)
        try:
            ready, _, _ = select.select([proc.stdout], [], [], 300)
            line = proc.stdout.readline() if ready else ""
            require(line.startswith("SERVE_READY port="),
                    "server handshake", line=line, exit=proc.poll())
            ready_s = time.perf_counter() - t0
            port = int(line.split("port=")[1].split()[0])
            # warm the ladder with traffic: the lane's 2 workers, then the
            # timed loop's concurrency, whose co-batches fill the larger
            # buckets the 2-worker batches never reach
            warm2 = closed_loop(port, lane_payloads_, 2, warm_s)
            warm8 = closed_loop(port, lane_payloads_, workers, warm_s)
            before = scrape(port)
            loop = closed_loop(port, lane_payloads_, workers, loop_s)
            after = scrape(port)
            t1 = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            code = proc.wait(timeout=DRAIN_GRACE_S + 30)
            drain_s = time.perf_counter() - t1
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            proc.stdout.close()
    shapes_warm = metric_value(before, "serve_distinct_shapes")
    shapes_after = metric_value(after, "serve_distinct_shapes")
    server_errors = (metric_value(after, "serve_errors_total")
                     - metric_value(before, "serve_errors_total"))
    sheds = (metric_value(after, "serve_shed_total")
             - metric_value(before, "serve_shed_total"))
    lane = {"ready_s": ready_s, "warmup": [warm2, warm8],
            "qps": loop["qps"], "completed": loop["completed"],
            "seconds": loop["seconds"], "p50_ms": loop["p50_ms"],
            "p99_ms": loop["p99_ms"], "errors": loop["errors"],
            "server_errors": server_errors, "sheds": sheds,
            "server_us": {name: hist_delta(before, after, name)
                          for name in ("serve_forward_us",
                                       "serve_parse_us",
                                       "serve_request_us")},
            "serve_batch_rows": hist_delta(before, after,
                                           "serve_batch_rows"),
            "distinct_shapes_warm": shapes_warm,
            "distinct_shapes_after": shapes_after,
            "drain_exit": code, "drain_s": drain_s}
    out["lane"] = lane
    out["launches"] = {k: fn.launches for k, fn in hk.KERNELS.items()}
    require(warm2["errors"] == 0 and warm8["errors"] == 0
            and loop["errors"] == 0 and server_errors == 0 and sheds == 0
            and loop["completed"] > 0, "lane errors", **{
                k: lane[k] for k in ("errors", "server_errors", "sheds",
                                     "completed")})
    require(shapes_after == shapes_warm, "new shapes after the warm-up",
            warm=shapes_warm, after=shapes_after)
    require(code == 0, "SIGTERM drain exit code", code=code)
    emit(out)
    return out


# -- phase 6: the DeviceRowBlockIter lanes -----------------------------------
def trees_equal(a: list, b: list) -> bool:
    """Whether two lists of batch trees hold the same leaves bit for bit."""
    def bits(t):
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    return len(a) == len(b) and all(
        set(x) == set(y) and all(torch.equal(bits(x[k]), bits(y[k]))
                                 for k in x) for x, y in zip(a, b))


def lane_epoch(uri: str, device: str, margin_path: str = "segment",
               keep: bool = False, **iter_kw) -> dict:
    """One epoch of ``LinearLearner(FEATURES)`` over one lane of
    ``DeviceRowBlockIter``: losses, parameters, rows/s from the iterator's
    start to the last loss, the host-side ``device_stage_us`` mean, and
    with ``keep`` a copy of every batch tree."""
    learner = LinearLearner(FEATURES, margin_path=margin_path, device=device)
    params = learner.init()
    telemetry.reset()
    losses, trees, rows = [], [], 0
    t0 = time.perf_counter()
    with device_iter.DeviceRowBlockIter(uri, device=device, **iter_kw) as it:
        for batch in it:
            if keep:
                trees.append({k: t.clone() for k, t in batch.tree().items()})
            params, loss = learner.step(params, batch)
            losses.append(float(loss))
            rows += batch.total_rows
    seconds = time.perf_counter() - t0
    stage = telemetry.histogram("device_stage_us").summary()
    return {"losses": losses, "w": params.w.cpu().numpy(),
            "b": float(params.b), "rows": rows, "seconds": seconds,
            "rows_per_s": rows / seconds, "stage_us_mean": stage["mean"],
            "stage_count": stage["count"], "trees": trees}


def lanes_phase(data: dict, text_csr: dict, device: str = "cuda",
                batch_rows: int = BATCH_ROWS) -> dict:
    """The ``train`` phase's file through every lane, one epoch each:
    ``.drec`` against the dense bf16 text lane (batches and losses bit
    for bit), ``.crec`` through the kernel (dense margin) against the
    ``train`` phase's text CSR run (``text_csr``) at rtol 1e-5, bf16 CSR
    values on ``device`` against the same lane on the CPU at rtol 1e-5,
    and ``index64`` batches against the native CSR lane's bit for bit."""
    rows = data["rows"]
    steps = -(-rows // batch_rows)
    kw = dict(batch_rows=batch_rows)
    out = {"phase": "lanes", "device": device, "rows": rows,
           "batch_rows": batch_rows, "steps": steps,
           "reduced": {"rows": [11_000_000, rows]},
           "files": {k: data[k] for k in ("bytes", "text_write_s",
                                           "crec_convert_s",
                                           "drec_convert_s")}}
    lanes = {}

    def record(name, run):
        require(run["rows"] == rows and len(run["losses"]) == steps
                and np.all(np.isfinite(run["losses"])), f"{name} epoch",
                rows=run["rows"], steps=len(run["losses"]))
        lanes[name] = {k: run[k] for k in ("rows_per_s", "seconds",
                                           "stage_us_mean", "losses")}

    # recd against the dense bf16 text lane
    dense = lane_epoch(data["text"], device, keep=True, layout="dense",
                       dense_dtype="bf16", **kw)
    recd = lane_epoch(data["drec"], device, keep=True, dense_dtype="bf16",
                      **kw)
    record("text_dense_bf16", dense)
    record("recd", recd)
    require(trees_equal(recd["trees"], dense["trees"]),
            "recd batches differ from the dense bf16 text lane's")
    require(recd["losses"] == dense["losses"]
            and np.array_equal(recd["w"], dense["w"]),
            "recd losses differ from the dense bf16 text lane's",
            recd=recd["losses"], text=dense["losses"])
    del dense, recd

    # index64 against the native CSR lane
    native_csr = lane_epoch(data["text"], device, keep=True, layout="csr",
                            **kw)
    wide = lane_epoch(data["text"], device, keep=True, layout="csr",
                      index64=True, **kw)
    record("text_csr", native_csr)
    record("index64", wide)
    require(trees_equal(wide["trees"], native_csr["trees"]),
            "index64 batches differ from the native CSR lane's")
    # the same batches; the segment margin's index_add_ sums with atomics
    # on the card, so the two runs agree to rtol 1e-5, not bit for bit
    gaps = {"index64_vs_text_csr": compare(wide, native_csr,
                                           "index64 vs text CSR")}
    out["bucket"] = {"text_csr": int(native_csr["trees"][0]["big"].shape[-1])}
    del wide

    # crec through the kernel, launches counted on this run alone
    os.environ["DCT_CSR_TO_DENSE"] = "pallas"
    hk.reset_launch_counts()
    crec = lane_epoch(data["crec"], device, margin_path="dense", keep=True,
                      **kw)
    out["launches"] = {k: fn.launches for k, fn in hk.KERNELS.items()}
    record("crec", crec)
    out["bucket"]["crec"] = int(crec["trees"][0]["big"].shape[-1])
    if device == "cuda":
        require(out["launches"]["csr_to_dense"] == steps,
                "kernel launches on the crec lane", steps=steps,
                launches=out["launches"])
    gaps["crec_vs_text_csr"] = compare(crec, text_csr, "crec vs text CSR")
    out["gaps"] = gaps
    del crec, native_csr

    # bf16 CSR values: the card against the CPU run of the same lane
    bf16 = lane_epoch(data["text"], device, layout="csr",
                      csr_val_dtype="bf16", **kw)
    record("text_csr_bf16_values", bf16)
    bf16_cpu = lane_epoch(data["text"], "cpu", layout="csr",
                          csr_val_dtype="bf16", **kw)
    out["gaps"]["bf16_values_vs_cpu"] = compare(bf16, bf16_cpu,
                                                f"bf16 values {device} vs cpu")
    # the rounding of the values moves the trajectory: reported, not gated
    la, lf = np.asarray(bf16["losses"]), np.asarray(lanes["text_csr"]
                                                    ["losses"])
    out["gaps"]["bf16_values_vs_f32_loss_max_rel"] = float(
        np.max(np.abs(la - lf) / np.abs(lf)))
    out["lanes"] = lanes
    emit(out)
    return out


# -- phase 6b: host batches (DeviceRowBlockIter(to_device=False)) ------------
HOST_STEPS = 8
# the copying path's counters and histograms, which a host batch never
# reaches (device.stage and device.wait still move)
HOST_DEVICE_COUNTERS = ("device_batches_total", "device_transfer_bytes_total",
                        "device_zero_copy_batches_total")
HOST_DEVICE_HISTOGRAMS = ("device_transfer_us", "device_put_submit_us",
                          "device_put_block_us")


def host_epoch(uri: str, device: str, batch_rows: int, **iter_kw) -> dict:
    """One ``to_device=False`` epoch: the batches as handed out (kept, no
    copy), rows/s, the device counters, and the card's allocated bytes
    before and after."""
    gc.collect()  # no earlier phase's tensor may be freed in the window
    sync(torch.device(device))
    mem0 = torch.cuda.memory_allocated() if device == "cuda" else 0
    telemetry.reset()
    t0 = time.perf_counter()
    with device_iter.DeviceRowBlockIter(uri, batch_rows=batch_rows,
                                        to_device=False, device=device,
                                        **iter_kw) as it:
        batches = list(it)
    seconds = time.perf_counter() - t0
    sync(torch.device(device))
    mem1 = torch.cuda.memory_allocated() if device == "cuda" else 0
    moved = {n: telemetry.counter(n).value for n in HOST_DEVICE_COUNTERS}
    moved.update({n: telemetry.histogram(n).summary()["count"]
                  for n in HOST_DEVICE_HISTOGRAMS})
    rows = sum(b.total_rows for b in batches)
    return {"batches": batches, "rows": rows, "seconds": seconds,
            "rows_per_s": rows / seconds, "memory_allocated": [mem0, mem1],
            "device_metrics": moved,
            "stage_count": telemetry.histogram(
                "device_stage_us").summary()["count"]}


def host_lane(name: str, uri: str, device: str, batch_rows: int,
              rows: int, **iter_kw) -> "tuple[dict, list, list]":
    """A lane's host epoch against its device epoch: numpy leaves, bit
    for bit the device batches' ``.cpu()``, no device counter and no
    allocated byte of the card moved, none pinned. Returns the lane's
    record, its host batches and its device batches."""
    host = host_epoch(uri, device, batch_rows, **iter_kw)
    t0 = time.perf_counter()
    with device_iter.DeviceRowBlockIter(uri, batch_rows=batch_rows,
                                        device=device, **iter_kw) as it:
        dev = list(it)
    sync(torch.device(device))
    dev_s = time.perf_counter() - t0
    batches = host["batches"]
    require(host["rows"] == rows and len(batches) == len(dev),
            f"{name}: host epoch rows", rows=host["rows"],
            batches=len(batches), device_batches=len(dev))
    require(all(v == 0 for v in host["device_metrics"].values())
            and host["stage_count"] == len(batches),
            f"{name}: a host epoch moved the device counters",
            **host["device_metrics"], stage_count=host["stage_count"])
    require(host["memory_allocated"][0] == host["memory_allocated"][1],
            f"{name}: a host epoch allocated on the card",
            memory_allocated=host["memory_allocated"])
    leaves = [v for b in batches for v in b.tree().values()]
    require(all(isinstance(v, np.ndarray) for v in leaves),
            f"{name}: host batch leaves are not numpy")
    if device == "cuda":
        require(not any(torch.from_numpy(v).is_pinned() for v in leaves),
                f"{name}: a host batch was staged in pinned memory")
    for i, (h, d) in enumerate(zip(batches, dev)):
        ht, dt = h.tree(), d.tree()
        require(set(ht) == set(dt) and all(
            torch.equal(torch.from_numpy(ht[k]), dt[k].cpu())
            for k in ht), f"{name}: host batch {i} differs from the "
            "device batch's .cpu()")
    return ({"rows_per_s": host["rows_per_s"], "seconds": host["seconds"],
             "device_rows_per_s": rows / dev_s,
             "memory_allocated": host["memory_allocated"],
             "batches": len(batches)}, batches, dev)


def host_steps(learner, batches: list, steps: int) -> dict:
    """``steps`` learner steps from zero parameters (each loss read
    back), then ``predict`` on the last batch."""
    params = learner.init()
    losses, step_s = [], []
    for b in batches[:steps]:
        ts = time.perf_counter()
        params, loss = learner.step(params, b)
        losses.append(float(loss))
        step_s.append(time.perf_counter() - ts)
    margin = learner.predict(params, batches[steps - 1])
    return {"losses": losses, "w": params.w.cpu().numpy(),
            "b": float(params.b), "step_s": step_s,
            "predict": margin.cpu().numpy(), "w_device": params.w.device}


def host_phase(data: dict, device: str = "cuda",
               batch_rows: int = BATCH_ROWS) -> dict:
    """Host batches (``to_device=False``) on the HIGGS-shaped files: one
    epoch of the text lane and one of ``.crec`` against the same lanes'
    device epochs; ``HOST_STEPS`` ``LinearLearner`` steps with the dense
    margin (the kernel) on host ``.crec`` batches, then ``predict``,
    against the same run on the device batches at rtol 1e-5 (launches
    counted on the host run alone); the bench's host-tree probe and
    replay first pass, which now iterate ``to_device=False``, against
    the host batcher read directly as they read it before."""
    from dmlc_core_tpu_torch.bench import device_lane, ingest
    rows = data["rows"]
    steps = min(HOST_STEPS, -(-rows // batch_rows))
    out = {"phase": "host", "device": device, "rows": rows,
           "batch_rows": batch_rows, "steps": steps,
           "reduced": {"rows": [11_000_000, rows]}}
    text, _, _ = host_lane("text", data["text"], device, batch_rows, rows,
                           layout="csr")
    crec, host_batches, dev_batches = host_lane(
        "crec", data["crec"], device, batch_rows, rows)
    out["lanes"] = {"text": text, "crec": crec}

    os.environ["DCT_CSR_TO_DENSE"] = "pallas"
    learner = LinearLearner(FEATURES, margin_path="dense", device=device)
    on_device = host_steps(learner, dev_batches, steps)
    del dev_batches
    hk.reset_launch_counts()
    on_host = host_steps(learner, host_batches, steps)
    out["launches"] = {k: fn.launches for k, fn in hk.KERNELS.items()}
    require(on_host["w_device"].type == device,
            "host-batch steps left the parameters' device")
    if device == "cuda":
        require(out["launches"]["csr_to_dense"] == steps,
                "kernel launches on host batches", steps=steps,
                launches=out["launches"])
    gaps = {"host_vs_device_batches": compare(
        on_host, on_device, "host batches vs device batches")}
    # predict's segment margin sums with atomics on the card: rtol 1e-5,
    # and atol 1e-6 for margins near 0
    gaps["predict_max_abs"] = float(np.max(
        np.abs(on_host["predict"] - on_device["predict"])))
    require(np.allclose(on_host["predict"], on_device["predict"],
                        rtol=1e-5, atol=1e-6), "host-batch predict differs "
            "from the device batch's", **gaps)
    out.update(losses=on_host["losses"], step_s=on_host["step_s"],
               step_s_median=statistics.median(on_host["step_s"]),
               device_batch_step_s_median=statistics.median(
                   on_device["step_s"]), gaps=gaps)

    dev = torch.device(device)
    probe = ingest.host_tree_of(data["text"], dev, fmt="libsvm",
                                batch_rows=batch_rows)
    hb = device_iter.NativeHostBatcher(data["text"], fmt="libsvm",
                                       batch_rows=batch_rows)
    try:
        before = {k: np.array(v) for k, v in hb.next_batch().tree().items()}
    finally:
        hb.close()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cache_") as cdir:
        first = device_lane.cache_first_pass(
            f"{data['text']}#cachefile={cdir}/new", dev, batch_rows)
        old = []
        with device_iter.DeviceRowBlockIter(
                f"{data['text']}#cachefile={cdir}/old", batch_rows=batch_rows,
                layout="csr", device=device) as it:
            while (b := it.batcher.next_batch()) is not None:
                old.append({k: np.array(v) for k, v in b.tree().items()})

    def same(a: dict, b: dict) -> bool:
        return set(a) == set(b) and all(
            a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
            for k in a)

    require(same(probe, before), "the bench's host-tree probe changed")
    require(len(first) == len(old) and all(
        same(a, b) for a, b in zip(first, old)),
        "the bench's replay first pass changed", batches=len(first),
        before=len(old))
    out["bench_trees"] = {"probe_leaves": sorted(probe),
                          "replay_first_pass_batches": len(first)}
    emit(out)
    return out


# -- phase 7: a Criteo-shaped factorization machine --------------------------
# The Criteo Display Advertising Challenge schema (Kaggle, 2014): 13 integer
# and 26 categorical fields, one nonzero each, written as libfm
# field:feature:value. Categoricals are hashed into 2^20 features, as
# libffm's Criteo example hashes them to about 10^6; the integer fields are
# features 0-12 with seeded log-normal values (four decimals).
CRITEO_INT_FIELDS = 13
CRITEO_CAT_FIELDS = 26
CRITEO_FEATURES = 1 << 20
CRITEO_ROWS = 45_840_617   # the challenge's training rows
FM_RANK = 8                # the train CLI's default --fm-rank
FM_ROWS = 4 * BATCH_ROWS
FM_HELD_OUT = 64
# v after the steps held against the CPU: index_add_ sums its gradient with
# atomics on the card, in an order that changes from run to run
FM_V_RTOL = 1e-5
FM_V_ATOL = 1e-7


def criteo_like(rows: int, seed: int, features: int = CRITEO_FEATURES):
    """(labels [rows], cols [rows, 39], vals [rows, 39]) of seeded
    Criteo-shaped rows: integer fields first (feature j, log-normal value
    rounded to four decimals), then the 26 categoricals (value 1) drawn
    Zipf-like per field and hashed to [13, features). Labels come from a
    seeded logistic rule over both, about a quarter of them clicks."""
    rng = np.random.default_rng(seed)
    ints = np.minimum(np.round(rng.lognormal(0.0, 0.5, (rows,
                                                        CRITEO_INT_FIELDS)),
                               4), 9999.9999)
    rank = np.minimum(rng.zipf(1.3, (rows, CRITEO_CAT_FIELDS)), 1 << 24)
    field = np.arange(CRITEO_CAT_FIELDS, dtype=np.uint64)
    h = (rank.astype(np.uint64) * np.uint64(2654435761)
         + field * np.uint64(40503)) % np.uint64(features - CRITEO_INT_FIELDS)
    cats = h.astype(np.int64) + CRITEO_INT_FIELDS
    cols = np.concatenate(
        [np.broadcast_to(np.arange(CRITEO_INT_FIELDS),
                         (rows, CRITEO_INT_FIELDS)), cats], axis=1)
    vals = np.concatenate([ints, np.ones((rows, CRITEO_CAT_FIELDS))], axis=1)
    effect = ((cats * 2654435761) % 1000) / 1000.0 - 0.5
    logit = (-1.2 + 0.3 * (np.log(ints)).sum(axis=1)
             + 0.25 * effect.sum(axis=1))
    labels = rng.random(rows) < 1 / (1 + np.exp(-logit))
    return labels, cols, vals


def fm_kernel_case(rows: int = BATCH_ROWS, bucket: int = 1 << 22,
                   features: int = CRITEO_FEATURES, k: int = FM_RANK) -> dict:
    """The FM kernel pair (``hk.fm_csr_kernel``, csrc/fm_csr.cu) at the
    ``criteo_fm.crec`` cell's batch: ``rows`` Criteo-shaped rows of 39
    nonzeros in a ``bucket``-entry shard, padding at the tail. Its margins
    and its gradients in b, w and v (of sum(g * margin) for a seeded g) are
    held against the plain version on the card: rtol 1e-5, and atol 1e-5
    of each output's largest magnitude, since both sum with atomics.
    Times (``time_ms``): the forward alone, forward and backward, and the
    plain version's forward and backward, which is the gather and
    ``index_add_`` path the step took before the kernel; the bound is
    ``benchmark/roofline.py::fm_step_cost``'s whole step."""
    from benchmark import roofline
    _, cols, vals = criteo_like(rows, seed=5, features=features)
    nnz = cols.size
    row = np.full(bucket, rows, np.int32)
    row[:nnz] = np.repeat(np.arange(rows, dtype=np.int32), cols.shape[1])
    col = np.zeros(bucket, np.int32)
    col[:nnz] = cols.reshape(-1)
    val = np.zeros(bucket, np.float32)
    val[:nnz] = vals.reshape(-1)
    rng = np.random.default_rng(6)
    dev = torch.device("cuda")
    b = torch.tensor(-1.2, device=dev)
    w = torch.from_numpy(rng.normal(scale=0.1, size=features)
                         .astype(np.float32)).to(dev)
    v = torch.from_numpy(rng.normal(scale=0.01, size=(features, k))
                         .astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.normal(size=rows).astype(np.float32)).to(dev)
    r, c, x = (torch.from_numpy(a).to(dev) for a in (row, col, val))

    def fwd_bwd(fn):
        leaves = [t.detach().requires_grad_(True) for t in (b, w, v)]
        m = fn(*leaves, r, c, x, rows)
        return [m.detach()] + list(torch.autograd.grad((m * g).sum(),
                                                       leaves))

    got, want = fwd_bwd(hk.fm_csr_kernel), fwd_bwd(hk.fm_csr_reference)
    rec = {"case": "fm_train_65536x39", "rows": rows, "nnz": nnz,
           "bucket": bucket, "features": features, "k": k}
    for name, a, e in zip(("margin", "grad_b", "grad_w", "grad_v"), got,
                          want):
        scale = float(e.abs().max())
        err = float((a - e).abs().max())
        rec[name + "_max_abs_err"] = err
        require(torch.allclose(a, e, rtol=1e-5, atol=1e-5 * scale),
                "fm kernel disagrees with its plain version", output=name,
                max_abs_err=err, scale=scale)
    with torch.no_grad():
        rec["kernel_forward_ms"] = time_ms(
            lambda: hk.fm_csr_kernel(b, w, v, r, c, x, rows))
    rec["kernel_ms"] = time_ms(lambda: fwd_bwd(hk.fm_csr_kernel))
    rec["plain_ms"] = time_ms(lambda: fwd_bwd(hk.fm_csr_reference))
    distinct = int(np.unique(cols).size)
    bound_s, by = roofline.bound_s(*roofline.fm_step_cost(rows, nnz,
                                                          distinct, k))
    rec.update(distinct_cols=distinct, bound_ms=bound_s * 1e3, bound_by=by,
               bound_share=bound_s * 1e3 / rec["kernel_ms"])
    return rec


def write_criteo_like(path: str, rows: int, seed: int,
                      features: int = CRITEO_FEATURES) -> None:
    """The rows of :func:`criteo_like` as a libfm file, every token fixed
    width (zero-padded field, feature and value digits), built as one byte
    matrix."""
    labels, cols, vals = criteo_like(rows, seed, features)
    nf = CRITEO_INT_FIELDS + CRITEO_CAT_FIELDS
    width = 1 + CRITEO_INT_FIELDS * 21 + CRITEO_CAT_FIELDS * 13 + 1
    buf = np.empty((rows, width), np.uint8)
    buf[:, 0] = ord("0") + labels
    pos = 1
    for f in range(nf):
        buf[:, pos] = ord(" ")
        put_digits(buf, pos + 1, np.full(rows, f), 2)
        buf[:, pos + 3] = ord(":")
        put_digits(buf, pos + 4, cols[:, f], 7)
        buf[:, pos + 11] = ord(":")
        if f < CRITEO_INT_FIELDS:
            q = np.rint(vals[:, f] * 1e4).astype(np.int64)
            put_digits(buf, pos + 12, q // 10000, 4)
            buf[:, pos + 16] = ord(".")
            put_digits(buf, pos + 17, q % 10000, 4)
            pos += 21
        else:
            buf[:, pos + 12] = ord("1")
            pos += 13
    buf[:, pos] = ord("\n")
    buf.tofile(path)


def put_digits(buf: np.ndarray, pos: int, n: np.ndarray, width: int) -> None:
    """Write ``n`` as ``width`` zero-padded decimal digits at column
    ``pos`` of every row of ``buf``."""
    n = np.asarray(n, np.int64)
    for k in range(width):
        buf[:, pos + k] = ord("0") + (n // 10 ** (width - 1 - k)) % 10


def fm_epoch(uri: str, params: FMParams, device: str, batch_rows: int,
             features: int, max_steps: "int | None" = None,
             snapshot_at: "int | None" = None) -> dict:
    """FMLearner(features, k=FM_RANK) from ``params`` over ``uri`` (CSR
    layout): losses, step times, the parameters after the last step and
    (``snapshot_at``) after that many steps, and the peak device memory
    of the run on a card."""
    learner = FMLearner(features, k=FM_RANK, device=device)
    params = FMParams(*(t.to(device) for t in params))
    losses, step_s, rows, snap, bucket = [], [], 0, None, None
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with device_iter.DeviceRowBlockIter(uri, batch_rows=batch_rows,
                                        layout="csr", device=device) as it:
        for batch in it:
            ts = time.perf_counter()
            params, loss = learner.step(params, batch)
            losses.append(float(loss))
            step_s.append(time.perf_counter() - ts)
            rows += batch.total_rows
            bucket = batch.nnz_bucket
            if len(losses) == snapshot_at:
                snap = fm_params_to_numpy(params)
            if len(losses) == max_steps:
                break
    seconds = time.perf_counter() - t0
    return {"losses": losses, "step_s": step_s, "rows": rows,
            "seconds": seconds, "params": params, "snapshot": snap,
            "nnz_bucket": bucket,
            "peak_bytes": (torch.cuda.max_memory_allocated()
                           if device == "cuda" else None)}


def fm_margin_f64(p: dict, offset, col, val) -> np.ndarray:
    """float64 FM margins of CSR rows (Rendle's identity)."""
    w, v = p["w"].astype(np.float64), p["v"].astype(np.float64)
    val = val.astype(np.float64)
    rows = np.repeat(np.arange(len(offset) - 1), np.diff(offset))
    n = len(offset) - 1
    lin = np.zeros(n)
    np.add.at(lin, rows, w[col] * val)
    vx = v[col] * val[:, None]
    s1 = np.zeros((n, v.shape[1]))
    s2 = np.zeros((n, v.shape[1]))
    np.add.at(s1, rows, vx)
    np.add.at(s2, rows, vx * vx)
    return float(p["b"]) + lin + 0.5 * (s1 * s1 - s2).sum(axis=1)


def fm_phase(workdir: str, data: dict, device: str = "cuda",
             rows: int = FM_ROWS, batch_rows: int = BATCH_ROWS,
             features: int = CRITEO_FEATURES, cpu_steps: int = 2) -> dict:
    """A Criteo-shaped FM at full width: one epoch on ``device`` after a
    warm-up step, its first ``cpu_steps`` steps held against the port on
    the CPU, the dense margin on a ``.drec`` batch against the CSR margin
    of the same rows, and the trained model served."""
    path = os.path.join(workdir, "criteo_like.libfm")
    t0 = time.perf_counter()
    write_criteo_like(path, rows, seed=3, features=features)
    write_s = time.perf_counter() - t0
    uri = path + "?format=libfm"
    init = FMLearner(features, k=FM_RANK, device="cpu").init(seed=0)
    fm_epoch(uri, init, device, batch_rows, features, max_steps=1)  # warm-up
    # the FM kernel's launches on the main path's epoch alone: a forward
    # and a backward a step
    hk.reset_launch_counts()
    run = fm_epoch(uri, init, device, batch_rows, features,
                   snapshot_at=cpu_steps)
    launches = {k: fn.launches for k, fn in hk.KERNELS.items()}
    steps = -(-rows // batch_rows)
    require(launches["fm_csr"] == (2 * steps if device == "cuda" else 0)
            and launches["csr_to_dense"] == 0,
            "fm kernel launches on the main path", steps=steps,
            launches=launches)
    trained = fm_params_to_numpy(run["params"])
    require(len(run["losses"]) == steps and run["rows"] == rows
            and np.all(np.isfinite(run["losses"]))
            and all(np.all(np.isfinite(a)) for a in trained.values())
            and trained["v"].shape == (features, FM_RANK),
            "fm epoch: misshapen or non-finite", losses=run["losses"])
    cpu = fm_epoch(uri, init, "cpu", batch_rows, features,
                   max_steps=cpu_steps, snapshot_at=cpu_steps)
    la = np.asarray(run["losses"][:cpu_steps])
    lb = np.asarray(cpu["losses"])
    got, want = run["snapshot"], cpu["snapshot"]
    gap = {"loss_max_rel": float(np.max(np.abs(la - lb) / np.abs(lb))),
           "w_max_abs": float(np.max(np.abs(got["w"] - want["w"]))),
           "b_abs": float(abs(got["b"] - want["b"])),
           "v_max_abs": float(np.max(np.abs(got["v"] - want["v"]))),
           "v_max_rel": float(np.max(np.abs(got["v"] - want["v"])
                                     / np.maximum(np.abs(want["v"]),
                                                  1e-30)))}
    require(np.allclose(la, lb, rtol=1e-5, atol=0)
            and np.allclose(got["w"], want["w"], rtol=1e-5, atol=1e-7)
            and np.allclose(got["b"], want["b"], rtol=1e-5, atol=1e-7),
            f"fm {device} vs cpu beyond rtol 1e-5", **gap)
    # v's gradient sums with atomics on the card (index_add_), in another
    # order on every run: held at the tolerance the first card run showed
    require(np.allclose(got["v"], want["v"], rtol=FM_V_RTOL,
                        atol=FM_V_ATOL), f"fm v {device} vs cpu", **gap)

    # the dense margin of a 28-feature .drec batch against the CSR margin
    # of the same rows (bf16 values on both lanes)
    prng = np.random.default_rng(8)
    small = {"b": np.float32(0.1),
             "w": prng.normal(scale=0.1, size=FEATURES).astype(np.float32),
             "v": prng.normal(scale=0.1, size=(FEATURES, FM_RANK))
             .astype(np.float32)}
    small_p = fm_params_from_numpy(small, device)
    dense_learner = FMLearner(FEATURES, k=FM_RANK, device=device)
    with device_iter.DeviceRowBlockIter(data["drec"], batch_rows=batch_rows,
                                        dense_dtype="bf16",
                                        device=device) as it:
        dense_m = dense_learner.predict(small_p, next(iter(it)))
    with device_iter.DeviceRowBlockIter(data["text"], batch_rows=batch_rows,
                                        layout="csr", csr_val_dtype="bf16",
                                        device=device) as it:
        batch = next(iter(it))
        hk.reset_launch_counts()
        csr_m = dense_learner.predict(small_p, batch)
        predict_launches = hk.fm_csr_kernel.launches
    dense_gap = float((dense_m - csr_m).abs().max())
    # rtol 1e-5, and atol 1e-5 for margins near 0: the two sum 28-term
    # products in other orders, whose f32 error reaches about
    # 28 * 2^-24 * sum|terms| (a few units of 1e-6 here)
    require(dense_m.shape == csr_m.shape == (1, batch_rows)
            and torch.allclose(dense_m, csr_m, rtol=1e-5, atol=1e-5),
            "fm dense margin vs CSR margin", max_abs_err=dense_gap)

    # the trained FM through save_model and ScoringModel
    art = os.path.join(workdir, "fm_model.ckpt")
    save_model(art, "fm", trained, features, step=steps)
    held = os.path.join(workdir, "criteo_held_out.libfm")
    write_criteo_like(held, FM_HELD_OUT, seed=4, features=features)
    with NativeParser(held + "?format=libfm") as parser:
        blocks = [(b.offset.astype(np.int64), b.index.astype(np.int64),
                   b.value.copy())
                  for b in parser]
    require(len(blocks) == 1, "held-out rows in one block")
    offset, col, val = blocks[0]
    model = ScoringModel.load(art, **({} if device == "cuda"
                                      else {"device": device}))
    require({t.device.type for t in model.params} == {device},
            "served FM off device")
    row = np.repeat(np.arange(FM_HELD_OUT), np.diff(offset))
    hk.reset_launch_counts()
    scores = model.scores(row, col, val, FM_HELD_OUT)
    serve_launches = hk.fm_csr_kernel.launches
    # one forward each for the CSR predict and the served batch
    require(predict_launches == serve_launches
            == (1 if device == "cuda" else 0),
            "fm kernel launches in predict and serve",
            predict=predict_launches, serve=serve_launches)
    want64 = 1 / (1 + np.exp(-fm_margin_f64(trained, offset, col, val)))
    serve_err = float(np.max(np.abs(scores - want64)))
    require(scores.shape == (FM_HELD_OUT,) and np.all(np.isfinite(scores))
            and serve_err <= 1e-5, "served FM scores vs float64 FM math",
            max_abs_err=serve_err)

    out = {"phase": "fm", "device": device, "rows": rows,
           "batch_rows": batch_rows, "steps": steps, "features": features,
           "k": FM_RANK, "fields": CRITEO_INT_FIELDS + CRITEO_CAT_FIELDS,
           "reduced": {"rows": [CRITEO_ROWS, rows]},
           "nnz_bucket": run["nnz_bucket"], "file_write_s": write_s,
           "losses": run["losses"], "epoch_s": run["seconds"],
           "rows_per_s": rows / run["seconds"], "step_s": run["step_s"],
           "step_s_median": statistics.median(run["step_s"]),
           "peak_bytes": run["peak_bytes"], "cpu_steps": cpu_steps,
           "gaps": gap, "v_tolerance": {"rtol": FM_V_RTOL,
                                        "atol": FM_V_ATOL},
           "dense_vs_csr_margin_max_abs": dense_gap,
           "serve": {"rows": FM_HELD_OUT, "max_abs_err_vs_f64": serve_err,
                     "model_device": device},
           "launches": launches, "predict_launches": predict_launches,
           "serve_launches": serve_launches}
    emit(out)
    return out


# -- phase 8: MSLR-WEB30K-shaped pairwise ranking ----------------------------
# Microsoft Learning to Rank, MSLR-WEB30K: 136 dense features, relevance
# labels 0-4 (about 52 / 32 / 13 / 2 / 1 % of the documents), about 120
# documents a query. Feature ids are written 0-based (the dataset's are
# 1-based), so the model's width is 136.
MSLR_FEATURES = 136
MSLR_DOCS = 3_771_125      # the dataset's documents (all five folds)
RANK_BATCH_ROWS = 8192     # the R ceiling of objective="pairwise"
RANK_ROWS = 8 * RANK_BATCH_ROWS
# top shares of a query's documents that get labels 4, 3, 2, 1
MSLR_LABEL_TOPS = (0.01, 0.03, 0.16, 0.48)


def write_mslr_like(path: str, rows: int, seed: int) -> int:
    """A libsvm file with ``qid:`` shaped like MSLR-WEB30K: query groups of
    seeded sizes (20-220 documents, mean 120), 136 features of seeded
    normals with four decimals, labels 0-4 from each document's place in
    its query under a seeded linear score plus noise. Every token is
    fixed width, built as one byte matrix. Returns the query count."""
    rng = np.random.default_rng(seed)
    sizes = []
    while sum(sizes) < rows:
        sizes.append(int(rng.integers(20, 221)))
    qid = np.repeat(np.arange(len(sizes)), sizes)[:rows]
    x = rng.standard_normal((rows, MSLR_FEATURES), dtype=np.float32)
    score = x @ rng.standard_normal(MSLR_FEATURES).astype(np.float32) + \
        4 * rng.standard_normal(rows, dtype=np.float32)
    order = np.lexsort((score, qid))        # by query, then score
    start = np.searchsorted(qid, qid)       # qid is sorted
    size = np.bincount(qid)[qid]
    rank = np.empty(rows, np.int64)
    rank[order] = np.arange(rows) - start[order]
    top = (size - 1 - rank + 0.5) / size    # 0 = the query's best
    label = sum((top < t).astype(np.int64) for t in MSLR_LABEL_TOPS)
    q = np.minimum(np.rint(np.abs(x) * 1e4), 99999).astype(np.int64)
    width = 1 + 10 + MSLR_FEATURES * 12 + 1
    buf = np.empty((rows, width), np.uint8)
    buf[:, 0] = ord("0") + label
    buf[:, 1:6] = np.frombuffer(b" qid:", np.uint8)
    put_digits(buf, 6, qid, 5)
    pos = 11
    for j in range(MSLR_FEATURES):
        buf[:, pos] = ord(" ")
        put_digits(buf, pos + 1, np.full(rows, j), 3)
        buf[:, pos + 4] = ord(":")
        buf[:, pos + 5] = np.where(x[:, j] < 0, ord("-"), ord("0"))
        put_digits(buf, pos + 6, q[:, j] // 10000, 1)
        buf[:, pos + 7] = ord(".")
        put_digits(buf, pos + 8, q[:, j] % 10000, 4)
        pos += 12
    buf[:, pos] = ord("\n")
    buf.tofile(path)
    return int(qid[-1]) + 1


def rank_epoch(uri: str, device: str, batch_rows: int) -> dict:
    """One epoch of LinearLearner(136, objective="pairwise") on the dense
    layout: losses, parameters, step times, peak device memory."""
    learner = LinearLearner(MSLR_FEATURES, objective="pairwise",
                            device=device)
    params = learner.init()
    losses, step_s = [], []
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with device_iter.DeviceRowBlockIter(uri, batch_rows=batch_rows,
                                        layout="dense", device=device) as it:
        for batch in it:
            ts = time.perf_counter()
            params, loss = learner.step(params, batch)
            losses.append(float(loss))
            step_s.append(time.perf_counter() - ts)
    return {"losses": losses, "w": params.w.cpu().numpy(),
            "b": float(params.b), "step_s": step_s,
            "seconds": time.perf_counter() - t0,
            "peak_bytes": (torch.cuda.max_memory_allocated()
                           if device == "cuda" else None)}


def rank_phase(workdir: str, data: dict, device: str = "cuda",
               rows: int = RANK_ROWS,
               batch_rows: int = RANK_BATCH_ROWS) -> dict:
    """MSLR-shaped pairwise ranking: one epoch on ``device`` against the
    port's CPU run at rtol 1e-5, then the learner's two refusals."""
    path = os.path.join(workdir, "mslr_like.libsvm")
    t0 = time.perf_counter()
    queries = write_mslr_like(path, rows, seed=5)
    write_s = time.perf_counter() - t0
    run = rank_epoch(path, device, batch_rows)
    steps = -(-rows // batch_rows)
    require(len(run["losses"]) == steps and np.all(np.isfinite(run["losses"]))
            and np.all(np.isfinite(run["w"])), "rank epoch",
            losses=run["losses"])
    cpu = rank_epoch(path, "cpu", batch_rows)
    gap = compare(run, cpu, f"rank {device} vs cpu")
    # the reference's refusals: R past the ceiling, and data without qids
    refusals = {}
    for name, uri, width, rows_, match in (
            ("oversized", path, MSLR_FEATURES, 2 * RANK_BATCH_ROWS,
             "R=16384 rows per shard"),
            ("no_qid", data["text"], FEATURES, batch_rows, "needs qid")):
        learner = LinearLearner(width, objective="pairwise", device=device)
        with device_iter.DeviceRowBlockIter(uri, batch_rows=rows_,
                                            layout="dense",
                                            device=device) as it:
            batch = next(iter(it))
            try:
                learner.step(learner.init(), batch)
            except ValueError as e:
                refusals[name] = str(e)
        require(match in refusals.get(name, ""), f"rank refusal {name}",
                got=refusals.get(name))
    out = {"phase": "rank", "device": device, "rows": rows,
           "batch_rows": batch_rows, "steps": steps,
           "features": MSLR_FEATURES, "queries": queries,
           "reduced": {"rows": [MSLR_DOCS, rows]}, "file_write_s": write_s,
           "losses": run["losses"], "epoch_s": run["seconds"],
           "rows_per_s": rows / run["seconds"], "step_s": run["step_s"],
           "step_s_median": statistics.median(run["step_s"]),
           "peak_bytes": run["peak_bytes"], "cpu_epoch_s": cpu["seconds"],
           "gaps": gap, "refusals": refusals}
    emit(out)
    return out


# -- phase 9: data-parallel worlds -------------------------------------------
# The machine has one card. The NCCL world holds one rank; the worlds of two
# ranks share cuda:0 over gloo (NCCL refuses two ranks on one device), so
# their collective times measure the code path on one card, not NCCL's
# bandwidth between cards.
DP_RANKS = 2
DP_TIMEOUT_S = 240     # each world's own limit
DP_BARE_RUNS = 20
DP_FM_STEPS = 2


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_world(argv_of_rank, size: int, label: str, env=None,
                timeout: float = DP_TIMEOUT_S) -> "list[str]":
    """Start ``size`` ranks at once under the launcher env protocol on a
    free localhost port; wait at most ``timeout`` seconds for all. A rank
    that fails, or a world that outlives its timeout, fails the phase with
    every rank killed. Returns the ranks' stdouts."""
    port = free_port()
    procs = []
    for r in range(size):
        penv = dict(os.environ, DCT_CSR_TO_DENSE="pallas",
                    DMLC_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                    DMLC_NUM_WORKER=str(size), DMLC_TASK_ID=str(r),
                    DMLC_COLLECTIVE_TIMEOUT_MS=str(int(timeout * 1000)),
                    PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
        penv.update(env or {})
        procs.append(subprocess.Popen(
            argv_of_rank(r), env=penv, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 0.1)))
    except subprocess.TimeoutExpired:
        outs = None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    require(outs is not None, f"{label}: world outlived its timeout",
            timeout_s=timeout)
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        require(p.returncode == 0, f"{label}: rank {r} failed",
                rc=p.returncode, stderr=err[-3000:])
    return [o for o, _ in outs]


def part_rows(uri: str, npart: int = DP_RANKS) -> "list[int]":
    """Rows of each part of ``uri`` as the ranks' parsers split it."""
    counts = []
    for part in range(npart):
        n = 0
        with NativeParser(uri, part=part, npart=npart) as parser:
            for b in parser:
                n += b.num_rows
        counts.append(n)
    return counts


def write_unions(uri: str, prefix: str, local_rows: int,
                 max_steps: "int | None" = None) -> "tuple[list, list]":
    """The batches a 2-rank world steps on, one file a step: part 0's
    batch of ``local_rows`` rows, then part 1's (a part that ran out adds
    none). Returns the parts' row counts and the files (the world's
    first ``max_steps`` steps), named ``prefix`` + step + ``uri``'s
    query."""
    counts = part_rows(uri)
    steps = max(-(-c // local_rows) for c in counts)
    if max_steps is not None:
        steps = min(steps, max_steps)
    path, _, query = uri.partition("?")
    raw = np.fromfile(path, np.uint8)
    ends = np.flatnonzero(raw == ord("\n")) + 1
    starts = np.concatenate([[0], ends[:-1]])
    require(len(ends) == sum(counts), "parts cover the file",
            lines=len(ends), counts=counts)
    first = [0, counts[0]]
    files = []
    for k in range(steps):
        pieces = []
        for p in range(DP_RANKS):
            lo = k * local_rows
            hi = min(lo + local_rows, counts[p])
            if lo < hi:
                pieces.append(raw[starts[first[p] + lo]:
                                  ends[first[p] + hi - 1]])
        dst = f"{prefix}{k}"
        np.concatenate(pieces).tofile(dst)
        files.append(dst + ("?" + query if query else ""))
    return counts, files


def union_run(files: list, learner, params, batch_rows: int,
              device: str) -> "tuple[object, list]":
    """One process stepping once on each union file: (params, losses)."""
    losses = []
    for uri in files:
        with device_iter.DeviceRowBlockIter(uri, batch_rows=batch_rows,
                                            layout="csr",
                                            device=device) as it:
            (batch,) = list(it)
            params, loss = learner.step(params, batch)
        losses.append(float(loss))
    return params, losses


def dp_task(task: dict, mesh, backend: str) -> dict:
    """One task of a world's rank: a warm-up step on a learner of its own,
    then the timed run (kernel launches counted on it alone), a bare
    all_reduce of the step's buffer, and the all-gathered check that every
    rank holds the same parameter bytes."""
    from dmlc_core_tpu_torch.parallel import distributed
    fm = task["model"] == "fm"
    features = task["features"]

    def learner():
        if fm:
            return FMLearner(features, k=FM_RANK, mesh=mesh)
        return LinearLearner(features, margin_path="dense", mesh=mesh)

    def start(lrn):
        if fm:  # the fm phase's start, drawn on the CPU from seed 0
            init = FMLearner(features, k=FM_RANK, device="cpu").init(seed=0)
            return FMParams(*(t.to(mesh.device) for t in init))
        return lrn.init()

    def batches():
        return device_iter.DeviceRowBlockIter(
            task["uri"], part=mesh.rank, npart=mesh.size,
            batch_rows=task["batch_rows"], mesh=mesh, layout="csr")

    warm = learner()
    with batches() as it:
        warm.step(start(warm), next(iter(it)))
    sync(mesh.device)
    hk.reset_launch_counts()
    lrn = learner()
    params = start(lrn)
    losses, step_s, rows = [], [], 0
    t0 = time.perf_counter()
    with batches() as it:
        stream = iter(it)
        while len(losses) != task.get("max_steps"):
            batch = next(stream, None)
            ts = time.perf_counter()
            stepped, loss = lrn.step(params, batch)
            if lrn.last_active == 0:  # no rank had a batch left
                break
            params = stepped
            losses.append(float(loss))  # synchronizes the step
            step_s.append(time.perf_counter() - ts)
            rows += 0 if batch is None else batch.total_rows
        local_batches = it.batches_consumed
    seconds = time.perf_counter() - t0
    launches = hk.csr_to_dense_kernel.launches

    numel = 3 + sum(p.numel() for p in params)  # loss, wsum, active, grads
    comm = mesh.device if backend == "nccl" else torch.device("cpu")
    buf = torch.zeros(numel, dtype=torch.float32, device=comm)
    bare = []
    for _ in range(DP_BARE_RUNS + 1):  # the first run warms up
        distributed.barrier()
        sync(mesh.device)
        tb = time.perf_counter()
        torch.distributed.all_reduce(buf)
        sync(mesh.device)
        bare.append(time.perf_counter() - tb)
    blobs = distributed.allgather_bytes(b"".join(
        p.detach().cpu().numpy().tobytes() for p in params))
    out = {"steps": len(losses), "local_batches": local_batches,
           "rows": rows, "losses": losses, "step_s": step_s,
           "step_s_median": statistics.median(step_s), "epoch_s": seconds,
           "launches": launches, "bytes_reduced_per_step": 4 * numel,
           "bare_allreduce_ms": 1e3 * statistics.median(bare[1:]),
           "replicas_identical": all(b == blobs[0] for b in blobs)}
    if fm:
        if mesh.rank == 0:
            np.savez(task["save"], **fm_params_to_numpy(params))
    else:
        out.update(w=params.w.cpu().numpy().tobytes().hex(),
                   b=float(params.b))
    return out


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def dp_worker(spec_path: str, out_path: str) -> int:
    """A rank of a ``dp`` world (``chip_smoke.py dp-worker SPEC OUT``):
    joins the world from the env protocol, runs the spec's tasks, writes
    its results as JSON."""
    from dmlc_core_tpu_torch.device.sharding import data_mesh
    from dmlc_core_tpu_torch.parallel import distributed
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(spec_path) as f:
        spec = json.load(f)
    distributed.init_from_env(device=spec["device"],
                              backend=spec["backend"])
    try:
        mesh = data_mesh(device=spec["device"])
        backend = torch.distributed.get_backend()
        out = {"rank": mesh.rank, "size": mesh.size, "backend": backend,
               "device": str(mesh.device)}
        for task in spec["tasks"]:
            out[task["name"]] = dp_task(task, mesh, backend)
        if spec.get("cluster"):
            out["cluster"] = cluster_merge(out[spec["tasks"][0]["name"]])
    finally:
        distributed.shutdown()
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


def prometheus_samples(text: str, prefix: str = "") -> dict:
    """{(name, labels text): value} of the counter samples in exposition
    text whose names start with ``prefix``."""
    kinds, out = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split()
            kinds[name] = kind
        elif line and not line.startswith("#") and line.startswith(prefix):
            series, value = line.rsplit(" ", 1)
            name, _, labels = series.partition("{")
            if kinds.get(name) == "counter":
                out[(name, labels.rstrip("}"))] = float(value)
    return out


def labels_text(labels: dict) -> str:
    """Labels as the exposition writes them (sorted, escaped)."""
    return ",".join('{}="{}"'.format(k, str(v).replace("\\", "\\\\")
                                     .replace('"', '\\"')
                                     .replace("\n", "\\n"))
                    for k, v in sorted(labels.items()))


def cluster_check(per_rank: dict, step_us: dict) -> dict:
    """Rank 0's side of the cluster half: the job-wide exposition of the
    ranks' ``rank_export`` documents, every ``job:`` counter against the
    sum of the ranks' own counters, and the straggler verdict over the
    ranks' step durations (microseconds)."""
    text = telemetry.cluster_prometheus_text(per_rank)
    job = prometheus_samples(text, "job:")
    want = {}
    for doc in per_rank.values():
        for c in doc["metrics"]["counters"]:
            key = ("job:" + c["name"], labels_text(c["labels"]))
            want[key] = want.get(key, 0) + c["value"]
    bad = {f"{k[0]}{{{k[1]}}}": [job.get(k), v] for k, v in want.items()
           if job.get(k) != float(v)}
    verdict = telemetry.straggler_attribution(step_us)
    return {"ranks": sorted(per_rank), "job_counters": len(job),
            "job_counters_equal_rank_sums": not bad and len(job) == len(want),
            "mismatches": bad, "exposition_bytes": len(text),
            "straggler": verdict}


def cluster_merge(task: dict) -> dict:
    """Every rank ships its ``rank_export()`` and its step durations through
    ``allgather_bytes``; rank 0 checks the merge (:func:`cluster_check`),
    the other ranks return an empty record."""
    from dmlc_core_tpu_torch.parallel import distributed
    mine = {"export": telemetry.rank_export(),
            "step_us": [1e6 * s for s in task["step_s"]]}
    blobs = distributed.allgather_bytes(json.dumps(mine).encode())
    if distributed.rank() != 0:
        return {}
    docs = [json.loads(b) for b in blobs]
    return cluster_check({r: d["export"] for r, d in enumerate(docs)},
                         {r: d["step_us"] for r, d in enumerate(docs)})


def run_dp_world(workdir: str, name: str, size: int, backend: str,
                 device: str, tasks: list, cluster: bool = False
                 ) -> "tuple[list, float]":
    """A world of ``size`` ``dp-worker`` ranks; their results and the
    world's wall-clock seconds, process start-up included. With
    ``cluster`` the ranks also merge their telemetry
    (:func:`cluster_merge`)."""
    spec = os.path.join(workdir, f"dp_{name}.json")
    with open(spec, "w") as f:
        json.dump({"backend": backend, "device": device, "tasks": tasks,
                   "cluster": cluster}, f)
    outs = [os.path.join(workdir, f"dp_{name}_rank{r}.out.json")
            for r in range(size)]
    script = os.path.abspath(__file__)
    t0 = time.perf_counter()
    spawn_world(lambda r: [sys.executable, script, "dp-worker", spec,
                           outs[r]], size, f"dp world {name}")
    seconds = time.perf_counter() - t0
    results = []
    for path in outs:
        with open(path) as f:
            results.append(json.load(f))
    return results, seconds


def world_report(results: list, task: str, seconds: float,
                 global_rows: int) -> dict:
    """The numbers of one task of a world, over its ranks."""
    per = [r[task] for r in results]
    return {"backend": results[0]["backend"], "ranks": len(results),
            "device": results[0]["device"], "steps": per[0]["steps"],
            "step_s_median": max(p["step_s_median"] for p in per),
            "epoch_s": max(p["epoch_s"] for p in per),
            "rows_per_s": global_rows / max(p["epoch_s"] for p in per),
            "bytes_reduced_per_step": per[0]["bytes_reduced_per_step"],
            "bare_allreduce_ms": statistics.median(
                p["bare_allreduce_ms"] for p in per),
            "launches_per_rank": [p["launches"] for p in per],
            "local_batches": [p["local_batches"] for p in per],
            "replicas_identical": all(p["replicas_identical"] for p in per),
            "world_s": seconds}


def linear_result(res: dict) -> dict:
    return {"losses": res["losses"], "b": res["b"],
            "w": np.frombuffer(bytes.fromhex(res["w"]), np.float32)}


def cli_world(data_uri: str, device: str, batch_rows: int,
              extra: list, label: str) -> "tuple[list, float]":
    """``python -m dmlc_core_tpu_torch.train`` in a 2-rank gloo world;
    the ranks' lines and the world's seconds."""
    argv = [sys.executable, "-m", "dmlc_core_tpu_torch.train", data_uri,
            "--epochs", "2", "--batch-rows", str(batch_rows),
            "--backend", "gloo", *extra]
    if device != "cuda":
        argv += ["--device", device]
    t0 = time.perf_counter()
    outs = spawn_world(lambda r: argv, DP_RANKS, label)
    return [o.splitlines() for o in outs], time.perf_counter() - t0


def line_loss(line: str) -> float:
    return float(line.split("mean loss ")[1].split(" ")[0])


def dp_phase(workdir: str, data: dict, main_run: dict,
             main_params: LinearParams, device: str = "cuda",
             batch_rows: int = BATCH_ROWS) -> dict:
    """The data-parallel path: (a) the ``train`` phase's run in an NCCL
    world of one rank, bit for bit; (b) a 2-rank gloo world sharing the
    card on the same file (the kernel on every rank) and the Criteo-shaped
    FM, each against one process stepping on the union of the two ranks'
    batches; (c) the training CLI in a 2-rank world: job checkpoint, then
    a resume from the one committed after epoch 1."""
    from dmlc_core_tpu_torch.utils.checkpoint import (commit_job_checkpoint,
                                                      restore_checkpoint)
    os.environ["DCT_CSR_TO_DENSE"] = "pallas"
    rows = data["rows"]
    steps = -(-rows // batch_rows)
    higgs = {"name": "linear", "model": "linear", "uri": data["text"],
             "features": FEATURES, "batch_rows": batch_rows}
    worlds = {}

    # (a) one rank on NCCL against the train phase's run without a mesh
    one = "nccl" if device == "cuda" else "gloo"
    res, secs = run_dp_world(workdir, "one", 1, one, device, [higgs])
    a = linear_result(res[0]["linear"])
    bit_equal = (a["losses"] == list(main_run["losses"])
                 and a["w"].tobytes() == main_params.w.cpu().numpy()
                 .tobytes() and a["b"] == float(main_params.b))
    worlds["nccl_1"] = world_report(res, "linear", secs, rows)
    worlds["nccl_1"]["bit_equal_to_no_mesh"] = bit_equal
    if not bit_equal:  # the stated fallback: the gap, at most rtol 1e-5
        worlds["nccl_1"]["gap_vs_no_mesh"] = compare(
            a, {"losses": main_run["losses"],
                "w": main_params.w.cpu().numpy(),
                "b": float(main_params.b)}, "nccl world of 1 vs no mesh")
    if device == "cuda":
        require(worlds["nccl_1"]["launches_per_rank"] == [steps],
                "nccl world: a launch a step", **worlds["nccl_1"])

    # (b) two ranks sharing the card over gloo: HIGGS through the kernel,
    # then the Criteo-shaped FM for DP_FM_STEPS steps
    fm_uri = os.path.join(workdir, "criteo_like.libfm") + "?format=libfm"
    fm_save = os.path.join(workdir, "dp_fm_params.npz")
    fm_task = {"name": "fm", "model": "fm", "uri": fm_uri,
               "features": CRITEO_FEATURES, "batch_rows": batch_rows,
               "max_steps": DP_FM_STEPS, "save": fm_save}
    res, secs = run_dp_world(workdir, "two", DP_RANKS, "gloo", device,
                             [higgs, fm_task], cluster=True)
    cluster = res[0]["cluster"]
    require(cluster["job_counters_equal_rank_sums"]
            and cluster["job_counters"] > 0
            and cluster["ranks"] == list(range(DP_RANKS)),
            "cluster exposition: job counters against the rank sums",
            **cluster)
    local = batch_rows // DP_RANKS
    union = os.path.join(workdir, "higgs_union_")
    counts, files = write_unions(data["text"], union, local)
    world_steps = len(files)
    lrn = LinearLearner(FEATURES, margin_path="dense", device=device)
    p, losses = union_run(files, lrn, lrn.init(), batch_rows, device)
    two = world_report(res, "linear", secs, rows)
    two["part_rows"] = counts
    two["gap_vs_union"] = compare(
        linear_result(res[0]["linear"]),
        {"losses": losses, "w": p.w.cpu().numpy(), "b": float(p.b)},
        "gloo world vs union run")
    require(two["replicas_identical"]
            and res[0]["linear"]["w"] == res[1]["linear"]["w"],
            "gloo world: replicas differ")
    # every rank takes the world's steps; a rank whose part ran out adds
    # zero-weight steps, which launch nothing
    require([r["linear"]["steps"] for r in res] == [world_steps] * DP_RANKS
            and two["local_batches"] == [-(-c // local) for c in counts],
            "gloo world: steps on every rank", **two)
    if device == "cuda":
        require(two["launches_per_rank"] == two["local_batches"],
                "gloo world: a launch a step on every rank", **two)
    worlds["gloo_2"] = two

    _, files = write_unions(fm_uri, os.path.join(workdir, "criteo_union"),
                            local, DP_FM_STEPS)
    lrn = FMLearner(CRITEO_FEATURES, k=FM_RANK, device=device)
    init = FMLearner(CRITEO_FEATURES, k=FM_RANK, device="cpu").init(seed=0)
    p, losses = union_run(files, lrn, FMParams(*(t.to(device)
                                                 for t in init)),
                          batch_rows, device)
    want_p = fm_params_to_numpy(p)
    with np.load(fm_save) as z:
        got_p = {k: z[k] for k in z.files}
    la = np.asarray(res[0]["fm"]["losses"])
    lb = np.asarray(losses)
    fm_gap = {"loss_max_rel": float(np.max(np.abs(la - lb) / np.abs(lb))),
              "w_max_abs": float(np.max(np.abs(got_p["w"] - want_p["w"]))),
              "b_abs": float(abs(got_p["b"] - want_p["b"])),
              "v_max_abs": float(np.max(np.abs(got_p["v"] - want_p["v"])))}
    require(la.shape == lb.shape == (DP_FM_STEPS,)
            and np.allclose(la, lb, rtol=1e-5, atol=0)
            and np.allclose(got_p["w"], want_p["w"], rtol=1e-5, atol=1e-7)
            and np.allclose(got_p["b"], want_p["b"], rtol=1e-5, atol=1e-7)
            and np.allclose(got_p["v"], want_p["v"], rtol=FM_V_RTOL,
                            atol=FM_V_ATOL), "fm world vs union run",
            **fm_gap)
    fm = world_report(res, "fm", secs, DP_FM_STEPS * batch_rows)
    fm["gap_vs_union"] = fm_gap
    require(fm["replicas_identical"], "fm world: replicas differ")
    worlds["gloo_2_fm"] = fm

    # (c) the CLI: a job checkpoint each epoch, then a resume from the
    # step committed after epoch 1 (its parts stay; the marker is
    # committed again at that step)
    base = os.path.join(workdir, "dp_job.ckpt")
    whole, secs = cli_world(data["text"], device, batch_rows,
                            ["--checkpoint", base], "cli world")
    require(whole[0] == whole[1] and len(whole[0]) == 2
            and all(f"over {world_steps} batches" in ln for ln in whole[0]),
            "cli world: the ranks' lines", lines=whole)
    with open(base + ".commit") as f:
        marker = json.load(f)
    require(marker == {"schema": 1, "step": 2, "npart": DP_RANKS,
                       "parts": [f"{base}.step2.part{p}of{DP_RANKS}"
                                 for p in range(DP_RANKS)]},
            "cli world: commit marker", marker=marker)
    for step in (1, 2):
        parts = [restore_checkpoint(f"{base}.step{step}.part{p}of2")
                 for p in range(DP_RANKS)]
        require(all(s == step for _, s, _ in parts)
                and [e["part"] for _, _, e in parts] == ["0", "1"]
                and all(parts[0][0][k].tobytes() == parts[1][0][k].tobytes()
                        for k in parts[0][0]),
                "cli world: job checkpoint parts", step=step)
    commit_job_checkpoint(base, 1, DP_RANKS)
    resumed, resume_s = cli_world(data["text"], device, batch_rows,
                                  ["--resume", base], "cli resume world")
    require(resumed[0] == resumed[1] and len(resumed[0]) == 1
            and resumed[0][0].split(" mean")[0] == "epoch 1:"
            and resumed[0][0].split(" over ")[1]
            == whole[0][1].split(" over ")[1]
            and np.isclose(line_loss(resumed[0][0]), line_loss(whole[0][1]),
                           rtol=1e-5, atol=0),
            "cli resume: the uninterrupted epoch-1 line", resumed=resumed,
            whole=whole)
    worlds["cli_gloo_2"] = {"backend": "gloo", "ranks": DP_RANKS,
                            "lines": whole[0], "resumed": resumed[0],
                            "world_s": secs, "resume_world_s": resume_s}

    launches = sum(sum(worlds[w]["launches_per_rank"])
                   for w in ("nccl_1", "gloo_2"))
    out = {"phase": "dp", "device": device, "rows": rows,
           "batch_rows": batch_rows, "cluster": cluster,
           "card": "one card: the 2-rank worlds "
           "share it over gloo and measure the code path, not NCCL "
           "between cards",
           "reduced": {"nccl_world_ranks": "1 (the machine has one card)",
                       "gloo_worlds": "2 ranks share cuda:0",
                       "fm_steps": [FM_ROWS // batch_rows, DP_FM_STEPS]},
           "worlds": worlds, "launches": {"csr_to_dense": launches}}
    emit(out)
    return out


# -- job: the tracker, elastic leases over s3://, a world relaunch ------------
JOB_SHARDS = 16          # run A: 32,768 rows a shard at the full size
JOB_ELASTIC_BATCH = 16384
JOB_STEPS = 8            # run B: steps of the world's global batch
JOB_KILL_STEP = 5        # attempt 0's rank 1 SIGKILLs itself in this step
JOB_CKPT_STEPS = (2, 4, 6)
JOB_HB_MS = 200
JOB_DEAD_MS = 2000
JOB_GRACE_MS = 500       # run A: nobody recovers; the write-off is the path
JOB_TIMEOUT_S = 300      # each submit's own limit
JOB_BUCKET = "chip-smoke"


def planes_sha(batch, h) -> None:
    """Fold a batch's leaves, copied to the host, into the sha256 ``h``."""
    for name, t in sorted(batch.tree().items()):
        h.update(name.encode())
        h.update(t.cpu().numpy().tobytes())


def write_json(path: str, obj) -> None:
    """One fsync'd JSON document (a worker's record survives its kill)."""
    with open(path, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())


def tracker_note(scratch: str) -> None:
    """Where this world's tracker listens, for the phase's /state poll."""
    write_json(os.path.join(scratch, "tracker.json"),
               {"host": os.environ["DMLC_TRACKER_URI"],
                "port": int(os.environ["DMLC_TRACKER_PORT"])})


def job_elastic_worker(spec_path: str) -> int:
    """A worker of run A (``chip_smoke.py job-elastic-worker SPEC``): joins
    the rendezvous with heartbeats and steps ``LinearLearner(dense)`` on
    every batch of the shards the tracker grants it, through
    ``ElasticDeviceRowBlockIter`` over the ``s3://`` file. Each finished
    shard is one fsync'd JSON line (shard, sha256 of its batches' planes,
    rows, the pipeline's start cost). The victim (task 0, first attempt)
    finishes one shard, acquires a second and SIGKILLs itself holding its
    lease. A relaunched worker cannot rejoin the running world through the
    link dance (the reference's recovery is two-sided), so it waits on
    the tracker's /state until its old rank is written off, and leaves."""
    from dmlc_core_tpu_torch.tracker.client import RendezvousClient
    from dmlc_core_tpu_torch.tracker.wire import env_int
    with open(spec_path) as f:
        spec = json.load(f)
    if spec["device"] == "cpu":
        torch.set_num_threads(1)  # beside the parser's spinning workers
    scratch, task = spec["scratch"], env_int("DMLC_TASK_ID", 0)
    host = os.environ["DMLC_TRACKER_URI"]
    port = env_int("DMLC_TRACKER_PORT", 9091)
    rank_file = os.path.join(scratch, f"rank_{task}")
    if env_int("DMLC_NUM_ATTEMPT", 0) > 0:
        t0 = time.time()
        with open(rank_file) as f:
            old_rank = int(f.read())
        phase = tracker_rank_phase(host, port, old_rank)
        write_json(os.path.join(scratch, f"relaunched_{task}.json"),
                   {"task": task, "saw": phase, "started_ts": t0,
                    "left_ts": time.time()})
        return 0
    hk.reset_launch_counts()
    client = RendezvousClient(host, port)
    assign = client.start(heartbeat=True)
    with open(rank_file, "w") as f:
        f.write(str(assign.rank))
    tracker_note(scratch)
    lrn = LinearLearner(FEATURES, margin_path="dense", device=spec["device"])
    params = lrn.init()
    it = device_iter.ElasticDeviceRowBlockIter(
        spec["uri"], batch_rows=spec["batch_rows"], layout="csr",
        device=spec["device"], acquire_timeout=120)
    out = open(os.path.join(scratch, f"consumed_{task}.jsonl"), "a")
    rec = None
    waited_from = time.perf_counter()
    for shard, batch in it:
        if rec is None or shard != rec["shard"]:
            start_s = time.perf_counter() - waited_from
            if rec is not None:
                out.write(json.dumps(rec | {"sha": h.hexdigest()}) + "\n")
                out.flush()
                os.fsync(out.fileno())
            if task == spec["victim_task"] and rec is not None:
                write_json(os.path.join(scratch, "victim.json"),
                           {"shard": shard, "rank": assign.rank,
                            "launches": hk.csr_to_dense_kernel.launches,
                            "kill_ts": time.time()})
                os.kill(os.getpid(), signal.SIGKILL)
            rec = {"shard": shard, "task": task, "rank": assign.rank,
                   "rows": 0, "batches": 0, "start_s": start_s}
            h = hashlib.sha256()
        planes_sha(batch, h)
        params, loss = lrn.step(params, batch)
        float(loss)  # synchronizes the step
        rec["rows"] += batch.total_rows
        rec["batches"] += 1
        waited_from = time.perf_counter()
    if rec is not None:
        out.write(json.dumps(rec | {"sha": h.hexdigest()}) + "\n")
    out.close()
    write_json(os.path.join(scratch, f"summary_{task}.json"),
               {"task": task, "rank": assign.rank,
                "launches": hk.csr_to_dense_kernel.launches})
    client.shutdown(assign.rank)
    return 0


def tracker_rank_phase(host: str, port: int, rank: int,
                       timeout: float = 120.0) -> str:
    """Poll the tracker's /state until ``rank`` is written off (``lost``)
    or the job is over; what was seen (``tracker-gone`` once the tracker
    stopped answering)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        st = tracker_state(host, port)
        if st is None:
            return "tracker-gone"
        phase = st["ranks"].get(str(rank), {}).get("phase")
        if phase == "lost" or st.get("finished"):
            return phase
        time.sleep(0.1)
    raise CheckFailed(f"rank {rank} was not written off in {timeout} s")


def tracker_state(host: str, port: int) -> "dict | None":
    """The tracker's /state document, or None when it does not answer."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(f"http://{host}:{port}/state",
                                    timeout=5) as r:
            return json.load(r)
    except (urllib.error.URLError, OSError, ValueError):
        return None


def job_mesh_worker(spec_path: str) -> int:
    """A rank of run B (``chip_smoke.py job-mesh-worker SPEC``): a gloo
    world sharing the card, joined to the rendezvous, stepping the
    data-parallel ``LinearLearner(dense)`` on its part of the ``s3://``
    file under a ``StepWatchdog``, with a job checkpoint (parameters and
    iterator position, on ``s3://``) after steps 2, 4 and 6. It resumes
    from the last committed one. In attempt 0, rank 1 SIGKILLs itself in
    step 5. A gloo error from the dead peer, the tracker's abort and the
    supervisor's SIGTERM all end in the same structured abort: the abort
    record, the flight dump naming the rank, an exit record and exit 41
    (the record names which came first)."""
    from dmlc_core_tpu_torch.device.sharding import data_mesh
    from dmlc_core_tpu_torch.parallel import (STEP_ABORT_EXIT, StepWatchdog,
                                              distributed, structured_abort)
    from dmlc_core_tpu_torch.tracker.client import RendezvousClient
    from dmlc_core_tpu_torch.tracker.wire import TrackerAbortedError, env_int
    from dmlc_core_tpu_torch.utils.checkpoint import (
        commit_job_checkpoint, restore_job_checkpoint, save_job_checkpoint)
    torch.backends.cuda.matmul.allow_tf32 = False
    with open(spec_path) as f:
        spec = json.load(f)
    if spec["device"] == "cpu":
        torch.set_num_threads(1)  # beside the parser's spinning workers
    scratch = spec["scratch"]
    attempt = env_int("DMLC_WORLD_ATTEMPT", 0)
    distributed.init_from_env(device=spec["device"], backend="gloo")
    client = RendezvousClient(os.environ["DMLC_TRACKER_URI"],
                              env_int("DMLC_TRACKER_PORT", 9091))
    assign = client.start(heartbeat=True)
    tracker_note(scratch)
    mesh = data_mesh(device=spec["device"])
    rank, size = mesh.rank, mesh.size
    hk.reset_launch_counts()
    lrn = LinearLearner(FEATURES, margin_path="dense", mesh=mesh)
    params, start = lrn.init(), 0
    it = device_iter.DeviceRowBlockIter(
        spec["uri"], part=rank, npart=size, batch_rows=spec["batch_rows"],
        mesh=mesh, layout="csr")
    got = restore_job_checkpoint(spec["job"], rank, size, like=params)
    if got is not None:
        params, start, extra = got
        it.restore(json.loads(extra["iter"]))
    log = open(os.path.join(scratch, f"steps_a{attempt}_r{rank}.jsonl"), "a")
    wd = StepWatchdog(rank=rank, drains=[it.abort_drain]).start()
    step = start

    leaving = threading.Lock()  # held by the one abort that runs

    def leave(cause: str, reason: str) -> None:
        # one abort, named by whatever took the lock first: a SIGTERM
        # whose handler runs while an earlier cause drains returns here,
        # and one that runs before it has taken the lock exits the
        # process itself, so the earlier cause never resumes
        if not leaving.acquire(blocking=False):
            return
        structured_abort(f"{cause}: rank {rank} at step {step}: {reason}",
                         drains=[it.abort_drain], rank=rank)
        write_json(os.path.join(scratch, f"exit_a{attempt}_r{rank}.json"),
                   {"cause": cause, "code": STEP_ABORT_EXIT,
                    "ts": time.time(), "rank": rank, "step": step})
        os._exit(STEP_ABORT_EXIT)

    signal.signal(signal.SIGTERM, lambda *_: leave(
        "sigterm", "the supervisor is tearing the world down"))
    stream = iter(it)
    try:
        for step in range(start, spec["steps"]):
            wd.step_begin(step)
            if attempt == 0 and rank == 1 and step == spec["kill_step"]:
                write_json(os.path.join(scratch, "victim.json"),
                           {"rank": rank, "step": step,
                            "kill_ts": time.time()})
                os.kill(os.getpid(), signal.SIGKILL)
            batch = next(stream)
            t_begin = time.time()
            params, loss = lrn.step(params, batch)
            loss = float(loss)  # synchronizes the step
            t_end = time.time()
            wd.step_end()
            log.write(json.dumps({
                "attempt": attempt, "rank": rank, "step": step,
                "loss": loss, "t_begin": t_begin, "t_end": t_end,
                "launches": hk.csr_to_dense_kernel.launches}) + "\n")
            log.flush()
            if step + 1 in spec["ckpt_steps"]:
                save_job_checkpoint(spec["job"], params, step + 1, rank,
                                    size, extra={"iter": json.dumps(
                                        it.state())})
                distributed.barrier()
                if rank == 0:
                    commit_job_checkpoint(spec["job"], step + 1, size)
    except RuntimeError as e:  # TrackerAbortedError is one
        leave("tracker-abort" if isinstance(e, TrackerAbortedError)
              else "collective-error", str(e))
    finally:
        wd.stop()
    log.close()
    it.close()
    client.shutdown(assign.rank)
    distributed.shutdown()
    return 0


class StatePoll(threading.Thread):
    """Samples the tracker's /state every 50 ms while a submit runs: the
    ranks' heartbeat ages as the tracker sees them (sample time, tracker
    port, rank, phase, age)."""

    def __init__(self, scratch: str):
        super().__init__(daemon=True)
        self.path = os.path.join(scratch, "tracker.json")
        self.samples = []
        self.stop = threading.Event()

    def run(self) -> None:
        while not self.stop.wait(0.05):
            try:
                with open(self.path) as f:
                    where = json.load(f)
            except (OSError, ValueError):
                continue
            st = tracker_state(where["host"], where["port"])
            now = time.time()
            for r, info in ((st or {}).get("ranks") or {}).items():
                if info.get("last_heartbeat_age_s") is not None:
                    self.samples.append((now, where["port"], int(r),
                                         info["phase"],
                                         info["last_heartbeat_age_s"]))


def run_submit(scratch: str, worker_mode: str, spec: dict, flags: list,
               events: str) -> "tuple[float, list]":
    """``python -m dmlc_core_tpu_torch.tracker.submit --cluster local``
    with two workers of this script in ``worker_mode``, under its own
    timeout; every process it started is gone when this returns. Returns
    the wall seconds and the /state samples."""
    spec_path = os.path.join(scratch, "spec.json")
    write_json(spec_path, spec)
    script = os.path.abspath(__file__)
    cmd = [sys.executable, "-m", "dmlc_core_tpu_torch.tracker.submit",
           "--cluster", "local", "--num-workers", "2", "--heartbeat-ms",
           str(JOB_HB_MS), "--dead-after-ms", str(JOB_DEAD_MS), *flags,
           "--", sys.executable, script, worker_mode, spec_path]
    env = dict(os.environ, DCT_CSR_TO_DENSE="pallas",
               DMLC_TRACKER_EVENT_LOG=events,
               DMLC_ABORT_RECORD=os.path.join(scratch, "abort.jsonl"),
               DMLC_TRACE_DUMP=os.path.join(scratch, "dumps"),
               PYTHONPATH=os.path.dirname(script))
    os.makedirs(env["DMLC_TRACE_DUMP"], exist_ok=True)
    poll = StatePoll(scratch)
    poll.start()
    t0 = time.perf_counter()
    with open(os.path.join(scratch, "submit.log"), "w") as log:
        proc = subprocess.Popen(cmd, env=env, stdout=log,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=JOB_TIMEOUT_S)
            # a relaunched worker may outlive the submit: let the session
            # empty on its own for a while
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                os.killpg(proc.pid, 0)
                time.sleep(0.1)
        except subprocess.TimeoutExpired:
            rc = None
        except ProcessLookupError:
            pass
        finally:
            # the submit, its workers and any straggler: one session
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
    seconds = time.perf_counter() - t0
    poll.stop.set()
    poll.join()
    with open(os.path.join(scratch, "submit.log")) as f:
        tail = f.read()[-3000:]
    require(rc == 0, f"{worker_mode}: submit failed", rc=rc, log=tail)
    return seconds, poll.samples


def read_jsonl(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def read_events(path: str) -> list:
    return read_jsonl(path) if os.path.exists(path) else []


def largest_gap(samples: list, skip) -> "float | None":
    """Largest heartbeat age the tracker reported for a live rank, in ms,
    over the /state samples for which ``skip(t, rank)`` is false (a killed
    rank's, or a dead world's, samples do not count)."""
    ages = [age for t, _, r, phase, age in samples
            if phase == "alive" and not skip(t, r)]
    return 1e3 * max(ages) if ages else None


def upload(src: str, uri: str) -> float:
    """Copy ``src`` to ``uri`` through the port's native stream; seconds."""
    t0 = time.perf_counter()
    with open(src, "rb") as f, native.NativeStream(uri, "w") as out:
        while True:
            chunk = f.read(8 << 20)
            if not chunk:
                break
            out.write(chunk)
    return time.perf_counter() - t0


def job_run_a(workdir: str, data: dict, uri: str, device: str,
              batch_rows: int) -> dict:
    """Run A: the elastic data plane (see :func:`job_elastic_worker`)."""
    scratch = os.path.join(workdir, "job_a")
    os.makedirs(scratch)
    events = os.path.join(scratch, "events.jsonl")
    seconds, samples = run_submit(
        scratch, "job-elastic-worker",
        {"uri": uri, "device": device, "batch_rows": batch_rows,
         "scratch": scratch, "victim_task": 0},
        ["--num-attempt", "1", "--recover-grace-ms", str(JOB_GRACE_MS),
         "--num-shards", str(JOB_SHARDS)], events)
    with open(os.path.join(scratch, "victim.json")) as f:
        victim = json.load(f)
    done = []
    for task in (0, 1):
        path = os.path.join(scratch, f"consumed_{task}.jsonl")
        done += read_jsonl(path) if os.path.exists(path) else []
    shards = sorted(r["shard"] for r in done)
    require(shards == list(range(JOB_SHARDS)),
            "run A: every shard completed exactly once", shards=shards)
    # the same shards read from the local file in this process
    want = {}
    for shard in range(JOB_SHARDS):
        h = hashlib.sha256()
        with device_iter.DeviceRowBlockIter(
                data["text"], part=shard, npart=JOB_SHARDS,
                batch_rows=batch_rows, layout="csr", device=device) as it:
            for b in it:
                planes_sha(b, h)
        want[shard] = h.hexdigest()
    bad = [r["shard"] for r in done if r["sha"] != want[r["shard"]]]
    require(not bad, "run A: shard batches differ from the local file's",
            shards=bad)
    ev = read_events(events)
    vr, held = victim["rank"], victim["shard"]
    require([r["task"] for r in done if r["shard"] == held] == [1],
            "run A: the victim's held shard completed by the other task",
            victim=victim)

    def first(kind: str, **match) -> "dict | None":
        return next((e for e in ev if e["event"] == kind and all(
            e.get(k) == v for k, v in match.items())), None)

    dead, lost = first("dead", rank=vr), first("lost", rank=vr)
    reclaim = first("lease-reclaim", rank=vr, shard=held)
    regrant = [e for e in ev if e["event"] == "lease-grant"
               and e["shard"] == held and e["ts"] > victim["kill_ts"]]
    require(dead and lost and reclaim and regrant
            and regrant[0]["rank"] != vr
            and dead["ts"] <= lost["ts"] <= reclaim["ts"]
            <= regrant[0]["ts"],
            "run A: the event log shows the victim dead, written off, its "
            "lease reclaimed and its shard granted again, in that order",
            victim=victim, dead=dead, lost=lost, reclaim=reclaim,
            regrant=regrant)
    grants = [e["ts"] for e in ev if e["event"] == "lease-grant"]
    drained = [e["ts"] for e in ev if e["event"] == "epoch-drained"]
    # how long the pool stood empty before the victim's shard came back
    last_done = max(e["ts"] for e in ev if e["event"] == "lease-complete"
                    and e["ts"] < regrant[0]["ts"])
    rows = sum(r["rows"] for r in done)
    require(rows == data["rows"], "run A: rows", rows=rows)
    relaunched = []
    for name in sorted(os.listdir(scratch)):
        if name.startswith("relaunched_"):
            with open(os.path.join(scratch, name)) as f:
                relaunched.append(json.load(f))
    require(len(relaunched) == 1 and relaunched[0]["task"] == 0,
            "run A: the supervisor relaunched the victim's task",
            relaunched=relaunched)
    # a relaunch that polled /state while the epoch still ran must have
    # seen its old rank written off; one that came later finds the job over
    relaunch = relaunched[0]
    require(relaunch["saw"] == "lost"
            or relaunch["started_ts"] >= drained[0],
            "run A: the relaunch during the job saw its rank written off",
            relaunch=relaunch, drained=drained[0])
    launches = victim["launches"]
    per_task = {}
    for task in (0, 1):
        path = os.path.join(scratch, f"summary_{task}.json")
        if os.path.exists(path):
            with open(path) as f:
                launches += json.load(f)["launches"]
        per_task[task] = sorted(r["shard"] for r in done
                                if r["task"] == task)
    if device == "cuda":
        require(launches == sum(r["batches"] for r in done),
                "run A: a launch a step", launches=launches)
    starts = [r["start_s"] for r in done]
    return {"seconds": seconds, "shards_per_task": per_task,
            "victim": {"task": 0, "rank": vr, "held_shard": held},
            "relaunch": relaunch["saw"],
            "relaunch_start_after_kill_ms": 1e3 * (relaunch["started_ts"]
                                                   - victim["kill_ts"]),
            "relaunch_start_after_drain_ms": 1e3 * (relaunch["started_ts"]
                                                    - drained[0]),
            "rows": rows, "rows_per_s": rows / (drained[0] - grants[0]),
            "kill_to_regrant_ms": 1e3 * (regrant[0]["ts"]
                                         - victim["kill_ts"]),
            "pool_empty_before_regrant_ms": 1e3 * (regrant[0]["ts"]
                                                   - last_done),
            "shard_start_ms": {"median": 1e3 * statistics.median(starts),
                               "max": 1e3 * max(starts)},
            "largest_heartbeat_gap_ms": largest_gap(
                samples, lambda t, r: r == vr and t >= victim["kill_ts"]),
            "state_samples": len(samples), "launches": launches}


def job_run_b(workdir: str, data: dict, uri: str, device: str,
              batch_rows: int) -> dict:
    """Run B: the mesh world, its SIGKILLed rank and the whole-world
    relaunch (see :func:`job_mesh_worker`), against one process stepping
    on the union batches."""
    scratch = os.path.join(workdir, "job_b")
    os.makedirs(scratch)
    events = os.path.join(scratch, "events.jsonl")
    seconds, samples = run_submit(
        scratch, "job-mesh-worker",
        {"uri": uri, "device": device, "batch_rows": batch_rows,
         "scratch": scratch, "job": f"s3://{JOB_BUCKET}/job",
         "steps": JOB_STEPS, "kill_step": JOB_KILL_STEP,
         "ckpt_steps": list(JOB_CKPT_STEPS)}, ["--mesh"], events)
    with open(os.path.join(scratch, "victim.json")) as f:
        victim = json.load(f)
    steps = {(a, r): read_jsonl(os.path.join(scratch,
                                             f"steps_a{a}_r{r}.jsonl"))
             for a in (0, 1) for r in (0, 1)}
    for r in (0, 1):
        require([s["step"] for s in steps[0, r]] == list(range(
            JOB_KILL_STEP)) and [s["step"] for s in steps[1, r]] ==
            list(range(JOB_CKPT_STEPS[1], JOB_STEPS)),
            "run B: steps of each attempt", rank=r,
            a0=[s["step"] for s in steps[0, r]],
            a1=[s["step"] for s in steps[1, r]])
    # the survivor: rank 0 of attempt 0
    with open(os.path.join(scratch, "exit_a0_r0.json")) as f:
        survivor = json.load(f)
    records = read_jsonl(os.path.join(scratch, "abort.jsonl"))
    dumps = []
    for name in os.listdir(os.path.join(scratch, "dumps")):
        if not name.endswith(".json"):
            continue  # a dump its writer died inside (another thread's
            # os._exit): the heartbeat thread dumps on the abort too
        with open(os.path.join(scratch, "dumps", name)) as f:
            doc = json.load(f)
        dumps.append((doc["reason"].split(":")[0], doc["rank"]))
    require(("mesh-abort", 0) in dumps, "run B: the survivor's flight "
            "dump naming its rank", dumps=dumps)
    kill_to_exit = 1e3 * (survivor["ts"] - victim["kill_ts"])
    require(survivor["code"] == 41
            and [rec["rank"] for rec in records] == [0]
            and 0 <= kill_to_exit <= 2 * JOB_DEAD_MS,
            "run B: the survivor's one structured abort within 2 x "
            "dead-after",
        survivor=survivor, records=records, kill_to_exit_ms=kill_to_exit)
    losses = [s["loss"] for s in steps[0, 0]] + \
        [s["loss"] for s in steps[1, 0][1:]]
    step4 = (steps[0, 0][JOB_CKPT_STEPS[1]]["loss"],
             steps[1, 0][0]["loss"])
    require(step4[0] == step4[1], "run B: the step-4 loss of both "
            "attempts bit for bit", step4=step4)
    require(all([s["loss"] for s in steps[a, 0]] ==
                [s["loss"] for s in steps[a, 1]] for a in (0, 1)),
            "run B: the ranks' losses differ")
    _, files = write_unions(data["text"],
                            os.path.join(workdir, "job_union_"),
                            batch_rows // DP_RANKS, JOB_STEPS)
    lrn = LinearLearner(FEATURES, margin_path="dense", device=device)
    _, want = union_run(files, lrn, lrn.init(), batch_rows, device)
    la, lb = np.asarray(losses), np.asarray(want)
    require(la.shape == lb.shape and np.allclose(la, lb, rtol=1e-5, atol=0),
            "run B: losses against the union run at rtol 1e-5",
            got=losses, want=want)
    ev = read_events(events)
    launches = sum(s[-1]["launches"] for s in steps.values())
    if device == "cuda":
        require(launches == sum(len(s) for s in steps.values()),
                "run B: a launch a step on every rank", launches=launches)
    a1_first = min(s[0]["t_begin"] for k, s in steps.items() if k[0] == 1)
    return {"seconds": seconds, "losses": losses, "union_losses": want,
            "loss_max_rel": float(np.max(np.abs(la - lb) / np.abs(lb))),
            "step4_bit_equal": True, "survivor_cause": survivor["cause"],
            "abort_reasons": [rec["reason"] for rec in records],
            "kill_to_survivor_exit_ms": kill_to_exit,
            "survivor_exit_to_attempt1_step_ms":
                1e3 * (a1_first - survivor["ts"]),
            "step_ms_median": {a: 1e3 * statistics.median(
                s["t_end"] - s["t_begin"] for r in (0, 1)
                for s in steps[a, r]) for a in (0, 1)},
            "world_relaunches": sum(e["event"] == "abort" for e in ev),
            "largest_heartbeat_gap_ms": largest_gap(
                samples, lambda t, r: victim["kill_ts"] <= t <= a1_first),
            "state_samples": len(samples),
            "launches": launches}


def job_phase(workdir: str, data: dict) -> dict:
    """The distributed job on the card: the ``train`` phase's file uploaded
    to a loopback mock S3 started in this process, then two runs of the
    port's ``tracker.submit --cluster local`` with two workers reading it
    from ``s3://`` (:func:`job_run_a`, :func:`job_run_b`)."""
    # the loopback S3 the tests use; a package named ``tests`` installed
    # elsewhere must not shadow this checkout's
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if here not in list(getattr(sys.modules.get("tests"), "__path__", [])):
        sys.modules["tests"] = types.ModuleType("tests")
        sys.modules["tests"].__path__ = [here]
    from tests import mock_s3
    state, port, shutdown = mock_s3.serve()
    os.environ.update(S3_ENDPOINT=f"http://127.0.0.1:{port}",
                      S3_ACCESS_KEY_ID=mock_s3.ACCESS_KEY,
                      S3_SECRET_ACCESS_KEY=mock_s3.SECRET_KEY,
                      S3_REGION=mock_s3.REGION)
    try:
        uri = f"s3://{JOB_BUCKET}/higgs_like.libsvm"
        upload_s = upload(data["text"], uri)
        with open(data["text"], "rb") as f:
            require(state.objects[(JOB_BUCKET, "higgs_like.libsvm")]
                    == f.read(), "s3 upload bytes")
        a = job_run_a(workdir, data, uri, "cuda", JOB_ELASTIC_BATCH)
        b = job_run_b(workdir, data, uri, "cuda", BATCH_ROWS)
    finally:
        shutdown()
    out = {"phase": "job", "device": "cuda", "rows": data["rows"],
           "uri": uri, "upload_s": upload_s, "shards": JOB_SHARDS,
           "elastic_batch_rows": JOB_ELASTIC_BATCH,
           "mesh_batch_rows": BATCH_ROWS,
           "heartbeat_ms": JOB_HB_MS, "dead_after_ms": JOB_DEAD_MS,
           "run_a": a, "run_b": b,
           "card": "one card: both workers of each run share it; run B's "
           "world runs on gloo (NCCL refuses two ranks on one card)",
           "reduced": {"workers": 2, "mesh_steps": JOB_STEPS},
           "launches": {"csr_to_dense": a["launches"] + b["launches"]}}
    emit(out)
    return out


# -- phase 11: the LM lane ---------------------------------------------------
# examples/train_lm.py's defaults: the repo's full width for this model
LM_SEQ = 2048
LM_EMBED = 128
LM_HEADS = 4
LM_LAYERS = 2
LM_BATCH = 8
LM_STEPS = 6
LM_LR = 0.05
LM_EXPERTS = 4          # the CLI's default at model=2 (2 per model slice)
LM_SEED = 0
LM_CKPT_EVERY = 3
LM_EXCHANGES = 20
LM_PIPE_MICRO = 4


def lm_corpus(workdir: str) -> dict:
    """The corpus: ``SURVEY.md`` then ``doc/*.md`` in sorted order, files of
    the repo that hold text, concatenated; its size and sha256."""
    here = os.path.dirname(os.path.abspath(__file__))
    doc = os.path.join(here, "doc")
    files = [os.path.join(here, "SURVEY.md")] + sorted(
        os.path.join(doc, n) for n in os.listdir(doc) if n.endswith(".md"))
    body = b"".join(open(f, "rb").read() for f in files)
    path = os.path.join(workdir, "lm_corpus.txt")
    with open(path, "wb") as f:
        f.write(body)
    return {"path": path, "bytes": len(body),
            "sha256": hashlib.sha256(body).hexdigest(),
            "files": [os.path.relpath(f, here) for f in files]}


def lm_model(kind: str, mesh, sizes: dict):
    """The CLI's model at ``sizes`` (seq, embed, heads, layers) on ``mesh``:
    ``lm`` the ring model, ``tp`` the tensor-parallel MoE."""
    if kind == "lm":
        from dmlc_core_tpu_torch.models.transformer import (
            TransformerConfig, TransformerLM)
        cfg = TransformerConfig(vocab=256, max_seq=sizes["seq"],
                                embed=sizes["embed"], heads=sizes["heads"],
                                layers=sizes["layers"])
        return TransformerLM(cfg, mesh, learning_rate=LM_LR)
    from dmlc_core_tpu_torch.models.tp_transformer import (
        TPTransformerConfig, TPTransformerLM)
    cfg = TPTransformerConfig(vocab=256, max_seq=sizes["seq"],
                              embed=sizes["embed"], heads=sizes["heads"],
                              layers=sizes["layers"],
                              moe_experts=LM_EXPERTS)
    return TPTransformerLM(cfg, mesh, learning_rate=LM_LR)


def lm_step_flops(kind: str, sizes: dict) -> int:
    """Matmul FLOPs of one training step (forward and twice that for the
    backward) as the step computes them: every score of the causal
    square (the ring masks, it does not skip), and the dense MoE dispatch
    through every expert."""
    B, S, D = sizes["batch"], sizes["seq"], sizes["embed"]
    F, V = 4 * D, 256
    layer = 2 * B * S * D * 3 * D + 2 * 2 * B * S * S * D \
        + 2 * B * S * D * D
    if kind == "lm":
        layer += 2 * 2 * B * S * D * F
    else:
        E = LM_EXPERTS
        layer += 2 * B * S * D * E + 2 * 2 * B * S * E * D * F \
            + 2 * B * S * E * D
    return 3 * (sizes["layers"] * layer + 2 * B * S * D * V)


def lm_step_profile(model, params, w, prof_dir: str) -> dict:
    """One more step (its result dropped) under ``torch_profiler_capture``,
    read as the ``telemetry`` phase reads its epoch: ``device_timeline``
    over the step's wall window gives the card's busy share (merged device
    intervals), the top device operations and the longest idle gaps."""
    sync(model.device)
    os.environ["DMLC_TORCH_PROFILE"] = prof_dir
    try:
        with device_iter.torch_profiler_capture(model.device) as captured:
            t0 = time.perf_counter()
            float(model.step(params, w[:, :-1], w[:, 1:])[1])
            t1 = time.perf_counter()
    finally:
        del os.environ["DMLC_TORCH_PROFILE"]
    require(captured, "lm: the profiler capture did not run")
    pid = os.getpid()
    with open(os.path.join(prof_dir, f"torch_trace_{pid}.json")) as f:
        trace = json.load(f)
    with open(os.path.join(prof_dir, f"dmlc_anchor_{pid}.json")) as f:
        anchors = json.load(f)
    shift, _ = trace_clock_shift_us(trace, anchors)
    tl = device_timeline(trace, shift, t0 * 1e6, t1 * 1e6, [])
    return {k: tl[k] for k in ("window_us", "busy_us", "busy_share",
                               "device_events", "top_ops", "idle_gaps")}


def lm_train(kind: str, mesh, corpus: str, sizes: dict,
             prof_dir: str = "") -> dict:
    """``sizes["steps"]`` steps of ``kind`` on ``mesh`` over the CLI's
    windows (``byte_windows(seed=0)``, one part): losses, step seconds
    (the loss read back), the WHOLE final parameters, peak device bytes;
    with ``prof_dir``, :func:`lm_step_profile` of one more step."""
    from dmlc_core_tpu_torch.models.convert import lm_params_to_numpy
    from dmlc_core_tpu_torch.models.transformer import leaves
    from dmlc_core_tpu_torch.train_lm import byte_windows, load_corpus
    data = load_corpus(corpus, sizes["seq"])
    model = lm_model(kind, mesh, sizes)
    params = model.init(seed=LM_SEED)
    cuda = mesh.device.type == "cuda"
    if cuda:
        sync(mesh.device)
        torch.cuda.reset_peak_memory_stats(mesh.device)
    losses, step_s = [], []
    for step in range(sizes["steps"]):
        w = byte_windows(data, sizes["seq"], sizes["batch"], LM_SEED, step)
        t0 = time.perf_counter()
        params, loss = model.step(params, w[:, :-1], w[:, 1:])
        losses.append(float(loss))  # synchronizes the step
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(mesh.device) if cuda else None
    prof = lm_step_profile(model, params, byte_windows(
        data, sizes["seq"], sizes["batch"], LM_SEED, sizes["steps"]),
        prof_dir) if prof_dir else None
    full = lm_params_to_numpy(params, model)
    return {"losses": losses, "step_s": step_s,
            "params": [np.asarray(p) for p in leaves(full)],
            "peak_bytes": peak, "profile": prof}


def params_close(got: list, want: list, rtol: float, atol: float
                 ) -> "tuple[bool, float]":
    """Whether every leaf agrees at the tolerance, and the largest
    absolute difference."""
    ok = len(got) == len(want) and all(
        a.shape == b.shape and np.allclose(a, b, rtol=rtol, atol=atol)
        for a, b in zip(got, want))
    err = max((float(np.max(np.abs(a - b))) for a, b in zip(got, want)
               if a.shape == b.shape), default=float("inf"))
    return ok, err


def lm_single(workdir: str, corpus: str, device: str, sizes: dict) -> dict:
    """(a): both models on a 1 x 1 mesh on ``device``, against the port's
    CPU run of the same steps: losses at rtol 1e-4, parameters at rtol
    5e-4, atol 1e-5 (the reference's mesh tolerance); the loss falls. On
    the card one more step of each runs under the profiler."""
    from dmlc_core_tpu_torch.device.sharding import process_mesh
    out = {}
    for kind, axis in (("lm", "seq"), ("tp", "model")):
        axes = (("data", 1), (axis, 1))
        prof_dir = os.path.join(workdir, f"lm_profile_{kind}") \
            if device == "cuda" else ""
        run = lm_train(kind, process_mesh(axes, device=device), corpus,
                       sizes, prof_dir)
        ref = lm_train(kind, process_mesh(axes, device="cpu"), corpus,
                       sizes) if device != "cpu" else run
        la, lb = np.asarray(run["losses"]), np.asarray(ref["losses"])
        require(np.allclose(la, lb, rtol=1e-4, atol=0),
                f"lm {kind}: losses against the CPU run at rtol 1e-4",
                got=run["losses"], cpu=ref["losses"])
        ok, err = params_close(run["params"], ref["params"], 5e-4, 1e-5)
        require(ok, f"lm {kind}: parameters against the CPU run at rtol "
                "5e-4, atol 1e-5", max_abs_err=err)
        require(run["losses"][-1] < run["losses"][0],
                f"lm {kind}: the loss falls", losses=run["losses"])
        step = statistics.median(run["step_s"])
        flops = lm_step_flops(kind, sizes)
        out[kind] = {
            "losses": run["losses"], "cpu_losses": ref["losses"],
            "loss_max_rel": float(np.max(np.abs(la - lb) / np.abs(lb))),
            "params_max_abs_err": err, "step_ms_median": 1e3 * step,
            "step_ms": [1e3 * s for s in run["step_s"]],
            "tokens_per_s": sizes["batch"] * sizes["seq"] / step,
            "peak_device_bytes": run["peak_bytes"],
            "step_flop": flops,
            "fp32_peak_share": flops / step / FP32_FLOP_PER_S
            if device == "cuda" else None,
            "profiled_step": run["profile"], "_params": run["params"]}
    return out


def pipeline_stage(w, x):
    """One homogeneous MLP stage of the pipeline case."""
    return torch.tanh(x @ w["a"]) @ w["b"] + x


def lm_world_cases(spec: dict, mesh_sp, mesh_tp) -> dict:
    """(b)'s cases on one rank: the ring model, the TP + MoE model, zigzag
    ring attention against the dense oracle, the 2-stage pipeline forward
    and backward against the sequential program, and the bare host-staged
    K/V exchange."""
    from dmlc_core_tpu_torch.ops.attention import mha_reference
    from dmlc_core_tpu_torch.parallel import axis, distributed
    from dmlc_core_tpu_torch.parallel.pipeline_parallel import pipeline_apply
    from dmlc_core_tpu_torch.parallel.ring import sequence_parallel_attention
    sizes, dev = spec["sizes"], mesh_sp.device
    out = {}
    for kind, mesh in (("lm", mesh_sp), ("tp", mesh_tp)):
        run = lm_train(kind, mesh, spec["corpus"], sizes)
        blob = b"".join(p.tobytes() for p in run["params"])
        blobs = distributed.allgather_bytes(blob)
        if distributed.rank() == 0:
            np.savez(spec[f"{kind}_params"], *run["params"])
        out[kind] = {"losses": run["losses"], "step_s": run["step_s"],
                     "peak_bytes": run["peak_bytes"],
                     "replicas_identical": all(b == blobs[0]
                                               for b in blobs)}
    g = mesh_sp.group_of("seq")
    rng = np.random.default_rng(5)
    B, S, H = sizes["batch"], sizes["seq"], sizes["heads"]
    hd = sizes["embed"] // H
    q, k, v = (torch.tensor(rng.normal(size=(B, S, H, hd)).astype(
        np.float32), device=dev) for _ in range(3))
    got = sequence_parallel_attention(q, k, v, g, causal=True,
                                      layout="zigzag")
    want = mha_reference(q, k, v, causal=True)
    out["zigzag"] = {"max_abs_err": float((got - want).abs().max()),
                     "ok": bool(torch.allclose(got, want, rtol=2e-4,
                                               atol=2e-5))}
    # the pipeline: stage s of 2, microbatches of one sequence at the
    # model's width, the mean squared error's per-stage gradient
    D = sizes["embed"]
    ws = [{n: torch.tensor(rng.normal(0, D ** -0.5, (D, D)).astype(
        np.float32), device=dev) for n in "ab"} for _ in range(2)]
    mb = torch.tensor(rng.normal(size=(LM_PIPE_MICRO, S, D)).astype(
        np.float32), device=dev)
    target = torch.tensor(rng.normal(size=mb.shape).astype(np.float32),
                          device=dev)
    stage = mesh_sp.index("seq")
    mine = {n: t.clone().requires_grad_() for n, t in ws[stage].items()}
    y = pipeline_apply(pipeline_stage, mine, mb, g)
    ((y - target) ** 2).mean().backward()
    seq_ws = [{n: t.clone().requires_grad_() for n, t in w.items()}
              for w in ws]
    x = mb
    for w in seq_ws:
        x = pipeline_stage(w, x)
    ((x - target) ** 2).mean().backward()
    close = [torch.allclose(y, x, rtol=1e-5, atol=1e-5)] + [
        torch.allclose(mine[n].grad, seq_ws[stage][n].grad, rtol=1e-5,
                       atol=1e-5) for n in "ab"]
    out["pipeline"] = {
        "ok": all(bool(c) for c in close),
        "max_abs_err": max(float((y - x).abs().max()), *(
            float((mine[n].grad - seq_ws[stage][n].grad).abs().max())
            for n in "ab"))}
    # the bare host-staged exchange of one K/V block of the ring
    kv = torch.stack([k, v])[:, :, :S // 2].contiguous()
    peer = 1 - stage
    times = []
    for _ in range(LM_EXCHANGES + 1):  # the first run warms up
        distributed.barrier()
        sync(dev)
        t0 = time.perf_counter()
        axis.exchange(kv, peer, peer, g)
        sync(dev)
        times.append(time.perf_counter() - t0)
    out["exchange"] = {"bytes": kv.numel() * 4,
                       "ms_median": 1e3 * statistics.median(times[1:])}
    return out


def lm_worker(spec_path: str, out_path: str) -> int:
    """A rank of (b)'s world (``chip_smoke.py lm-worker SPEC OUT``): two
    gloo ranks sharing the card, each case of :func:`lm_world_cases`,
    the results as JSON."""
    from dmlc_core_tpu_torch.device.sharding import process_mesh
    from dmlc_core_tpu_torch.parallel import distributed
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(spec_path) as f:
        spec = json.load(f)
    if spec["device"] == "cpu":
        torch.set_num_threads(2)
    distributed.init_from_env(device=spec["device"], backend="gloo")
    try:
        mesh_sp = process_mesh((("data", 1), ("seq", 2)),
                               device=spec["device"])
        mesh_tp = process_mesh((("data", 1), ("model", 2)),
                               device=spec["device"])
        hk.reset_launch_counts()
        out = lm_world_cases(spec, mesh_sp, mesh_tp)
        out["launches"] = hk.csr_to_dense_kernel.launches
        out["rank"] = distributed.rank()
    finally:
        distributed.shutdown()
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


def lm_world(workdir: str, corpus: str, device: str, sizes: dict,
             single: dict) -> dict:
    """(b): one 2-rank gloo world sharing the card, each model held to
    (a)'s single-rank run on the same windows — parameters at rtol 5e-4,
    atol 1e-5, the ring model's losses at rtol 1e-5 and the TP model's at
    rtol 2e-5, atol 2e-5 (the reference's mesh tolerances) — replicas
    bit-identical, zigzag and the pipeline held to their dense
    programs."""
    spec = {"device": device, "corpus": corpus, "sizes": sizes,
            "lm_params": os.path.join(workdir, "lm_world_lm.npz"),
            "tp_params": os.path.join(workdir, "lm_world_tp.npz")}
    path = os.path.join(workdir, "lm_world.json")
    write_json(path, spec)
    outs = [os.path.join(workdir, f"lm_world_rank{r}.json")
            for r in range(2)]
    script = os.path.abspath(__file__)
    t0 = time.perf_counter()
    spawn_world(lambda r: [sys.executable, script, "lm-worker", path,
                           outs[r]], 2, "lm world")
    seconds = time.perf_counter() - t0
    res = [json.load(open(p)) for p in outs]
    report = {"world_s": seconds, "ranks": 2, "backend": "gloo"}
    for kind, tol in (("lm", dict(rtol=1e-5, atol=0.0)),
                      ("tp", dict(rtol=2e-5, atol=2e-5))):
        losses = res[0][kind]["losses"]
        want = single[kind]["losses"]
        require(all(r[kind]["losses"] == losses for r in res)
                and all(r[kind]["replicas_identical"] for r in res),
                f"lm world {kind}: replicas bit-identical")
        require(np.allclose(losses, want, **tol), f"lm world {kind}: "
                f"losses against the single rank at {tol}", got=losses,
                want=want)
        with np.load(spec[f"{kind}_params"]) as z:
            got = [z[f"arr_{i}"] for i in range(len(z.files))]
        ok, err = params_close(got, single[kind]["_params"], 5e-4, 1e-5)
        require(ok, f"lm world {kind}: parameters against the single rank "
                "at rtol 5e-4, atol 1e-5", max_abs_err=err)
        report[kind] = {
            "losses": losses, "params_max_abs_err": err,
            "loss_max_rel": float(np.max(np.abs(np.subtract(losses, want))
                                         / np.abs(want))),
            "step_ms_median": 1e3 * max(statistics.median(
                r[kind]["step_s"]) for r in res),
            "tokens_per_s": sizes["batch"] * sizes["seq"] / max(
                statistics.median(r[kind]["step_s"]) for r in res),
            "peak_device_bytes": max(r[kind]["peak_bytes"] or 0
                                     for r in res) or None}
    for case in ("zigzag", "pipeline"):
        require(all(r[case]["ok"] for r in res), f"lm world {case} "
                "against its dense program",
                errs=[r[case]["max_abs_err"] for r in res])
        report[case] = {"max_abs_err": max(r[case]["max_abs_err"]
                                           for r in res)}
    report["kv_exchange"] = {
        "bytes": res[0]["exchange"]["bytes"],
        "ms_median": statistics.median(r["exchange"]["ms_median"]
                                       for r in res)}
    report["launches"] = sum(r["launches"] for r in res)
    return report


def lm_cli(workdir: str, corpus: str, device: str, sizes: dict) -> dict:
    """(c): ``python -m dmlc_core_tpu_torch.train_lm`` in a 2-rank world
    under ``tracker.submit --mesh`` (``--mesh data=1,seq=2``, job
    checkpoints every 3 steps), then the same command resumed from the
    step-3 commit (the marker re-committed at step 3, where rank 0 first
    committed it): steps 3-5 and the step-6 parameters equal the
    uninterrupted run's."""
    from dmlc_core_tpu_torch.utils.checkpoint import (commit_job_checkpoint,
                                                      job_part_uri,
                                                      restore_checkpoint)
    scratch = os.path.join(workdir, "lm_cli")
    os.makedirs(scratch)
    runs = {}
    for name in ("whole", "resumed"):
        base = "file://" + os.path.join(scratch, f"{name}.job")
        cmd = [sys.executable, "-m", "dmlc_core_tpu_torch.train_lm", corpus,
               "--mesh", "data=1,seq=2", "--steps", str(sizes["steps"]),
               "--seq", str(sizes["seq"]), "--embed", str(sizes["embed"]),
               "--heads", str(sizes["heads"]),
               "--layers", str(sizes["layers"]),
               "--checkpoint", base, "--ckpt-every", str(LM_CKPT_EVERY),
               "--backend", "gloo"]
        if device != "cuda":
            cmd += ["--device", device]
        if name == "resumed":
            whole = "file://" + os.path.join(scratch, "whole.job")
            commit_job_checkpoint(whole, LM_CKPT_EVERY, 1)
            cmd += ["--resume", whole]
        argv = [sys.executable, "-m", "dmlc_core_tpu_torch.tracker.submit",
                "--cluster", "local", "--num-workers", "2", "--mesh", "--",
                *cmd]
        env = dict(os.environ, PYTHONPATH=os.path.dirname(
            os.path.abspath(__file__)))
        t0 = time.perf_counter()
        proc = subprocess.run(argv, env=env, capture_output=True, text=True,
                              timeout=DP_TIMEOUT_S, cwd=scratch)
        seconds = time.perf_counter() - t0
        require(proc.returncode == 0, f"lm cli {name}: submit failed",
                rc=proc.returncode, log=(proc.stdout + proc.stderr)[-3000:])
        lines = {}
        for step, loss in re.findall(r"step (\d+): loss (\d+\.\d{4})",
                                     proc.stdout):
            require(lines.setdefault(int(step), loss) == loss,
                    f"lm cli {name}: the ranks printed different losses",
                    step=step)
        final = job_part_uri(base, sizes["steps"], 0, 1)
        params, at, _ = restore_checkpoint(final)
        runs[name] = {"seconds": seconds, "lines": lines,
                      "resumed": "resumed from committed job checkpoint"
                      in proc.stdout, "params": params, "step": at}
    whole, resumed = runs["whole"], runs["resumed"]
    tail = list(range(LM_CKPT_EVERY, sizes["steps"]))
    require(sorted(whole["lines"]) == list(range(sizes["steps"]))
            and sorted(resumed["lines"]) == tail and resumed["resumed"],
            "lm cli: the steps of each run", whole=sorted(whole["lines"]),
            resumed=sorted(resumed["lines"]))
    a = np.asarray([float(resumed["lines"][s]) for s in tail])
    b = np.asarray([float(whole["lines"][s]) for s in tail])
    require(np.allclose(a, b, rtol=1e-5, atol=0), "lm cli: steps 3-5 of "
            "the resumed run against the uninterrupted run at rtol 1e-5",
            got=a.tolist(), want=b.tolist())
    ok, err = params_close(list(resumed["params"].values()),
                           list(whole["params"].values()), 1e-5, 0.0)
    require(ok and resumed["step"] == whole["step"] == sizes["steps"],
            "lm cli: the resumed run's final parameters against the "
            "uninterrupted run's at rtol 1e-5", max_abs_err=err)
    return {"whole_s": whole["seconds"], "resumed_s": resumed["seconds"],
            "losses": [whole["lines"][s] for s in range(sizes["steps"])],
            "resumed_losses": [resumed["lines"][s] for s in tail],
            "final_params_max_abs_err": err}


def lm_phase(workdir: str, device: str = "cuda", seq: int = LM_SEQ,
             embed: int = LM_EMBED, layers: int = LM_LAYERS) -> dict:
    """The LM lane on the card: (a) both models on one rank against the
    CPU, (b) a 2-rank world of the ring, TP + MoE, zigzag and the
    pipeline, (c) the CLI under the tracker with a resume. The kernel's
    launches are counted over the phase: the lane launches none."""
    sizes = {"seq": seq, "embed": embed, "heads": LM_HEADS,
             "layers": layers, "batch": LM_BATCH, "steps": LM_STEPS}
    corpus = lm_corpus(workdir)
    hk.reset_launch_counts()
    t0 = time.perf_counter()
    single = lm_single(workdir, corpus["path"], device, sizes)
    t1 = time.perf_counter()
    world = lm_world(workdir, corpus["path"], device, sizes, single)
    t2 = time.perf_counter()
    cli = lm_cli(workdir, corpus["path"], device, sizes)
    t3 = time.perf_counter()
    launches = hk.csr_to_dense_kernel.launches + world.pop("launches")
    require(launches == 0, "lm: the lane launches no csr_to_dense",
            launches=launches)
    out = {"phase": "lm", "device": device,
           "corpus": {k: corpus[k] for k in ("bytes", "sha256", "files")},
           "sizes": sizes, "lr": LM_LR, "experts": LM_EXPERTS,
           "single": {k: {n: v for n, v in r.items() if n != "_params"}
                      for k, r in single.items()},
           "world": world, "cli": cli,
           "seconds": {"single": t1 - t0, "world": t2 - t1,
                       "cli": t3 - t2},
           "card": "one card: the 2-rank worlds of (b) and (c) share it "
           "over gloo (NCCL refuses two ranks on one card), every ring "
           "and pipeline exchange staged through the host",
           "reduced": {"steps": f"{LM_STEPS} (the CLI's default: 20)",
                       "world_ranks": 2, **{
                           k: sizes[k] for k, full in (
                               ("seq", LM_SEQ), ("embed", LM_EMBED),
                               ("layers", LM_LAYERS)) if sizes[k] != full}},
           "launches": {"csr_to_dense": launches}}
    emit(out)
    return out


# -- phase 12: the bench -----------------------------------------------------
BENCH_TIMEOUT_S = 900


def best_epoch_bytes_per_sec(lane: dict, rows_per_sec: float) -> float:
    """A lane's best epoch in bytes/s: its median bytes/s scaled by its
    best epoch's rows/s over its median rows/s."""
    return (lane["device_bytes_per_sec"] * lane["e2e_spread_rows_per_sec"][1]
            / rows_per_sec)


def check_bench_result(res: dict, records: list, device: str,
                       rows: int) -> None:
    """The gates on the bench's JSON line ``res`` and the records it
    appended, for a run on ``device`` at ``rows``.

    The bandwidth shares divide by the best rate any probe or the lane's
    own best epoch saw (the reference's ``max()``), so they cannot pass 1
    whatever the probes read. The gates ask more: that the pinned-copy
    probe set the denominator, its rate at least the best epoch's, for the
    headline, the ``recd`` (zero-parse) lane and, on the card, the device
    lane's replay.
    A probe that reads too low (pageable memory, the wrong stream) fails
    here instead of hiding behind the ``max()``."""
    ex = res["extras"]
    require(res["metric"] == "higgs_libsvm_ingest_rows_per_sec"
            and res["unit"] == "rows/s" and res["value"] > 0,
            "bench: the headline", metric=res["metric"], value=res["value"])
    want_device = card_line() if device == "cuda" else "cpu"
    require(ex["device"] == want_device, "bench: the card in extras.device",
            got=ex["device"], want=want_device)
    require(all(0 < ex[k] <= 1.0 for k in ("hbm_ingest_bw_util",
                                            "hbm_ingest_bw_util_best")),
            "bench: the bandwidth share in (0, 1]",
            util=ex["hbm_ingest_bw_util"],
            best=ex["hbm_ingest_bw_util_best"])
    for name, lane, rps in (("headline", ex, res["value"]),
                            ("recd_lane", ex["recd_lane"],
                             ex["recd_lane"]["rows_per_sec"])):
        best = best_epoch_bytes_per_sec(lane, rps)
        require(lane["attainable_pytree_bytes_per_sec"] >= best,
                "bench: the copy probe sets the share's denominator",
                lane=name, probe=lane["attainable_pytree_bytes_per_sec"],
                best_epoch=best)
    probe = ex["csr_to_dense_kernel"]
    if device == "cuda":
        require(probe.get("launches", 0) >= 1 and "check" in probe
                and probe["max_abs_err"] <= 1e-5,
                "bench: the kernel probe checked and launched", probe=probe)
    dl = ex["device_lane"]
    require(dl["rows"] == rows and dl["backend"] == device
            and 0 < dl["hbm_ingest_bw_util"] <= 1.0,
            "bench: the device lane counted every row", lane=dl)
    if device == "cuda":
        # on the card every replayed batch is a copy (on the CPU the
        # replay hands the cache's memory over and outruns any copy); the
        # best-epoch share divides by max(probe, best epoch), so it is
        # below 1 only where the probe outran the best epoch
        require(dl["zero_copy_batches_total"] == 0
                and 0 < dl["hbm_ingest_bw_util_best"] < 1.0,
                "bench: the device lane's copy probe sets the share's "
                "denominator", lane=dl)
    sl = ex["serving_lane"]
    require(sl["errors"] == 0 and sl["slo_burn_clean"] == 0
            and sl["steady_new_shapes"] == 0 and sl["completed"] > 0,
            "bench: the serving lane", lane=sl)
    ml = ex["mesh_lane"]
    require(ml["steps_per_sec"] > 0 and 0 < ml["recovery_s"] < math.inf,
            "bench: the mesh lane's numbers", lane=ml)
    require(len(records) == 1 and records[0]["metric"] == res["metric"]
            and records[0]["value"] == res["value"]
            and {"device_lane", "mesh_lane", "serving_lane"}
            <= set(records[0]["lanes"]),
            "bench: the record", records=records)


def bench_phase(workdir: str) -> dict:
    """``python -m dmlc_core_tpu_torch.bench --rows TRAIN_ROWS`` in a
    process session of its own under its own timeout (every process it
    starts is gone when this returns), its record going to the workdir;
    then :func:`check_bench_result`. The kernel's launches are the bench's
    kernel probe's (counted in its child)."""
    history = os.path.join(workdir, "bench_history_torch.jsonl")
    cmd = [sys.executable, "-m", "dmlc_core_tpu_torch.bench",
           f"--rows={TRAIN_ROWS}"]
    env = dict(os.environ, DMLC_BENCH_HISTORY=history,
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    env.pop("DCT_CSR_TO_DENSE", None)  # the bench's own settings
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            cwd=os.path.dirname(os.path.abspath(__file__)),
                            start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=BENCH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        stdout, stderr = "", "timed out"
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
    seconds = time.perf_counter() - t0
    require(proc.returncode == 0, "bench: the run failed",
            rc=proc.returncode, stderr=stderr[-3000:])
    lines = [ln for ln in stdout.splitlines() if ln.strip()]
    require(len(lines) == 1, "bench: one JSON line on stdout",
            stdout=stdout[-2000:])
    res = json.loads(lines[0])
    with open(history) as f:
        records = [json.loads(line) for line in f if line.strip()]
    check_bench_result(res, records, "cuda", TRAIN_ROWS)
    ex = res["extras"]
    out = {"phase": "bench", "device": "cuda", "seconds": seconds,
           "cmd": " ".join(cmd[1:]), "metric": res["metric"],
           "value": res["value"], "vs_baseline": res["vs_baseline"],
           "extras": {k: v for k, v in ex.items()
                      if k not in ("host_resources", "provenance")},
           "lane_seconds": {k: v.get("wall_s") for k, v in
                            ex["host_resources"]["lanes"].items()},
           "host": ex["provenance"]["host"],
           "reduced": {"rows": f"{TRAIN_ROWS} (HIGGS: 11,000,000; "
                       "bench.py's default run: 200,000)"},
           "launches": {"csr_to_dense": ex["csr_to_dense_kernel"]["launches"]}}
    emit(out)
    return out


def main() -> int:
    if sys.argv[1:2] == ["dp-worker"]:
        return dp_worker(*sys.argv[2:4])
    if sys.argv[1:2] == ["job-elastic-worker"]:
        return job_elastic_worker(sys.argv[2])
    if sys.argv[1:2] == ["job-mesh-worker"]:
        return job_mesh_worker(sys.argv[2])
    if sys.argv[1:2] == ["lm-worker"]:
        return lm_worker(*sys.argv[2:4])
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
    # every compiler at once: the kernel's and its previous version's
    # nvcc, the bench's g++ beside the native core's
    previous = start_previous_kernel_build()
    pipeline = start_bench_pipeline_build()
    kernel_log = hk.build() or ""
    load_previous_kernel(*previous)
    t1 = time.perf_counter()
    native.build()
    t2 = time.perf_counter()
    finish_bench_pipeline_build(*pipeline)
    t3 = time.perf_counter()
    emit({"phase": "build", "kernel_s": t1 - t0, "native_s": t2 - t1,
          "all_builds_s": t3 - t0,
          "ptxas": [ln for ln in kernel_log.splitlines() if "ptxas" in ln]})

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        data = write_higgs_files(workdir)
        emit({"phase": "data", **{k: data[k] for k in (
            "rows", "bytes", "text_write_s", "crec_convert_s",
            "drec_convert_s")}, "rowblock_iter": rowblock_epochs(
                data["text"], os.path.join(workdir, "cache"))})
        surface = surface_phase(data["text"])
        qa_phase()
        cases = kernels_phase([crec_kernel_case(data["crec"])])
        fm_case = cases.pop("fm")
        run, params = train_phase(data["text"])
        tel = telemetry_phase(data["text"], run["losses"], workdir)
        serve_phase(workdir, params)
        lanes = lanes_phase(data, {"losses": run["losses"],
                                   "w": params.w.cpu().numpy(),
                                   "b": float(params.b)})
        host = host_phase(data)
        fm = fm_phase(workdir, data)
        rank_phase(workdir, data)
        dp = dp_phase(workdir, data, run, params)
        job = job_phase(workdir, data)
        lm = lm_phase(workdir)
        bench = bench_phase(workdir)

    main_case = cases["train_65536x28"]
    emit({"kernels": [{
        "name": "csr_to_dense", "route": "cuda",
        "source": "dmlc_core_tpu_torch/csrc/csr_to_dense.cu",
        "replaces": "dmlc_core_tpu/ops/pallas_kernels.py:58",
        # the paths that launch it, each counted on its own run
        "launches": (run["launches"]["csr_to_dense"]
                     + tel["launches"]["csr_to_dense"]
                     + lanes["launches"]["csr_to_dense"]
                     + host["launches"]["csr_to_dense"]
                     + dp["launches"]["csr_to_dense"]
                     + job["launches"]["csr_to_dense"]
                     + lm["launches"]["csr_to_dense"]
                     + bench["launches"]["csr_to_dense"]
                     + surface["launches"]["csr_to_dense"]),
        "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
        "ms": main_case["kernel_ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_us"] / 1e3,
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"]}, {
        "name": "fm_csr", "route": "cuda",
        "source": "dmlc_core_tpu_torch/csrc/fm_csr.cu", "replaces": None,
        # the main path's epoch: forward and backward each count a launch
        "launches": fm["launches"]["fm_csr"],
        "predict_launches": fm["predict_launches"],
        "serve_launches": fm["serve_launches"],
        "ms": fm_case["kernel_ms"], "plain_ms": fm_case["plain_ms"],
        "bound_ms": fm_case["bound_ms"], "bound_by": fm_case["bound_by"]}]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
