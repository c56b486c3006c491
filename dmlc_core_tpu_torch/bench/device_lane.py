"""The device lane (``bench.py:631-870``): ``LinearLearner(28)`` stepping
on ``DeviceRowBlockIter(layout="csr")`` on the bench's device.

A warm epoch, then ``reps`` timed epochs under
``torch_profiler_capture`` (``DMLC_TORCH_PROFILE``) with the telemetry
plane zeroed between: rows/s, the ``device_transfer_us`` /
``device_put_block_us`` percentiles, the span-derived overlap ratio and
the stall verdict. Then the replay ingest: the same rows from a warm
shard cache (``#cachefile=``, epoch 2 on is an mmap replay and one fused
fill a batch) drained with no consumer, its bytes/s over the best copy
of the same batch sequence (pinned, ``non_blocking`` on a side stream,
as the iterator copies), sampled in interleaved pairs: the median ratio
is ``hbm_ingest_bw_util``. The ``zero_copy_*`` keys keep the reference's
names: on the card every batch is a copy (``zero_copy_batches_total``
counts the CPU's aliased batches only).

Eager torch compiles nothing, so the reference's compile-churn keys
(``distinct_shapes``, ``compile_events_total``, ``jit_compiles_total``,
``steady_new_shapes``) have no counterpart here.
"""

from __future__ import annotations

import os
import shutil
import statistics
import tempfile
import time

import torch

from dmlc_core_tpu_torch import telemetry
from dmlc_core_tpu_torch.bench.datasets import ensure_dataset
from dmlc_core_tpu_torch.bench.ingest import (Copier, consume, pinned_like,
                                              salt, sync)
from dmlc_core_tpu_torch.device.device_iter import (DeviceRowBlockIter,
                                                    torch_profiler_capture)
from dmlc_core_tpu_torch.models.linear import LinearLearner


def _counter_total(snap: dict, name: str) -> int:
    return sum(int(c["value"]) for c in snap["counters"]
               if c["name"] == name)


def cache_first_pass(curi: str, device: torch.device,
                     batch_rows: int) -> list:
    """The first pass over a ``#cachefile=`` URI, which parses the text
    and tees the cache: its host batch trees (``to_device=False``, as
    ``bench.py`` takes them), copied into the memory the iterator stages
    in."""
    with DeviceRowBlockIter(curi, batch_rows=batch_rows, layout="csr",
                            to_device=False, prefetch=0,
                            device=device) as it:
        return [{k: pinned_like(v, device) for k, v in b.tree().items()}
                for b in it]


def replay_ingest(path: str, device: torch.device, batch_rows: int,
                  reps: int) -> dict:
    """The shard-cache replay's landed bytes/s against the copy of the
    same batch sequence (see the module docstring)."""
    cdir = tempfile.mkdtemp(prefix="dct_bench_zc_")
    curi = f"{path}#cachefile={cdir}"
    try:
        host_trees = cache_first_pass(curi, device, batch_rows)
        probe_bytes = sum(int(v.nbytes) for t in host_trees
                          for v in t.values())
        copier = Copier(device)

        def put_sequence_sample(value: int) -> float:
            # one copy a batch of the whole epoch, the numerator's
            # sequence at its granularity, salted against any cache
            salt(host_trees, value)
            t0 = time.perf_counter()
            copier.put(host_trees)
            return probe_bytes / (time.perf_counter() - t0)

        # prefetch=0: nothing to overlap with here, so no staging threads
        with DeviceRowBlockIter(curi, batch_rows=batch_rows, layout="csr",
                                prefetch=0, device=device) as it:
            zc_bytes = 0
            for b in it:  # warm replay epoch, consumed on the device
                zc_bytes += sum(v.numel() * v.element_size()
                                for v in b.tree().values())
                consume(b.tree())
            sync(device)
            # many short epochs, interleaved with the copy samples so
            # drift on the host hits both sides of the ratio
            zbws, abws = [], []
            t_start = time.perf_counter()
            while len(zbws) < 3 * reps or \
                    time.perf_counter() - t_start < 0.6:
                it.before_first()
                t0 = time.perf_counter()
                for b in it:  # each batch's copy completed when handed
                    pass
                zbws.append(zc_bytes / (time.perf_counter() - t0))
                abws.append(put_sequence_sample(len(abws)))
        landed, best = statistics.median(zbws), max(zbws)
        attain, attain_med = max(abws), statistics.median(abws)
        snap = telemetry.snapshot(native=False)
        return {
            "hbm_ingest_bw_util": round(
                landed / max(attain_med, landed, 1.0), 4),
            "hbm_ingest_bw_util_best": round(
                best / max(attain, best, 1.0), 4),
            "zero_copy_bytes_per_sec": round(landed, 1),
            "attainable_pytree_bytes_per_sec": round(attain, 1),
            "zero_copy_batches_total": _counter_total(
                snap, "device_zero_copy_batches_total"),
            "zero_copy_fallbacks_total": _counter_total(
                snap, "device_zero_copy_fallbacks_total"),
        }
    finally:
        shutil.rmtree(cdir, ignore_errors=True)


def train_epochs(path: str, rows: int, device: torch.device,
                 batch_rows: int = 8192, reps: int = 3):
    """``LinearLearner(28, learning_rate=0.1)`` from zero over one warm
    epoch and ``reps`` timed ones (telemetry zeroed after the warm one,
    the timed ones under ``torch_profiler_capture``). Returns (sorted
    epoch seconds, final parameters, whether a profile was captured)."""
    learner = LinearLearner(28, learning_rate=0.1, device=device)
    params = learner.init()

    def one_epoch(it, params):
        t0 = time.perf_counter()
        got = 0
        for batch in it:
            got += batch.total_rows
            params, _ = learner.step(params, batch)
        sync(device)
        dt = time.perf_counter() - t0
        if got != rows:
            raise RuntimeError(f"row count mismatch: {got} != {rows}")
        return dt, params

    with DeviceRowBlockIter(path, batch_rows=batch_rows, layout="csr",
                            device=device) as it:
        _, params = one_epoch(it, params)  # warm
        telemetry.reset()
        dts = []
        with torch_profiler_capture(device) as profiled:
            for _ in range(reps):
                it.before_first()
                dt, params = one_epoch(it, params)
                dts.append(dt)
    return sorted(dts), params, profiled


def device_lane_probe(rows: int, device: torch.device,
                      batch_rows: int = 8192, reps: int = 3) -> dict:
    """The lane's numbers (see the module docstring)."""
    path = ensure_dataset(rows)
    telemetry.reset()
    dts, _, profiled = train_epochs(path, rows, device, batch_rows, reps)
    dt = statistics.median(dts)
    xfer = telemetry.histogram("device_transfer_us")
    block = telemetry.histogram("device_put_block_us")
    ratio = telemetry.device_overlap_ratio()
    # the verdict needs the native half of the snapshot too: the parse
    # stage sums it subtracts live in the native registry
    att = telemetry.stall_attribution(telemetry.snapshot(native=True))
    dev_bytes = telemetry.counter("device_transfer_bytes_total").value
    out = {
        "backend": device.type,
        "ndevices": torch.cuda.device_count() if device.type == "cuda"
        else 1,
        "rows": rows,
        "batch_rows": batch_rows,
        "reps": len(dts),
        "hbm_ingest_rows_per_sec": round(rows / dt, 1),
        "spread_rows_per_sec": [round(rows / dts[-1], 1),
                                round(rows / dts[0], 1)],
        "device_bytes_per_sec": round(dev_bytes / sum(dts), 1),
        "device_transfer_p50_us": xfer.quantile(0.5),
        "device_transfer_p99_us": xfer.quantile(0.99),
        "device_put_block_p99_us": block.quantile(0.99),
        "overlap_ratio": round(ratio, 4) if ratio is not None else -1.0,
        "stall_verdict": att["verdict"],
    }
    out.update(replay_ingest(path, device, batch_rows, reps))
    if profiled:
        out["torch_profile_dir"] = os.environ.get("DMLC_TORCH_PROFILE")
    return out
