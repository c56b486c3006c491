"""The headline: file to device batches, consumed on the device
(``bench.py:1201-1350``).

Each batch of the port's ``DeviceRowBlockIter`` goes to a reduction on
the device that reads every array of the batch (:func:`consume`); an
epoch's clock stops after a device synchronise, so the rows/s counts
bytes that landed and were read. The consumer's stream waits on each
batch's copy event (``DeviceRowBlockIter`` hands batches over that way),
so the reduction cannot run ahead of the bytes.

``hbm_ingest_bw_util`` divides the bytes landed per second (median epoch)
by the best host-to-device rate any probe saw: the same pytree the
pipeline lands per batch, copied the way the iterator copies it (from
pinned host memory, ``non_blocking`` on a side stream, then the copy's
event), one large contiguous pinned buffer, and the lane's own best
epoch; the share cannot read above 1. On the H100 that link is PCIe from
the host, not HBM: the key keeps its name so ``benchdiff.py`` compares
like with like. On the CPU the iterator aliases its staging buffers and
the probes time a host copy.
"""

from __future__ import annotations

import statistics
import time
from typing import Dict, Optional

import numpy as np
import torch

from dmlc_core_tpu_torch.device.device_iter import DeviceRowBlockIter


def sync(device: torch.device) -> None:
    """Wait for every queued device operation (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def consume(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Read every array of a batch on its device: the sum of all their
    elements as float32."""
    return sum(v.float().sum() for v in tree.values())


def tree_nbytes(batch) -> int:
    """Bytes of a device batch's tensors."""
    return sum(v.numel() * v.element_size() for v in batch.tree().values())


def pinned_like(a: np.ndarray, device: torch.device) -> np.ndarray:
    """A copy of host array ``a`` in the memory the iterator stages in:
    pinned for a CUDA device, pageable for the CPU."""
    raw = torch.empty(a.nbytes, dtype=torch.uint8,
                      pin_memory=device.type == "cuda").numpy()
    out = raw.view(a.dtype).reshape(a.shape)
    out[...] = a
    return out


class Copier:
    """Host-to-device copies as ``DeviceRowBlockIter._copy`` makes them:
    ``non_blocking`` on a side stream, then wait for the copy's event.
    On the CPU a copy is a ``clone`` of the host memory."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = (torch.cuda.Stream(device)
                       if device.type == "cuda" else None)

    def put(self, trees) -> list:
        """Copy every array of every tree in ``trees``; returns the device
        tensors after the copies completed."""
        if self.stream is None:
            return [torch.from_numpy(v).clone()
                    for t in trees for v in t.values()]
        with torch.cuda.stream(self.stream):
            out = [torch.from_numpy(v).to(self.device, non_blocking=True)
                   for t in trees for v in t.values()]
            ev = torch.cuda.Event()
            ev.record(self.stream)
        ev.synchronize()
        return out


def salt(trees, value: int) -> None:
    """Write ``value`` into one word of every page of every array, so no
    layer can serve a repeated copy from a cache."""
    for t in trees:
        for v in t.values():
            flat = v.reshape(-1)
            flat[::max(1, 4096 // max(v.itemsize, 1))] = np.asarray(
                value, dtype=v.dtype)


def pytree_put_sample(copier: Copier, host_tree: dict, value: int) -> float:
    """One timed copy of the whole batch tree: bytes/s."""
    nbytes = sum(int(v.nbytes) for v in host_tree.values())
    salt([host_tree], value)
    t0 = time.time()
    copier.put([host_tree])
    return nbytes / (time.time() - t0)


def attainable_pytree_bw(copier: Copier, host_tree: dict) -> float:
    """Best host-to-device bytes/s for the batch tree the pipeline lands
    (best of 3): per-array costs are part of what a batch pays."""
    return max(pytree_put_sample(copier, host_tree, i) for i in range(3))


def attainable_contiguous_bw(copier: Copier, nbytes: int) -> float:
    """Best host-to-device bytes/s of one large contiguous buffer (best of
    3), the optimistic ceiling; dirtied between reps."""
    buf = pinned_like(np.ones(max(nbytes // 4, 1 << 20), np.float32),
                      copier.device)
    return max(pytree_put_sample(copier, {"buf": buf}, i) for i in range(3))


def host_tree_of(path: str, device: torch.device, **kw) -> dict:
    """The first batch of ``path`` as the iterator stages it on the host
    (``to_device=False``, as ``bench.py`` takes it), copied into pinned
    memory for a CUDA device."""
    with DeviceRowBlockIter(path, device=device, to_device=False,
                            prefetch=0, **kw) as it:
        batch = next(iter(it))
        return {k: pinned_like(v, device) for k, v in batch.tree().items()}


def run_e2e_epoch(it, rows: int, device: torch.device):
    """One timed pass over a (restarted) iterator, each batch consumed on
    the device; returns (seconds, device bytes)."""
    t0 = time.time()
    got = 0
    device_bytes = 0
    for batch in it:
        got += batch.total_rows  # host-side count: no device sync
        device_bytes += tree_nbytes(batch)
        consume(batch.tree())
    sync(device)
    dt = time.time() - t0
    if got != rows:
        raise RuntimeError(f"row count mismatch: {got} != {rows}")
    return dt, device_bytes


def run_lane(path: str, rows: int, fmt: str, device: torch.device,
             batch_rows: int, threads: int, dense_dtype: str,
             reps: int) -> dict:
    """The median-of-reps end-to-end lane and its bandwidth share."""
    kw = dict(fmt=fmt, batch_rows=batch_rows, nthread=threads,
              dense_dtype=dense_dtype)
    host_tree = host_tree_of(path, device, **kw)
    # one iterator for the warm epoch and the timed reps: the warm epoch
    # faults the page cache and fills the staging pool
    with DeviceRowBlockIter(path, device=device, **kw) as it:
        for batch in it:
            consume(batch.tree())
        sync(device)
        # fast lanes need more samples for a stable median: toward ~1 s
        # of timed work from the first steady epoch, at most 15 (an
        # explicit larger --reps is honoured)
        it.before_first()
        runs = [run_e2e_epoch(it, rows, device)]
        n = max(reps, min(15, int(0.75 / max(runs[0][0], 1e-3))))
        for _ in range(n - 1):
            it.before_first()
            runs.append(run_e2e_epoch(it, rows, device))
    dts = sorted(dt for dt, _ in runs)
    device_bytes = runs[0][1]
    dt = statistics.median(dts)
    landed_bw = device_bytes / dt
    best_bw = device_bytes / dts[0]
    copier = Copier(device)
    attain_pytree = attainable_pytree_bw(copier, host_tree)
    attain_contig = attainable_contiguous_bw(copier,
                                             min(device_bytes, 256 << 20))
    # the best host-to-device rate any probe saw, the lane's own best
    # epoch included, so the share cannot read above 1
    denom = max(attain_pytree, attain_contig, best_bw, 1.0)
    return {
        "dt": dt,
        "reps": len(runs),
        "rows_per_sec": rows / dt,
        "spread_rows_per_sec": [round(rows / dts[-1], 1),
                                round(rows / dts[0], 1)],
        "hbm_ingest_bw_util": round(landed_bw / denom, 4),
        "hbm_ingest_bw_util_best": round(best_bw / denom, 4),
        "device_bytes_per_sec": round(landed_bw, 1),
        "attainable_pytree_bytes_per_sec": round(attain_pytree, 1),
        "attainable_contiguous_bytes_per_sec": round(attain_contig, 1),
    }


def lane_summary(lane: dict) -> dict:
    """A secondary lane's entry in ``extras`` (``<fmt>_lane``)."""
    return {"rows_per_sec": round(lane["rows_per_sec"], 1),
            **{k: lane[k] for k in (
                "hbm_ingest_bw_util", "hbm_ingest_bw_util_best",
                "device_bytes_per_sec", "attainable_pytree_bytes_per_sec")},
            "e2e_spread_rows_per_sec": lane["spread_rows_per_sec"],
            "reps": lane["reps"]}


def stall_extras(att: dict) -> dict:
    """``extras.stall_attribution`` from ``telemetry.stall_attribution``."""
    return {"verdict": att["verdict"],
            "occupancy": {k: round(v, 4)
                          for k, v in att["occupancy"].items()},
            "stage_ms": {k: round(v / 1e3, 1)
                         for k, v in att["stage_us"].items()}}


def bottleneck(verdict: str, ncores: Optional[int]) -> str:
    """The binding stage: one core serialises every stage, so no verdict
    can promise overlap there."""
    return ("host_cpu_serialized_single_core" if (ncores or 1) <= 1
            else verdict)
