"""Device-resident row-block iteration: data files to CUDA batches.

Port of ``dmlc_core_tpu/tpu/device_iter.py`` for one device:

  host batcher: fill into pinned staging buffers (PaddedBatch /
  DenseBatch, static shapes, shard-major packed planes)
        -> staging thread (queue of depth ``prefetch``)
        -> transfer thread: host->device copy on a side CUDA stream
        -> consumer: its stream waits on the copy's event

The host batcher is picked by the lane, as in the reference:

- text (libsvm/csv/libfm, ``.rec``): :class:`NativeHostBatcher`, one
  native parse + fill pass; CSR values as float32 or, with
  ``csr_val_dtype="bf16"``, as a separate bfloat16 ``val16`` leaf;
- ``.crec`` (``fmt="crec"``): :class:`CsrRecHostBatcher`, records already
  in device layout, one static nnz bucket for the whole epoch;
- ``.drec`` (``fmt="recd"``): :class:`DenseRecHostBatcher`, row matrices
  copied as they are;
- ``index64=True``: :class:`HostBatcher`, Python batching of blocks parsed
  with 64-bit ids, refusing any id or qid that the int32 layout cannot
  hold.

The static-shape rules are the reference's: ``batch_rows`` rows per batch
(the last one padded with zero-weight rows), nnz bucketed to the next power
of two (floor ``min_nnz_bucket``; the ``.crec`` lane's bucket comes from
the file's window table), per-nonzero local row ids with padding nonzeros
on row ``rows_per_shard``. Batches keep the reference's leading device
axis D, which is 1 on every rank: the port's mesh is one device per
process (``device/sharding.py``), and with ``mesh=`` the global
``batch_rows`` splits over the mesh's ranks, ``batch_rows / mesh.size``
rows a batch on each, read from the rank's own ``part``.

The device half replaces ``jax.device_put``. Staging buffers come from
pinned memory (``torch.empty(..., pin_memory=True)``, 64-byte aligned for
the native fills), the copy runs with ``non_blocking=True`` on a side
stream, and the transfer thread waits for the copy's event before it
queues the batch — so a staging buffer returns to the pool only after its
copy completed. The consumer's stream then ``wait_event``\\ s on the copy
and every device tensor gets ``record_stream`` for that stream, since the
tensors were allocated on the side stream. On the CPU (``device="cpu"``)
``torch.from_numpy`` aliases the staging buffer instead of copying; that
is counted in ``device_zero_copy_batches_total``, and, as the reference
does on its aliasing backends, such buffers are parked behind weakrefs and
recycled once the consumer has dropped every tensor that reads them (a
full parking lot drops its oldest entry, counted in
``device_recycle_skipped``). With ``to_device=False`` the iterator hands
over the host batches themselves, unpinned and never recycled, as the
reference's ``to_device=False`` does.

:func:`torch_profiler_capture` is the counterpart of the reference's
``jax_profiler_capture``: under ``DMLC_TORCH_PROFILE=<dir>`` it records
the body with ``torch.profiler`` (the card's kernels, copies and memsets
beside the host's rows) and writes the clock anchors that put that trace
on the telemetry spans' timeline.

:class:`ElasticDeviceRowBlockIter` feeds the card from tracker shard
leases: each granted shard becomes a :class:`DeviceRowBlockIter` over
``part=shard, npart=num_shards``.
"""

from __future__ import annotations

import contextlib
import json
import os
import queue
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from dmlc_core_tpu_torch import telemetry
from dmlc_core_tpu_torch.base import DMLCError, resolve_device
from dmlc_core_tpu_torch.device.sharding import (check_mesh,
                                                 local_device_count)
from dmlc_core_tpu_torch.io.crec_map import (BufferState,
                                             MappedCsrRecBatcher, mappable)
from dmlc_core_tpu_torch.io.native import (BF16_STORAGE, NativeBatcher,
                                           NativeCsrRecBatcher,
                                           NativeDenseRecBatcher,
                                           NativeParser, bf16_bits)
from dmlc_core_tpu_torch.tracker.wire import TrackerAbortedError, env_int

__all__ = ["PaddedBatch", "DenseBatch", "DeviceRowBlockIter", "HostBatcher",
           "NativeHostBatcher", "CsrRecHostBatcher", "DenseRecHostBatcher",
           "ElasticDeviceRowBlockIter", "unpack_tree", "unpack_shard",
           "to_device_batch", "torch_profiler_capture"]

_lane_metrics = None


def _get_lane_metrics():
    """Device-lane metric objects, resolved once (same names as the
    reference's device lane)."""
    global _lane_metrics
    if _lane_metrics is None:
        _lane_metrics = {
            "transfer_us": telemetry.histogram("device_transfer_us"),
            "submit_us": telemetry.histogram("device_put_submit_us"),
            "block_us": telemetry.histogram("device_put_block_us"),
            "stage_us": telemetry.histogram("device_stage_us"),
            "wait_us": telemetry.histogram("device_wait_us"),
            "batches": telemetry.counter("device_batches_total"),
            "bytes": telemetry.counter("device_transfer_bytes_total"),
            "failures": telemetry.counter("device_put_failures_total"),
            "host_q": telemetry.gauge("device_host_q_depth"),
            "ready_q": telemetry.gauge("device_ready_q_depth"),
            "zc_batches": telemetry.counter("device_zero_copy_batches_total"),
            "recycle_skip": telemetry.gauge("device_recycle_skipped"),
        }
    return _lane_metrics


@contextlib.contextmanager
def torch_profiler_capture(device=None):
    """Optional ``torch.profiler`` capture of the body, anchored to the
    telemetry timeline. With ``DMLC_TORCH_PROFILE=<dir>`` set, the body
    runs under ``torch.profiler.profile`` with CPU activity, plus CUDA
    activity when the card is in use (``device`` is a CUDA device, or
    None with CUDA available); the Chrome trace goes to
    ``<dir>/torch_trace_<pid>.json`` and this process's (wall, monotonic)
    clock-anchor pairs at start and stop to
    ``<dir>/dmlc_anchor_<pid>.json`` as ``{"pid", "start", "stop"}`` — the
    anchors ``telemetry.trace_json`` shifts spans by, so the profiler's
    rows and the spans land on one clock. A ``torch-profile`` event
    records the directory. Yields True while a capture runs, False when
    the variable is unset or the profiler refused (every failure of the
    capture is swallowed: profiling must not sink the lane, and the
    caller sees False)."""
    out_dir = os.environ.get("DMLC_TORCH_PROFILE")
    if not out_dir:
        yield False
        return
    import torch.profiler as tp
    cuda = (torch.cuda.is_available() if device is None
            else torch.device(device).type == "cuda")
    activities = [tp.ProfilerActivity.CPU]
    if cuda:
        activities.append(tp.ProfilerActivity.CUDA)
    anchors = {"pid": os.getpid(), "start": telemetry.clock_anchor()}
    prof = None
    try:
        os.makedirs(out_dir, exist_ok=True)
        prof = tp.profile(activities=activities)
        prof.__enter__()
    except Exception:
        prof = None
    try:
        yield prof is not None
    finally:
        if prof is not None:
            try:
                if cuda:
                    torch.cuda.synchronize()
                prof.__exit__(None, None, None)
                prof.export_chrome_trace(os.path.join(
                    out_dir, f"torch_trace_{os.getpid()}.json"))
            except Exception:
                pass
        anchors["stop"] = telemetry.clock_anchor()
        try:
            with open(os.path.join(out_dir,
                                   f"dmlc_anchor_{os.getpid()}.json"),
                      "w") as f:
                json.dump(anchors, f)
            telemetry.emit_event("torch-profile", dir=out_dir,
                                 started=prof is not None)
        except Exception:
            pass


def _dense_dtype_of(d) -> np.dtype:
    """Host storage dtype of the dense x plane: float32, or uint16 holding
    bfloat16 bits (what the native FillDense writes)."""
    if isinstance(d, str) and d in ("bf16", "bfloat16"):
        return BF16_STORAGE
    try:
        if np.dtype(d) == np.float32:
            return np.dtype(np.float32)
    except TypeError:
        pass
    raise DMLCError(f"dense_dtype must be float32 or bfloat16, got {d}")


def _aligned_empty(shape, dtype, pin: bool = False) -> np.ndarray:
    """C-contiguous uninitialised array whose base address is 64-byte
    aligned (the native fills require it); pinned (page-locked) memory
    when ``pin``, so host->device copies can run asynchronously. The
    returned array keeps its pinned torch storage alive."""
    dtype = np.dtype(dtype)
    nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    if pin:
        raw = torch.empty(nbytes + 64, dtype=torch.uint8,
                          pin_memory=True).numpy()
    else:
        raw = np.empty(nbytes + 64, np.uint8)
    off = (-raw.ctypes.data) % 64
    return raw[off:off + nbytes].view(dtype).reshape(shape)


@dataclass
class PaddedBatch:
    """Static-shape CSR batch; named arrays lead with the device axis D.

    row/col/val: [D, NNZ] local row id, column, value (padding nonzeros
    have row == R); label/weight: [D, R] (weight 0 marks padding rows);
    nrows: [D]; qid: [D, R] or None; field: [D, NNZ] or None.

    Packed transfer layout: ``big`` [D, Kb, NNZ] int32 stacks row/col/val
    (f32 bits)[/field] and ``aux`` [D, K, R] int32 stacks label bits/
    weight bits[/qid]/nrows plane, shard-major. With bfloat16 values
    (``csr_val_dtype="bf16"``) the values travel as a separate ``val16``
    leaf [D, NNZ] (uint16 bits on the host, ``torch.bfloat16`` on the
    device) and ``big`` has no val plane. Host batches carry both the
    packs and named views into them; device batches carry only the packs,
    which consumers decode with :func:`unpack_shard`."""
    row: Any = None
    col: Any = None
    val: Any = None
    label: Any = None
    weight: Any = None
    nrows: Any = None
    total_rows: int = 0
    qid: Any = None
    field: Any = None
    big: Any = None
    aux: Any = None
    val16: Any = None

    @property
    def rows_per_shard(self) -> int:
        return self.aux.shape[2] if self.label is None else \
            self.label.shape[1]

    @property
    def nnz_bucket(self) -> int:
        return self.big.shape[2] if self.row is None else self.row.shape[1]

    def tree(self) -> Dict[str, Any]:
        """The batch as a flat dict: the packed leaves (and the bf16
        values as ``val``) when packed, the named leaves otherwise."""
        if self.aux is not None:
            t = {"big": self.big, "aux": self.aux}
            if self.val16 is not None:
                t["val"] = self.val16
            return t
        t = {"row": self.row, "col": self.col, "val": self.val,
             "label": self.label, "weight": self.weight,
             "nrows": self.nrows}
        if self.qid is not None:
            t["qid"] = self.qid
        if self.field is not None:
            t["field"] = self.field
        return t


@dataclass
class DenseBatch:
    """Dense layout for low-dimensional data: x is [D, R, F] (float32 or
    bfloat16; bf16 bits as uint16 on the host), ``aux`` packs
    label/weight[/qid]/nrows as in :class:`PaddedBatch`."""
    x: Any = None
    label: Any = None
    weight: Any = None
    nrows: Any = None
    total_rows: int = 0
    qid: Any = None
    aux: Any = None

    @property
    def rows_per_shard(self) -> int:
        return self.aux.shape[2] if self.label is None else \
            self.label.shape[1]

    @property
    def num_features(self) -> int:
        return self.x.shape[2]

    def tree(self) -> Dict[str, Any]:
        """The batch as a flat dict: x and aux when packed, the named
        leaves otherwise."""
        if self.aux is not None:
            return {"x": self.x, "aux": self.aux}
        t = {"x": self.x, "label": self.label, "weight": self.weight,
             "nrows": self.nrows}
        if self.qid is not None:
            t["qid"] = self.qid
        return t


# -- packed-batch helpers ----------------------------------------------------
# Shard-major packs: aux [D, K, R], big [D, Kb, NNZ]. Plane order, aux:
# 0=label (f32 bits), 1=weight (f32 bits), [2=qid], last=nrows plane (entry
# [d, -1, 0] holds shard d's true row count). big: 0=row, 1=col, 2=val (f32
# bits) unless a separate bf16 ``val`` leaf travels, [last=field]. Float
# planes travel as raw bits and are reinterpreted (a view, not a cast) on
# either side.

def _view_aux(aux: np.ndarray):
    """Named [D, R] views over a host [D, K, R] aux pack."""
    label = aux[:, 0].view(np.float32)
    weight = aux[:, 1].view(np.float32)
    qid = aux[:, 2] if aux.shape[1] == 4 else None
    return aux, label, weight, qid


def _view_big(big: np.ndarray, has_val: bool = True):
    """Named [D, NNZ] row/col[/val][/field] views over a host [D, Kb, NNZ]
    pack; ``has_val=False`` when the values travel as a separate bf16
    leaf (val is then None)."""
    if not has_val:
        field = big[:, 2] if big.shape[1] == 3 else None
        return big[:, 0], big[:, 1], None, field
    field = big[:, 3] if big.shape[1] == 4 else None
    return big[:, 0], big[:, 1], big[:, 2].view(np.float32), field


def _pack_aux(label, weight, qid, nrows, D: int, R: int, emit_qid: bool,
              aux=None):
    """Assemble an aux pack from flat row arrays, reusing ``aux`` when its
    shape fits. Returns (aux, label, weight, qid) with views [D, R]."""
    K = 4 if emit_qid else 3
    if aux is None or aux.shape != (D, K, R):
        aux = _aligned_empty((D, K, R), np.int32)
    _, label_v, weight_v, qid_v = _view_aux(aux)
    label_v[:] = np.asarray(label).reshape(D, R)
    weight_v[:] = np.asarray(weight).reshape(D, R)
    if qid_v is not None:
        qid_v[:] = np.asarray(qid).reshape(D, R)
    aux[:, -1] = 0
    aux[:, -1, 0] = nrows
    return aux, label_v, weight_v, qid_v


def _bitcast_f32(a):
    if isinstance(a, np.ndarray):
        return a.view(np.float32)
    return a.view(torch.float32)


def _unpack(tree: Dict[str, Any], sel, nrows_of) -> Dict[str, Any]:
    """Shared plane decoding; ``sel(pack, i)`` slices plane i of a
    shard-major pack, ``nrows_of`` reads the nrows plane."""
    if "aux" not in tree:
        return tree
    aux = tree["aux"]
    out = {}
    if "x" in tree:
        out["x"] = tree["x"]
    if "big" in tree:
        big = tree["big"]
        kb = big.shape[-2]
        out["row"] = sel(big, 0)
        out["col"] = sel(big, 1)
        if "val" in tree:  # separate bf16 value leaf; no val plane
            out["val"] = tree["val"]
            if kb == 3:
                out["field"] = sel(big, 2)
        else:
            out["val"] = _bitcast_f32(sel(big, 2))
            if kb == 4:
                out["field"] = sel(big, 3)
    out["label"] = _bitcast_f32(sel(aux, 0))
    out["weight"] = _bitcast_f32(sel(aux, 1))
    if aux.shape[-2] == 4:
        out["qid"] = sel(aux, 2)
    out["nrows"] = nrows_of(sel(aux, aux.shape[-2] - 1))
    return out


def unpack_tree(tree: Dict[str, Any]) -> Dict[str, Any]:
    """Named leaves [D, ...] from a packed batch tree (nrows [D]); identity
    for named trees. Views only; works on numpy and torch alike."""
    return _unpack(tree, lambda a, i: a[:, i], lambda plane: plane[:, 0])


def unpack_shard(tree: Dict[str, Any]) -> Dict[str, Any]:
    """Named leaves of one shard (device axis already dropped: aux [K, R],
    big [Kb, NNZ], x [R, F]; nrows a 0-d value)."""
    return _unpack(tree, lambda a, i: a[i], lambda plane: plane[0])


def _device_batch(host, out: Dict[str, torch.Tensor]):
    """The device batch of ``host`` from its leaves ``out`` (tensors of
    ``host.tree()``): bf16 bits (uint16 on the host) viewed as
    ``torch.bfloat16``, and a packed batch's separate bf16 value leaf
    riding as ``val16``."""
    if isinstance(host, DenseBatch) and host.x.dtype == BF16_STORAGE:
        out["x"] = out["x"].view(torch.bfloat16)
    if "val" in out and "big" in out:
        out["val16"] = out.pop("val").view(torch.bfloat16)
    return type(host)(total_rows=host.total_rows, **out)


def to_device_batch(batch, device):
    """A host batch (numpy leaves, as ``to_device=False`` hands them over)
    as the batch the iterator would have put on ``device``: every leaf
    copied there (aliased on the CPU), the bf16 planes as the copying
    path carries them. A batch of tensors is returned as it is."""
    tree = batch.tree()
    if not any(isinstance(v, np.ndarray) for v in tree.values()):
        return batch
    device = torch.device(device)
    return _device_batch(batch, {k: torch.from_numpy(v).to(device)
                                 for k, v in tree.items()})


def _next_pow2(n: int, floor: int) -> int:
    b = floor
    while b < n:
        b <<= 1
    return b


class _HostBufferPool:
    """Shape-keyed free-list of host batch buffers. Buffers enter only
    after their host->device copy has completed and only when no device
    tensor aliases them; bounded per key."""

    CAP = 4

    def __init__(self):
        self._pool: Dict[Any, list] = {}
        self._lock = threading.Lock()

    def pop(self, key):
        with self._lock:
            lst = self._pool.get(key)
            return lst.pop() if lst else None

    def put(self, key, arrs) -> None:
        with self._lock:
            lst = self._pool.setdefault(key, [])
            if len(lst) < self.CAP:
                lst.append(arrs)


def _observe_padding(batch) -> None:
    """``device_batch_nnz`` (useful nonzeros) and ``device_batch_slots``
    (D x the nnz bucket) of a host CSR batch. Every batcher fills a
    shard's row plane in row order and pads its tail with row R, so one
    binary search a shard counts the useful entries; R goes in as the
    plane's own dtype, since another would make numpy copy the plane."""
    row = batch.row if isinstance(batch, PaddedBatch) else None
    if row is None:
        return
    pad = row.dtype.type(batch.rows_per_shard)
    nnz = sum(int(np.searchsorted(plane, pad)) for plane in row)
    telemetry.histogram("device_batch_nnz").observe(nnz)
    telemetry.histogram("device_batch_slots").observe(row.size)


def _check_shards(batch_rows: int, num_shards: int) -> None:
    if batch_rows % num_shards != 0:
        raise DMLCError(
            f"batch_rows={batch_rows} must divide by shards={num_shards}")


def _shard_nrows(take: int, D: int, R: int) -> np.ndarray:
    """True row count of each of D shards of R rows holding ``take``."""
    return np.minimum(np.maximum(take - np.arange(D) * R, 0),
                      R).astype(np.int32)


class HostBatcher:
    """Fixed-row-count host batches assembled in numpy from native
    RowBlocks: the ``index64=True`` lane, whose parser reads 64-bit
    feature ids. The device layout stays int32, so a feature id or qid of
    2^31 or more raises instead of wrapping into a wrong column. Native
    blocks have arbitrary sizes (one per parser worker per chunk), so rows
    are split and merged here to make ``batch_rows`` exactly."""

    def __init__(self, parser: NativeParser, batch_rows: int,
                 num_shards: int, min_nnz_bucket: int = 4096,
                 index64: bool = False, layout: str = "auto",
                 dense_max_features: int = 512, dense_dtype=np.float32,
                 pin: bool = False):
        # index64 is the reference's keyword, accepted and never read
        # there too: the parser's width decides the ids' width
        del index64
        _check_shards(batch_rows, num_shards)
        if layout not in ("auto", "csr", "dense"):
            raise DMLCError(f"unknown layout {layout!r}")
        self.parser = parser
        self.batch_rows = batch_rows
        self.num_shards = num_shards
        self.min_nnz_bucket = min_nnz_bucket
        self.layout = layout
        self.dense_max_features = dense_max_features
        self.dense_dtype = _dense_dtype_of(dense_dtype)
        self.pin = pin
        self._num_features: Optional[int] = None
        # leftover rows of earlier blocks: (label, weight, lens, col, val,
        # qid, field) numpy copies
        self._pending: list = []
        self._pending_rows = 0
        self._done = False
        self._has_qid = False
        self._has_field = False
        # plane presence pins on the first batch (static batch structure)
        self._emit_qid: Optional[bool] = None
        self._emit_field: Optional[bool] = None
        self._pool = _HostBufferPool()

    def _empty(self, shape, dtype) -> np.ndarray:
        return _aligned_empty(shape, dtype, pin=self.pin)

    def recycle(self, batch) -> None:
        """Return a consumed host batch's buffers for reuse (the contract
        of :meth:`NativeHostBatcher.recycle`); every plane is rewritten on
        reuse."""
        if not isinstance(getattr(batch, "aux", None), np.ndarray):
            return
        if isinstance(batch, DenseBatch):
            self._pool.put(("dense", batch.x.shape[-1], batch.x.dtype),
                           (batch.x.reshape(self.batch_rows, -1), batch.aux))
        else:
            self._pool.put(("csr", batch.big.shape[-1]),
                           (batch.big, batch.aux))

    def _block_to_parts(self, b) -> tuple:
        lens = np.diff(b.offset).astype(np.int32)
        # the device layout is int32: an id >= 2^31 would wrap negative
        # and land in a wrong column, so refuse it (the native batcher
        # does the same in PaddedBatcher::Accumulate)
        if b.nnz:
            mx = int(b.max_index) or int(b.index.max())
            if mx > np.iinfo(np.int32).max:
                raise DMLCError(
                    f"feature index {mx} exceeds the int32 device layout "
                    f"(max {np.iinfo(np.int32).max}); remap feature ids "
                    f"below 2^31 for the device batch layout")
        col = b.index.astype(np.int32, copy=True)
        val = (b.value.astype(np.float32, copy=True) if b.value is not None
               else np.ones(b.nnz, dtype=np.float32))
        label = b.label.astype(np.float32, copy=True)
        weight = (b.weight.astype(np.float32, copy=True)
                  if b.weight is not None
                  else np.ones(b.num_rows, dtype=np.float32))
        qid = fld = None
        if b.qid is not None:
            self._has_qid = True
            if b.qid.max(initial=0) > np.iinfo(np.int32).max:
                raise DMLCError(
                    f"qid {int(b.qid.max())} exceeds the int32 device "
                    f"layout")
            qid = b.qid.astype(np.int32)
        if b.field is not None:
            self._has_field = True
            fld = b.field.astype(np.int32)
        return label, weight, lens, col, val, qid, fld

    def _take_rows(self, take: int) -> list:
        """Pop ``take`` rows off the pending pieces, splitting one."""
        parts, got = [], 0
        while got < take:
            label, weight, lens, col, val, qid, fld = self._pending[0]
            n = len(label)
            if got + n <= take:
                parts.append(self._pending.pop(0))
                got += n
                continue
            keep = take - got
            nz = int(lens[:keep].sum())
            head = (label[:keep], weight[:keep], lens[:keep], col[:nz],
                    val[:nz], None if qid is None else qid[:keep],
                    None if fld is None else fld[:nz])
            self._pending[0] = (label[keep:], weight[keep:], lens[keep:],
                                col[nz:], val[nz:],
                                None if qid is None else qid[keep:],
                                None if fld is None else fld[nz:])
            parts.append(head)
            got = take
        return parts

    def next_batch(self):
        """The next static-shape host batch (None at end)."""
        while self._pending_rows < self.batch_rows and not self._done:
            b = self.parser.next_block()
            if b is None:
                self._done = True
                break
            self._pending.append(self._block_to_parts(b))
            self._pending_rows += len(self._pending[-1][0])
        if self._pending_rows == 0:
            return None
        if self._emit_qid is None:
            self._emit_qid, self._emit_field = self._has_qid, self._has_field
        elif (self._has_qid and not self._emit_qid) or (
                self._has_field and not self._emit_field):
            raise DMLCError(
                "qid/field column appeared mid-stream after the batch "
                "structure was pinned without it; order the inputs so the "
                "first batch carries the column")
        take = min(self.batch_rows, self._pending_rows)
        parts = self._take_rows(take)
        self._pending_rows -= take
        label, weight, lens, col, val = (
            np.concatenate([p[i] for p in parts]) for i in range(5))
        # sentinels (qid -1, field 0) only when the stream has the column
        qid = (np.concatenate(
            [p[5] if p[5] is not None else np.full(len(p[0]), -1, np.int32)
             for p in parts]) if self._emit_qid else np.empty(0, np.int32))
        fld = (np.concatenate(
            [p[6] if p[6] is not None else np.zeros(len(p[3]), np.int32)
             for p in parts]) if self._emit_field
            else np.empty(0, np.int32))
        D = self.num_shards
        R = self.batch_rows // D
        if take < self.batch_rows:  # pad rows (weight 0: no gradient)
            pad = self.batch_rows - take
            label = np.concatenate([label, np.zeros(pad, np.float32)])
            weight = np.concatenate([weight, np.zeros(pad, np.float32)])
            lens = np.concatenate([lens, np.zeros(pad, np.int32)])
            if self._emit_qid:
                qid = np.concatenate([qid, np.full(pad, -1, np.int32)])
        if self.layout == "auto":
            # decided once, on the first batch; field-aware data has no
            # dense representation
            max_idx = int(col.max()) if len(col) else 0
            self.layout = ("dense" if not self._emit_field
                           and max_idx + 1 <= self.dense_max_features
                           else "csr")
        if self.layout == "dense":
            if self._emit_field:
                raise DMLCError(
                    "field ids have no dense layout; pass layout='csr' for "
                    "field-aware (libfm) data")
            return self._emit_dense(take, label, weight, lens, col, val, qid)

        # split the nonzeros by shard; bucket to the largest shard's
        row_of = np.repeat(np.arange(self.batch_rows, dtype=np.int32), lens)
        shard_starts = np.concatenate(
            [[0], np.cumsum(lens.reshape(D, R).sum(axis=1))]).astype(np.int64)
        bucket = _next_pow2(int(np.diff(shard_starts).max()) if take else 1,
                            self.min_nnz_bucket)
        kb = 4 if self._emit_field else 3
        pooled = self._pool.pop(("csr", bucket))
        big, aux = pooled if pooled is not None else (None, None)
        if big is None or big.shape[1] != kb:
            big = self._empty((D, kb, bucket), np.int32)
        row, colp, valp, fldp = _view_big(big)
        row[:] = R  # the padding segment
        colp[:] = 0
        valp[:] = 0.0
        if fldp is not None:
            fldp[:] = 0
        for d in range(D):
            lo, hi = shard_starts[d], shard_starts[d + 1]
            n = hi - lo
            row[d, :n] = row_of[lo:hi] - d * R  # local row ids
            colp[d, :n] = col[lo:hi]
            valp[d, :n] = val[lo:hi]
            if fldp is not None:
                fldp[d, :n] = fld[lo:hi]
        nrows = _shard_nrows(take, D, R)
        if aux is None or aux.shape != (D, 4 if self._emit_qid else 3, R):
            aux = self._empty((D, 4 if self._emit_qid else 3, R), np.int32)
        aux, label_v, weight_v, qid_v = _pack_aux(
            label, weight, qid, nrows, D, R, self._emit_qid, aux=aux)
        return PaddedBatch(row=row, col=colp, val=valp, label=label_v,
                           weight=weight_v, nrows=nrows,
                           total_rows=int(take), qid=qid_v, field=fldp,
                           big=big, aux=aux)

    def _emit_dense(self, take, label, weight, lens, col, val, qid):
        D = self.num_shards
        R = self.batch_rows // D
        if self._num_features is None:
            self._num_features = int(col.max()) + 1 if len(col) else 1
        F = self._num_features
        mx = int(col.max()) + 1 if len(col) else 1
        if mx > F:
            raise DMLCError(
                f"dense layout fixed at {F} features but saw index {mx - 1}; "
                f"pass layout='csr' or a larger dense_max_features")
        pooled = self._pool.pop(("dense", F, self.dense_dtype))
        x, aux = pooled if pooled is not None else (None, None)
        if x is None:
            x = self._empty((self.batch_rows, F), self.dense_dtype)
        x.fill(0)  # the scatter below touches present entries only
        row_of = np.repeat(np.arange(self.batch_rows, dtype=np.int64), lens)
        # bf16 storage: the native core's rounding, as the fills round
        x[row_of, col] = (bf16_bits(val) if self.dense_dtype == BF16_STORAGE
                          else val)
        nrows = _shard_nrows(take, D, R)
        if aux is None or aux.shape != (D, 4 if self._emit_qid else 3, R):
            aux = self._empty((D, 4 if self._emit_qid else 3, R), np.int32)
        aux, label_v, weight_v, qid_v = _pack_aux(
            label, weight, qid, nrows, D, R, self._emit_qid, aux=aux)
        return DenseBatch(x=x.reshape(D, R, F), label=label_v,
                          weight=weight_v, nrows=nrows,
                          total_rows=int(take), qid=qid_v, aux=aux)

    def reset(self) -> None:
        """Restart from the first row (new epoch)."""
        self.parser.before_first()
        self._pending.clear()
        self._pending_rows = 0
        self._done = False

    def set_epoch(self, epoch: int) -> bool:
        """Pin the shuffle permutation the next reset() samples."""
        return self.parser.set_epoch(epoch)

    def bytes_read(self) -> int:
        """Bytes consumed from the source so far."""
        return self.parser.bytes_read()

    def close(self) -> None:
        """Free the parser's native handle (idempotent)."""
        self.parser.close()


class NativeHostBatcher:
    """Fixed-row-count host batches from the C++ PaddedBatcher
    (cpp/src/batcher.h): next_meta() stages a batch, Python allocates (or
    reuses) the staging buffers, and one GIL-free native pass fills them.
    Layouts: ``csr`` (float32 values, or with ``csr_val_dtype="bf16"`` a
    separate bfloat16 value leaf that the fill rounds to nearest even) and
    ``dense`` (float32 or bf16)."""

    def __init__(self, uri: str, part: int = 0, npart: int = 1,
                 fmt: str = "auto", nthread: int = 0,
                 batch_rows: int = 65536, num_shards: int = 1,
                 min_nnz_bucket: int = 4096, layout: str = "auto",
                 dense_max_features: int = 512, dense_dtype=np.float32,
                 csr_val_dtype: str = "f32", pin: bool = False):
        _check_shards(batch_rows, num_shards)
        if layout not in ("auto", "csr", "dense"):
            raise DMLCError(f"unknown layout {layout!r}")
        if csr_val_dtype not in ("f32", "bf16"):
            raise DMLCError(f"unknown csr_val_dtype {csr_val_dtype!r} "
                            f"(expected 'f32' or 'bf16')")
        self._csr_bf16 = csr_val_dtype == "bf16"
        self.dense_dtype = _dense_dtype_of(dense_dtype)
        self._b = NativeBatcher(uri, part=part, npart=npart, fmt=fmt,
                                nthread=nthread, batch_rows=batch_rows,
                                num_shards=num_shards,
                                min_nnz_bucket=min_nnz_bucket)
        self.batch_rows = batch_rows
        self.num_shards = num_shards
        self.layout = layout
        self.dense_max_features = dense_max_features
        self.pin = pin
        self._num_features: Optional[int] = None
        # plane presence pins on the first batch so batch structure stays
        # static for the whole stream
        self._emit_qid: Optional[bool] = None
        self._emit_field: Optional[bool] = None
        self._pool = _HostBufferPool()

    def _empty(self, shape, dtype) -> np.ndarray:
        return _aligned_empty(shape, dtype, pin=self.pin)

    def next_batch(self):
        """The next static-shape host batch (None at end)."""
        meta = self._b.next_meta()
        if meta is None:
            return None
        take, bucket, max_index, has_qid, has_field = meta
        if self._emit_qid is None:
            self._emit_qid, self._emit_field = has_qid, has_field
        elif (has_qid and not self._emit_qid) or (
                has_field and not self._emit_field):
            raise DMLCError(
                "qid/field column appeared mid-stream after the batch "
                "structure was pinned without it; order the inputs so the "
                "first batch carries the column")
        has_qid, has_field = self._emit_qid, self._emit_field
        D = self.num_shards
        R = self.batch_rows // D
        ka = 4 if has_qid else 3
        if self.layout == "auto":
            # decided once, on the first batch; field-aware data has no
            # dense representation
            self.layout = ("dense" if not has_field
                           and max_index + 1 <= self.dense_max_features
                           else "csr")
        elif self.layout == "dense" and has_field:
            raise DMLCError(
                "field ids have no dense layout; pass layout='csr' for "
                "field-aware (libfm) data")
        if self.layout == "dense":
            if self._num_features is None:
                self._num_features = max(int(max_index) + 1, 1)
            F = self._num_features
            pooled = self._pool.pop(("dense", F))
            if pooled is not None:
                x, aux, nrows = pooled
            else:
                x = self._empty((self.batch_rows, F), self.dense_dtype)
                aux, nrows = None, np.empty(D, np.int32)
            if aux is None or aux.shape[1] != ka:
                aux = self._empty((D, ka, R), np.int32)
            self._b.fill_dense_packed(x, aux, nrows)
            _, label, weight, qid = _view_aux(aux)
            return DenseBatch(x=x.reshape(D, R, F), label=label,
                              weight=weight, nrows=nrows,
                              total_rows=int(take), qid=qid, aux=aux)
        sep_val = self._csr_bf16
        kb = 2 + (0 if sep_val else 1) + (1 if has_field else 0)
        pooled = self._pool.pop(("csr", bucket, sep_val))
        if pooled is not None:
            big, val16, aux, nrows = pooled
        else:
            big, val16, aux = None, None, None
            nrows = np.empty(D, np.int32)
        if big is None or big.shape[1] != kb:
            big = self._empty((D, kb, bucket), np.int32)
        if sep_val and val16 is None:
            val16 = self._empty((D, bucket), BF16_STORAGE)
        if aux is None or aux.shape[1] != ka:
            aux = self._empty((D, ka, R), np.int32)
        self._b.fill_packed(big, aux, nrows, val=val16)
        row, col, val, field = _view_big(big, has_val=not sep_val)
        _, label, weight, qid = _view_aux(aux)
        return PaddedBatch(row=row, col=col,
                           val=val16 if sep_val else val, label=label,
                           weight=weight, nrows=nrows,
                           total_rows=int(take), qid=qid, field=field,
                           big=big, aux=aux, val16=val16)

    def recycle(self, batch) -> None:
        """Return a consumed host batch's buffers for reuse. The caller
        guarantees that the batch's host->device copy has completed and
        that no device tensor aliases the buffers."""
        if not isinstance(getattr(batch, "aux", None), np.ndarray):
            return
        if isinstance(batch, DenseBatch):
            self._pool.put(("dense", batch.x.shape[-1]),
                           (batch.x.reshape(self.batch_rows, -1),
                            batch.aux, batch.nrows))
        else:
            self._pool.put(("csr", batch.big.shape[-1],
                            batch.val16 is not None),
                           (batch.big, batch.val16, batch.aux, batch.nrows))

    def reset(self) -> None:
        """Restart from the first row (new epoch); the pool survives."""
        self._b.before_first()

    def set_epoch(self, epoch: int) -> bool:
        """Pin the shuffle permutation the next reset() samples."""
        return self._b.set_epoch(epoch)

    def bytes_read(self) -> int:
        """Bytes consumed from the source so far."""
        return self._b.bytes_read()

    def close(self) -> None:
        """Free the native handle (idempotent)."""
        self._b.close()


class CsrRecHostBatcher:
    """Host batches from a ``.crec`` file (cpp/src/csr_rec.h): records hold
    col/val/row-length planes in device layout, so a batch is bulk memcpy
    plus row-id expansion straight into the packs, in one GIL-free native
    pass. The per-shard nnz bucket is static for the epoch (the file's
    window table bounds it). Emits the text CSR lane's PaddedBatch.

    A local file, whole or a part of it, is read in place from a read-only
    mapping (:class:`~dmlc_core_tpu_torch.io.crec_map.MappedCsrRecBatcher`),
    and a pooled buffer's padding and row ids are written again only where
    its previous fill left other values; any other URI (a list, a
    directory, a remote store, a ``#`` chunk cache) takes the shared
    core's fill (:class:`~dmlc_core_tpu_torch.io.native.NativeCsrRecBatcher`).
    Both give the same planes, bit for bit. With telemetry on, the padding
    entries each fill wrote are counted (``crec_pad_entries_written``)."""

    def __init__(self, uri: str, part: int = 0, npart: int = 1,
                 batch_rows: int = 65536, num_shards: int = 1,
                 min_nnz_bucket: int = 4096, pin: bool = False):
        _check_shards(batch_rows, num_shards)
        path = mappable(uri)
        self._mapped = path is not None
        if self._mapped:
            self._b = MappedCsrRecBatcher(path, part=part, npart=npart,
                                          batch_rows=batch_rows,
                                          num_shards=num_shards,
                                          min_nnz_bucket=min_nnz_bucket)
        else:
            self._b = NativeCsrRecBatcher(uri, part=part, npart=npart,
                                          batch_rows=batch_rows,
                                          num_shards=num_shards,
                                          min_nnz_bucket=min_nnz_bucket)
        self.batch_rows = batch_rows
        self.num_shards = num_shards
        self.pin = pin
        self._meta = None
        self._pool = _HostBufferPool()
        # id(big) -> (weakref to big, its BufferState): what a refill of
        # that buffer need not write again; dropped with the buffer
        self._held: Dict[int, tuple] = {}

    def recycle(self, batch) -> None:
        """Return a consumed host batch's buffers for reuse (the contract
        of :meth:`NativeHostBatcher.recycle`)."""
        if not isinstance(getattr(batch, "aux", None), np.ndarray):
            return
        self._pool.put(("crec", batch.big.shape[-1]),
                       (batch.big, batch.aux, batch.nrows))

    def _buffer_state(self, big: np.ndarray, bucket: int) -> BufferState:
        """What ``big`` holds from its last fill (nothing for a fresh
        buffer)."""
        known = self._held.get(id(big))
        if known is not None and known[0]() is big:
            return known[1]
        state = BufferState(self.num_shards,
                            self.batch_rows // self.num_shards, bucket)
        self._held[id(big)] = (
            weakref.ref(big, lambda _r, held=self._held, key=id(big):
                        held.pop(key, None)),
            state)
        return state

    def next_batch(self) -> Optional[PaddedBatch]:
        """The next static-shape host batch (None at end)."""
        if self._meta is None:
            self._meta = self._b.meta()
        bucket, _, has_qid, has_field = self._meta
        D = self.num_shards
        R = self.batch_rows // D
        pooled = self._pool.pop(("crec", bucket))
        if pooled is not None:
            big, aux, nrows = pooled
        else:
            big = _aligned_empty((D, 4 if has_field else 3, bucket),
                                 np.int32, pin=self.pin)
            aux = _aligned_empty((D, 4 if has_qid else 3, R), np.int32,
                                 pin=self.pin)
            nrows = np.empty(D, np.int32)
        if self._mapped:
            take, pad = self._b.fill_packed(
                big, aux, nrows, self._buffer_state(big, bucket))
        else:  # the shared fill pads every shard's whole tail
            take = self._b.fill_packed(big, aux, nrows)
            pad = None
        if take == 0:
            return None
        if telemetry.enabled():
            if pad is None:
                pad = sum(bucket - int(np.searchsorted(
                    plane, plane.dtype.type(R))) for plane in big[:, 0])
            telemetry.counter("crec_pad_entries_written").inc(pad)
        row, col, val, field = _view_big(big)
        _, label, weight, qid = _view_aux(aux)
        return PaddedBatch(row=row, col=col, val=val, label=label,
                           weight=weight, nrows=nrows,
                           total_rows=int(take), qid=qid, field=field,
                           big=big, aux=aux)

    def reset(self) -> None:
        """Restart from the first record (new epoch); the pool survives."""
        self._b.before_first()

    def set_epoch(self, epoch: int) -> bool:
        """Pin the shuffle permutation the next reset() samples."""
        return self._b.set_epoch(epoch)

    def bytes_read(self) -> int:
        """Record bytes consumed from the source so far."""
        return self._b.bytes_read()

    def close(self) -> None:
        """Free the native handle (idempotent)."""
        self._b.close()


class DenseRecHostBatcher:
    """Host batches from a ``.drec`` file (cpp/src/dense_rec.h): records
    hold [rows, F] matrices in device layout, so a batch is record framing
    plus bulk memcpy (converting float32 <-> bf16 where the file and
    ``dense_dtype`` differ). Emits the dense text lane's DenseBatch."""

    def __init__(self, uri: str, part: int = 0, npart: int = 1,
                 batch_rows: int = 65536, num_shards: int = 1,
                 dense_dtype=np.float32, pin: bool = False):
        _check_shards(batch_rows, num_shards)
        self._b = NativeDenseRecBatcher(uri, part=part, npart=npart,
                                        batch_rows=batch_rows,
                                        num_shards=num_shards)
        self.batch_rows = batch_rows
        self.num_shards = num_shards
        self.dense_dtype = _dense_dtype_of(dense_dtype)
        self.pin = pin
        self._F: Optional[int] = None
        self._pool = _HostBufferPool()

    def recycle(self, batch) -> None:
        """Return a consumed host batch's buffers for reuse (the contract
        of :meth:`NativeHostBatcher.recycle`)."""
        if not isinstance(getattr(batch, "aux", None), np.ndarray):
            return
        self._pool.put(("drec", batch.x.shape[-1]),
                       (batch.x.reshape(self.batch_rows, -1), batch.aux,
                        batch.nrows))

    def next_batch(self) -> Optional[DenseBatch]:
        """The next static-shape host batch (None at end)."""
        if self._F is None:
            self._F = max(int(self._b.meta()[0]), 1)
        F = self._F
        D = self.num_shards
        R = self.batch_rows // D
        pooled = self._pool.pop(("drec", F))
        if pooled is not None:
            x, aux, nrows = pooled
        else:
            x = _aligned_empty((self.batch_rows, F), self.dense_dtype,
                               pin=self.pin)
            aux = _aligned_empty((D, 3, R), np.int32, pin=self.pin)
            nrows = np.empty(D, np.int32)
        take = self._b.fill_packed(x, aux, nrows)
        if take == 0:
            return None
        _, label, weight, _ = _view_aux(aux)
        return DenseBatch(x=x.reshape(D, R, F), label=label, weight=weight,
                          nrows=nrows, total_rows=int(take), aux=aux)

    def reset(self) -> None:
        """Restart from the first record (new epoch); the pool survives."""
        self._b.before_first()

    def set_epoch(self, epoch: int) -> bool:
        """Pin the shuffle permutation the next reset() samples (always
        False: the dense-rec split does not shuffle)."""
        return self._b.set_epoch(epoch)

    def bytes_read(self) -> int:
        """Record bytes consumed from the source so far."""
        return self._b.bytes_read()

    def close(self) -> None:
        """Free the native handle (idempotent)."""
        self._b.close()


class DeviceRowBlockIter:
    """Row-block iterator whose batches live on the device (the port of
    the reference's DeviceRowBlockIter).

    Iterate to get :class:`PaddedBatch` / :class:`DenseBatch` objects whose
    ``big``/``aux``/``x`` are tensors on ``device``; ``before_first()``,
    ``state()``/``restore()``, ``bytes_read()`` and ``close()`` behave as in
    the reference. With ``prefetch >= 1`` a staging thread parses and fills
    while a transfer thread copies, ``prefetch`` batches deep; with
    ``prefetch=0`` everything runs inline on the caller's thread.

    ``device`` defaults to ``cuda`` and raises when CUDA is missing; pass
    ``device="cpu"`` to run on the CPU. The lane follows ``fmt`` (``auto``
    reads the suffix: ``.drec`` -> ``recd``, ``.crec`` -> ``crec``,
    ``.rec`` -> ``rec``) and ``index64``; bf16 CSR values
    (``csr_val_dtype="bf16"``) are a text/rec-lane option and are refused
    on the crec, recd and index64 lanes, as in the reference.

    With ``mesh=`` (a ``DataMesh``), ``batch_rows`` is the global batch:
    this rank builds batches of ``batch_rows / mesh.size`` rows from its
    ``part`` of ``npart`` (which must divide), on the mesh's device unless
    ``device`` names another.

    ``to_device=False`` hands over the host batches themselves (numpy
    leaves, as the reference's ``to_device=False`` does): no copy, no
    stream, no pinned staging, and no device counter or ``device.put``
    span moves. A handed-out batch is never recycled, so it stays valid
    after the iterator moves on. ``device`` is still resolved (and still
    raises without CUDA unless it is ``"cpu"``); the learners copy such
    batches to their parameters' device (:func:`to_device_batch`)."""

    _SHUTDOWN = object()

    def __init__(self, uri: str, part: int = 0, npart: int = 1,
                 fmt: str = "auto", batch_rows: int = 65536,
                 mesh=None, min_nnz_bucket: int = 4096,
                 index64: bool = False, nthread: int = 0,
                 prefetch: int = 2, to_device: bool = True,
                 layout: str = "auto", dense_max_features: int = 512,
                 dense_dtype=np.float32, csr_val_dtype: str = "f32",
                 device=None):
        check_mesh(mesh)
        self.to_device = to_device
        num_shards = local_device_count(mesh)
        self.device = (mesh.device if device is None and mesh is not None
                       else resolve_device(device))
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        path_part = uri.split("?", 1)[0].split("#", 1)[0]
        if fmt == "auto" and path_part.endswith(".drec"):
            fmt = "recd"
        elif fmt == "auto" and path_part.endswith(".crec"):
            fmt = "crec"
        elif fmt == "auto" and path_part.endswith(".rec"):
            fmt = "rec"
        if csr_val_dtype != "f32" and (fmt in ("recd", "crec") or index64):
            raise DMLCError(
                "csr_val_dtype='bf16' is a native text/rec-lane feature "
                "(the fused fill converts values in-pass); the crec/recd "
                "binary lanes and the index64 python batcher keep f32")
        self.batch_rows = batch_rows
        self.mesh = mesh
        if mesh is not None:
            # batch_rows is the GLOBAL batch: it splits over the mesh's
            # ranks, as the reference's splits over its devices
            _check_shards(batch_rows, mesh.size)
        local_rows = batch_rows // (1 if mesh is None else mesh.size)
        # determinism keys for mid-epoch resume (state()/restore()), after
        # the suffix rule, so fmt="auto" and the explicit format agree
        self._identity = {"uri": uri, "part": part, "npart": npart,
                          "fmt": fmt, "batch_rows": batch_rows}
        # host batches handed out are never recycled: pinning each would
        # cost a fresh page-locked allocation a batch
        pin = to_device and self.device.type == "cuda"
        if fmt == "recd":
            self.batcher = DenseRecHostBatcher(
                uri, part=part, npart=npart, batch_rows=local_rows,
                num_shards=num_shards, dense_dtype=dense_dtype, pin=pin)
        elif fmt == "crec":
            self.batcher = CsrRecHostBatcher(
                uri, part=part, npart=npart, batch_rows=local_rows,
                num_shards=num_shards, min_nnz_bucket=min_nnz_bucket,
                pin=pin)
        elif index64:
            self.batcher = HostBatcher(
                NativeParser(uri, part=part, npart=npart, fmt=fmt,
                             nthread=nthread, index64=True),
                local_rows, num_shards, min_nnz_bucket, index64,
                layout=layout, dense_max_features=dense_max_features,
                dense_dtype=dense_dtype, pin=pin)
        else:
            self.batcher = NativeHostBatcher(
                uri, part=part, npart=npart, fmt=fmt, nthread=nthread,
                batch_rows=local_rows, num_shards=num_shards,
                min_nnz_bucket=min_nnz_bucket, layout=layout,
                dense_max_features=dense_max_features,
                dense_dtype=dense_dtype, csr_val_dtype=csr_val_dtype,
                pin=pin)
        self._stream = (torch.cuda.Stream(self.device) if pin else None)
        self._prefetch = prefetch
        self._host_q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
        self._thread: Optional[threading.Thread] = None
        self._xfer_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # deferred recycling on the CPU, whose tensors alias the staging
        # buffers: parked (host batch, weakrefs) entries, recycled once
        # the consumer has dropped the batch; overflow drops the oldest
        # entry for real (device_recycle_skipped). Touched only by the
        # transfer thread or the prefetch=0 generator, never both, and by
        # the joins once those have stopped.
        self._deferred: list = []
        self._deferred_cap = max(4, prefetch * 2)
        self._recycle_skipped = 0
        self.batches_consumed = 0
        self._skip_batches = 0
        self._epoch = 0
        # perf_counter at the open epoch turn's before_first(), or None
        self._turn_t0: Optional[float] = None

    # -- staging threads -----------------------------------------------------
    # Queue ops are stop-aware, so a close-time drain cannot leave a peer
    # blocked forever on a queue it emptied.
    def _put_stop(self, q: "queue.Queue", item) -> bool:
        while True:
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                if self._stop.is_set():
                    return False

    def _get_stop(self, q: "queue.Queue"):
        while True:
            try:
                return q.get(timeout=0.05)
            except queue.Empty:
                if self._stop.is_set():
                    return self._SHUTDOWN

    def _skip_prefix(self) -> None:
        """Mid-epoch resume: parse and discard the recorded prefix (never
        transferred, so its buffers recycle at once)."""
        skip, self._skip_batches = self._skip_batches, 0
        for i in range(skip):
            if self._stop.is_set():
                return
            batch = self.batcher.next_batch()
            if batch is None:
                raise DMLCError(
                    f"restore: resume point ({skip} batches) is past "
                    f"end-of-data (got {i}); the checkpoint and the data "
                    f"stream disagree")
            self.batcher.recycle(batch)

    def _stage(self):
        """One host batch (parse + fill), timed as ``device.stage``; a CSR
        batch's padding is observed too (:func:`_observe_padding`)."""
        if not telemetry.enabled():
            return self.batcher.next_batch()
        t0 = time.perf_counter()
        batch = self.batcher.next_batch()
        dur_us = (time.perf_counter() - t0) * 1e6
        if batch is not None:
            _get_lane_metrics()["stage_us"].observe(dur_us)
            _observe_padding(batch)
            telemetry.emit_span("device.stage", t0 * 1e6, dur_us,
                                rows=batch.total_rows)
        return batch

    def _parse_loop(self) -> None:
        try:
            self._skip_prefix()
            m = _get_lane_metrics()
            while not self._stop.is_set():
                batch = self._stage()
                if not self._put_stop(self._host_q, batch):
                    return
                m["host_q"].set(self._host_q.qsize())
                if batch is None:
                    return
        except BaseException as e:  # handed on through the transfer stage
            self._put_stop(self._host_q, e)

    def _transfer_loop(self) -> None:
        try:
            m = _get_lane_metrics()
            while not self._stop.is_set():
                item = self._get_stop(self._host_q)
                if item is self._SHUTDOWN:
                    return
                if isinstance(item, BaseException) or item is None:
                    self._put_stop(self._queue, item)
                    return
                out = self._device_put(item)
                if not self._put_stop(self._queue, out):
                    return
                m["ready_q"].set(self._queue.qsize())
                m["host_q"].set(self._host_q.qsize())
        except BaseException as e:
            self._put_stop(self._queue, e)

    def _ensure_started(self) -> None:
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._parse_loop,
                                            daemon=True)
            self._xfer_thread = threading.Thread(target=self._transfer_loop,
                                                 daemon=True)
            self._thread.start()
            self._xfer_thread.start()

    # -- host -> device -------------------------------------------------------
    def _copy(self, tree):
        """Start the host->device copies; returns (device tree, event,
        alias refs). On the CPU the tensors alias the staging memory (the
        zero-copy counterpart): no event, and weakrefs that die once no
        tensor reads a staging buffer any more."""
        if self._stream is None:
            # each tensor's storage holds its own numpy view of the buffer
            # until every tensor and view over that storage is gone, so a
            # weakref to that view outlives reshapes and dtype views of
            # the handed-out tensor, which a weakref to the tensor would not
            views = [(k, v.view()) for k, v in tree.items()]
            return ({k: torch.from_numpy(a) for k, a in views}, None,
                    tuple(weakref.ref(a) for _k, a in views))
        with torch.cuda.stream(self._stream):
            out = {k: torch.from_numpy(v).to(self.device, non_blocking=True)
                   for k, v in tree.items()}
            ev = torch.cuda.Event()
            ev.record(self._stream)
        return out, ev, ()

    def _device_put(self, host):
        """Copy one host batch to the device. Returns (device batch, copy
        event or None). Waits for the copy before returning — as the
        reference blocks on its transfer — so the staging buffers go back
        to the pool here, after the copy's event has completed. With
        ``to_device=False`` returns ``(host, None)`` before any copy,
        counter or span, and the batch is never recycled."""
        if not self.to_device:
            return host, None
        m = _get_lane_metrics()
        tree = host.tree()
        nbytes = sum(int(v.nbytes) for v in tree.values())
        tel = telemetry.enabled()
        try:
            with telemetry.span("device.put", bytes=nbytes):
                t0 = time.perf_counter()
                out, ev, refs = self._copy(tree)
                t1 = time.perf_counter()
                if ev is not None:
                    ev.synchronize()
                t2 = time.perf_counter()
        except BaseException:
            m["failures"].inc()
            telemetry.flight_dump("device-put-failure")
            raise
        if tel:
            m["transfer_us"].observe((t2 - t0) * 1e6)
            m["submit_us"].observe((t1 - t0) * 1e6)
            m["block_us"].observe((t2 - t1) * 1e6)
            telemetry.emit_span("device.put.submit", t0 * 1e6,
                                (t1 - t0) * 1e6)
            telemetry.emit_span("device.put.block", t1 * 1e6,
                                (t2 - t1) * 1e6)
        m["batches"].inc()
        m["bytes"].inc(nbytes)
        if ev is None:
            m["zc_batches"].inc()
            self._recycle_or_defer(host, refs, m)
        else:
            self.batcher.recycle(host)
        return _device_batch(host, out), ev

    def _recycle_or_defer(self, host, refs, m) -> None:
        """Park ``host``'s staging buffers, aliased by the batch being
        handed out, behind ``refs`` and recycle the parked batches whose
        tensors the consumer has dropped (the reference's
        ``_recycle_or_defer``). Without this every CPU batch would be a
        fresh allocation. A parking lot over its cap drops its oldest
        entry for real, counted in ``device_recycle_skipped``."""
        self._sweep_deferred()
        self._deferred.append((host, refs))
        if len(self._deferred) > self._deferred_cap:
            self._deferred.pop(0)
            self._recycle_skipped += 1
            m["recycle_skip"].set(self._recycle_skipped)

    def _sweep_deferred(self) -> None:
        """Recycle parked host batches whose aliasing tensors have all
        been dropped by the consumer."""
        keep = []
        for host, refs in self._deferred:
            if all(r() is None for r in refs):
                self.batcher.recycle(host)
            else:
                keep.append((host, refs))
        self._deferred = keep

    def _hand_over(self, item):
        """Make a transferred batch safe to use on the consumer's current
        stream: wait for the copy, and tell the allocator that the side-
        stream tensors are in use there. A batch without a copy event (the
        CPU's, or a ``to_device=False`` host batch) passes as it is."""
        batch, ev = item
        if ev is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(ev)
            for t in batch.tree().values():
                t.record_stream(consumer)
        return batch

    def _iter_sync(self) -> Iterator:
        """prefetch=0: parse, fill, copy and hand over on the caller's
        thread."""
        self._skip_prefix()
        while True:
            host = self._stage()
            if host is None:
                return
            item = self._device_put(host)
            self.batches_consumed += 1
            batch = self._hand_over(item)
            if self._turn_t0 is not None:
                self._end_turn()
            yield batch

    def __iter__(self) -> Iterator:
        if self._prefetch == 0:
            yield from self._iter_sync()
            return
        self._ensure_started()
        m = _get_lane_metrics()
        while True:
            # device.wait: the consumer idle because the next batch was
            # not ready yet
            t0 = time.perf_counter()
            item = self._queue.get()
            if telemetry.enabled():
                dur_us = (time.perf_counter() - t0) * 1e6
                m["wait_us"].observe(dur_us)
                telemetry.emit_span("device.wait", t0 * 1e6, dur_us)
            m["ready_q"].set(self._queue.qsize())
            if item is None or isinstance(item, BaseException):
                self._thread = None
                self._xfer_thread = None
                if item is None:
                    return
                raise item
            self.batches_consumed += 1
            batch = self._hand_over(item)
            if self._turn_t0 is not None:
                self._end_turn()
            yield batch

    # -- mid-epoch checkpoint/resume ----------------------------------------
    def state(self) -> Dict[str, Any]:
        """Resume point: batches yielded this epoch plus the determinism
        keys (uri/part/npart/fmt/batch_rows) that make it a position."""
        return dict(self._identity, batches_consumed=self.batches_consumed,
                    epoch=self._epoch)

    def restore(self, state: Dict[str, Any]) -> None:
        """Rewind to the epoch start and skip ``batches_consumed`` batches
        host-side, so iteration resumes where state() was taken. Raises if
        a determinism key disagrees with this iterator, or — at iteration
        time — if the resume point is past end-of-data."""
        for key, ours in self._identity.items():
            theirs = state.get(key, ours)
            if theirs != ours:
                raise DMLCError(
                    f"restore: checkpoint was taken with {key}={theirs!r} "
                    f"but this iterator uses {ours!r}; resuming a batch "
                    f"count across a different stream slicing would read "
                    f"the wrong rows")
        self._epoch = int(state.get("epoch", 0))
        self._reset_stream()
        self._skip_batches = int(state.get("batches_consumed", 0))
        self.batches_consumed = self._skip_batches

    def _join_threads(self) -> None:
        self._stop.set()
        for th, q in ((self._thread, self._host_q),
                      (self._xfer_thread, self._queue)):
            if th is None:
                continue
            while th.is_alive():
                try:  # drain so a blocked put can finish
                    q.get_nowait()
                except queue.Empty:
                    pass
                th.join(timeout=0.02)
        self._thread = None
        self._xfer_thread = None
        for q in (self._host_q, self._queue):
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
        # reclaim what the consumer has released; drop the rest (their
        # tensors may still read the staging memory)
        self._sweep_deferred()
        self._deferred = []
        self._stop.clear()

    def before_first(self) -> None:
        """Restart iteration as the next epoch. With telemetry on, the
        turn from here to the hand-over of the new epoch's first batch
        (the joins, the reset, the restart, the first stage and copy) is
        observed once as ``device_epoch_turn_us`` and a
        ``device.epoch_turn`` span."""
        t0 = time.perf_counter() if telemetry.enabled() else None
        self._epoch += 1
        self._reset_stream()
        self._turn_t0 = t0

    def _end_turn(self) -> None:
        """Close the epoch turn at the new epoch's first hand-over."""
        t0, self._turn_t0 = self._turn_t0, None
        dur_us = (time.perf_counter() - t0) * 1e6
        telemetry.histogram("device_epoch_turn_us").observe(dur_us)
        telemetry.emit_span("device.epoch_turn", t0 * 1e6, dur_us)

    def _reset_stream(self) -> None:
        self._join_threads()
        self.batcher.set_epoch(self._epoch)
        self.batcher.reset()
        self.batches_consumed = 0
        self._skip_batches = 0

    def bytes_read(self) -> int:
        """Bytes consumed from the source so far."""
        return self.batcher.bytes_read()

    def close(self) -> None:
        """Stop the staging threads and free native resources
        (idempotent)."""
        self._join_threads()
        self.batcher.close()

    def abort_drain(self, reason: str = "tracker-abort") -> None:
        """Abort-path teardown with a BOUNDED wall clock
        (``DMLC_DEVICE_ABORT_DRAIN_MS``, default 2000 ms): a survivor of a
        dead peer drains this pipeline and exits promptly, even if the
        transfer thread is parked in a copy it cannot finish.

        Unlike the cooperative :meth:`_join_threads`, the joins give up at
        the deadline (the threads are daemons; the process is about to
        exit). A CUDA staging buffer goes back to the pool only after its
        copy's event completed, so only the CPU's parked buffers are
        force-dropped here (once the threads joined).
        Counted in ``device_abort_drains_total``; idempotent, and
        :meth:`close` stays safe after it."""
        deadline = time.monotonic() + max(
            1, env_int("DMLC_DEVICE_ABORT_DRAIN_MS", 2000)) / 1000.0
        self._stop.set()
        joined = True
        for th, q in ((self._thread, self._host_q),
                      (self._xfer_thread, self._queue)):
            if th is None:
                continue
            while th.is_alive():
                if time.monotonic() > deadline:
                    joined = False
                    break
                try:  # drain so a blocked put can finish
                    q.get_nowait()
                except queue.Empty:
                    pass
                th.join(timeout=0.02)
        self._thread = None
        self._xfer_thread = None
        for q in (self._host_q, self._queue):
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
        if joined:
            # reclaim what the consumer released and drop the rest; a
            # straggler transfer thread may still touch the parking lot,
            # so it is left alone then
            self._sweep_deferred()
            self._deferred = []
            # only a fully stopped pipeline may rearm; a straggler thread
            # still sees _stop and exits on its own
            self._stop.clear()
        telemetry.counter("device_abort_drains_total").inc()
        telemetry.flight_dump(
            f"device-abort-drain: {reason} (threads "
            f"{'joined' if joined else 'abandoned at deadline'})")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ElasticDeviceRowBlockIter:
    """Lease data plane × device pipeline (the reference's
    ``ElasticDeviceRowBlockIter``, tpu/device_iter.py).

    Each shard the tracker grants becomes a :class:`DeviceRowBlockIter`
    over ``part=shard, npart=num_shards`` on the device, so leased shards
    flow lease → batcher → device. Yields ``(shard, device_batch)`` pairs;
    a shard's lease completes only after its last batch was yielded, so a
    consumer that dies mid-shard leaves the shard to the tracker, which
    reclaims and grants it again.

    On :class:`TrackerAbortedError` (from an acquire, or surfaced by the
    monitor mid-shard) the live pipeline is torn down through
    :meth:`DeviceRowBlockIter.abort_drain` and the error propagates.
    :meth:`abort_drain` may be called from another thread, so it fits a
    :class:`~dmlc_core_tpu_torch.parallel.elastic.StepWatchdog` drain
    list. ``device_kwargs`` go to each shard's :class:`DeviceRowBlockIter`
    (``batch_rows``, ``device``, ``to_device``, ...): with
    ``to_device=False`` the pairs carry host batches."""

    def __init__(self, uri: str, num_shards: Optional[int] = None,
                 monitor=None, epoch: int = 0,
                 acquire_timeout: Optional[float] = None,
                 **device_kwargs):
        from dmlc_core_tpu_torch.tracker.client import current_monitor
        self.uri = uri
        self._monitor = monitor if monitor is not None else current_monitor()
        if self._monitor is None:
            raise DMLCError(
                "ElasticDeviceRowBlockIter needs a heartbeat channel "
                "(rendezvous with heartbeat=True under an elastic "
                "tracker) — without leases there is no shard source")
        self.num_shards = num_shards if num_shards is not None \
            else env_int("DMLC_TRACKER_NUM_SHARDS", 0)
        if self.num_shards <= 0:
            raise DMLCError(
                "ElasticDeviceRowBlockIter: num_shards must be > 0 (set "
                "DMLC_TRACKER_NUM_SHARDS or pass num_shards=)")
        self.epoch = epoch
        self._acquire_timeout = acquire_timeout
        self._device_kwargs = device_kwargs
        self._current: Optional[DeviceRowBlockIter] = None

    def __iter__(self):
        while True:
            shard = self._monitor.acquire_lease(
                self.epoch, timeout=self._acquire_timeout)
            if shard is None:
                return  # epoch drained: every shard checked out
            it = DeviceRowBlockIter(self.uri, part=shard,
                                    npart=self.num_shards,
                                    **self._device_kwargs)
            self._current = it
            try:
                for batch in it:
                    yield shard, batch
                self._monitor.complete_lease(self.epoch, shard)
            except TrackerAbortedError:
                it.abort_drain("tracker-abort mid-shard")
                raise
            finally:
                self._current = None
                it.close()

    def abort_drain(self, reason: str = "tracker-abort") -> None:
        """Tear down the in-flight shard's pipeline with a bounded wall
        clock (:meth:`DeviceRowBlockIter.abort_drain`). Safe from a
        watchdog thread: the pipeline's stop flag and queues are
        thread-safe, and a racing consumer leaves its queue wait."""
        it = self._current
        if it is not None:
            it.abort_drain(reason)
