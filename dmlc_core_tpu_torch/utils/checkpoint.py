"""Checkpoint/resume over the URI-dispatched stream layer, without JAX.

The port of ``save_checkpoint``, ``restore_checkpoint`` and
``CheckpointError`` from ``dmlc_core_tpu/utils/checkpoint.py``, with the
local and remote writers. It writes the same bytes as the reference for
the same parameters, step and ``extra``, so either package reads the
other's files: magic ``DCTCKPT1``, the step, the ``extra`` string map, then
per leaf its key, dtype string, shape and raw little-endian bytes.

The reference names leaves with ``jax.tree_util.keystr``; the port's own
flattener (:func:`flatten_with_keys`) spells keys the same way over
NamedTuples (``.w``, ``.b`` in field order), dicts (``['b']``, ``['w']``,
keys sorted), lists and tuples (``[0]``), with tensors written as
``tensor.detach().cpu().numpy()``.

Durability: a local save goes to a temp file in the same directory, is
fsync'd, then renamed over the target, so a killed save leaves the old
complete checkpoint or the new one, never a truncated file. A remote save
uploads a temp object and size-verifies it before it touches the real
key, and repairs the target from the in-memory body if its own verify
fails. Any failure cleans up and raises :class:`CheckpointError`
(counted in ``ckpt_save_failures_total``); every local file op is
injectable through ``DMLC_FS_FAULT_PLAN``.

The two-phase job checkpoints of a world (one part per rank, then a
commit marker from rank 0: ``save_job_checkpoint``,
``commit_job_checkpoint``, ``restore_job_checkpoint``) and
``fast_forward`` are the reference's too, byte for byte.
"""

from __future__ import annotations

import io
import json
import os
import random
import time
import uuid
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from dmlc_core_tpu_torch import telemetry
from dmlc_core_tpu_torch.base import DMLCError
from dmlc_core_tpu_torch.io.native import NativeStream, path_info
from dmlc_core_tpu_torch.serializer import BinaryReader, BinaryWriter
from dmlc_core_tpu_torch.tracker.wire import env_int
from dmlc_core_tpu_torch.utils import fs_fault

__all__ = ["CheckpointError", "save_checkpoint", "restore_checkpoint",
           "flatten_with_keys", "job_part_uri", "job_commit_uri",
           "save_job_checkpoint", "commit_job_checkpoint",
           "restore_job_checkpoint", "fast_forward"]

_MAGIC = b"DCTCKPT1"


class CheckpointError(DMLCError):
    """A checkpoint save/restore that failed WITHOUT corrupting state:
    the temp was cleaned up (local) or abandoned under its temp name
    (remote), the target URI still holds whatever complete checkpoint it
    held before. ``uri`` and ``phase`` ("write", "fsync", "publish",
    "verify") say where it died; ``__cause__`` carries the original
    exception."""

    def __init__(self, uri: str, phase: str, detail: str,
                 guarantee: str = "no truncated checkpoint is left "
                                  "visible under the target"):
        super().__init__(
            f"checkpoint save failed at {phase} for {uri}: {detail} "
            f"({guarantee})")
        self.uri = uri
        self.phase = phase
        self._detail = detail
        self._guarantee = guarantee

    def __reduce__(self):
        # exceptions with required extra __init__ args do not survive
        # pickle by default (unpickling calls cls(message)) — and this
        # one crosses multiprocessing boundaries in supervised training
        return (self.__class__,
                (self.uri, self.phase, self._detail, self._guarantee))


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree: Any) -> Optional[List[Tuple[str, Any]]]:
    """(key suffix, child) pairs of a container node in the reference's
    flattening order, or None for a leaf."""
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", c) for i, c in enumerate(tree)]
    return None


def _leaves_with_keys(tree: Any, prefix: str = ""
                      ) -> Iterator[Tuple[str, Any]]:
    if tree is None:  # an empty subtree, as in the reference
        return
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for suffix, child in kids:
        yield from _leaves_with_keys(child, prefix + suffix)


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def flatten_with_keys(params: Any) -> List[Tuple[str, np.ndarray]]:
    """``[(key, numpy leaf)]`` in the order and with the key spellings of
    the reference's ``jax.tree_util.tree_flatten_with_path`` +
    ``keystr``."""
    return [(key, _to_numpy(leaf))
            for key, leaf in _leaves_with_keys(params)]


def _rebuild(tree: Any, leaves: Iterator[Any]) -> Any:
    """``tree``'s structure with its leaves taken from ``leaves`` in
    flattening order."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return next(leaves)
    if _is_namedtuple(tree):
        return type(tree)(*[_rebuild(c, leaves) for _, c in kids])
    if isinstance(tree, dict):
        built = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return type(tree)((k, built[k]) for k in tree)
    return type(tree)(_rebuild(c, leaves) for _, c in kids)


def _numpy_dtype(tmpl: Any) -> np.dtype:
    if isinstance(tmpl, torch.Tensor):
        name = str(tmpl.dtype).replace("torch.", "")
        try:
            return np.dtype(name)
        except TypeError:
            raise DMLCError(f"template dtype {tmpl.dtype} has no numpy "
                            "counterpart a checkpoint can hold")
    return np.dtype(getattr(tmpl, "dtype", type(tmpl)))


def _local_path(uri: str) -> Optional[str]:
    """The filesystem path for a local URI, else None. `file://` and
    scheme-less paths are local; everything with another scheme (s3://,
    hdfs://, azure://, http(s)://...) is remote."""
    if uri.startswith("file://"):
        return uri[len("file://"):]
    if "://" not in uri:
        return uri
    return None


class _InjectedStream:
    """Routes every write through the Python fault plan (fs_fault
    checked_write) — how the chaos gauntlet provokes ENOSPC/EIO/short
    writes inside the body write without a sick disk. A passthrough when
    no plan is installed."""

    __slots__ = ("_inner", "_path")

    def __init__(self, inner, path: str):
        self._inner = inner
        self._path = path

    def write(self, data: bytes):
        fs_fault.checked_write(self._inner.write, data, self._path)


def _write_body(stream, params: Any, step: int,
                extra: Optional[Dict[str, str]]) -> None:
    flat = flatten_with_keys(params)
    # stream leaf-by-leaf: peak extra memory is O(largest leaf), not
    # O(model) — the BinaryWriter only needs .write, which NativeStream has
    w = BinaryWriter(stream)
    w.write_bytes(_MAGIC)
    w.write_scalar(step, "int64")
    w.write_str_map(extra or {})
    w.write_scalar(len(flat), "int64")
    for key, arr in flat:
        w.write_string(key)
        w.write_string(str(arr.dtype))
        w.write_scalar(arr.ndim, "int32")
        for d in arr.shape:
            w.write_scalar(int(d), "int64")
        w.write_bytes(arr.tobytes())


def _stat_sig(path: str):
    """(inode, size, mtime_ns) of `path`, or None when absent — the
    did-the-failed-rename-actually-touch-the-target probe."""
    try:
        st = os.stat(path)
        return (st.st_ino, st.st_size, st.st_mtime_ns)
    except OSError:
        return None


def _is_complete_body(path: str) -> bool:
    """Structurally walk a local checkpoint file: magic, header, every
    declared leaf present in full. The post-failed-publish probe that
    distinguishes 'the previous complete checkpoint' (keep) from 'a torn
    half-copy' (delete) — a truncated body parses short and returns
    False, it never raises. Plain built-in I/O on purpose: the probe runs
    on the failure path and must not draw further injected faults."""
    try:
        with open(path, "rb") as f:
            r = BinaryReader(f)
            if r.read_bytes() != _MAGIC:
                return False
            r.read_scalar("int64")
            r.read_str_map()
            n = int(r.read_scalar("int64"))
            if not 0 <= n < 1 << 32:
                return False
            for _ in range(n):
                r.read_string()
                r.read_string()
                ndim = int(r.read_scalar("int32"))
                if not 0 <= ndim < 256:
                    return False
                for _ in range(ndim):
                    r.read_scalar("int64")
                r.read_bytes()
            return True
    except Exception:
        return False


def _ckpt_fail(uri: str, phase: str, exc: Exception,
               guarantee: Optional[str] = None) -> CheckpointError:
    telemetry.counter("ckpt_save_failures_total").inc()
    if guarantee is None:
        return CheckpointError(uri, phase, str(exc))
    return CheckpointError(uri, phase, str(exc), guarantee)


def _save_local(uri: str, path: str, params: Any, step: int,
                extra: Optional[Dict[str, str]]) -> None:
    # same directory (rename() stays within one fs); unique per pid AND
    # per call — a periodic-checkpoint thread racing a shutdown save in
    # the same process must not interleave bodies into one temp file
    tmp = f"{path}.tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}"
    phase = "write"
    try:
        fs_fault.maybe_inject("open", tmp)
        with NativeStream(tmp, "w") as s:
            _write_body(_InjectedStream(s, tmp), params, step, extra)
        phase = "fsync"
        fd = os.open(tmp, os.O_RDONLY)
        try:
            fs_fault.checked_fsync(fd, tmp)
        finally:
            os.close(fd)
        phase = "publish"
        # fingerprint the target BEFORE the rename: a failed-but-ATOMIC
        # replace (plain EIO) leaves it byte-for-byte untouched, and the
        # cleanup below must never delete a pre-existing file — whatever
        # its format — that this save did not modify
        target_before = _stat_sig(path)
        fs_fault.checked_replace(tmp, path)
    except BaseException as e:
        # a failed/interrupted save must not leave temp litter that a
        # later glob of the checkpoint dir would pick up — and must not
        # leave a torn body visible under the TARGET either (an injected/
        # real non-atomic rename can land a half-copy there before dying)
        try:
            os.unlink(tmp)
        except OSError:
            pass
        if phase == "publish" and _stat_sig(path) != target_before and \
                os.path.exists(path) and not _is_complete_body(path):
            # the target CHANGED during this save's failed rename and is
            # not a complete body: that is the torn half-copy artifact
            # (non-atomic filesystem crash shape; injected torn_rename
            # reproduces it) — a truncated checkpoint must never stay
            # visible. An UNCHANGED target (previous checkpoint, or any
            # foreign file an atomic-but-failed rename never touched) is
            # left strictly alone.
            try:
                os.unlink(path)
            except OSError:
                pass
        if isinstance(e, Exception):
            raise _ckpt_fail(uri, phase, e) from e
        raise  # KeyboardInterrupt/SystemExit: cleaned up, not rewrapped
    # best-effort directory fsync so the rename itself survives a crash
    try:
        dfd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass


def _put_verified(uri: str, body: bytes) -> None:
    """Upload one object and verify the stored size matches — a PUT that
    'succeeded' but landed short must fail the attempt, not become a
    trusted checkpoint."""
    with NativeStream(uri, "w") as s:
        s.write(body)
    size, _is_dir = path_info(uri)
    if size != len(body):
        raise DMLCError(
            f"checkpoint object size mismatch for {uri}: stored {size} "
            f"vs written {len(body)}")


def _save_remote(uri: str, params: Any, step: int,
                 extra: Optional[Dict[str, str]]) -> None:
    # Serialize once; the retry loop re-uploads bytes, never re-flattens
    # (the training step may replace the parameters meanwhile).
    buf = io.BytesIO()
    _write_body(buf, params, step, extra)
    body = buf.getvalue()
    # object-level retry budget; transport-level retries already happen
    # inside the native client (cpp/src/retry.h) — this loop covers
    # whole-object verification failures on top. Clamped (the CheckedEnvInt
    # lo/hi rule): a negative value must not silently skip the save.
    max_retry = max(0, min(env_int("DMLC_CKPT_MAX_RETRY", 3), 100))
    base_ms = max(1, min(env_int("DMLC_IO_BACKOFF_BASE_MS", 100),
                         24 * 3600 * 1000))
    # temp key stable per WRITER PROCESS, not per call: periodic
    # checkpointing must not leak one orphan key per save (no DELETE
    # verb exists to reclaim them — the tombstone only empties the
    # body), and the single-writer checkpoint pattern makes pid
    # uniqueness sufficient
    tmp = f"{uri}.tmp.{os.getpid()}"
    prev_ms = max(base_ms, 1)
    last: Optional[Exception] = None
    touched_target = False

    def tombstone():
        try:
            # no DELETE verb in the fs layer: tombstone the temp to
            # zero bytes so it cannot be mistaken for a checkpoint
            with NativeStream(tmp, "w") as s:
                s.write(b"")
        except (DMLCError, OSError):
            pass  # cleanup is best-effort; the save is already good

    for attempt in range(max_retry + 1):
        if attempt:
            # decorrelated jitter, the retry.h shape
            sleep_ms = min(10000, random.uniform(base_ms, prev_ms * 3))
            prev_ms = max(sleep_ms, base_ms)
            time.sleep(sleep_ms / 1000.0)
        try:
            # temp object first: prove the upload path delivers intact
            # bytes BEFORE touching the real key, so a sick endpoint can
            # never leave a short object under the trusted name without
            # first demonstrating it CAN deliver this body intact
            _put_verified(tmp, body)
            touched_target = True
            _put_verified(uri, body)
            tombstone()
            return
        except (DMLCError, OSError) as e:
            last = e
    # retries exhausted. A failed target PUT may have left a SHORT object
    # under the trusted key (object stores overwrite in place — there is
    # no rename to make this atomic): repair from the in-memory bytes
    # before raising, and say so honestly when even that fails.
    if touched_target:
        try:
            _put_verified(uri, body)
            tombstone()
            return  # the repair IS a verified save — the target is good
        except (DMLCError, OSError) as e:
            last = e
        raise _ckpt_fail(
            uri, "verify", last,
            guarantee="WARNING: the target object may hold a partial "
                      "body — remote stores overwrite in place; restore "
                      "from an earlier checkpoint or re-save") from last
    raise _ckpt_fail(uri, "verify", last) from last


def save_checkpoint(uri: str, params: Any, step: int = 0,
                    extra: Optional[Dict[str, str]] = None) -> None:
    """Write a parameter-tree checkpoint to any stream URI, atomically.

    Local URIs (plain paths and ``file://``): temp name in the same
    directory, fsync, then rename over the target — a worker killed
    mid-checkpoint (exactly what the liveness layer's supervisor does,
    doc/robustness.md) leaves either the old complete checkpoint or the
    new complete one, never a truncated file that restore_checkpoint then
    trusts. Remote URIs (s3://, azure://, hdfs://, http(s)://): the body
    is uploaded to a temp OBJECT and size-verified, then uploaded to the
    target and size-verified again, with an object-level retry loop
    (DMLC_CKPT_MAX_RETRY, default 3) over the native transport retries —
    a short PUT can never quietly become the trusted checkpoint (on
    verify-exhaustion the target is repaired from the in-memory body;
    if even that fails, the error warns the target may hold a partial
    object — stores overwrite in place, there is no remote rename).

    Any failure cleans up and raises :class:`CheckpointError` (counted in
    ``ckpt_save_failures_total``)."""
    path = _local_path(uri)
    if path is None:
        _save_remote(uri, params, step, extra)
        return
    _save_local(uri, path, params, step, extra)


def _read_all(uri: str) -> bytes:
    with NativeStream(uri, "r") as s:
        return s.read_all()


def restore_checkpoint(uri: str, like: Any = None
                       ) -> Tuple[Any, int, Dict[str, str]]:
    """Read a checkpoint; returns (params, step, extra).

    With ``like`` (a template: NamedTuple, dict, list or tuple of tensors
    or arrays), leaves are matched by position, their keys, shapes and
    dtypes checked, and the template's structure returned with each
    tensor leaf on its template's device (numpy leaves stay numpy).
    Without it, a ``{key: np.ndarray}`` dict is returned.
    """
    buf = io.BytesIO(_read_all(uri))
    r = BinaryReader(buf)
    if r.read_bytes() != _MAGIC:
        raise DMLCError(f"not a dmlc_core_tpu checkpoint: {uri}")
    step = int(r.read_scalar("int64"))
    extra = r.read_str_map()
    n = int(r.read_scalar("int64"))
    flat: Dict[str, np.ndarray] = {}
    order = []
    for _ in range(n):
        key = r.read_string()
        dtype = r.read_string()
        ndim = int(r.read_scalar("int32"))
        shape = tuple(int(r.read_scalar("int64")) for _ in range(ndim))
        raw = r.read_bytes()
        # copy: frombuffer views over bytes are read-only
        arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()
        flat[key] = arr
        order.append(key)
    if like is None:
        return flat, step, extra

    like_flat = list(_leaves_with_keys(like))
    paths = [k for k, _ in like_flat]
    if paths != order:
        raise DMLCError(
            "checkpoint tree does not match template: "
            f"{order[:3]}... vs {paths[:3]}...")
    leaves = []
    for (key, tmpl) in like_flat:
        arr = flat[key]
        if tuple(np.shape(tmpl)) != arr.shape:
            raise DMLCError(
                f"shape mismatch at {key}: checkpoint {arr.shape} vs "
                f"template {tuple(np.shape(tmpl))}")
        tmpl_dtype = _numpy_dtype(tmpl)
        if tmpl_dtype != arr.dtype:
            raise DMLCError(
                f"dtype mismatch at {key}: checkpoint {arr.dtype} vs "
                f"template {tmpl_dtype} (a silent cast would change the "
                f"model)")
        leaves.append(torch.from_numpy(arr).to(tmpl.device)
                      if isinstance(tmpl, torch.Tensor) else arr)
    return _rebuild(like, iter(leaves)), step, extra


# -- two-phase job checkpoints ------------------------------------------------
# One checkpoint per rank of a world is not atomic as a set: a kill between
# the ranks' saves leaves a mixed-step set that resumes a silently
# diverging world. The two phases make the job checkpoint atomic:
#
#   phase 1  every rank publishes `<base>.step<N>.part<k>of<n>` through the
#            atomic per-file path above (save_job_checkpoint);
#   phase 2  rank 0 checks every part of step N is complete, then
#            atomically publishes `<base>.commit`, a small JSON marker
#            naming the step and the whole part set (commit_job_checkpoint).
#
# restore_job_checkpoint trusts ONLY the marker: parts newer than the
# committed step are invisible, a part the marker names but that is missing
# or truncated is a loud error, and no marker means a fresh start. The
# parts and the marker are the reference's bytes.

_JOB_SCHEMA = 1


def job_part_uri(base: str, step: int, part: int, npart: int) -> str:
    """The per-rank part URI of job step ``step``: step-qualified, so a
    later step's save never overwrites a committed step's bytes."""
    return f"{base}.step{int(step)}.part{int(part)}of{int(npart)}"


def job_commit_uri(base: str) -> str:
    """The job's commit-marker URI (one per job; overwritten atomically)."""
    return f"{base}.commit"


def save_job_checkpoint(base: str, params: Any, step: int, part: int,
                        npart: int,
                        extra: Optional[Dict[str, str]] = None) -> str:
    """Phase 1: publish this rank's part of job step ``step`` atomically.
    Returns the part URI. The step is not resumable until rank 0 runs
    :func:`commit_job_checkpoint`."""
    uri = job_part_uri(base, step, part, npart)
    save_checkpoint(uri, params, step=step, extra=extra)
    return uri


def _part_is_complete(uri: str) -> bool:
    """True when the part holds a structurally complete checkpoint: local
    parts are walked byte for byte, remote ones were size-verified by
    their own save, so presence with a plausible size is the check."""
    path = _local_path(uri)
    if path is not None:
        return _is_complete_body(path)
    try:
        size, is_dir = path_info(uri)
        return not is_dir and size > len(_MAGIC)
    except (DMLCError, OSError):
        return False


def commit_job_checkpoint(base: str, step: int, npart: int) -> str:
    """Phase 2 (rank 0 only): check that every part of ``step`` is
    complete, then atomically publish the commit marker naming the set.

    Raises :class:`CheckpointError`, with the previous marker untouched,
    when a part is missing or truncated: committing a torn set is the
    mixed-step resume this protocol exists to prevent."""
    parts = [job_part_uri(base, step, p, npart) for p in range(npart)]
    for uri in parts:
        if not _part_is_complete(uri):
            raise _ckpt_fail(
                job_commit_uri(base), "commit",
                DMLCError(f"part {uri} is missing or incomplete; refusing "
                          f"to commit a torn step-{step} set"),
                guarantee="the previous commit marker is untouched — "
                          "restore still resumes the last committed step")
    body = json.dumps({"schema": _JOB_SCHEMA, "step": int(step),
                       "npart": int(npart), "parts": parts},
                      sort_keys=True).encode()
    marker = job_commit_uri(base)
    path = _local_path(marker)
    if path is None:
        try:
            _put_verified(marker, body)
        except (DMLCError, OSError) as e:
            raise _ckpt_fail(marker, "commit", e) from e
        return marker
    # the local save's temp + fsync + rename, for a JSON body
    tmp = f"{path}.tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}"
    try:
        fs_fault.maybe_inject("open", tmp)
        with open(tmp, "wb") as f:
            fs_fault.checked_write(f.write, body, tmp)
            f.flush()
            fs_fault.checked_fsync(f.fileno(), tmp)
        fs_fault.checked_replace(tmp, path)
    except BaseException as e:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        if isinstance(e, Exception):
            raise _ckpt_fail(marker, "commit", e) from e
        raise
    try:
        dfd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass
    return marker


def restore_job_checkpoint(base: str, part: int, npart: int,
                           like: Any = None
                           ) -> Optional[Tuple[Any, int, Dict[str, str]]]:
    """Restore this rank's part of the last COMMITTED job step: (params,
    step, extra), or None when no commit marker exists (a fresh start).

    Parts published after the committed step are ignored. Raises when the
    marker was committed by another number of ranks (their parts slice the
    stream differently), when a committed part is missing or corrupt, or
    when the part's recorded step disagrees with the marker."""
    marker = job_commit_uri(base)
    try:
        raw = _read_all(marker)
    except (DMLCError, OSError):
        return None
    try:
        meta = json.loads(raw.decode())
        step = int(meta["step"])
        m_npart = int(meta["npart"])
        parts = list(meta["parts"])
    except (ValueError, KeyError, TypeError) as e:
        raise DMLCError(f"corrupt job commit marker {marker}: {e}") from e
    if m_npart != int(npart) or len(parts) != m_npart:
        raise DMLCError(
            f"job checkpoint {marker} was committed by {m_npart} rank(s) "
            f"but this world has {npart}: the per-part streams do not line "
            f"up; start fresh or restore with the original world size")
    if not 0 <= int(part) < m_npart:
        raise DMLCError(f"part {part} out of range for {marker} "
                        f"({m_npart} parts)")
    params, got_step, extra = restore_checkpoint(parts[int(part)],
                                                 like=like)
    if got_step != step:
        raise DMLCError(
            f"job commit marker {marker} names step {step} but part "
            f"{parts[int(part)]} holds step {got_step}: the marker and the "
            f"part set disagree; refusing a mixed-step resume")
    return params, step, extra


def fast_forward(iterator: Iterable, n_batches: int) -> Iterator:
    """Skip ``n_batches`` from a deterministic-order batch iterator (a
    mid-epoch data resume); returns the advanced iterator. It pulls the
    skipped batches through the whole pipeline; ``DeviceRowBlockIter``'s
    ``state()``/``restore()`` skip them on the staging thread instead.

    Raises :class:`DMLCError` when the iterator runs dry first: a resume
    point past the end of the data means the checkpoint and the stream
    disagree, and yielding nothing would hide it."""
    it = iter(iterator)
    sentinel = object()
    for skipped in range(n_batches):
        if next(it, sentinel) is sentinel:
            raise DMLCError(
                f"fast_forward: iterator exhausted after {skipped} of "
                f"{n_batches} batches; checkpoint resume point is past "
                f"end-of-data")
    return it
