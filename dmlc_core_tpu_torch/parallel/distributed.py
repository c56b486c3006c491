"""Multi-process initialization and Rabit-style collectives (port of
``dmlc_core_tpu/parallel/distributed.py``).

A job calls :func:`init_from_env` once per process. It reads the
launchers' env protocol in the reference's order — the
``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``
trio of the pod launcher, then ``DMLC_COORDINATOR_ADDRESS`` /
``DMLC_NUM_WORKER`` / ``DMLC_TASK_ID`` — and starts a
``torch.distributed`` world on that address (``tcp://host:port``; rank 0
hosts the rendezvous store there). Without either, the job is one process.

Backends: ``nccl`` when the device is CUDA, ``gloo`` on the CPU. An
explicit ``backend="gloo"`` on CUDA lets several ranks share one card,
which NCCL refuses. Nothing switches backends on its own: an NCCL world
that fails to start is an error.

The Rabit surface (``rank``, ``world_size``, ``allreduce``,
``allreduce_tree``, ``allgather_bytes``, ``barrier``, ``broadcast``)
returns what the reference's returns, torch tensors where the reference
returns jax arrays, and is the identity in a one-process world. A
collective's buffer lives where the backend wants it: on the CPU for gloo
(gloo stages CUDA tensors through the host anyway), on this rank's card
for NCCL; results come back on the caller's device. Every process must
issue the same collectives in the same order (the Rabit contract).
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from dmlc_core_tpu_torch.base import DMLCError, resolve_device
from dmlc_core_tpu_torch.tracker.wire import env_int, env_int_opt
from dmlc_core_tpu_torch.utils.checkpoint import _leaves_with_keys, _rebuild

__all__ = ["init_from_env", "allreduce", "allreduce_tree", "allgather_bytes",
           "barrier", "broadcast", "rank", "world_size", "allreduce_sum_",
           "shutdown"]

logger = logging.getLogger("dmlc_core_tpu_torch.parallel")

_OPS = ("sum", "max", "min", "mean")


def _collective_timeout() -> datetime.timedelta:
    # generous on purpose, as in the reference: it only backstops a lost
    # peer; every spawned world in the tests carries a shorter one of its
    # own
    return datetime.timedelta(
        milliseconds=env_int("DMLC_COLLECTIVE_TIMEOUT_MS", 600000))


def _world_env():
    """(address, size, rank, the variables they came from), or None for a
    one-process job. A set but invalid count or rank raises, naming the
    variable, instead of degrading this rank to a world of its own."""
    if os.getenv("JAX_COORDINATOR_ADDRESS"):
        names = ("JAX_NUM_PROCESSES", "JAX_PROCESS_ID")
        addr = os.environ["JAX_COORDINATOR_ADDRESS"]
        nproc, pid = (env_int_opt(n) for n in names)
        for name, value in zip(names, (nproc, pid)):
            if value is None:
                raise DMLCError(
                    f"JAX_COORDINATOR_ADDRESS={addr!r} is exported but "
                    f"{name} is not: a torch.distributed world needs the "
                    f"process count and this process's id")
    else:
        # the coordinator address must be exported explicitly:
        # DMLC_TRACKER_URI is the submit machine, which hosts no world
        addr = os.getenv("DMLC_COORDINATOR_ADDRESS")
        if not addr:
            return None
        names = ("DMLC_NUM_WORKER", "DMLC_TASK_ID")
        # parsed only with the coordinator exported: garbage in these
        # must not kill a run that never takes this path
        nproc, pid = (env_int_opt(n) for n in names)
        if nproc is None or pid is None:
            return None
    if nproc < 1 or not 0 <= pid < nproc:
        raise DMLCError(f"{names[1]}={pid} out of range for "
                        f"{names[0]}={nproc}")
    return addr, nproc, pid, names


def init_from_env(device=None, backend: Optional[str] = None) -> None:
    """Start this process's ``torch.distributed`` world from the launcher
    env protocol (see the module docstring); a one-process job logs the
    reference's line and returns. ``device`` picks the default backend
    (``nccl`` for CUDA, ``gloo`` otherwise) and, on CUDA, the card: an
    explicit index, else ``rank % device_count``. ``backend`` overrides
    the choice (``"gloo"`` to share one card between ranks). A second call
    in an initialized world does nothing."""
    env = _world_env()
    if env is None:
        logger.info("init_from_env: no launcher env found; single-process "
                    "mode (export JAX_COORDINATOR_ADDRESS or "
                    "DMLC_COORDINATOR_ADDRESS)")
        return
    if dist.is_initialized():
        return
    addr, nproc, pid, _ = env
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise DMLCError(f"backend must be 'nccl' or 'gloo', got "
                        f"{backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise DMLCError(f"the nccl backend needs a CUDA device, got {dev}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else pid % torch.cuda.device_count())
    dist.init_process_group(backend=backend, init_method=f"tcp://{addr}",
                            world_size=nproc, rank=pid,
                            timeout=_collective_timeout())


def shutdown() -> None:
    """Leave the world (``destroy_process_group``); a no-op outside one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def rank() -> int:
    """This process's index (Rabit GetRank equivalent)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """Number of processes in the job (Rabit GetWorldSize equivalent)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _comm_device(group=None) -> torch.device:
    """Where a collective's buffer lives: this rank's card under NCCL, the
    host under gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def allreduce_sum_(buf: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``buf`` over the world in place with ONE ``all_reduce`` (the
    data-parallel step's reduction); under gloo the buffer goes through a
    host copy, once each way. Every rank ends with the same bits."""
    comm = _comm_device(group)
    if buf.device == comm:
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        return buf
    staged = buf.to(comm)
    dist.all_reduce(staged, op=dist.ReduceOp.SUM, group=group)
    return buf.copy_(staged)


def allgather_bytes(payload: bytes, name: str = "ag") -> List[bytes]:
    """All-gather one bytes payload per process; returns the rank-ordered
    list on every process. Two collectives: the lengths, then the payloads
    padded to the longest. ``name`` is the reference's KV-key tag, kept
    for its signature."""
    del name
    n = world_size()
    if n == 1:
        return [payload]
    comm = _comm_device()
    size = torch.tensor([len(payload)], dtype=torch.int64, device=comm)
    sizes = [torch.empty_like(size) for _ in range(n)]
    dist.all_gather(sizes, size)
    lengths = [int(s) for s in sizes]
    if max(lengths) == 0:
        return [b""] * n
    host = np.zeros(max(lengths), np.uint8)
    host[:len(payload)] = np.frombuffer(payload, np.uint8)
    buf = torch.from_numpy(host).to(comm)
    bufs = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(bufs, buf)
    return [b[:k].cpu().numpy().tobytes() for b, k in zip(bufs, lengths)]


def barrier(name: str = "barrier") -> None:
    """Block until every process arrives. ``name`` is the reference's tag,
    kept for its signature."""
    del name
    if world_size() > 1:
        dist.barrier()


def allreduce(x, op: str = "sum") -> torch.Tensor:
    """Rabit-equivalent Allreduce: each process contributes one value; the
    elementwise reduction comes back on every process, on the input's
    device. As the reference on its host transport, the values ride one
    packed all-gather (:func:`allgather_bytes`) and every rank reduces the
    rank-ordered stack with numpy (``_reduce_stack``), so sums and means
    are the same bits for any number of ranks and any backend (``mean``
    of integers is float64, numpy's mean). A one-process job returns the
    input as a tensor."""
    if op not in _OPS:
        raise ValueError(f"op must be one of {_OPS}")
    t = torch.as_tensor(x)
    if world_size() == 1:
        return t
    arr = _host_array(t)
    blobs = allgather_bytes(arr.tobytes(), name="ar")
    stack = np.stack([np.frombuffer(b, dtype=arr.dtype).reshape(arr.shape)
                      for b in blobs])
    # np.array keeps a 0-d result 0-d (ascontiguousarray would not)
    return torch.from_numpy(np.array(_reduce_stack(stack, op))).to(t.device)


def _reduce_stack(stack: np.ndarray, op: str) -> np.ndarray:
    if op == "sum":
        return np.sum(stack, axis=0)
    if op == "mean":
        return np.mean(stack, axis=0)
    if op == "max":
        return np.max(stack, axis=0)
    return np.min(stack, axis=0)


def _host_array(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def allreduce_tree(tree: Any, op: str = "mean") -> Any:
    """Elementwise cross-process reduction of a whole tree (NamedTuple,
    dict, list, tuple) in ONE collective: the leaves' bytes ride a single
    packed all-gather and are reduced on the host in RANK ORDER, so the
    result is bit-deterministic across runs, as in the reference. Tensor
    leaves come back as tensors on their device and dtype; other leaves
    come back as numpy."""
    if op not in _OPS:
        raise ValueError(f"op must be one of {_OPS}")
    n = world_size()
    if n == 1:
        return tree
    leaves = [leaf for _, leaf in _leaves_with_keys(tree)]
    arrays = [_host_array(leaf) for leaf in leaves]
    payload = b"".join(a.tobytes() for a in arrays)
    comm = _comm_device()
    packed = torch.from_numpy(np.frombuffer(payload, np.uint8).copy()).to(
        comm)
    gathered = [torch.empty_like(packed) for _ in range(n)]
    dist.all_gather(gathered, packed)
    blobs = [g.cpu().numpy().tobytes() for g in gathered]
    out, offset = [], 0
    for leaf, arr in zip(leaves, arrays):
        nb = arr.nbytes
        stack = np.stack([np.frombuffer(b[offset:offset + nb],
                                        dtype=arr.dtype).reshape(arr.shape)
                          for b in blobs])
        offset += nb
        red = _reduce_stack(stack, op).astype(arr.dtype, copy=False)
        out.append(torch.from_numpy(np.ascontiguousarray(red)).to(
            leaf.device) if isinstance(leaf, torch.Tensor) else red)
    return _rebuild(tree, iter(out))


def broadcast(x, root: int = 0) -> torch.Tensor:
    """Replicate root's value to every process (Rabit Broadcast), on the
    input's device. Every rank passes a value of the same shape and dtype.
    A one-process job returns the input as a tensor."""
    t = torch.as_tensor(x)
    if world_size() == 1:
        return t
    work = t.detach().to(_comm_device()).reshape(-1).clone()
    dist.broadcast(work, src=root)
    return work.reshape(t.shape).to(t.device)
