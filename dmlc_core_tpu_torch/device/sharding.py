"""The data mesh and input-split rank math for the device path.

Port of ``data_mesh``, ``process_part`` and ``local_device_count`` from
``dmlc_core_tpu/tpu/sharding.py``.

The port's mesh is ONE DEVICE PER PROCESS. The reference's mesh spans the
devices of its processes, and a batch carries a device axis of D shards,
one per device; here each rank of a ``torch.distributed`` world owns one
device, so a batch's device axis stays D = 1 on every rank and the
reference's D-device in-process mesh maps onto D ranks. The learners take
the mesh as ``mesh=`` and reduce each step over its process group; the
iterator takes it to split the global ``batch_rows`` over its ranks.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch

from dmlc_core_tpu_torch.base import DMLCError, resolve_device
from dmlc_core_tpu_torch.tracker.wire import env_int_opt

__all__ = ["DataMesh", "data_mesh", "check_mesh", "process_part",
           "local_device_count"]


@dataclass(frozen=True)
class DataMesh:
    """A 1-D data-parallel mesh, one device per process: the process group
    (None outside a ``torch.distributed`` world), this rank, the number of
    ranks, and this rank's device."""

    group: Optional[Any]
    rank: int
    size: int
    device: torch.device


def data_mesh(device=None) -> DataMesh:
    """The mesh over every rank of the initialized world (a world of one
    outside one). ``device`` defaults to ``cuda`` — the card
    ``init_from_env`` made current — and raises without CUDA; pass
    ``device="cpu"`` for the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return DataMesh(group=dist.group.WORLD, rank=dist.get_rank(),
                        size=dist.get_world_size(), device=dev)
    return DataMesh(group=None, rank=0, size=1, device=dev)


def check_mesh(mesh) -> None:
    """Raise unless ``mesh`` is None or a :class:`DataMesh`."""
    if mesh is not None and not isinstance(mesh, DataMesh):
        raise DMLCError(
            f"mesh must be a DataMesh from device.sharding.data_mesh() (the "
            f"port's multi-device mesh: one device per process), got "
            f"{type(mesh).__name__}")


def process_part() -> Tuple[int, int]:
    """(part_index, num_parts) for this process's InputSplit.

    Resolved in the reference's order: an initialized ``torch.distributed``
    world (its rank and size, the counterpart of the JAX process id and
    count); then the launcher's ``DMLC_TASK_ID``/``DMLC_NUM_WORKER``; then
    the MPI and slurm rank variables (the slurm count is the step-scoped
    ``SLURM_STEP_NUM_TASKS``); else (0, 1). A fully exported pair with a
    rank outside its count raises instead of mis-sharding."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() and \
            dist.get_world_size() > 1:
        return dist.get_rank(), dist.get_world_size()
    if os.environ.get("DMLC_ROLE", "worker") != "worker":
        return 0, 1  # servers/schedulers are not data consumers
    for rank_var, count_var in (
            ("DMLC_TASK_ID", "DMLC_NUM_WORKER"),
            ("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE"),
            ("PMI_RANK", "PMI_SIZE"),
            ("SLURM_PROCID", "SLURM_STEP_NUM_TASKS")):
        if rank_var not in os.environ or count_var not in os.environ:
            continue
        npart = env_int_opt(count_var)
        if npart <= 1:
            continue
        part = env_int_opt(rank_var)
        if not 0 <= part < npart:
            raise ValueError(
                f"{rank_var}={part} out of range for {count_var}={npart}")
        return part, npart
    return 0, 1


def local_device_count(mesh: Optional[DataMesh] = None) -> int:
    """Devices a batch is split over in this process: 1 for every rank (the
    port's mesh is one device per process)."""
    del mesh
    return 1
