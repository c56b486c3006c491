"""Input-split rank math for the device path (single device).

Port of ``process_part`` and ``local_device_count`` from
``dmlc_core_tpu/tpu/sharding.py``. This slice runs on one device; a mesh
is refused by name (ROADMAP.md queue 1, "Multi-process data parallelism
via torch.distributed").
"""

from __future__ import annotations

import os
from typing import Tuple

import torch

from dmlc_core_tpu_torch.base import DMLCError
from dmlc_core_tpu_torch.tracker.wire import env_int_opt

__all__ = ["process_part", "local_device_count", "refuse_mesh"]


def refuse_mesh(mesh) -> None:
    """Raise unless ``mesh`` is None: the port runs on one device until the
    multi-device slice lands."""
    if mesh is not None:
        raise DMLCError(
            "the port runs on one device; a mesh needs the multi-device "
            "slice (ROADMAP.md queue 1, 'Multi-process data parallelism "
            "via torch.distributed')")


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


def local_device_count(mesh=None) -> int:
    """Devices a batch is split over: 1 until the multi-device slice."""
    refuse_mesh(mesh)
    return 1
