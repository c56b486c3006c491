"""The data mesh, the LM lane's named mesh and input-split rank math.

Port of ``data_mesh``, ``host_data_mesh``, ``process_part`` and
``local_device_count`` from ``dmlc_core_tpu/tpu/sharding.py``, plus
:class:`ProcessMesh`, the port's counterpart of the LM lane's named
``jax.sharding.Mesh``.

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
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from dmlc_core_tpu_torch.base import DMLCError, resolve_device
from dmlc_core_tpu_torch.tracker.wire import env_int_opt

__all__ = ["DataMesh", "data_mesh", "check_mesh", "process_part",
           "local_device_count", "ProcessMesh", "process_mesh",
           "host_data_mesh"]


@dataclass(frozen=True)
class DataMesh:
    """A 1-D data-parallel mesh, one device per process: the process group
    (None outside a ``torch.distributed`` world), this rank, the number of
    ranks, this rank's device and the axis's name."""

    group: Optional[Any]
    rank: int
    size: int
    device: torch.device
    axis_name: str = "data"


def data_mesh(num_devices: Optional[int] = None, axis_name: str = "data",
              device=None) -> DataMesh:
    """The mesh over every rank of the initialized world (a world of one
    outside one), with the reference's parameters in its places.
    ``num_devices`` counts the mesh's devices, one a rank: None, or the
    world's size, since a mesh over part of the world is not one device
    per rank (DMLCError). ``axis_name`` names the mesh's one axis.
    ``device`` defaults to ``cuda`` — the card ``init_from_env`` made
    current — and raises without CUDA; pass ``device="cpu"`` for the
    CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    dist = torch.distributed
    world = dist.is_available() and dist.is_initialized()
    size = dist.get_world_size() if world else 1
    if num_devices is not None and num_devices != size:
        raise DMLCError(
            f"data_mesh(num_devices={num_devices!r}): the port's mesh is one "
            f"device per rank, so it spans the whole world of {size} "
            f"rank(s); pass num_devices=None or {size}")
    if world:
        return DataMesh(group=dist.group.WORLD, rank=dist.get_rank(),
                        size=size, device=dev, axis_name=axis_name)
    return DataMesh(group=None, rank=0, size=1, device=dev,
                    axis_name=axis_name)


def check_mesh(mesh) -> None:
    """Raise unless ``mesh`` is None or a :class:`DataMesh`."""
    if mesh is not None and not isinstance(mesh, DataMesh):
        raise DMLCError(
            f"mesh must be a DataMesh from device.sharding.data_mesh() (the "
            f"port's multi-device mesh: one device per process), got "
            f"{type(mesh).__name__}")


def process_part(num_parts_per_process: int = 1) -> Tuple[int, int]:
    """(part_index, num_parts) for this process's InputSplit.
    ``num_parts_per_process`` is the reference's keyword, accepted and
    never read there either.

    Resolved in the reference's order: an initialized ``torch.distributed``
    world (its rank and size, the counterpart of the JAX process id and
    count); then the launcher's ``DMLC_TASK_ID``/``DMLC_NUM_WORKER``; then
    the MPI and slurm rank variables (the slurm count is the step-scoped
    ``SLURM_STEP_NUM_TASKS``); else (0, 1). A fully exported pair with a
    rank outside its count raises instead of mis-sharding."""
    del num_parts_per_process
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


@dataclass(frozen=True)
class ProcessMesh:
    """A named grid of ranks, one device each — the port's counterpart of
    the LM lane's ``Mesh(devices.reshape(shape), axis_names)``.

    The world is ``npart`` consecutive blocks of ``prod(shape)`` ranks;
    each block is one mesh, laid out row-major as
    ``np.arange(prod(shape)).reshape(shape)``, and stands where the
    reference has a host (``part = rank // prod(shape)``). ``groups``
    holds one process group per axis (None for an axis of size 1),
    ``group`` the whole block's (None for a block of one), and
    ``part_group`` the ranks at this rank's place in every block (None
    with one block): the cross-host reduction's group."""

    names: Tuple[str, ...]
    shape: Tuple[int, ...]
    coords: Tuple[int, ...]
    groups: Dict[str, Any]
    group: Optional[Any]
    part: int
    npart: int
    part_group: Optional[Any]
    device: torch.device

    def size(self, name: str) -> int:
        """The axis's size; 1 for an axis the mesh does not have."""
        return self.shape[self.names.index(name)] if name in self.names \
            else 1

    def index(self, name: str) -> int:
        """This rank's coordinate on the axis; 0 for a missing axis."""
        return self.coords[self.names.index(name)] if name in self.names \
            else 0

    def group_of(self, name: str):
        """The axis's process group; None for a missing axis or one of
        size 1."""
        return self.groups.get(name)


def process_mesh(axes: Sequence[Tuple[str, int]], device=None
                 ) -> ProcessMesh:
    """The named mesh ``axes`` (``(("data", 2), ("seq", 4))``) over the
    initialized world, whose size must be a multiple of the mesh's; a
    mesh of one needs no world. ``device`` defaults to ``cuda`` (the card
    ``init_from_env`` made current) and raises without CUDA.

    Every rank builds every group of every block in the same order —
    ``dist.new_group`` is a collective of the whole world — and keeps the
    ones it belongs to."""
    names = tuple(str(n) for n, _ in axes)
    shape = tuple(int(k) for _, k in axes)
    if len(set(names)) != len(names) or min(shape, default=1) < 1:
        raise DMLCError(f"bad mesh axes {list(axes)}")
    per = 1
    for k in shape:
        per *= k
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    dist = torch.distributed
    world = dist.is_available() and dist.is_initialized()
    rank, size = (dist.get_rank(), dist.get_world_size()) if world \
        else (0, 1)
    if size % per:
        raise DMLCError(f"a mesh of {per} rank(s) {dict(zip(names, shape))} "
                        f"does not divide a world of {size}")
    npart, part, local = size // per, rank // per, rank % per
    coords = tuple(int(c) for c in
                   np.unravel_index(local, shape)) if shape else ()

    def new_group(ranks):
        # every rank calls this for every group; only a group of two or
        # more ranks is made, and only its members keep it
        if len(ranks) < 2:
            return None
        g = dist.new_group(ranks=list(ranks))
        return g if rank in ranks else None

    groups: Dict[str, Any] = {}
    block_group = part_group = None
    layout = np.arange(per).reshape(shape) if shape else np.arange(1)
    for p in range(npart):
        for a, name in enumerate(names):
            lines = np.moveaxis(layout, a, -1).reshape(-1, shape[a])
            for line in lines:
                g = new_group([p * per + int(r) for r in line])
                if g is not None:
                    groups[name] = g
        g = new_group(range(p * per, (p + 1) * per))
        block_group = g if g is not None else block_group
    for j in range(per):
        g = new_group([p * per + j for p in range(npart)])
        part_group = g if g is not None else part_group
    return ProcessMesh(names=names, shape=shape, coords=coords,
                       groups=groups, group=block_group, part=part,
                       npart=npart, part_group=part_group, device=dev)


def host_data_mesh(num_devices: Optional[int] = None,
                   axis_name: str = "data", device=None) -> ProcessMesh:
    """A 1-D mesh over this PROCESS's devices only: one device, since the
    port's mesh is one device per process. Each process steps over it
    and the cross-process reduction rides the collectives
    (``parallel.allreduce_tree``), the elastic-mesh layout."""
    if num_devices is not None and num_devices < 1:
        raise DMLCError(f"num_devices must be positive, got {num_devices}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return ProcessMesh(names=(axis_name,), shape=(1,), coords=(0,),
                       groups={}, group=None, part=0, npart=1,
                       part_group=None, device=dev)
