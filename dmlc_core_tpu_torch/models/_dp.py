"""Shared data-parallel step harness for the margin models (port of
``models/_dp.py``).

A step unpacks the batch's one shard and takes the local loss sum, weight
sum and gradients with autograd. Without a mesh it divides by
``max(weight_sum, 1)`` and applies the model's update. With a mesh (a
``DataMesh``: one device per rank) every rank packs (loss_sum, wsum, the
number of ranks that had a batch, the gradients in the params' field
order) into ONE flat float32 buffer, sums it over the world with ONE
``all_reduce`` — the reference's psum over its mesh, the Rabit allreduce
equivalent — and applies the same update to the same reduced bits, so the
ranks' parameters stay bit-identical. The update uses the global weight
sum, so a world steps exactly as one process on the union of its shards
does: the reference's mesh branch, which steps with D times the learning
rate on a mesh of D devices, is not copied (ROADMAP.md section 3).

A batch with numpy leaves (``to_device=False``) is first copied to the
parameters' device (:func:`device_iter.to_device_batch`), as JAX places
numpy leaves on its own; the math never runs on the host for a model on
the card.

A rank whose part has no batch left steps with ``batch=None``: it adds
zeros (loss, weight, gradients) to the reduction, so the ranks issue the
same collectives and the global mean stays the mean over real rows. When
no rank had a batch the step applies nothing and :attr:`last_active` is
0, which ends the epoch everywhere at once.

With telemetry on (:func:`telemetry.enabled`), a step observes
``step_host_us``, the caller's thread issuing it, and its phases
``step_forward_us`` (``_shard_loss``), ``step_backward_us``
(``torch.autograd.grad``), ``step_reduce_us`` (``_reduce``, with a mesh
only) and ``step_update_us`` (``_apply``). A phase is stream time between
two markers: ``time.perf_counter()`` on the CPU, where ops run
synchronously, and on CUDA timing events recorded on the current stream
and read once done, never waited for (:class:`_PhaseTimer`). Stream time is
the card's time only where the card sets the pace; where the host does,
it reads the host's launch pace. While a profiler records, the step and
its phases also run inside the ``record_function`` ranges ``dct.step``
and ``dct.step.<phase>``. A model may also time nested spans of its own
(:attr:`DataParallelModel._SPANS`, entered with ``_span``): each takes its
own start and end markers from the same set and its own histogram and
range. None of this launches work on the card or waits for it.

A model whose parameters carry optimizer state beside the weights names
the leaves the step differentiates (``_differentiated``); the others reach
``_apply`` with a ``None`` gradient. A leaf may get a sparse (row)
gradient, as an embedding table's does; the mesh step all-reduces dense
gradients of every leaf, so it refuses both.

Subclasses implement:
  _shard_loss(params, shard, rows_per_shard) -> (loss_sum, weight_sum)
  _apply(params, grads, denom) -> new params
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from typing import Optional, Tuple

import torch

from dmlc_core_tpu_torch import telemetry
from dmlc_core_tpu_torch.device.device_iter import (to_device_batch,
                                                    unpack_shard)
from dmlc_core_tpu_torch.device.sharding import local_device_count
from dmlc_core_tpu_torch.parallel.distributed import allreduce_sum_

__all__ = ["DataParallelModel"]

_NULL = contextlib.nullcontext()
# the step's phases: (profiler range, histogram); a histogram registers
# at its first observation
_PHASES = {
    "forward": ("dct.step.forward",
                lambda: telemetry.histogram("step_forward_us")),
    "backward": ("dct.step.backward",
                 lambda: telemetry.histogram("step_backward_us")),
    "reduce": ("dct.step.reduce",
               lambda: telemetry.histogram("step_reduce_us")),
    "update": ("dct.step.update",
               lambda: telemetry.histogram("step_update_us")),
}


def _profiled(name: str):
    """``record_function(name)`` while a profiler records, else nothing."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL


class _PhaseTimer:
    """One model's step phases, timed without waiting on the card.

    A phase runs from a marker to the next: the step's first phase takes
    its own start marker, and each later one starts at its predecessor's
    end marker, since the step launches nothing between its phases. A
    nested span (``spans``: the model's :attr:`~DataParallelModel._SPANS`)
    takes a start and an end marker of its own. On the CPU a marker is
    ``time.perf_counter()`` and an interval is observed as it ends. On
    CUDA a marker is a timing event recorded on the current stream, from a
    set of ``1 + len(_PHASES) + 2 * len(spans)`` that the step takes from
    a pool of :attr:`POOL` sets made once. After the step is issued,
    :meth:`end` resolves the pending sets in order, while the card runs
    that step: a set whose last event's ``query()`` says done is observed
    and goes back to the pool, and the first one still running ends the
    pass. With no set free, a step goes untimed, and so does an interval
    once the step's set is used up."""

    POOL = 8

    def __init__(self, spans: Optional[dict] = None):
        self.on = False
        self._size = 1 + len(_PHASES) + 2 * len(spans or ())
        self._device: Optional[torch.device] = None
        self._stream = None
        self._free: list = []
        self._pending: deque = deque()
        self._events: Optional[list] = None
        self._marks: list = []  # perf_counter readings, or event indices
        self._laps: list = []   # (histogram getter, start event, end event)

    def begin(self, device: torch.device) -> None:
        self.on = True
        self._marks = []
        if device.type != "cuda":
            self._device = None
            return
        if device != self._device:
            self._free = [[torch.cuda.Event(enable_timing=True)
                           for _ in range(self._size)]
                          for _ in range(self.POOL)]
            self._pending.clear()
            self._device = device
        if not self._free:
            self._resolve()
        self._events = self._free.pop() if self._free else None
        self._stream = torch.cuda.current_stream(device)
        self._laps = []

    def end(self) -> None:
        self.on = False
        if self._events is None:
            return
        if self._laps:
            self._pending.append((self._events, self._laps))
        else:
            self._free.append(self._events)
        self._events = None
        self._resolve()

    def _resolve(self) -> None:
        while self._pending:
            events, laps = self._pending[0]
            if not events[laps[-1][2]].query():
                return
            self._pending.popleft()
            for hist, a, b in laps:
                hist().observe(events[a].elapsed_time(events[b]) * 1e3)
            self._free.append(events)

    def _timed(self) -> bool:
        return self._device is None or self._events is not None

    def _mark(self):
        """A new marker (None once the step's set is used up)."""
        if self._device is None:
            self._marks.append(time.perf_counter())
        elif len(self._marks) < len(self._events):
            self._events[len(self._marks)].record(self._stream)
            self._marks.append(len(self._marks))
        else:
            return None
        return self._marks[-1]

    def _lap(self, hist, a, b) -> None:
        if a is None or b is None:
            return
        if self._device is None:
            hist().observe((b - a) * 1e6)
        else:
            self._laps.append((hist, a, b))

    @contextlib.contextmanager
    def phase(self, phase: str):
        """Time the body as ``phase``."""
        with _profiled(_PHASES[phase][0]):
            if not self._timed():
                yield
                return
            a = self._marks[-1] if self._marks else self._mark()
            yield
            self._lap(_PHASES[phase][1], a, self._mark())

    @contextlib.contextmanager
    def span(self, name: str, hist):
        """Time the body, nested in a phase, into ``hist()``."""
        with _profiled(name):
            if not self._timed():
                yield
                return
            a = self._mark()
            yield
            self._lap(hist, a, self._mark())


class DataParallelModel:
    """Mixin: the step over packed or named batch trees. Parameters are a
    NamedTuple of float32 tensors."""

    mesh = None
    # ranks that stepped on a batch in the last mesh step
    last_active = None
    # made at the first step with telemetry on
    _timer: Optional[_PhaseTimer] = None
    # nested spans the model times: key -> (profiler range, histogram
    # getter); a histogram registers at its first observation
    _SPANS: dict = {}

    def _shard_loss(self, params, shard, rows_per_shard: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def _apply(self, params, grads, denom):
        raise NotImplementedError

    def _differentiated(self, params) -> Tuple[bool, ...]:
        """Which leaves of ``params`` the step differentiates; the others
        (an optimizer's state) reach ``_apply`` with a None gradient."""
        return (True,) * len(params)

    def _phase(self, phase: str):
        """The step's ``phase`` timed, when this step is."""
        t = self._timer
        return t.phase(phase) if t is not None and t.on else _NULL

    def _span(self, key: str):
        """The model's nested span ``key`` (:attr:`_SPANS`) timed, when
        this step is."""
        t = self._timer
        return t.span(*self._SPANS[key]) if t is not None and t.on \
            else _NULL

    def _local(self, params, batch):
        """(loss_sum, weight_sum, grads) of this rank's batch."""
        tree = to_device_batch(batch, params[0].device).tree()
        D = (tree["aux"].shape[0] if "aux" in tree
             else tree["label"].shape[0])
        n_dev = local_device_count(self.mesh)
        if D != n_dev:
            # the step reads shard [0] only; a mismatch would silently
            # train on 1/D of the rows
            raise ValueError(
                f"batch device axis D={D} != devices per rank {n_dev}; "
                f"build the batch with num_shards={n_dev}")
        shard = unpack_shard({k: v[0] for k, v in tree.items()})
        cls = type(params)
        wrt = self._differentiated(params)
        leaves = [p.detach().requires_grad_(d) for p, d in zip(params, wrt)]
        with self._phase("forward"):
            loss_sum, wsum = self._shard_loss(cls(*leaves), shard,
                                              batch.rows_per_shard)
        with self._phase("backward"):
            got = iter(torch.autograd.grad(
                loss_sum, [p for p, d in zip(leaves, wrt) if d]))
        grads = tuple(next(got) if d else None for d in wrt)
        return loss_sum.detach(), wsum.detach(), grads

    def _reduce(self, loss_sum, wsum, grads, active: float):
        """Sum (loss_sum, wsum, active, grads) over the mesh in one
        all_reduce of one flat float32 buffer. Only dense gradients of
        every leaf pack into it."""
        if any(g is None or g.layout != torch.strided for g in grads):
            raise ValueError(
                f"{type(self).__name__} has row-sparse table gradients and "
                f"optimizer state among its leaves; the mesh step "
                f"all-reduces a dense gradient of every leaf, and a table "
                f"sharded over the mesh's ranks is not implemented: step "
                f"it on one device (mesh=None)")
        head = torch.stack([loss_sum.float(), wsum.float(),
                            torch.full_like(wsum, active,
                                            dtype=torch.float32)])
        flat = torch.cat([head] + [g.reshape(-1) for g in grads])
        if self.mesh.group is not None:
            allreduce_sum_(flat, self.mesh.group)
        parts = torch.split(flat, [3] + [g.numel() for g in grads])
        grads = tuple(p.view_as(g) for p, g in zip(parts[1:], grads))
        return parts[0][0], parts[0][1], int(parts[0][2]), grads

    def step(self, params, batch):
        """One training step on a device or host batch; returns (params,
        loss).
        With a mesh, ``batch=None`` is the zero-weight step of a rank
        whose part ran out."""
        if not telemetry.enabled():
            return self._step(params, batch)
        if self._timer is None:
            self._timer = _PhaseTimer(self._SPANS)
        t0 = time.perf_counter()
        with _profiled("dct.step"):
            self._timer.begin(params[0].device)
            try:
                out = self._step(params, batch)
            finally:
                self._timer.end()
        telemetry.histogram("step_host_us").observe(
            (time.perf_counter() - t0) * 1e6)
        return out

    def _step(self, params, batch):
        cls = type(params)
        if batch is None:
            if self.mesh is None:
                raise ValueError("batch=None is the zero-weight step of a "
                                 "mesh rank whose part ran out; without a "
                                 "mesh there is nothing to step")
            zero = torch.zeros((), dtype=torch.float32,
                               device=params[0].device)
            loss_sum, wsum, active = zero, zero, 0.0
            grads = tuple(torch.zeros_like(p) if d else None for p, d in
                          zip(params, self._differentiated(params)))
        else:
            loss_sum, wsum, grads = self._local(params, batch)
            active = 1.0
        if self.mesh is not None:
            with self._phase("reduce"):
                loss_sum, wsum, self.last_active, grads = self._reduce(
                    loss_sum, wsum, grads, active)
            if self.last_active == 0:  # every rank is out of batches
                return params, loss_sum
        with torch.no_grad(), self._phase("update"):
            denom = torch.clamp(wsum, min=1.0)
            new = self._apply(cls(*(p.detach() for p in params)),
                              cls(*grads), denom)
        return new, loss_sum / denom
