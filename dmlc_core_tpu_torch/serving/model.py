"""Scoring-side model artifacts: load, forward on the device, reload.

The port of ``dmlc_core_tpu/serving/model.py``. A serving model is a
checkpoint (``utils.checkpoint.save_checkpoint``) whose ``extra`` names
the model kind (``linear`` / ``fm``), feature count and objective; the
bytes are the reference's, so either package serves the other's
artifacts. Loads and reloads go through the checkpoint layer's
NativeStream reads, so the ``fs_fault`` plane applies to the artifact
path.

The parameters live on the device as float32 tensors (``cuda`` unless the
caller passes ``device="cpu"``). The forward is the trainers' CSR margin
math: ``ops.sparse.csr_matvec`` + ``b`` for ``linear``,
``models.fm._fm_margin_csr`` for ``fm``; PyTorch runs it eagerly, so the
reference's ``jax.jit`` per shape has no counterpart here. The
process-wide shape census stays: it counts every distinct padded ``(kind,
rows, nnz)`` the forward has seen, which ``serve_distinct_shapes`` and the
steady-state new-shape checks read.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np
import torch

from dmlc_core_tpu_torch import telemetry
from dmlc_core_tpu_torch.base import DMLCError, resolve_device
from dmlc_core_tpu_torch.models.convert import (fm_params_from_numpy,
                                                linear_params_from_numpy)
from dmlc_core_tpu_torch.models.fm import _fm_margin_csr
from dmlc_core_tpu_torch.ops.sparse import csr_matvec
from dmlc_core_tpu_torch.utils.checkpoint import restore_checkpoint, \
    save_checkpoint

__all__ = ["ScoringModel", "save_model", "distinct_shapes", "KIND_KEY",
           "FEATURES_KEY", "OBJECTIVE_KEY"]

#: checkpoint ``extra`` keys a serving model artifact carries
KIND_KEY = "serving_kind"
FEATURES_KEY = "num_features"
OBJECTIVE_KEY = "objective"

_shape_lock = threading.Lock()
_shapes_seen: set = set()


def _note_shape(kind: str, num_rows: int, nnz: int) -> None:
    """Census one forward shape (the reference's first sight of a shape
    was a fresh jit trace)."""
    key = (kind, num_rows, nnz)
    with _shape_lock:
        new = key not in _shapes_seen
        if new:
            _shapes_seen.add(key)
        n = len(_shapes_seen)
    if new:
        telemetry.emit_event("serve-shape", kind=kind, rows=num_rows,
                             nnz=nnz, distinct=n)
    telemetry.gauge("serve_distinct_shapes").set(n)


def distinct_shapes() -> int:
    """Number of distinct padded forward shapes seen by this process."""
    with _shape_lock:
        return len(_shapes_seen)


def _reset_shape_census() -> None:
    """Forget every seen shape (tests only; the census is process-wide)."""
    with _shape_lock:
        _shapes_seen.clear()


def save_model(uri: str, kind: str, params: Dict[str, np.ndarray],
               num_features: int, objective: str = "logistic",
               step: int = 0) -> None:
    """Write a serving model artifact.

    ``params`` is a plain dict — ``{"w", "b"}`` for ``linear``,
    ``{"w", "b", "v"}`` for ``fm`` — of numpy arrays or tensors, written
    atomically through the checkpoint layer with serving metadata in
    ``extra``."""
    if kind not in ("linear", "fm"):
        raise DMLCError(f"unknown serving model kind {kind!r}")
    save_checkpoint(uri, dict(params), step=step,
                    extra={KIND_KEY: kind,
                           FEATURES_KEY: str(int(num_features)),
                           OBJECTIVE_KEY: objective})


def _param_name(keystr: str) -> str:
    """``"['w']"`` (the key of a dict leaf) -> ``"w"``."""
    return keystr.strip("[]'\" .")


class ScoringModel:
    """A loaded model and its forward on ``device``.

    Thread-compatible rather than thread-safe: :meth:`scores` and
    :meth:`reload` are only called from the scorer thread, so a reload
    never races a forward. A failed reload raises and leaves the previous
    (last-good) parameters serving.
    """

    def __init__(self, kind: str, params: Dict[str, np.ndarray],
                 num_features: int, objective: str = "logistic",
                 step: int = 0, uri: str = "", device=None):
        if kind not in ("linear", "fm"):
            raise DMLCError(f"unknown serving model kind {kind!r}")
        need = ("w", "b") if kind == "linear" else ("w", "b", "v")
        missing = [k for k in need if k not in params]
        if missing:
            raise DMLCError(
                f"serving model {kind!r} checkpoint is missing "
                f"parameters {missing}")
        self.kind = kind
        self.num_features = int(num_features)
        self.objective = objective
        self.step = int(step)
        self.uri = uri
        self.device = resolve_device(device)
        w_shape = np.shape(params["w"])
        if w_shape != (self.num_features,):
            raise DMLCError(
                f"serving model w has shape {w_shape}, "
                f"expected ({self.num_features},)")
        to_params = linear_params_from_numpy if kind == "linear" \
            else fm_params_from_numpy
        #: LinearParams or FMParams: float32 tensors on :attr:`device`
        self.params = to_params(params, device=self.device)

    @classmethod
    def load(cls, uri: str, device=None) -> "ScoringModel":
        """Load a serving artifact written by :func:`save_model` onto
        ``device`` (default ``cuda``; raises without CUDA).

        Raises :class:`~dmlc_core_tpu_torch.base.DMLCError` (or a
        checkpoint error subclass) on any fault — unreadable stream, bad
        payload, missing metadata — so callers can fall back to
        last-good."""
        device = resolve_device(device)
        flat, step, extra = restore_checkpoint(uri)
        kind = extra.get(KIND_KEY)
        if kind is None:
            raise DMLCError(
                f"checkpoint {uri} is not a serving model artifact "
                f"(missing extra[{KIND_KEY!r}])")
        try:
            num_features = int(extra.get(FEATURES_KEY, ""))
        except ValueError:
            raise DMLCError(
                f"checkpoint {uri} carries a bad {FEATURES_KEY!r}")
        params = {_param_name(k): v for k, v in flat.items()}
        return cls(kind, params, num_features,
                   objective=extra.get(OBJECTIVE_KEY, "logistic"),
                   step=step, uri=uri, device=device)

    def reload(self, uri: Optional[str] = None) -> "ScoringModel":
        """Load a replacement model onto the same device; raises on
        failure (the caller keeps serving ``self``, the last-good)."""
        return ScoringModel.load(uri or self.uri, device=self.device)

    # -- forward -----------------------------------------------------------

    def _margin(self, row: torch.Tensor, col: torch.Tensor,
                val: torch.Tensor, num_rows: int) -> torch.Tensor:
        p = self.params
        if self.kind == "linear":
            return csr_matvec(row, col, val, p.w, num_rows) + p.b
        return _fm_margin_csr(p, row, col, val, num_rows)

    @torch.no_grad()
    def scores(self, row: np.ndarray, col: np.ndarray, val: np.ndarray,
               num_rows: int) -> np.ndarray:
        """Scores for one padded batch: ``sigmoid(margin)`` for the
        logistic objective, the raw margin otherwise, as a numpy array.
        ``row`` entries equal to ``num_rows`` are padding (the spare
        segment), and the entries may come in any order (the ``fm``
        kind's kernel is fastest with rows ascending and the padding at
        the tail, as the server batches them); feature ids outside
        ``[0, num_features)`` are masked to zero weight on the host before
        the device sees them (a clamped gather would credit them to
        feature 0). The arrays go to the
        device as int32/int32/float32."""
        col = np.asarray(col, dtype=np.int32)
        val = np.asarray(val, dtype=np.float32)
        row = np.asarray(row, dtype=np.int32)
        bad = (col < 0) | (col >= self.num_features)
        if bad.any():
            col = np.where(bad, 0, col)
            val = np.where(bad, np.float32(0), val)
        _note_shape(self.kind, num_rows, len(val))
        dev = self.device
        margin = self._margin(torch.from_numpy(row).to(dev),
                              torch.from_numpy(col).to(dev),
                              torch.from_numpy(val).to(dev), num_rows)
        if self.objective == "logistic":
            margin = torch.sigmoid(margin)
        return margin.cpu().numpy()

    def describe(self) -> Dict[str, object]:
        """Small JSON-able summary for ``/statz`` and reload replies."""
        return {"kind": self.kind, "num_features": self.num_features,
                "objective": self.objective, "step": self.step,
                "uri": self.uri}
