"""The numbers that decide ``correct``, each held against its limit.

Training (the program's first steps in set-up, against the reference's
three steps from the same parameters and rows). A leaf's gap is
| ‖program‖ − ‖reference‖ | over the larger of the reference's norm of
that leaf and the median of the reference's norms over the leaves of its
kind; ``grad_gap`` and ``change_gap`` are their worst leaf's:

- ``loss_gap``: the largest |program − reference| / |reference| over the
  first steps' losses (all three, or the adapter's ``LOSS_STEPS``);
- ``grad_gap``: the first gradient as the optimizer got it, worked out
  from the state after one step;
- ``change_gap``: the leaves' change after three steps, p3 − p0 (the
  worst leaf's, or the adapter's median leaf's), leaving out leaves
  whose reference gradient is under a thousandth of the median leaf's
  (they move by round-off alone; a leaf with no gradient of its own, an
  optimizer's state, always counts).

What the optimizer is, the model kind's adapter (``models/<kind>.py``)
says, where it is not plain SGD over every leaf of one kind:

- ``gradient(before, after, model)``: the first gradient of each leaf
  that has one, from the leaves before and after the first step and the
  configuration's ``model`` section; without it, (p0 − p1) / lr of every
  leaf, which is SGD's gradient;
- ``leaf_kind(name)``: the kind whose median floors the leaf's gap;
  without it, every leaf is of one kind;
- ``LOSS_STEPS``: how many of the first steps' losses ``loss_gap``
  compares, where the later ones carry round-off that the optimizer
  amplifies; without it, all three;
- ``CHANGE_MEDIAN_LEAF``: true where ``change_gap`` is the median leaf's
  gap of each kind (the larger of the kinds'), for the same reason;
  without it, the worst leaf's.

So the linear and FM cells read SGD's (p0 − p1) / lr, one median, three
losses and the worst leaf's change. The DLRM cell (Adagrad) reads
``loss_gap`` from the first step's loss alone and ``change_gap`` from the
median leaf (Adagrad moves an entry whose gradient is round-off by a
whole step, so the later losses and a few leaves wander), ``grad_gap``
from its weight leaves' gradient worked out of the update and the
accumulator after it (the update alone is about the gradient's sign),
and weights and accumulators each against the median of its own kind.

Scoring: ``score_gap``, the largest |served − reference| over every score
of every answered request.
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import numpy as np

# a leaf whose reference gradient norm is under this share of the median
# leaf's is left out of change_gap
NOUGHT = 1e-3


def _norms(leaves: Dict[str, np.ndarray]) -> Dict[str, float]:
    return {k: float(np.linalg.norm(np.asarray(v, np.float64).ravel()))
            for k, v in leaves.items()}


def _one_kind(name: str) -> str:
    return ""


def worst_leaf(prog: Dict[str, np.ndarray], ref: Dict[str, np.ndarray],
               keep=None, kind=_one_kind, median: bool = False) -> dict:
    """The worst leaf's gap: ``{"value", "leaf", "program", "reference"}``
    (the two norms of that leaf). ``median``: the median leaf's gap of
    each kind instead, the larger of the kinds'."""
    pn, rn = _norms(prog), _norms(ref)
    kinds = {k: kind(k) for k in rn}
    med = {c: statistics.median(v for k, v in rn.items() if kinds[k] == c)
           for c in set(kinds.values())}
    gaps = {k: abs(pn[k] - rn[k]) / max(rn[k], med[kinds[k]], 1e-300)
            for k in rn if keep is None or k in keep}
    if median:
        def mid(c):
            ranked = sorted((g, k) for k, g in gaps.items() if kinds[k] == c)
            return ranked[(len(ranked) - 1) // 2]
        gap, leaf = max(mid(c) for c in {kinds[k] for k in gaps})
    else:
        gap, leaf = max((g, k) for k, g in gaps.items())
    return {"value": gap, "leaf": leaf, "program": pn[leaf],
            "reference": rn[leaf]}


def _diff(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray],
          scale: float = 1.0) -> Dict[str, np.ndarray]:
    return {k: (np.asarray(a[k], np.float64) - np.asarray(b[k], np.float64))
            * scale for k in a}


def sgd_gradient(before: dict, after: dict, model: dict) -> dict:
    """(p0 − p1) / lr of every leaf."""
    return _diff(before, after, 1.0 / model["learning_rate"])


def train_detail(prog: dict, ref: dict, model: dict,
                 adapter=None) -> Dict[str, dict]:
    """Each number with where it was read: ``{name: {"value", ...}}``,
    the step for ``loss_gap`` and the leaf and its two norms for the
    others. ``prog``: {"loss": [l1, l2, l3], "params": [p0, p1, p3]};
    ``ref``: {"loss": [...], "params": [p0, p1, p2, p3]} (dicts of leaf
    arrays); ``model`` the configuration's ``model`` section; ``adapter``
    the model kind's module (``models/<kind>.py``)."""
    gradient = getattr(adapter, "gradient", sgd_gradient)
    kind = getattr(adapter, "leaf_kind", _one_kind)
    n = getattr(adapter, "LOSS_STEPS", 3)
    loss_gap, step = max((abs(float(p) - float(r)) / abs(float(r)), s)
                         for s, (p, r) in enumerate(zip(prog["loss"][:n],
                                                        ref["loss"][:n])))
    g_ref = gradient(ref["params"][0], ref["params"][1], model)
    grad = worst_leaf(gradient(prog["params"][0], prog["params"][1], model),
                      g_ref, kind=kind)
    gn = _norms(g_ref)
    med = statistics.median(gn.values())
    keep = [k for k in ref["params"][0] if gn.get(k, med) >= NOUGHT * med]
    change = worst_leaf(_diff(prog["params"][2], prog["params"][0]),
                        _diff(ref["params"][3], ref["params"][0]), keep,
                        kind, getattr(adapter, "CHANGE_MEDIAN_LEAF", False))
    return {"loss_gap": {"value": loss_gap, "step": step + 1},
            "grad_gap": grad, "change_gap": change}


def train_gaps(prog: dict, ref: dict, model: dict,
               adapter=None) -> Dict[str, float]:
    """The numbers of :func:`train_detail` alone."""
    return {k: v["value"]
            for k, v in train_detail(prog, ref, model, adapter).items()}


def score_gap(served: List[np.ndarray], ref: List[np.ndarray]) -> float:
    worst = 0.0
    for s, r in zip(served, ref):
        if len(s):
            worst = max(worst, float(np.max(np.abs(
                np.asarray(s, np.float64) - np.asarray(r, np.float64)))))
    return worst


def checks(values: Dict[str, float], limits: Dict[str, float]) -> dict:
    """``{name: {"value", "limit"}}`` in the limits' order."""
    return {k: {"value": float(values[k]), "limit": float(limits[k])}
            for k in limits}
