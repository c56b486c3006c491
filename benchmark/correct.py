"""The numbers that decide ``correct``, each held against its limit.

Training (the program's first steps in set-up, against the reference's
three steps from the same parameters and rows):

- ``loss_gap``: the largest |program − reference| / |reference| over the
  three steps' losses;
- ``grad_gap``: the first gradient as the optimizer got it, worked out
  from the program's state after one step (SGD: (p0 − p1) / lr), by the
  worst leaf: | ‖program‖ − ‖reference‖ | over the larger of the
  reference's norm of that leaf and of the median leaf;
- ``change_gap``: the parameters' change after three steps, p3 − p0, by
  the worst leaf in the same way, leaving out leaves whose reference
  gradient is under a thousandth of the median leaf's (they move by
  round-off alone).

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


def worst_leaf_gap(prog: Dict[str, np.ndarray], ref: Dict[str, np.ndarray],
                   keep=None) -> float:
    pn, rn = _norms(prog), _norms(ref)
    med = statistics.median(rn.values())
    return max(abs(pn[k] - rn[k]) / max(rn[k], med, 1e-300)
               for k in rn if keep is None or k in keep)


def _diff(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray],
          scale: float = 1.0) -> Dict[str, np.ndarray]:
    return {k: (np.asarray(a[k], np.float64) - np.asarray(b[k], np.float64))
            * scale for k in a}


def train_gaps(prog: dict, ref: dict, lr: float) -> Dict[str, float]:
    """``prog``: {"loss": [l1, l2, l3], "params": [p0, p1, p3]};
    ``ref``: {"loss": [...], "params": [p0, p1, p2, p3]} (dicts of leaf
    arrays)."""
    n = 3
    loss_gap = max(abs(float(p) - float(r)) / abs(float(r))
                   for p, r in zip(prog["loss"][:n], ref["loss"][:n]))
    g_prog = _diff(prog["params"][0], prog["params"][1], 1.0 / lr)
    g_ref = _diff(ref["params"][0], ref["params"][1], 1.0 / lr)
    grad_gap = worst_leaf_gap(g_prog, g_ref)
    gn = _norms(g_ref)
    med = statistics.median(gn.values())
    keep = [k for k, v in gn.items() if v >= NOUGHT * med]
    change_gap = worst_leaf_gap(
        _diff(prog["params"][2], prog["params"][0]),
        _diff(ref["params"][3], ref["params"][0]), keep)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap}


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
