"""HIGGS-shaped rows (UCI HIGGS: 28 real features, a 0/1 label).

A frozen copy of ``chip_smoke.py::write_higgs_like`` (the same bytes for
the same rows and seed): seeded normal values written with four
decimals, labels from a seeded linear rule plus noise, every row the same
width (written by ``datagen/text.py`` in blocks).
:func:`arrays` gives the numbers exactly as the file spells them, so the
reference starts from the same rows as the parser without reading the
file.
"""

from __future__ import annotations

import functools

import numpy as np

from benchmark.datagen import text

FEATURES = 28
NNZ_PER_ROW = FEATURES      # every feature of every row is written
# the libsvm text of one row: label, then " j:" and "sd.dddd" per feature
_KEYS = [f" {j}:".encode() for j in range(FEATURES)]


# set-up writes the rows and the reference reads them after the window:
# one draw serves both
@functools.lru_cache(maxsize=1)
def _draw(rows: int, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, FEATURES), dtype=np.float32)
    w_true = rng.standard_normal(FEATURES).astype(np.float32)
    y = (x @ w_true + rng.standard_normal(rows, dtype=np.float32)) > 0
    q = np.minimum(np.rint(np.abs(x) * 1e4), 99999).astype(np.int64)
    return x < 0, q, y


def arrays(rows: int, seed: int) -> dict:
    """``label`` [rows] (0/1), ``col`` [rows, 28] and ``val`` [rows, 28]
    (float64, the decimals the file holds) of the rows :func:`write`
    writes for the same ``rows`` and ``seed``."""
    neg, q, y = _draw(rows, seed)
    val = np.where(neg, -q, q) / 1e4
    col = np.broadcast_to(np.arange(FEATURES), (rows, FEATURES))
    return {"label": y.astype(np.float64), "col": col, "val": val}


def _layout():
    """The template row and where each feature's "sd.dddd" starts."""
    t, starts = bytearray(b"0"), []
    for key in _KEYS:
        t += key
        starts.append(len(t))
        t += b"00.0000"
    return bytes(t + b"\n"), starts


def _values():
    """[100000, 7] spellings "0d.dddd" of q / 10^4."""
    d = text.spellings(5, 100000)
    out = np.empty((100000, 7), np.uint8)
    out[:, 0] = ord("0")
    out[:, 1] = d[:, 0]
    out[:, 2] = ord(".")
    out[:, 3:] = d[:, 1:]
    return out


def write(path: str, rows: int, seed: int, fmt: str = "libsvm") -> None:
    """The rows as a libsvm file (0-based feature ids): "-d.dddd" or
    "0d.dddd", seven characters for every value."""
    if fmt != "libsvm":
        raise ValueError(f"higgs_like writes libsvm, not {fmt!r}")
    neg, q, y = _draw(rows, seed)
    template, starts = _layout()
    table = _values()

    def fill(lo, hi):
        v = table[q[lo:hi]]
        v[..., 0] = np.where(neg[lo:hi], ord("-"), ord("0"))
        yield 0, (ord("0") + y[lo:hi]).astype(np.uint8)[:, None]
        yield starts, v

    text.write(path, template, fill, rows)
