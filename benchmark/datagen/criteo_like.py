"""Criteo-shaped rows (the Criteo Display Advertising Challenge, Kaggle
2014: 13 integer and 26 categorical fields, one nonzero each).

A frozen copy of ``chip_smoke.py::criteo_like``/``write_criteo_like``:
the integer fields are features 0-12 with seeded log-normal values (four
decimals); the categoricals are drawn Zipf(1.3)-like per field and hashed
into ``[13, features)``, as libffm's Criteo example hashes them to about
10^6; labels come from a seeded logistic rule over both, about a quarter
of them clicks. Every token is fixed width (zero-padded digits), the
bytes ``write_criteo_like`` writes, so a file is a template row with its
variable columns filled in blocks (``datagen/text.py``). :func:`arrays`
gives the numbers exactly as the text spells them.
"""

from __future__ import annotations

import functools

import numpy as np

from benchmark.datagen import text

INT_FIELDS = 13
CAT_FIELDS = 26
FIELDS = INT_FIELDS + CAT_FIELDS
FEATURES = 1 << 20
NNZ_PER_ROW = FIELDS        # one nonzero a field


# set-up writes the rows and the reference reads them after the window:
# one draw serves both
@functools.lru_cache(maxsize=1)
def _draw(rows: int, seed: int, features: int):
    """(labels [rows], cols [rows, 39] int64, q [rows, 13]: the integer
    fields' values times 10^4)."""
    rng = np.random.default_rng(seed)
    ints = np.minimum(np.round(rng.lognormal(0.0, 0.5, (rows, INT_FIELDS)),
                               4), 9999.9999)
    rank = np.minimum(rng.zipf(1.3, (rows, CAT_FIELDS)), 1 << 24)
    field = np.arange(CAT_FIELDS, dtype=np.uint64)
    h = (rank.astype(np.uint64) * np.uint64(2654435761)
         + field * np.uint64(40503)) % np.uint64(features - INT_FIELDS)
    cats = h.astype(np.int64) + INT_FIELDS
    cols = np.concatenate(
        [np.broadcast_to(np.arange(INT_FIELDS), (rows, INT_FIELDS)), cats],
        axis=1)
    effect = ((cats * 2654435761) % 1000) / 1000.0 - 0.5
    logit = (-1.2 + 0.3 * (np.log(ints)).sum(axis=1)
             + 0.25 * effect.sum(axis=1))
    labels = rng.random(rows) < 1 / (1 + np.exp(-logit))
    return labels, cols, np.rint(ints * 1e4).astype(np.int64)


def arrays(rows: int, seed: int, features: int = FEATURES) -> dict:
    """``label`` [rows] (0/1), ``col`` [rows, 39] and ``val`` [rows, 39]
    (float64, as the text spells them) of the rows :func:`write` and
    :func:`text_rows` write for the same ``rows`` and ``seed``."""
    labels, cols, q = _draw(rows, seed, features)
    val = np.concatenate([q / 1e4, np.ones((rows, CAT_FIELDS))], axis=1)
    return {"label": labels.astype(np.float64), "col": cols, "val": val}


def _layout(fmt: str):
    """The template row, where each integer field's "dddd.dddd" starts and
    where each categorical's seven feature-id digits start; field ids,
    the integer fields' ids and the categoricals' value "1" are the same
    in every row."""
    t, ints, cats = bytearray(b"0"), [], []
    for f in range(FIELDS):
        t += b" " + (f"{f:02d}:".encode() if fmt == "libfm" else b"")
        if f < INT_FIELDS:
            ints.append(len(t) + 8)
            t += f"{f:07d}:0000.0000".encode()
        else:
            cats.append(len(t))
            t += b"0000000:1"
    return bytes(t + b"\n"), ints, cats


def _fill(labels, cols, q, ints, cats):
    four = text.spellings(4, 10000)
    seven = text.spellings(7, 10 ** 7)

    def fill(lo, hi):
        qq = q[lo:hi]
        v = np.empty(qq.shape + (9,), np.uint8)
        v[..., :4] = four[qq // 10000]
        v[..., 4] = ord(".")
        v[..., 5:] = four[qq % 10000]
        yield 0, (ord("0") + labels[lo:hi]).astype(np.uint8)[:, None]
        yield ints, v
        yield cats, seven[cols[lo:hi, INT_FIELDS:]]
    return fill


def text_rows(rows: int, seed: int, fmt: str = "libfm",
              features: int = FEATURES) -> np.ndarray:
    """The rows as a [rows, width] byte matrix of ``libfm``
    (``ff:ccccccc:value``) or ``libsvm`` (``ccccccc:value``) lines, each
    ending in a newline."""
    if fmt not in ("libfm", "libsvm"):
        raise ValueError(f"criteo_like writes libfm or libsvm, not {fmt!r}")
    template, ints, cats = _layout(fmt)
    return text.rows(template, _fill(*_draw(rows, seed, features), ints,
                                     cats), 0, rows)


def write(path: str, rows: int, seed: int, fmt: str = "libfm",
          features: int = FEATURES) -> None:
    """The rows as a ``libfm`` (or ``libsvm``) file, in blocks."""
    if fmt not in ("libfm", "libsvm"):
        raise ValueError(f"criteo_like writes libfm or libsvm, not {fmt!r}")
    template, ints, cats = _layout(fmt)
    text.write(path, template,
               _fill(*_draw(rows, seed, features), ints, cats), rows)
