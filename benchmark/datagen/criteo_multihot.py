"""Criteo-1TB-shaped multi-hot rows (MLPerf DLRM-DCNv2's synthetic
multi-hot Criteo: 13 dense fields, 26 categorical fields with
``multi_hot_sizes`` ids each, 214 a row), drawn from the rows one chip
holds of each table. The tables' held rows and multi-hot sizes are the
``dlrm_dcnv2`` configuration's (its ``model`` section), read from its
file, so they are stated in one place.

A seeded rule, in blocks of :data:`BLOCK` rows each drawn from its own
generator (``default_rng([seed, block])``), so any prefix of the rows is
the same whatever the count asked for:

- label, then the 13 dense values: log-normal (μ 0, σ 0.5) with four
  decimals, as the model reads them (the source's log transform belongs
  to data preparation); fields 0-12 at columns 0-12;
- table ``t`` (field ``13 + t``): its first id, the one-hot id, drawn
  Zipf(1.3)-like and hashed into the table's held rows as ``criteo_like``
  hashes; the other ``h_t − 1`` ids a fixed function of the table and the
  first id, uniform over the held rows (:func:`_extra_ids`), as MLPerf's
  ``multi_hot.py`` takes them from a fixed ``[N, h − 1]`` uniform lookup
  row of the one-hot id: a bag repeats whenever its first id does; column
  ``13 + offset_t + row``;
- labels from a seeded logistic rule over the dense values and the first
  ids, about a quarter of them clicks.

Each token is fixed width (eight-digit columns), so a file is a template
row filled in blocks (``datagen/text.py``). :func:`arrays` gives the
numbers exactly as the text spells them.
"""

from __future__ import annotations

import json
import os

import numpy as np

from benchmark.datagen import text

CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "dlrm_dcnv2.json")
with open(CONFIG) as _f:
    _MODEL = json.load(_f)["model"]
DENSE = _MODEL["dense_features"]
HELD_ROWS = _MODEL["num_embeddings_per_feature"]
MULTI_HOT = _MODEL["multi_hot_sizes"]
NNZ_PER_ROW = DENSE + sum(MULTI_HOT)
BLOCK = 8192
_U64 = np.uint64


def _mix(x: np.ndarray) -> np.ndarray:
    """SplitMix64's finalizer, elementwise over uint64 (wrapping)."""
    x = (x ^ (x >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> _U64(27))) * _U64(0x94D049BB133111EB)
    return x ^ (x >> _U64(31))


def _extra_ids(seed: int, t: int, first: np.ndarray, h: int,
               rows: int) -> np.ndarray:
    """[n, h − 1] ids of table ``t`` that follow each first id: a seeded
    hash of (table, first id, place) into the ``rows`` held, so they are
    the same wherever the first id recurs."""
    key = _mix(np.array([seed % (1 << 64)], _U64)
               ^ _mix(np.array([t + 1], _U64)))
    place = np.arange(1, h, dtype=_U64)
    x = _mix(key ^ (first.astype(_U64)[:, None] * _U64(128) + place))
    return (x % _U64(rows)).astype(np.int64)


def _block(seed: int, b: int):
    """(labels [BLOCK], cols [BLOCK, 227] int64, q [BLOCK, 13]: dense
    values × 10^4) of block ``b``."""
    n = BLOCK
    rng = np.random.default_rng([seed % (1 << 64), b])
    dense = np.minimum(np.round(rng.lognormal(0.0, 0.5, (n, DENSE)), 4),
                       9999.9999)
    cols = [np.broadcast_to(np.arange(DENSE), (n, DENSE))]
    first = []
    offset = DENSE
    for t, (rows, h) in enumerate(zip(HELD_ROWS, MULTI_HOT)):
        rank = np.minimum(rng.zipf(1.3, n), 1 << 24).astype(np.uint64)
        h0 = ((rank * np.uint64(2654435761) + np.uint64(t * 40503))
              % np.uint64(rows)).astype(np.int64)
        rest = _extra_ids(seed, t, h0, h, rows)
        cols.append(offset + np.concatenate([h0[:, None], rest], axis=1))
        first.append(offset + h0)
        offset += rows
    effect = ((np.stack(first, axis=1) * 2654435761) % 1000) / 1000.0 - 0.5
    logit = (-1.2 + 0.3 * np.log(dense).sum(axis=1)
             + 0.25 * effect.sum(axis=1))
    labels = rng.random(n) < 1 / (1 + np.exp(-logit))
    return labels, np.concatenate(cols, axis=1), np.rint(
        dense * 1e4).astype(np.int64)


def _draw(lo: int, hi: int, seed: int):
    """The blocks' draws, rows ``lo:hi`` (``lo`` a multiple of BLOCK)."""
    parts = [_block(seed, b) for b in range(lo // BLOCK, -(-hi // BLOCK))]
    return tuple(np.concatenate(p)[:hi - lo] for p in zip(*parts))


def arrays(rows: int, seed: int) -> dict:
    """``label`` [rows] (0/1), ``col`` [rows, 227] and ``val`` [rows, 227]
    (float64, as the text spells them) of the rows :func:`write` writes
    for the same ``seed``."""
    labels, cols, q = _draw(0, rows, seed)
    val = np.concatenate([q / 1e4, np.ones((rows, NNZ_PER_ROW - DENSE))],
                         axis=1)
    return {"label": labels.astype(np.float64), "col": cols, "val": val}


def _layout():
    """The template row, where each dense value's "dddd.dddd" starts and
    where each id's eight digits start; the field ids, the dense columns
    and the ids' value "1" are the same in every row."""
    t, vals, ids = bytearray(b"0"), [], []
    for f in range(DENSE):
        t += f" {f:02d}:{f:08d}:".encode()
        vals.append(len(t))
        t += b"0000.0000"
    for k, h in enumerate(MULTI_HOT):
        for _ in range(h):
            t += f" {DENSE + k:02d}:".encode()
            ids.append(len(t))
            t += b"00000000:1"
    return bytes(t + b"\n"), vals, ids


def _fill(seed: int, vals, ids):
    four = text.spellings(4, 10000)

    def fill(lo, hi):
        labels, cols, q = _draw(lo, hi, seed)
        v = np.empty(q.shape + (9,), np.uint8)
        v[..., :4] = four[q // 10000]
        v[..., 4] = ord(".")
        v[..., 5:] = four[q % 10000]
        c = cols[:, DENSE:]
        d = np.empty(c.shape + (8,), np.uint8)
        d[..., :4] = four[c // 10000]
        d[..., 4:] = four[c % 10000]
        yield 0, (ord("0") + labels).astype(np.uint8)[:, None]
        yield vals, v
        yield ids, d
    return fill


def write(path: str, rows: int, seed: int, fmt: str = "libfm") -> None:
    """The rows as a ``libfm`` file (field-aware: the tables are the
    fields), in blocks."""
    if fmt != "libfm":
        raise ValueError(f"criteo_multihot writes libfm, not {fmt!r}")
    template, vals, ids = _layout()
    text.write(path, template, _fill(seed, vals, ids), rows)
