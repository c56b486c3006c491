"""The bench's seeded HIGGS-shaped files (``bench.py:66-182``).

Every generator draws from ``numpy.random.default_rng(7)`` in the same
order and formats the same way as the reference's, so for the same
``rows`` the files are byte for byte ``bench.py``'s and both harnesses
measure the same bytes. The binary lanes are the port's converter's
output of the libsvm file (``io/convert.py``, the reference's bytes).
Files are written to a temporary name and renamed into place, under
``.bench_cache/torch/`` of the checkout.
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np

from dmlc_core_tpu_torch.base import REPO_ROOT

CACHE_DIR = os.path.join(REPO_ROOT, ".bench_cache", "torch")
FEATURES = 28  # UCI HIGGS's width
SEED = 7
_CHUNK = 10000  # rows drawn at a time (the reference's step)


def _cached(name: str, write: Callable[[str], None]) -> str:
    """``CACHE_DIR/name``, written by ``write(tmp)`` when absent."""
    path = os.path.join(CACHE_DIR, name)
    if os.path.exists(path):
        return path
    os.makedirs(CACHE_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _write_text(path: str, rows: int, line: Callable) -> None:
    """``rows`` lines of ``line(label, values)``, drawn chunk by chunk as
    the reference draws them (values before labels)."""
    rng = np.random.default_rng(SEED)
    step = min(rows, _CHUNK)
    with open(path, "w") as f:
        for start in range(0, rows, step):
            n = min(step, rows - start)
            vals = rng.uniform(-3, 3, size=(n, FEATURES)).tolist()
            labels = rng.integers(0, 2, size=n).tolist()
            f.write("\n".join(line(y, v) for y, v in zip(labels, vals))
                    + "\n")


def ensure_dataset(rows: int) -> str:
    """The libsvm file: ``label j:v ...`` with 28 dense features."""
    return _cached(f"higgs_{rows}.libsvm", lambda p: _write_text(
        p, rows, lambda y, v: f"{y} " + " ".join(
            f"{j}:{x:.6f}" for j, x in enumerate(v))))


def ensure_csv_dataset(rows: int) -> str:
    """The same rows as dense csv, label first."""
    return _cached(f"higgs_{rows}.csv", lambda p: _write_text(
        p, rows, lambda y, v: f"{y}," + ",".join(f"{x:.6f}" for x in v)))


def ensure_libfm_dataset(rows: int) -> str:
    """The same rows as libfm, ``label field:feature:value`` with field
    ``feature % 7``."""
    return _cached(f"higgs_{rows}.libfm", lambda p: _write_text(
        p, rows, lambda y, v: f"{y} " + " ".join(
            f"{j % 7}:{j}:{x:.6f}" for j, x in enumerate(v))))


def ensure_rec_dataset(rows: int) -> str:
    """The libsvm file as RecordIO-framed row blocks (``.rec``)."""
    from dmlc_core_tpu_torch.io.convert import rows_to_recordio
    src = ensure_dataset(rows)
    return _cached(f"higgs_{rows}.rec", lambda p: rows_to_recordio(
        src, p, fmt="libsvm"))


def ensure_drec_dataset(rows: int) -> str:
    """The libsvm file as dense bf16 row matrices (``.drec``)."""
    from dmlc_core_tpu_torch.io.convert import rows_to_dense_recordio
    src = ensure_dataset(rows)
    return _cached(f"higgs_{rows}.drec", lambda p: rows_to_dense_recordio(
        src, p, fmt="libsvm", dtype="bf16"))


def ensure_crec_dataset(rows: int) -> str:
    """The libsvm file as CSR planes in device layout (``.crec``)."""
    from dmlc_core_tpu_torch.io.convert import rows_to_csr_recordio
    src = ensure_dataset(rows)
    return _cached(f"higgs_{rows}.crec", lambda p: rows_to_csr_recordio(
        src, p, fmt="libsvm"))


# the binary ingest lanes and their one-time converters: the headline's
# path picker, the secondary device lanes and the host lane rates
BINARY_LANES = (("rec", ensure_rec_dataset),
                ("crec", ensure_crec_dataset),
                ("recd", ensure_drec_dataset))
