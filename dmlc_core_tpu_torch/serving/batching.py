"""Micro-batch assembly: payloads -> parsed rows -> padded buckets.

A copy of ``dmlc_core_tpu/serving/batching.py`` over the port's
:class:`~dmlc_core_tpu_torch.io.native.NativeParser`.

Request payloads (libsvm or csv text) are concatenated, parsed by the
native parser in one pass, and mapped back to their requests by row
count. The mapping is verified: the number of non-blank payload lines
must equal the number of parsed rows, otherwise the co-batch degrades to
per-request isolation parses so one malformed payload can never poison
(or silently steal rows from) its co-batched neighbors — each bad
request gets its own structured 4xx and every good one keeps its exact
rows.

Parsed batches are padded into fixed buckets — rows to a configured
ladder, nnz to powers of two — so the forward sees a finite shape set
and ``steady_new_shapes`` stays 0 under ragged traffic.
"""

import os
import tempfile
import uuid
from typing import List, Optional, Sequence, Tuple

import numpy as np

from dmlc_core_tpu_torch.base import DMLCError
from dmlc_core_tpu_torch.io.native import NativeParser
from dmlc_core_tpu_torch.tracker.minihttp import HttpError

#: content types accepted on ``POST /score``, mapped to parser formats
CONTENT_FORMATS = {
    "application/x-libsvm": "libsvm",
    "text/x-libsvm": "libsvm",
    "text/csv": "csv",
    "application/csv": "csv",
}
DEFAULT_FORMAT = "libsvm"


def payload_format(content_type: str) -> str:
    """Parser format for a request ``Content-Type`` (422-style 400 on an
    unknown type; missing/blank falls back to libsvm)."""
    base = content_type.partition(";")[0].strip().lower()
    if not base:
        return DEFAULT_FORMAT
    fmt = CONTENT_FORMATS.get(base)
    if fmt is None:
        raise HttpError(400, f"unsupported Content-Type {base!r}; "
                             "send application/x-libsvm or text/csv")
    return fmt


def count_rows(payload: bytes) -> int:
    """Rows a well-formed text payload should parse to: its non-blank
    lines (the verification anchor for co-batch row accounting)."""
    return sum(1 for ln in payload.split(b"\n") if ln.strip())


def scratch_dir() -> str:
    """Directory for micro-batch scratch files: tmpfs when the host has
    it (``/dev/shm``), else the default temp dir."""
    if os.path.isdir("/dev/shm"):
        return "/dev/shm"
    return tempfile.gettempdir()


def parse_rows(payload: bytes, fmt: str, tmp_dir: str
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Parse one text payload through the native parser.

    Returns ``(row_ids, col, val, num_rows)`` with ``row_ids`` local to
    this payload. Raises :class:`DMLCError` on parser faults (propagated
    from the native format checks).
    """
    if not payload.endswith(b"\n"):
        payload += b"\n"
    path = os.path.join(tmp_dir, f"serve-{os.getpid()}-{uuid.uuid4().hex}"
                                 f".{fmt}")
    with open(path, "wb") as f:
        f.write(payload)
    try:
        rows: List[np.ndarray] = []
        cols: List[np.ndarray] = []
        vals: List[np.ndarray] = []
        base = 0
        parser = NativeParser(path, fmt=fmt, threaded=False, nthread=1)
        try:
            for blk in parser:
                n = blk.num_rows
                counts = np.diff(blk.offset.astype(np.int64))
                rows.append(np.repeat(
                    np.arange(base, base + n, dtype=np.int64), counts))
                cols.append(np.asarray(blk.index, dtype=np.int64).copy())
                vals.append(np.asarray(blk.value, dtype=np.float32).copy()
                            if blk.value is not None
                            else np.ones(int(counts.sum()),
                                         dtype=np.float32))
                base += n
        finally:
            parser.close()
        if rows:
            return (np.concatenate(rows), np.concatenate(cols),
                    np.concatenate(vals), base)
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros(0, np.float32), 0)
    finally:
        try:
            os.unlink(path)
        except OSError:
            pass


class ParsedGroup:
    """A co-batch parse result: concatenated rows plus, per payload,
    either an ``(row_start, row_end)`` slice or the :class:`HttpError`
    that payload earned."""

    __slots__ = ("row", "col", "val", "num_rows", "slices", "errors")

    def __init__(self, row: np.ndarray, col: np.ndarray, val: np.ndarray,
                 num_rows: int,
                 slices: List[Optional[Tuple[int, int]]],
                 errors: List[Optional[HttpError]]):
        self.row = row
        self.col = col
        self.val = val
        self.num_rows = num_rows
        self.slices = slices
        self.errors = errors


def parse_group(payloads: Sequence[bytes], fmt: str,
                tmp_dir: str) -> ParsedGroup:
    """Parse a co-batch of payloads with verified row accounting.

    Fast path: one concatenated parse, accepted only when the total row
    count matches the summed non-blank line counts (so every request's
    slice is exact). Any mismatch or parser fault degrades to isolation:
    each payload parses alone, and only the faulty ones turn into 400s.
    """
    expected = [count_rows(p) for p in payloads]
    for i, p in enumerate(payloads):
        if expected[i] == 0:
            return _parse_isolated(payloads, expected, fmt, tmp_dir)
    joined = b"".join(p if p.endswith(b"\n") else p + b"\n"
                      for p in payloads)
    try:
        row, col, val, total = parse_rows(joined, fmt, tmp_dir)
    except DMLCError:
        return _parse_isolated(payloads, expected, fmt, tmp_dir)
    if total != sum(expected):
        # the parser dropped or merged lines somewhere in the co-batch:
        # per-request attribution is unknowable — isolate
        return _parse_isolated(payloads, expected, fmt, tmp_dir)
    slices: List[Optional[Tuple[int, int]]] = []
    start = 0
    for n in expected:
        slices.append((start, start + n))
        start += n
    return ParsedGroup(row, col, val, total, slices,
                       [None] * len(payloads))


def _parse_isolated(payloads: Sequence[bytes], expected: List[int],
                    fmt: str, tmp_dir: str) -> ParsedGroup:
    """Isolation path: one parse per payload; faulty payloads become
    per-request 400s, healthy ones are re-concatenated."""
    rows: List[np.ndarray] = []
    cols: List[np.ndarray] = []
    vals: List[np.ndarray] = []
    slices: List[Optional[Tuple[int, int]]] = []
    errors: List[Optional[HttpError]] = []
    base = 0
    for i, p in enumerate(payloads):
        if expected[i] == 0:
            slices.append(None)
            errors.append(HttpError(400, "empty payload: no data rows"))
            continue
        try:
            r, c, v, n = parse_rows(p, fmt, tmp_dir)
        except DMLCError as e:
            slices.append(None)
            errors.append(HttpError(400, f"payload failed to parse as "
                                         f"{fmt}: {e}"))
            continue
        if n != expected[i]:
            slices.append(None)
            errors.append(HttpError(
                400, f"payload parsed to {n} rows but contains "
                     f"{expected[i]} data lines ({fmt} framing error)"))
            continue
        rows.append(r + base)
        cols.append(c)
        vals.append(v)
        slices.append((base, base + n))
        errors.append(None)
        base += n
    if rows:
        row = np.concatenate(rows)
        col = np.concatenate(cols)
        val = np.concatenate(vals)
    else:
        row = np.zeros(0, np.int64)
        col = np.zeros(0, np.int64)
        val = np.zeros(0, np.float32)
    return ParsedGroup(row, col, val, base, slices, errors)


def parse_buckets(spec: str) -> Tuple[int, ...]:
    """``"16,64,256,1024"`` -> validated ascending row-bucket ladder."""
    try:
        buckets = tuple(sorted({int(tok) for tok in spec.split(",")
                                if tok.strip()}))
    except ValueError:
        raise DMLCError(f"bad rows-bucket spec {spec!r}; want "
                        "comma-separated positive ints")
    if not buckets or buckets[0] <= 0:
        raise DMLCError(f"bad rows-bucket spec {spec!r}; want "
                        "comma-separated positive ints")
    return buckets


def pad_to_bucket(group: ParsedGroup, rows_buckets: Sequence[int],
                  min_nnz: int
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                             int, int]:
    """Pad a parsed co-batch to its ``(rows_bucket, nnz_bucket)``.

    Rows pad to the smallest ladder entry that fits; nnz pads to the
    next power of two (floored at ``min_nnz``). Padding nnz entries
    carry ``row == rows_bucket`` — the sacrificial segment the CSR
    forward drops — and zero value, so padding can never leak into a
    real row's score. Returns ``(row, col, val, rows_bucket,
    nnz_bucket)``.
    """
    rows_bucket = 0
    for b in rows_buckets:
        if group.num_rows <= b:
            rows_bucket = b
            break
    if rows_bucket == 0:
        raise HttpError(413, f"batch of {group.num_rows} rows exceeds "
                             f"the largest bucket {rows_buckets[-1]}")
    nnz = max(int(min_nnz), 1, len(group.val))
    nnz_bucket = 1
    while nnz_bucket < nnz:
        nnz_bucket *= 2
    pad = nnz_bucket - len(group.val)
    row = np.concatenate([group.row, np.full(pad, rows_bucket,
                                             dtype=np.int64)])
    col = np.concatenate([group.col, np.zeros(pad, dtype=np.int64)])
    val = np.concatenate([group.val, np.zeros(pad, dtype=np.float32)])
    return row, col, val, rows_bucket, nnz_bucket
