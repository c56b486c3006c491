"""Fixed-width text rows written fast: every row of a generator's file has
the same width, so a file is one template row (the characters every row
shares: keys, separators, the newline) with a few fields filled per row
(label, values, feature ids), each field a fixed run of columns. Rows go
out in blocks; a field's characters come from a lookup table of its
spellings, indexed by the numbers."""

from __future__ import annotations

import concurrent.futures
import functools
import os
from typing import Callable, Iterable, Tuple

import numpy as np

BLOCK_ROWS = 1 << 17


@functools.lru_cache(maxsize=8)
def spellings(width: int, n: int) -> np.ndarray:
    """[n, width] ASCII of 0 .. n - 1, zero-padded (read-only)."""
    pow10 = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    out = (ord("0") + (np.arange(n, dtype=np.int64)[:, None] // pow10) % 10
           ).astype(np.uint8)
    out.flags.writeable = False
    return out


# fill(lo, hi) yields (first column, [hi - lo, ..., w] bytes) of each field
Fill = Callable[[int, int], Iterable[Tuple[int, np.ndarray]]]


def rows(template: bytes, fill: Fill, lo: int, hi: int) -> np.ndarray:
    """Rows ``lo:hi`` as a [hi - lo, width] byte matrix: the template in
    every row, each field of ``fill(lo, hi)`` at its columns. A field
    array [B, k, w] holds k fields whose starts are given as a list."""
    buf = np.empty((hi - lo, len(template)), np.uint8)
    buf[:] = np.frombuffer(template, np.uint8)
    for start, chars in fill(lo, hi):
        if np.ndim(start) == 0:
            buf[:, start:start + chars.shape[-1]] = chars
        else:
            w = chars.shape[-1]
            for k, s in enumerate(start):
                buf[:, s:s + w] = chars[:, k]
    return buf


def write(path: str, template: bytes, fill: Fill, n: int) -> None:
    """The ``n`` rows as a file, blocks formatted on several threads
    (numpy's copies release the interpreter lock) and written at their
    offsets."""
    width = len(template)
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        os.ftruncate(fd, n * width)

        def one(lo: int) -> None:
            buf = rows(template, fill, lo, min(n, lo + BLOCK_ROWS))
            os.pwrite(fd, memoryview(buf).cast("B"), lo * width)

        threads = min(8, os.cpu_count() or 1)
        with concurrent.futures.ThreadPoolExecutor(threads) as ex:
            for f in [ex.submit(one, lo) for lo in range(0, n, BLOCK_ROWS)]:
                f.result()
    finally:
        os.close(fd)
