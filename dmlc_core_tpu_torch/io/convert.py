"""Dataset conversion: text formats -> binary RecordIO-framed row blocks
(port of ``dmlc_core_tpu/io/convert.py``; the files it writes are the
JAX package's, byte for byte).

Text is parsed ONCE here; every later epoch ingests records whose
deserialization is bulk memcpy: ``.rec`` (serialized row blocks), ``.crec``
(CSR device planes) and ``.drec`` (dense row matrices, bf16 by default).
bfloat16 values are rounded to nearest even by the native core
(:func:`~dmlc_core_tpu_torch.io.native.bf16_bits`), as the batch fills
round them.

    python -m dmlc_core_tpu_torch.io.convert data.libsvm data.crec

Record layout (cpp/src/parser.cc RecParser):
  [u32le 'DRB1' magic][u32le flags: bit0 = uint64 feature ids]
  [RowBlockContainer wire format, rowblock.h Save: 9 length-prefixed
   vectors + value_dtype i32 + max_index u64 + max_field u32]
"""

from __future__ import annotations

import struct

import numpy as np

from dmlc_core_tpu_torch.base import DMLCError
from dmlc_core_tpu_torch.io.native import (BF16_STORAGE, NativeParser,
                                           NativeRecordIOWriter, NativeStream,
                                           bf16_bits)

__all__ = ["rows_to_recordio", "rows_to_dense_recordio",
           "rows_to_csr_recordio", "compute_csr_window_table",
           "build_recordio_index"]

_REC_MAGIC = 0x44524231       # 'DRB1' (CSR row blocks)
_DENSE_REC_MAGIC = 0x44524431  # 'DRD1' (dense row matrices)
_CSR_REC_MAGIC = 0x44524331   # 'DRC1' (CSR device planes)


def _vec(arr, dtype) -> bytes:
    """Length-prefixed little-endian vector (serializer.h WriteVec)."""
    if arr is None:
        return struct.pack("<Q", 0)
    a = np.ascontiguousarray(arr, dtype=np.dtype(dtype).newbyteorder("<"))
    return struct.pack("<Q", a.size) + a.tobytes()


def _serialize_rows(block, r0: int, r1: int, index64: bool) -> bytes:
    """Wire-format payload for rows [r0, r1) of a parsed RowBlock."""
    o = block.offset
    lo, hi = int(o[r0]), int(o[r1])
    sub_offset = o[r0:r1 + 1] - lo
    index = block.index[lo:hi]
    value = block.value[lo:hi] if block.value is not None else None
    # typed csv values route to the matching wire vector (rowblock.h)
    val_f32 = val_i32 = val_i64 = None
    value_dtype = 0
    if value is not None:
        if value.dtype == np.int32:
            val_i32, value_dtype = value, 1
        elif value.dtype == np.int64:
            val_i64, value_dtype = value, 2
        else:
            val_f32 = value.astype(np.float32, copy=False)
    max_index = int(index.max()) if index.size else 0
    field = block.field[lo:hi] if block.field is not None else None
    max_field = int(field.max()) if field is not None and field.size else 0
    parts = [
        struct.pack("<II", _REC_MAGIC, 1 if index64 else 0),
        _vec(sub_offset, np.uint64),
        _vec(block.label[r0:r1], np.float32),
        _vec(block.weight[r0:r1] if block.weight is not None else None,
             np.float32),
        _vec(block.qid[r0:r1] if block.qid is not None else None, np.uint64),
        _vec(field, np.uint32),
        _vec(index, np.uint64 if index64 else np.uint32),
        _vec(val_f32, np.float32),
        _vec(val_i32, np.int32),
        _vec(val_i64, np.int64),
        struct.pack("<iQI", value_dtype, max_index, max_field),
    ]
    return b"".join(parts)


def rows_to_dense_recordio(src_uri: str, dst_uri: str, fmt: str = "auto",
                           rows_per_record: int = 4096,
                           dtype: str = "bf16",
                           num_features: int = 0,
                           part: int = 0, npart: int = 1,
                           nthread: int = 0) -> int:
    """Parse `src_uri` and write DENSE row-matrix records (cpp/src/
    dense_rec.h layout) to `dst_uri`; returns the number of rows.

    The zero-parse ingest lane: each record stores label[] (+weight[] when
    the source carries weights) and the [rows, F] feature matrix in device
    layout — bf16 by default, so the bytes on disk are the bytes the
    device batch holds and ingest is framing + memcpy. Dense-only by design: qid/field
    data has no dense plane (use rows_to_recordio for those).

    num_features=0 pre-scans the source once for the global max feature id
    (the matrix width must be uniform across records)."""
    if rows_per_record <= 0:
        raise DMLCError("rows_per_record must be positive")
    if dtype in ("bf16", "bfloat16"):
        np_dtype, flag_bf16 = BF16_STORAGE, 1
    elif np.dtype(dtype) == np.float32:
        np_dtype, flag_bf16 = np.float32, 0
    else:
        raise DMLCError(f"dense rec dtype must be bf16 or float32, "
                        f"got {dtype!r}")
    if num_features <= 0:
        # the matrix width must be GLOBAL: prescan the whole source (not
        # this part) so parallel part-wise conversions agree on F
        num_features = 0
        with NativeParser(src_uri, part=0, npart=1, fmt=fmt,
                          nthread=nthread) as p:
            for b in p:
                num_features = max(num_features, int(b.max_index) + 1)
        if num_features == 0:
            num_features = 1
    F = num_features

    total = 0
    has_weight = None  # pinned on the first block (uniform records)
    with NativeParser(src_uri, part=part, npart=npart, fmt=fmt,
                      nthread=nthread) as p, \
            NativeRecordIOWriter(dst_uri) as w:
        for block in p:
            if block.qid is not None or block.field is not None:
                raise DMLCError(
                    "qid/field columns have no dense representation; use "
                    "rows_to_recordio for ranking/FM data")
            if has_weight is None:
                has_weight = block.weight is not None
            elif has_weight != (block.weight is not None):
                raise DMLCError(
                    "weight column appeared in some rows only; dense rec "
                    "records must be uniform")
            n = block.num_rows
            if int(block.max_index) + 1 > F:
                raise DMLCError(
                    f"feature index {int(block.max_index)} exceeds the "
                    f"dense width {F}; pass a larger num_features")
            lens = np.diff(block.offset).astype(np.int64)
            row_of = np.repeat(np.arange(n, dtype=np.int64), lens)
            vals = (block.value if block.value is not None
                    else np.ones(block.nnz, np.float32))
            if flag_bf16:
                vals = bf16_bits(vals)  # uint16 bits, scattered as is
            for r0 in range(0, n, rows_per_record):
                r1 = min(r0 + rows_per_record, n)
                lo, hi = int(block.offset[r0]), int(block.offset[r1])
                x = np.zeros((r1 - r0, F), dtype=np_dtype)
                x[row_of[lo:hi] - r0, block.index[lo:hi]] = vals[lo:hi]
                parts = [struct.pack("<IIII", _DENSE_REC_MAGIC,
                                     flag_bf16 | (2 if has_weight else 0),
                                     r1 - r0, F),
                         np.ascontiguousarray(
                             block.label[r0:r1],
                             dtype=np.dtype(np.float32).newbyteorder("<"))
                         .tobytes()]
                if has_weight:
                    parts.append(np.ascontiguousarray(
                        block.weight[r0:r1],
                        dtype=np.dtype(np.float32).newbyteorder("<"))
                        .tobytes())
                # x elements are little-endian on disk (dense_rec.h)
                if flag_bf16:
                    parts.append(x.astype(np.dtype("<u2"), copy=False)
                                 .tobytes())
                else:
                    parts.append(x.astype(np.dtype("<f4"), copy=False)
                                 .tobytes())
                w.write_record(b"".join(parts))
            total += n
    return total


def compute_csr_window_table(src_uri: str, fmt: str = "auto",
                             nthread: int = 0) -> "np.ndarray":
    """GLOBAL sliding-window nnz maxima of a text source: win[i] = max nnz
    over any 2^i consecutive rows. Stamped into every .crec record so any
    byte-range partition can bound its per-shard bucket. Distributed
    conversions compute this ONCE (it needs the whole source) and pass it
    to each part's rows_to_csr_recordio."""
    lens_parts = []
    with NativeParser(src_uri, part=0, npart=1, fmt=fmt,
                      nthread=nthread) as p:
        for b in p:
            lens_parts.append(np.diff(b.offset).astype(np.int64))
    lens = (np.concatenate(lens_parts) if lens_parts
            else np.zeros(0, np.int64))
    total_rows = int(lens.size)
    prefix = np.concatenate([[0], np.cumsum(lens)])
    nwin = max(int(np.ceil(np.log2(max(total_rows, 1)))) + 1, 1)
    win_max = np.zeros(nwin, np.uint64)
    for i in range(nwin):
        w = min(1 << i, total_rows)
        if w <= 0:
            continue
        win_max[i] = int((prefix[w:] - prefix[:-w]).max()) \
            if total_rows else 0
    # windows wider than the data hold everything
    return np.maximum.accumulate(win_max)


def rows_to_csr_recordio(src_uri: str, dst_uri: str, fmt: str = "auto",
                         rows_per_record: int = 4096,
                         part: int = 0, npart: int = 1,
                         nthread: int = 0,
                         window_table: "np.ndarray" = None) -> int:
    """Parse `src_uri` and write CSR DEVICE-PLANE records (cpp/src/
    csr_rec.h layout) to `dst_uri`; returns the number of rows.

    The zero-rearrangement sparse lane: each record stores row lengths,
    label[/weight/qid] vectors and the col/val[/field] planes contiguously
    in the exact order the packed batch wants them, so ingest is bulk
    memcpy + run-length row-id expansion (one pass, vs the "rec" lane's
    deserialize-then-rebatch two). Every record is stamped with the GLOBAL
    sliding-window nnz maxima table (max nnz over any 2^i consecutive
    rows), which makes the reader's per-shard nnz bucket a static
    property of (file, batch_rows, num_shards) — one device shape per
    epoch. Ingests via format "crec" (auto-detected for .crec).

    Two passes over the source: row lengths first (the window table), then
    the data — unless `window_table` (compute_csr_window_table) is passed,
    which distributed part-wise conversions should compute once and share
    instead of re-parsing the whole source per part. Float32 values only
    (typed csv int values convert)."""
    if rows_per_record <= 0:
        raise DMLCError("rows_per_record must be positive")
    win_max = (window_table if window_table is not None
               else compute_csr_window_table(src_uri, fmt=fmt,
                                             nthread=nthread))
    win_max = np.ascontiguousarray(win_max, np.uint64)
    nwin = int(win_max.size)

    written = 0
    max_col_global = 0
    with NativeParser(src_uri, part=part, npart=npart, fmt=fmt,
                      nthread=nthread) as p, \
            NativeRecordIOWriter(dst_uri) as w:
        flags = None
        for block in p:
            if flags is None:
                flags = ((1 if block.weight is not None else 0) |
                         (2 if block.qid is not None else 0) |
                         (4 if block.field is not None else 0))
            else:
                now = ((1 if block.weight is not None else 0) |
                       (2 if block.qid is not None else 0) |
                       (4 if block.field is not None else 0))
                if now != flags:
                    raise DMLCError(
                        "weight/qid/field columns appeared in some rows "
                        "only; csr rec records must be uniform")
            n = block.num_rows
            vals = (block.value if block.value is not None
                    else np.ones(block.nnz, np.float32))
            vals = vals.astype(np.float32, copy=False)
            for r0 in range(0, n, rows_per_record):
                r1 = min(r0 + rows_per_record, n)
                lo, hi = int(block.offset[r0]), int(block.offset[r1])
                rl = np.diff(block.offset[r0:r1 + 1]).astype("<u4")
                cols = block.index[lo:hi]
                mc = int(cols.max()) if cols.size else 0
                max_col_global = max(max_col_global, mc)
                if mc > 0x7FFFFFFF:
                    raise DMLCError(
                        f"feature index {mc} exceeds the int32 device "
                        f"layout")
                parts = [struct.pack("<IIIIQII", _CSR_REC_MAGIC, flags,
                                     r1 - r0, nwin, hi - lo, mc, 0),
                         win_max.astype("<u8").tobytes(),
                         rl.tobytes(),
                         np.ascontiguousarray(
                             block.label[r0:r1], "<f4").tobytes()]
                if flags & 1:
                    parts.append(np.ascontiguousarray(
                        block.weight[r0:r1], "<f4").tobytes())
                if flags & 2:
                    q = block.qid[r0:r1]
                    if q.max(initial=0) > 0x7FFFFFFF:
                        raise DMLCError(
                            "qid exceeds the int32 device layout")
                    parts.append(np.ascontiguousarray(q, "<i4").tobytes())
                parts.append(np.ascontiguousarray(cols, "<u4").tobytes())
                parts.append(np.ascontiguousarray(
                    vals[lo:hi], "<f4").tobytes())
                if flags & 4:
                    parts.append(np.ascontiguousarray(
                        block.field[lo:hi], "<u4").tobytes())
                w.write_record(b"".join(parts))
            written += n
    return written


def rows_to_recordio(src_uri: str, dst_uri: str, fmt: str = "auto",
                     rows_per_record: int = 4096, index64: bool = False,
                     part: int = 0, npart: int = 1, nthread: int = 0) -> int:
    """Parse `src_uri` (libsvm/csv/libfm) and write binary row-block records
    to `dst_uri`; returns the number of rows converted. The output ingests
    via format "rec" (auto-detected for a .rec suffix)."""
    if rows_per_record <= 0:
        raise DMLCError("rows_per_record must be positive")
    total = 0
    with NativeParser(src_uri, part=part, npart=npart, fmt=fmt,
                      nthread=nthread, index64=index64) as p, \
            NativeRecordIOWriter(dst_uri) as w:
        for block in p:
            n = block.num_rows
            for r0 in range(0, n, rows_per_record):
                r1 = min(r0 + rows_per_record, n)
                w.write_record(_serialize_rows(block, r0, r1, index64))
            total += n
    return total


def _main(argv=None) -> int:
    """CLI: `python -m dmlc_core_tpu_torch.io.convert SRC DST` — the output
    lane is chosen by DST's suffix (.rec / .crec / .drec), mirroring the
    readers' suffix auto-detection. `--index` additionally builds the
    .idx file that unlocks ?index=1&shuffle=1 on .rec outputs."""
    import argparse
    ap = argparse.ArgumentParser(
        description="Convert text datasets (libsvm/csv/libfm) to the "
                    "binary ingest lanes")
    ap.add_argument("src", help="source URI (any supported filesystem)")
    ap.add_argument("dst", help="destination: *.rec (CSR row blocks), "
                                "*.crec (CSR device planes), *.drec "
                                "(dense matrices)")
    ap.add_argument("--format", default="auto",
                    help="source format (auto/libsvm/csv/libfm; "
                         "?format= URI sugar also works)")
    ap.add_argument("--rows-per-record", type=int, default=4096)
    ap.add_argument("--dtype", default=None,
                    help="dense (.drec) element dtype: bf16 (default) or "
                         "float32; rejected for other output lanes")
    ap.add_argument("--part", type=int, default=0)
    ap.add_argument("--npart", type=int, default=1)
    ap.add_argument("--index", action="store_true",
                    help="also write DST.idx (rec outputs only)")
    args = ap.parse_args(argv)
    if args.index and not args.dst.endswith(".rec"):
        # usage errors must surface BEFORE a possibly hours-long write
        raise DMLCError("--index applies to .rec outputs only")
    if args.dtype is not None and not args.dst.endswith(".drec"):
        raise DMLCError("--dtype applies to .drec outputs only "
                        "(.rec/.crec store exact CSR values)")
    common = dict(fmt=args.format, rows_per_record=args.rows_per_record,
                  part=args.part, npart=args.npart)
    if args.dst.endswith(".crec"):
        n = rows_to_csr_recordio(args.src, args.dst, **common)
    elif args.dst.endswith(".drec"):
        n = rows_to_dense_recordio(args.src, args.dst,
                                   dtype=args.dtype or "bf16", **common)
    elif args.dst.endswith(".rec"):
        n = rows_to_recordio(args.src, args.dst, **common)
    else:
        raise DMLCError(
            f"cannot infer the output lane from {args.dst!r}: use a "
            f".rec, .crec, or .drec suffix")
    print(f"wrote {n} rows to {args.dst}")
    if args.index:
        nrec = build_recordio_index(args.dst)
        print(f"indexed {nrec} records -> {args.dst}.idx")
    return 0


def build_recordio_index(uri: str, index_uri: str = None) -> int:
    """Write the `id offset` text index for a RecordIO file — the
    indexed_recordio contract (reference indexed_recordio_split.h) that
    unlocks record-count partitioning and EXACT per-epoch record shuffling
    (`?index=1&shuffle=1` on a .rec data URI). Walks the on-disk frames,
    so escaped multi-part records index at their first part. Returns the
    record count; index lands at `uri + ".idx"` unless given."""
    magic = 0xCED7230A
    entries = []
    rec_id = 0
    pos = 0
    with NativeStream(uri) as s:
        buf = b""
        buf_start = 0  # stream offset of buf[0]

        def headers():
            """Yield (pos, word, lrec) for each frame head, skipping
            payload bytes the walk doesn't need (the stream is
            sequential-only, so 'seek' = read-and-discard)."""
            nonlocal buf, buf_start, pos
            while True:
                # the payload may extend past everything buffered: discard
                # the buffer and swallow the gap chunkwise
                if pos >= buf_start + len(buf):
                    gap = pos - (buf_start + len(buf))
                    while gap > 0:
                        chunk = s.read(min(gap, 1 << 20))
                        if not chunk:
                            return  # truncated tail: stop at EOF
                        gap -= len(chunk)
                    buf = b""
                    buf_start = pos
                else:  # drop the consumed prefix only
                    buf = buf[pos - buf_start:]
                    buf_start = pos
                while len(buf) < 8:
                    chunk = s.read()
                    if not chunk:
                        return  # end of stream (or trailing partial head)
                    buf += chunk
                yield struct.unpack_from("<II", buf, 0)

        for word, lrec in headers():
            if word != magic:
                raise DMLCError(
                    f"not a RecordIO file: bad magic at byte {pos} of "
                    f"{uri}")
            cflag = lrec >> 29
            length = lrec & ((1 << 29) - 1)
            if cflag in (0, 1):  # whole record or first part
                entries.append((rec_id, pos))
                rec_id += 1
            pos += 8 + (length + 3) // 4 * 4
    if index_uri is None:
        index_uri = uri + ".idx"
    with NativeStream(index_uri, "w") as s:
        s.write("".join(f"{i} {o}\n" for i, o in entries).encode())
    return rec_id


if __name__ == "__main__":
    import sys as _sys

    _sys.exit(_main())
