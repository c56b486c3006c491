"""The port's unpacked native fills and bf16 helpers against the reference.

``NativeBatcher.fill_csr`` / ``fill_dense``, ``NativeCsrRecBatcher.fill``,
``NativeDenseRecBatcher.fill`` and ``bf16_convert`` / ``bf16_upcast``
(``doc/api.md``) run in both packages on the same file and batch shape;
every plane of every batch must be equal bit for bit. The port carries
bf16 as uint16 bits, the reference as ``ml_dtypes.bfloat16``: they are
compared as uint16.
"""

import ml_dtypes
import numpy as np
import pytest

from dmlc_core_tpu.io import native as ref
from tests.torch_reference_native import reference_native  # noqa: F401

from dmlc_core_tpu_torch.base import DMLCError
from dmlc_core_tpu_torch.io import convert
from dmlc_core_tpu_torch.io import native as port

BF16 = ml_dtypes.bfloat16
D, ROWS = 2, 64  # two shards of 32 rows a batch


def write_libsvm(path, rows=300, features=40, seed=3, qid=False):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(rows):
            keep = np.flatnonzero(rng.random(features) < 0.3)
            feats = " ".join(f"{j}:{rng.uniform(-2, 2):.5f}" for j in keep)
            q = f" qid:{i // 7}" if qid else ""
            f.write(f"{i % 2}{q} {feats}\n")
    return str(path)


def write_libfm(path, rows=300, seed=4):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(rows):
            feats = " ".join(f"{j % 5}:{j}:{rng.uniform(-1, 1):.4f}"
                             for j in sorted(rng.choice(60, 6, False)))
            f.write(f"{i % 2} {feats}\n")
    return str(path) + "?format=libfm"


def as_bits(a):
    return a.view(np.uint16) if a.dtype == BF16 else a


def csr_epoch(mod, uri):
    """Every batch of ``mod.NativeBatcher`` through fill_csr."""
    out = []
    with mod.NativeBatcher(uri, batch_rows=ROWS, num_shards=D,
                           min_nnz_bucket=64) as b:
        while (meta := b.next_meta()) is not None:
            take, bucket, _, has_qid, has_field = meta
            planes = {k: np.full((D, bucket), -7, dt) for k, dt in (
                ("row", np.int32), ("col", np.int32), ("val", np.float32))}
            planes.update(label=np.zeros(ROWS, np.float32),
                          weight=np.zeros(ROWS, np.float32),
                          nrows=np.zeros(D, np.int32))
            if has_qid:
                planes["qid"] = np.zeros(ROWS, np.int32)
            if has_field:
                planes["field"] = np.zeros((D, bucket), np.int32)
            b.fill_csr(**planes)
            out.append((take, planes))
    return out


def dense_epoch(mod, uri, dtype, features):
    out = []
    with mod.NativeBatcher(uri, batch_rows=ROWS, num_shards=D) as b:
        while (meta := b.next_meta()) is not None:
            planes = {"x": np.full((ROWS, features), 5, dtype),
                      "label": np.zeros(ROWS, np.float32),
                      "weight": np.zeros(ROWS, np.float32),
                      "nrows": np.zeros(D, np.int32)}
            if meta[3]:
                planes["qid"] = np.zeros(ROWS, np.int32)
            b.fill_dense(**planes)
            out.append((meta[0], planes))
    return out


def assert_epochs_equal(got, want):
    assert len(got) == len(want) and len(got) > 1
    for (tg, pg), (tw, pw) in zip(got, want):
        assert tg == tw
        assert sorted(pg) == sorted(pw)
        for k in pw:
            np.testing.assert_array_equal(as_bits(pg[k]), as_bits(pw[k]),
                                          err_msg=k)


@pytest.mark.parametrize("kind", ["libsvm", "libsvm_qid", "libfm"])
def test_fill_csr_matches_reference(tmp_path, kind):
    if kind == "libfm":
        uri = write_libfm(tmp_path / "d.libfm")
    else:
        uri = write_libsvm(tmp_path / "d.libsvm", qid=kind == "libsvm_qid")
    got, want = csr_epoch(port, uri), csr_epoch(ref, uri)
    assert_epochs_equal(got, want)
    if kind == "libfm":
        assert "field" in got[0][1]
    if kind == "libsvm_qid":
        assert "qid" in got[0][1]


@pytest.mark.parametrize("qid", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bf16"])
def test_fill_dense_matches_reference(tmp_path, dtype, qid):
    uri = write_libsvm(tmp_path / "d.libsvm", features=12, qid=qid)
    got = dense_epoch(port, uri, np.float32 if dtype == "float32"
                      else port.BF16_STORAGE, 12)
    want = dense_epoch(ref, uri, np.float32 if dtype == "float32"
                       else BF16, 12)
    assert_epochs_equal(got, want)


def test_fill_dense_refuses_other_dtypes(tmp_path):
    uri = write_libsvm(tmp_path / "d.libsvm", features=12)
    with port.NativeBatcher(uri, batch_rows=ROWS, num_shards=D) as b:
        b.next_meta()
        with pytest.raises(DMLCError, match="float32 or bf16"):
            b.fill_dense(np.zeros((ROWS, 12), np.float64),
                         np.zeros(ROWS, np.float32),
                         np.zeros(ROWS, np.float32), np.zeros(D, np.int32))


def crec_epoch(mod, uri):
    out = []
    with mod.NativeCsrRecBatcher(uri, batch_rows=ROWS, num_shards=D,
                                 min_nnz_bucket=64) as b:
        bucket, has_weight, has_qid, has_field = b.meta()
        while True:
            planes = {k: np.full((D, bucket), -7, dt) for k, dt in (
                ("row", np.int32), ("col", np.int32), ("val", np.float32))}
            planes.update(label=np.zeros(ROWS, np.float32),
                          weight=np.zeros(ROWS, np.float32),
                          nrows=np.zeros(D, np.int32))
            if has_qid:
                planes["qid"] = np.zeros(ROWS, np.int32)
            take = b.fill(**planes)
            if take == 0:
                return out
            out.append((take, planes))


@pytest.mark.parametrize("qid", [False, True])
def test_crec_fill_matches_reference(tmp_path, qid):
    src = write_libsvm(tmp_path / "d.libsvm", qid=qid)
    crec = str(tmp_path / "d.crec")
    convert.rows_to_csr_recordio(src, crec, fmt="libsvm", rows_per_record=48)
    assert_epochs_equal(crec_epoch(port, crec), crec_epoch(ref, crec))


def drec_epoch(mod, uri, dtype):
    out = []
    with mod.NativeDenseRecBatcher(uri, batch_rows=ROWS,
                                   num_shards=D) as b:
        F = b.meta()[0]
        while True:
            planes = {"x": np.full((ROWS, F), 5, dtype),
                      "label": np.zeros(ROWS, np.float32),
                      "weight": np.zeros(ROWS, np.float32),
                      "nrows": np.zeros(D, np.int32)}
            take = b.fill(**planes)
            if take == 0:
                return out
            out.append((take, planes))


@pytest.mark.parametrize("disk", ["bf16", "float32"])
@pytest.mark.parametrize("out", ["bf16", "float32"])
def test_drec_fill_matches_reference(tmp_path, disk, out):
    src = write_libsvm(tmp_path / "d.libsvm", features=12)
    drec = str(tmp_path / "d.drec")
    convert.rows_to_dense_recordio(src, drec, fmt="libsvm", dtype=disk,
                                   rows_per_record=40)
    got = drec_epoch(port, drec, np.float32 if out == "float32"
                     else port.BF16_STORAGE)
    want = drec_epoch(ref, drec, np.float32 if out == "float32" else BF16)
    assert_epochs_equal(got, want)


def bf16_fuzz(n=1 << 16, seed=21):
    """float32 values that stress the conversion: NaNs (quiet and
    signalling payloads), +-inf, +-0, subnormals, exact ties between two
    bf16 neighbours (both parities), one ulp either side of a tie, the
    largest finite values (which round to inf), and random bit patterns."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    hi = rng.integers(0, 1 << 16, n // 8, dtype=np.uint32) << 16
    ties = hi | 0x8000                       # exactly halfway
    special = np.array([0x7FC00000, 0x7F800001, 0xFFC00001, 0x7FBFFFFF,
                        0x7F800000, 0xFF800000, 0x00000000, 0x80000000,
                        0x00000001, 0x807FFFFF, 0x00400000, 0x7F7FFFFF,
                        0xFF7FFFFF, 0x7F7F8000, 0x3F808000, 0x3F818000,
                        0x3F807FFF, 0x3F808001], np.uint32)
    sub = rng.integers(0, 1 << 23, n // 8, dtype=np.uint32) | (
        rng.integers(0, 2, n // 8, dtype=np.uint32) << 31)
    return np.concatenate([special, ties, ties - 1, ties + 1, sub,
                           bits]).view(np.float32)


def test_bf16_convert_matches_reference_and_rne():
    src = bf16_fuzz()
    got = np.empty(src.size, port.BF16_STORAGE)
    port.bf16_convert(src, got)
    want = np.empty(src.size, BF16)
    ref.bf16_convert(src, want)
    nan = np.isnan(src)
    np.testing.assert_array_equal(got, want.view(np.uint16))
    # ml_dtypes' round to nearest even on every non-NaN; NaN stays NaN
    rne = src[~nan].astype(BF16).view(np.uint16)
    np.testing.assert_array_equal(got[~nan], rne)
    assert np.isnan(got[nan].view(BF16).astype(np.float32)).all()
    np.testing.assert_array_equal(port.bf16_bits(src), got)


def test_bf16_upcast_matches_reference_and_is_exact():
    bits = np.concatenate([port.bf16_bits(bf16_fuzz()),
                           np.arange(1 << 16, dtype=np.uint16)])
    got = np.empty(bits.size, np.float32)
    port.bf16_upcast(bits, got)
    want = np.empty(bits.size, np.float32)
    ref.bf16_upcast(bits.view(BF16), want)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(
        got.view(np.uint32), bits.astype(np.uint32) << 16)


def test_bf16_helpers_check_their_buffers():
    src = np.ones(8, np.float32)
    with pytest.raises(DMLCError, match="uint16"):
        port.bf16_convert(src, np.empty(8, np.float16))
    with pytest.raises(DMLCError, match="8 elements"):
        port.bf16_convert(src, np.empty(7, port.BF16_STORAGE))
    with pytest.raises(DMLCError, match="float32"):
        port.bf16_upcast(np.zeros(8, port.BF16_STORAGE),
                         np.empty(8, np.float64))
