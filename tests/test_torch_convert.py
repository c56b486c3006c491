"""The port's converter against the reference's: the same seeded text files
through ``dmlc_core_tpu.io.convert`` and ``dmlc_core_tpu_torch.io.convert``
give byte-equal ``.rec``, ``.crec`` and ``.drec`` (bf16 and float32) files,
the same window tables and record indexes, and the two CLIs write the same
bytes and print the same lines.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from dmlc_core_tpu.io import convert as ref
from tests.torch_reference_native import reference_native  # noqa: F401

from dmlc_core_tpu_torch.base import DMLCError
from dmlc_core_tpu_torch.io import convert
from dmlc_core_tpu_torch.io.native import NativeRecordIOReader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_text(path, rows=900, features=11, seed=0, kind="libsvm"):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(rows):
            keep = np.flatnonzero(rng.random(features) < 0.6)
            vals = rng.normal(size=len(keep))
            if kind == "libfm":
                feats = " ".join(f"{j % 4}:{j}:{v:.5f}"
                                 for j, v in zip(keep, vals))
                head = f"{i % 2}"
            else:
                feats = " ".join(f"{j}:{v:.5f}" for j, v in zip(keep, vals))
                head = f"{i % 3} qid:{i // 7}" if kind == "qid" else \
                    f"{i % 2}:{1 + (i % 3) * 0.5}" if kind == "weight" else \
                    f"{i % 2}"
            f.write(f"{head} {feats}\n")
    return str(path) + ("?format=libfm" if kind == "libfm" else "")


CASES = [
    ("crec", "rows_to_csr_recordio", "libsvm", {}),
    ("crec", "rows_to_csr_recordio", "qid", {}),
    ("crec", "rows_to_csr_recordio", "libfm", {}),
    ("crec", "rows_to_csr_recordio", "weight", {"part": 1, "npart": 2}),
    ("drec", "rows_to_dense_recordio", "libsvm", {}),
    ("drec", "rows_to_dense_recordio", "weight", {"dtype": "float32"}),
    ("drec", "rows_to_dense_recordio", "libsvm", {"num_features": 20}),
    ("rec", "rows_to_recordio", "libsvm", {}),
    ("rec", "rows_to_recordio", "qid", {"index64": True}),
    ("rec", "rows_to_recordio", "libfm", {}),
]


@pytest.mark.parametrize("suffix,fn,kind,kw", CASES)
def test_files_byte_equal_reference(tmp_path, suffix, fn, kind, kw):
    src = write_text(tmp_path / "src.txt", kind=kind)
    want, got = tmp_path / f"ref.{suffix}", tmp_path / f"port.{suffix}"
    n_ref = getattr(ref, fn)(src, str(want), rows_per_record=250, **kw)
    n = getattr(convert, fn)(src, str(got), rows_per_record=250, **kw)
    assert n == n_ref > 0
    assert got.read_bytes() == want.read_bytes()
    # the port's reader frames the records (at most 250 rows each, cut
    # per parsed block), each under its lane's magic
    magic = {"crec": b"1CRD", "drec": b"1DRD", "rec": b"1BRD"}[suffix]
    with NativeRecordIOReader(str(got)) as r:
        records = list(r)
    assert len(records) >= -(-n // 250)
    assert all(rec[:4] == magic for rec in records)


def test_window_table_and_index_match_reference(tmp_path):
    src = write_text(tmp_path / "w.libsvm", rows=1000, seed=3)
    np.testing.assert_array_equal(convert.compute_csr_window_table(src),
                                  ref.compute_csr_window_table(src))
    rec = str(tmp_path / "w.rec")
    convert.rows_to_recordio(src, rec, rows_per_record=100)
    with NativeRecordIOReader(rec) as r:
        count = len(list(r))
    assert convert.build_recordio_index(rec, rec + ".port.idx") == \
        ref.build_recordio_index(rec) == count >= 10
    assert (tmp_path / "w.rec.port.idx").read_bytes() == \
        (tmp_path / "w.rec.idx").read_bytes()


def test_bf16_rounding_matches_reference(tmp_path):
    # values whose bf16 rounding ties or carries: the native conversion
    # rounds to nearest even, as ml_dtypes does for the reference
    path = tmp_path / "t.libsvm"
    vals = np.array([1.00390625, 1.01171875, -3.0078125, 65504.0, 1e-30,
                     0.0, 3.4e38], np.float64)
    path.write_text("".join(f"1 {j}:{v!r}\n" for j, v in enumerate(vals)))
    a, b = tmp_path / "a.drec", tmp_path / "b.drec"
    ref.rows_to_dense_recordio(str(path), str(a))
    convert.rows_to_dense_recordio(str(path), str(b))
    assert b.read_bytes() == a.read_bytes()


@pytest.mark.parametrize("dst,extra", [("o.crec", []), ("o.drec", []),
                                       ("o.drec", ["--dtype", "float32"]),
                                       ("o.rec", ["--index"])])
def test_cli_matches_reference(tmp_path, dst, extra):
    src = write_text(tmp_path / "c.libsvm", rows=500, seed=4)
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    outs = {}
    for pkg in ("dmlc_core_tpu", "dmlc_core_tpu_torch"):
        d = tmp_path / pkg
        d.mkdir()
        proc = subprocess.run(
            [sys.executable, "-m", f"{pkg}.io.convert", src, str(d / dst),
             "--rows-per-record", "128", *extra], env=env,
            capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
        outs[pkg] = (proc.stdout.replace(str(d), "D"),
                     sorted((p.name, p.read_bytes()) for p in d.iterdir()))
    assert outs["dmlc_core_tpu_torch"] == outs["dmlc_core_tpu"]
    assert "wrote 500 rows" in outs["dmlc_core_tpu"][0]


@pytest.mark.parametrize("args,match", [
    (["x.crec", "--index"], "--index applies to .rec"),
    (["x.rec", "--dtype", "bf16"], "--dtype applies to .drec"),
    (["x.csv"], "cannot infer the output lane")])
def test_cli_usage_errors(tmp_path, args, match):
    src = write_text(tmp_path / "u.libsvm", rows=10)
    with pytest.raises(DMLCError, match=match):
        convert._main([src, str(tmp_path / args[0]), *args[1:]])


def test_bad_arguments_refused(tmp_path):
    src = write_text(tmp_path / "b.libsvm", rows=10)
    with pytest.raises(DMLCError, match="rows_per_record"):
        convert.rows_to_csr_recordio(src, str(tmp_path / "b.crec"),
                                     rows_per_record=0)
    with pytest.raises(DMLCError, match="dtype"):
        convert.rows_to_dense_recordio(src, str(tmp_path / "b.drec"),
                                       dtype="float16")
    qsrc = write_text(tmp_path / "q.libsvm", rows=10, kind="qid")
    with pytest.raises(DMLCError, match="no dense representation"):
        convert.rows_to_dense_recordio(qsrc, str(tmp_path / "q.drec"))
