"""The port's DeviceRowBlockIter lanes against the reference's: crec, recd,
index64 and bf16 CSR values.

The same seeded files (libsvm with and without ``qid:``, libfm with field
ids) go through ``dmlc_core_tpu``'s iterator and the port's. Host planes
must be byte-equal and device leaves must equal the reference's leaves bit
for bit (bf16 compared as bits): the planes are copied, never recomputed,
so the tolerance is zero. ``unpack_tree`` must decode the same named
leaves. Each lane resumes mid-epoch through ``state()``/``restore()``.
"""

import numpy as np
import pytest
import torch

from dmlc_core_tpu.io import convert as ref_convert
from dmlc_core_tpu.tpu import device_iter as ref_di
from tests.torch_reference_native import reference_native  # noqa: F401

from dmlc_core_tpu_torch.base import DMLCError
from dmlc_core_tpu_torch.device import device_iter as di
from dmlc_core_tpu_torch.io import convert

BATCH_ROWS = 128


def write_text(path, rows=700, features=9, seed=0, qid=False,
               field=False):
    """libsvm (``qid:`` optional) or, with ``field``, libfm rows; about
    70 % of the features present in each row."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(rows):
            keep = np.flatnonzero(rng.random(features) < 0.7)
            vals = rng.uniform(-2, 2, len(keep))
            if field:
                feats = " ".join(f"{j % 3}:{j}:{v:.5f}"
                                 for j, v in zip(keep, vals))
            else:
                feats = " ".join(f"{j}:{v:.5f}" for j, v in zip(keep, vals))
            head = f"{int(rng.integers(0, 3))} qid:{i // 9}" if qid else \
                f"{int(rng.random() < 0.5)}"
            f.write(f"{head} {feats}\n")
    return str(path)


def bits(a):
    """Raw bytes and shape of a numpy array or tensor (bf16 as bits)."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        a = a.numpy()
    a = np.asarray(a)
    if a.dtype.itemsize == 2:
        a = a.view(np.int16)
    return a.tobytes(), a.shape


def ref_trees(uri, to_device, **kw):
    with ref_di.DeviceRowBlockIter(uri, batch_rows=BATCH_ROWS, mesh=None,
                                   min_nnz_bucket=64, to_device=to_device,
                                   prefetch=0, **kw) as it:
        return [{k: np.array(v) for k, v in b.tree().items()} for b in it]


def port_trees(uri, prefetch=2, **kw):
    with di.DeviceRowBlockIter(uri, batch_rows=BATCH_ROWS,
                               min_nnz_bucket=64, prefetch=prefetch,
                               device="cpu", **kw) as it:
        return [{k: v.clone() for k, v in b.tree().items()} for b in it]


def assert_trees_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert bits(g[k]) == bits(w[k]), k
    # the named leaves decode the same planes
    for g, w in ((got[0], want[0]), (got[-1], want[-1])):
        port_named, ref_named = di.unpack_tree(g), ref_di.unpack_tree(w)
        assert set(port_named) == set(ref_named)
        for k in ref_named:
            assert bits(port_named[k]) == bits(ref_named[k]), k


def _files(tmp_path, kind):
    """(uri, iterator kwargs) of one lane case."""
    if kind.startswith("crec"):
        src = write_text(tmp_path / "s.txt", seed=1, qid=kind == "crec_qid",
                         field=kind == "crec_field")
        uri = str(tmp_path / "d.crec")
        fmt = "libfm" if kind == "crec_field" else "auto"
        convert.rows_to_csr_recordio(src, uri, fmt=fmt, rows_per_record=100)
        return uri, {}
    if kind.startswith("recd"):
        _, file_dtype, dtype = kind.split("_")
        src = write_text(tmp_path / "s.txt", seed=2)
        uri = str(tmp_path / "d.drec")
        convert.rows_to_dense_recordio(src, uri, rows_per_record=100,
                                       dtype=file_dtype)
        return uri, {"dense_dtype": dtype}
    if kind.startswith("index64"):
        _, layout, dtype = kind.split("_")
        uri = write_text(tmp_path / "s.txt", seed=3, qid=layout == "csr")
        return uri, {"index64": True, "layout": layout,
                     "dense_dtype": dtype}
    # bf16 CSR values on the text lane, with qid or field planes
    field = kind == "bf16vals_field"
    uri = write_text(tmp_path / "s.txt", seed=4, qid=not field, field=field)
    return (uri + ("?format=libfm" if field else ""),
            {"csr_val_dtype": "bf16", "layout": "csr"})


CASES = ["crec_plain", "crec_qid", "crec_field", "recd_bf16_bf16",
         "recd_float32_float32", "recd_bf16_float32", "index64_csr_float32",
         "index64_dense_float32", "index64_dense_bf16", "bf16vals_qid",
         "bf16vals_field"]


@pytest.mark.parametrize("kind", CASES)
def test_host_planes_byte_equal(tmp_path, kind):
    uri, kw = _files(tmp_path, kind)
    want = ref_trees(uri, to_device=False, **kw)
    with di.DeviceRowBlockIter(uri, batch_rows=BATCH_ROWS,
                               min_nnz_bucket=64, device="cpu",
                               **kw) as it:
        batcher = it.batcher
        got = []
        while (b := batcher.next_batch()) is not None:
            got.append({k: v.copy() for k, v in b.tree().items()})
            assert all(v.ctypes.data % 64 == 0 for v in b.tree().values())
            batcher.recycle(b)
    assert_trees_equal(got, want)


@pytest.mark.parametrize("kind", CASES)
def test_device_leaves_equal_reference(tmp_path, kind):
    uri, kw = _files(tmp_path, kind)
    want = ref_trees(uri, to_device=True, **kw)
    got = port_trees(uri, **kw)
    assert_trees_equal(got, want)
    if "csr_val_dtype" in kw:
        assert got[0]["val"].dtype == torch.bfloat16
        # kb = 3 with a field plane: field is plane 2
        shard = di.unpack_shard({k: v[0] for k, v in got[0].items()})
        assert shard["val"].dtype == torch.bfloat16
        assert ("field" in shard) == kind.endswith("field")
    if kw.get("dense_dtype") == "bf16":
        assert got[0]["x"].dtype == torch.bfloat16


@pytest.mark.parametrize("kind", ["crec_qid", "recd_bf16_bf16",
                                  "index64_csr_float32", "bf16vals_field"])
@pytest.mark.parametrize("prefetch", [0, 2])
def test_state_restore_mid_epoch(tmp_path, kind, prefetch):
    uri, kw = _files(tmp_path, kind)
    full = port_trees(uri, **kw)
    it_kw = dict(batch_rows=BATCH_ROWS, min_nnz_bucket=64,
                 prefetch=prefetch, device="cpu", **kw)
    with di.DeviceRowBlockIter(uri, **it_kw) as it:
        stream = iter(it)
        for _ in range(2):
            next(stream)
        state = it.state()
    assert state["batches_consumed"] == 2
    with di.DeviceRowBlockIter(uri, **it_kw) as it:
        it.restore(state)
        rest = [{k: v.clone() for k, v in b.tree().items()} for b in it]
        it.before_first()
        again = [{k: v.clone() for k, v in b.tree().items()} for b in it]
        assert it.bytes_read() > 0
    assert len(rest) == len(full) - 2
    for a, b in zip(rest + again, full[2:] + full):
        for k in a:
            assert bits(a[k]) == bits(b[k]), k


def test_suffix_picks_the_lane(tmp_path):
    uri, _ = _files(tmp_path, "crec_plain")
    with di.DeviceRowBlockIter(uri, device="cpu") as it:
        assert isinstance(it.batcher, di.CsrRecHostBatcher)
        assert it.state()["fmt"] == "crec"
    drec, _ = _files(tmp_path, "recd_bf16_bf16")
    with di.DeviceRowBlockIter(drec, device="cpu") as it:
        assert isinstance(it.batcher, di.DenseRecHostBatcher)
        assert it.state()["fmt"] == "recd"


@pytest.mark.parametrize("kw", [dict(fmt="crec"), dict(fmt="recd"),
                                dict(index64=True)])
def test_bf16_values_refused_on_binary_and_index64_lanes(tmp_path, kw):
    path = write_text(tmp_path / "a.libsvm", rows=10)
    for mod in (ref_di, di):
        extra = {} if mod is ref_di else {"device": "cpu"}
        with pytest.raises(Exception, match="csr_val_dtype='bf16'"):
            mod.DeviceRowBlockIter(path, csr_val_dtype="bf16", **kw,
                                   **extra)


@pytest.mark.parametrize("what", ["feature", "qid"])
def test_index64_refuses_ids_past_int32(tmp_path, what):
    path = tmp_path / "big.libsvm"
    if what == "feature":
        path.write_text("1 0:1.0 2147483648:2.0\n0 1:1.0\n")
    else:
        path.write_text("1 qid:2147483648 0:1.0\n0 qid:1 1:1.0\n")
    for mod in (ref_di, di):
        extra = {"to_device": False} if mod is ref_di else {"device": "cpu"}
        with mod.DeviceRowBlockIter(str(path), index64=True, batch_rows=2,
                                    layout="csr", prefetch=0,
                                    **extra) as it:
            with pytest.raises(Exception, match="int32 device layout"):
                list(it)
    # below the limit, the 64-bit parse goes through
    path.write_text("1 0:1.0 2147483647:2.0\n0 1:1.0\n")
    got = port_trees(str(path), index64=True, layout="csr")
    assert int(got[0]["big"][0, 1].max()) == 2147483647


def test_unknown_csr_val_dtype_refused(tmp_path):
    path = write_text(tmp_path / "a.libsvm", rows=10)
    with pytest.raises(DMLCError, match="csr_val_dtype"):
        di.DeviceRowBlockIter(path, csr_val_dtype="f16", device="cpu")


def test_bf16_pool_never_recycles_f32_buffers(tmp_path):
    path = write_text(tmp_path / "a.libsvm", rows=300, seed=5)
    hb = di.NativeHostBatcher(path, batch_rows=BATCH_ROWS, layout="csr",
                              min_nnz_bucket=64, csr_val_dtype="bf16")
    b = hb.next_batch()
    assert b.val16.dtype == np.uint16 and b.big.shape[1] == 2
    hb.recycle(b)
    assert list(hb._pool._pool) == [("csr", b.big.shape[-1], True)]
    b2 = hb.next_batch()
    assert b2.val16 is b.val16  # the same staging plane, reused
    hb.close()
