"""Host batches: ``DeviceRowBlockIter(to_device=False)`` and the learners
that take them, against the reference.

Every lane (text CSR and dense bf16, ``.rec``, ``.drec``, ``.crec``,
``index64``, ``?shuffle_parts=``, ``#cachefile=``; ``prefetch=0`` and
``prefetch=2``) goes through the reference's iterator and the port's, both
with ``to_device=False``. The port hands over numpy batches whose leaves
equal the reference's bit for bit (bf16 compared as its uint16 bits); no
handed-out batch is overwritten while the iterator moves on (every batch
of the epoch is kept and compared after the epoch ends), and no device
counter moves in either package. The reference's own ``to_device=False``
calls are mirrored one by one (``bench.py:758`` and ``:1295``,
``tests/test_s3.py:194``, ``tests/test_fm.py:52``,
``tests/test_ranking_learner.py:73``, ``tests/test_native_parser.py:412``):
the learners' predictions and steps on host batches agree with the
reference's at rtol 2e-5, the reference's tolerance. The reference's
call signatures that the port now honours (``HostBatcher(p, 256, 4, 64,
True)``, ``process_part(1)``, a positional ``data_mesh``) close the file.
"""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dmlc_core_tpu import telemetry as ref_telemetry
from dmlc_core_tpu.io.native import NativeParser as RefParser
from dmlc_core_tpu.models.fm import FMLearner as RefFM
from dmlc_core_tpu.models.fm import FMParams as RefFMParams
from dmlc_core_tpu.models.linear import LinearLearner as RefLinear
from dmlc_core_tpu.models.linear import LinearParams as RefLinearParams
from dmlc_core_tpu.tpu import device_iter as ref_di
from test_s3 import _STATE as S3_STATE
from tests.torch_reference_native import reference_native  # noqa: F401

from dmlc_core_tpu_torch import telemetry
from dmlc_core_tpu_torch.base import DMLCError
from dmlc_core_tpu_torch.device import device_iter as di
from dmlc_core_tpu_torch.device import sharding
from dmlc_core_tpu_torch.io import convert
from dmlc_core_tpu_torch.io.native import NativeParser
from dmlc_core_tpu_torch.models.convert import (fm_params_from_numpy,
                                                linear_params_from_numpy,
                                                linear_params_to_numpy)
from dmlc_core_tpu_torch.models.fm import FMLearner
from dmlc_core_tpu_torch.models.linear import LinearLearner

BATCH_ROWS = 128
# the counters and histograms of the copying path, which a host batch
# never reaches (device.stage and device.wait still move)
DEVICE_COUNTERS = ("device_batches_total", "device_transfer_bytes_total",
                   "device_zero_copy_batches_total")
DEVICE_HISTOGRAMS = ("device_transfer_us", "device_put_submit_us",
                     "device_put_block_us")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_text(path, rows=700, features=9, seed=0, qid=False):
    """libsvm rows (``qid:`` optional), about 70 % of the features
    present in each."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(rows):
            keep = np.flatnonzero(rng.random(features) < 0.7)
            vals = rng.uniform(-2, 2, len(keep))
            feats = " ".join(f"{j}:{v:.5f}" for j, v in zip(keep, vals))
            head = f"{int(rng.integers(0, 3))} qid:{i // 9}" if qid else \
                f"{int(rng.random() < 0.5)}"
            f.write(f"{head} {feats}\n")
    return str(path)


def bits(a):
    """Raw bytes, dtype size and shape of a host leaf (bf16 as uint16)."""
    a = np.asarray(a)
    return a.tobytes(), a.dtype.itemsize, a.shape


def lane(tmp_path, kind):
    """(uri, iterator kwargs) of one lane."""
    src = write_text(tmp_path / "s.libsvm", seed=len(kind), qid=kind ==
                     "index64")
    if kind == "text_csr":
        return src, {"layout": "csr"}
    if kind == "text_dense_bf16":
        return src, {"layout": "dense", "dense_dtype": "bf16"}
    if kind == "rec":
        uri = str(tmp_path / "d.rec")
        convert.rows_to_recordio(src, uri, rows_per_record=100)
        return uri, {"layout": "csr"}
    if kind == "drec":
        uri = str(tmp_path / "d.drec")
        convert.rows_to_dense_recordio(src, uri, rows_per_record=100,
                                       dtype="bf16")
        return uri, {"dense_dtype": "bf16"}
    if kind == "crec":
        uri = str(tmp_path / "d.crec")
        convert.rows_to_csr_recordio(src, uri, rows_per_record=100)
        return uri, {}
    if kind == "index64":
        return src, {"index64": True, "layout": "csr"}
    if kind == "shuffle":
        return src + "?shuffle_parts=8&shuffle_seed=3", {"layout": "csr"}
    assert kind == "cachefile"
    return f"{src}#cachefile={tmp_path / 'cache'}", {"layout": "csr"}


LANES = ["text_csr", "text_dense_bf16", "rec", "drec", "crec", "index64",
         "shuffle", "cachefile"]


def ref_host(uri, **kw):
    """The reference's host batches of one ``to_device=False`` epoch."""
    kw.setdefault("batch_rows", BATCH_ROWS)
    with ref_di.DeviceRowBlockIter(uri, mesh=None, to_device=False,
                                   **kw) as it:
        return list(it)


def port_host(uri, **kw):
    """Every batch of one ``to_device=False`` epoch, kept as handed out
    (no copy) until the epoch ended."""
    kw.setdefault("batch_rows", BATCH_ROWS)
    with di.DeviceRowBlockIter(uri, to_device=False, device="cpu",
                               **kw) as it:
        return list(it)


def assert_host_equal(got, want):
    """The port's host batches hold the reference's leaves bit for bit."""
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        tree, w = g.tree(), w.tree()
        assert set(tree) == set(w)
        for k in w:
            assert isinstance(tree[k], np.ndarray), k
            assert bits(tree[k]) == bits(w[k]), k


def device_metrics():
    return ({n: telemetry.counter(n).value for n in DEVICE_COUNTERS},
            {n: telemetry.histogram(n).summary()["count"]
             for n in DEVICE_HISTOGRAMS})


def ref_device_metrics():
    return ({n: ref_telemetry.counter(n).value for n in DEVICE_COUNTERS},
            {n: ref_telemetry.histogram(n).count
             for n in DEVICE_HISTOGRAMS})


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("kind", LANES)
def test_host_batches_are_the_references(tmp_path, kind, prefetch):
    uri, kw = lane(tmp_path, kind)
    want = ref_host(uri, min_nnz_bucket=64, prefetch=prefetch, **kw)
    before = device_metrics()
    stage0 = telemetry.histogram("device_stage_us").summary()["count"]
    got = port_host(uri, min_nnz_bucket=64, prefetch=prefetch, **kw)
    assert device_metrics() == before
    assert telemetry.histogram("device_stage_us").summary()["count"] == \
        stage0 + len(got)
    # kept without a copy through the whole epoch: a recycled buffer
    # would have been refilled by a later batch by now
    assert_host_equal(got, want)
    leaves = [v for b in got for v in b.tree().values()]
    assert not any(np.shares_memory(a, b) for i, a in enumerate(leaves)
                   for b in leaves[i + 1:])


@pytest.mark.parametrize("kind", ["text_csr", "drec", "crec"])
def test_host_epoch_moves_no_device_counter_in_either_package(tmp_path,
                                                              kind):
    uri, kw = lane(tmp_path, kind)
    ref_before, port_before = ref_device_metrics(), device_metrics()
    ref_host(uri, **kw)
    port_host(uri, **kw)
    assert ref_device_metrics() == ref_before
    assert device_metrics() == port_before
    # the copying path does move them
    with di.DeviceRowBlockIter(uri, batch_rows=BATCH_ROWS, device="cpu",
                               **kw) as it:
        n = sum(1 for _ in it)
    assert device_metrics()[0]["device_batches_total"] == \
        port_before[0]["device_batches_total"] + n


def test_host_batches_equal_the_copied_batches(tmp_path):
    uri, kw = lane(tmp_path, "text_dense_bf16")
    host = port_host(uri, **kw)
    with di.DeviceRowBlockIter(uri, batch_rows=BATCH_ROWS, device="cpu",
                               **kw) as it:
        dev = [{k: v.clone() for k, v in b.tree().items()} for b in it]
    assert len(host) == len(dev)
    for h, d in zip(host, dev):
        moved = di.to_device_batch(h, "cpu").tree()
        assert set(moved) == set(d)
        for k in d:
            assert moved[k].dtype == d[k].dtype
            assert torch.equal(moved[k].view(torch.int16),
                               d[k].view(torch.int16))


def test_restore_and_before_first_with_host_batches(tmp_path):
    uri, kw = lane(tmp_path, "text_csr")
    full = port_host(uri, **kw)
    with di.DeviceRowBlockIter(uri, batch_rows=BATCH_ROWS, to_device=False,
                               device="cpu", **kw) as it:
        head = [b for _, b in zip(range(2), it)]
        state = it.state()
        it.restore(state)
        rest = list(it)
        it.before_first()
        again = list(it)
    assert_host_equal(head + rest, full)
    assert_host_equal(again, full)


def test_mesh_rank_hands_over_its_local_host_batch(tmp_path):
    """With ``mesh=`` the global batch splits over the ranks; each rank
    hands over its own part's local host batch, the copied batch's
    planes."""
    uri, kw = lane(tmp_path, "text_csr")
    mesh = sharding.DataMesh(group=None, rank=0, size=2,
                             device=torch.device("cpu"))
    for part in range(2):
        it_kw = dict(batch_rows=2 * BATCH_ROWS, mesh=mesh, part=part,
                     npart=2, device="cpu", **kw)
        with di.DeviceRowBlockIter(uri, to_device=False, **it_kw) as it:
            host = list(it)
        with di.DeviceRowBlockIter(uri, **it_kw) as it:
            dev = [{k: v.clone() for k, v in b.tree().items()} for b in it]
        assert len(host) == len(dev) > 0
        for h, d in zip(host, dev):
            assert h.rows_per_shard == BATCH_ROWS
            for k, v in h.tree().items():
                assert torch.equal(torch.from_numpy(v), d[k]), k


# -- the reference's own to_device=False calls, mirrored --------------------
def test_bench_cache_probe_flow(tmp_path):
    """``bench.py:758``: the first pass over a ``#cachefile=`` URI, then
    its replay, as host trees."""
    src = write_text(tmp_path / "s.libsvm", rows=900, seed=5)
    for p in ("ref", "port"):
        (tmp_path / p).mkdir()
    for epoch in range(2):  # the pass that tees the cache, then a replay
        want = ref_host(f"{src}#cachefile={tmp_path / 'ref' / 'c'}",
                        batch_rows=256, layout="csr")
        got = port_host(f"{src}#cachefile={tmp_path / 'port' / 'c'}",
                        batch_rows=256, layout="csr")
        assert_host_equal(got, want)


@pytest.mark.parametrize("kind,fmt", [("text_csr", "libsvm"),
                                      ("rec", "rec"), ("drec", "recd"),
                                      ("crec", "crec")])
def test_bench_first_host_batch_flow(tmp_path, kind, fmt):
    """``bench.py:1295``: one host batch of each lane for the pytree
    ceiling, at the bench's keywords."""
    uri, _ = lane(tmp_path, kind)
    kw = dict(fmt=fmt, batch_rows=256, nthread=2, dense_dtype="bf16")
    with ref_di.DeviceRowBlockIter(uri, mesh=None, to_device=False,
                                   **kw) as hit:
        want = next(iter(hit))
    with di.DeviceRowBlockIter(uri, mesh=None, to_device=False,
                               device="cpu", **kw) as hit:
        got = next(iter(hit))
    assert_host_equal([got], [want])


def test_s3_flow(tmp_path):
    """``tests/test_s3.py:194``: ``.rec`` and ``.drec`` written through
    the stream layer to ``s3://``, read back as host batches whole and in
    three parts."""
    rng = np.random.default_rng(17)
    src = tmp_path / "s.libsvm"
    with open(src, "w") as f:
        for i in range(1500):
            f.write(f"{i % 2} " + " ".join(
                f"{j}:{rng.uniform():.4f}" for j in range(8)) + "\n")
    base = "s3://bkt/torch-host-batches"
    convert.rows_to_recordio(str(src), f"{base}/a.rec", rows_per_record=128)
    convert.rows_to_dense_recordio(str(src), f"{base}/a.drec",
                                   rows_per_record=128)
    try:
        for uri, fmt in ((f"{base}/a.rec", "rec"),
                         (f"{base}/a.drec", "recd")):
            kw = dict(fmt=fmt, batch_rows=256, dense_dtype="bf16")
            got = port_host(uri, **kw)
            assert sum(b.total_rows for b in got) == 1500
            assert_host_equal(got, ref_host(uri, **kw))
        total = 0
        for k in range(3):
            kw = dict(fmt="rec", part=k, npart=3, batch_rows=256)
            got = port_host(f"{base}/a.rec", **kw)
            assert_host_equal(got, ref_host(f"{base}/a.rec", **kw))
            total += sum(b.total_rows for b in got)
        assert total == 1500
    finally:
        for key in ("a.rec", "a.drec"):
            S3_STATE.objects.pop(("bkt", f"torch-host-batches/{key}"), None)


def write_interaction_libsvm(path, rows=256, seed=3):
    """``tests/test_fm.py``'s file: y = 1 iff x0*x1 > 0."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, size=(rows, 4)).astype(np.float32)
    y = (X[:, 0] * X[:, 1] > 0).astype(int)
    with open(path, "w") as f:
        for i in range(rows):
            feats = " ".join(f"{j}:{X[i, j]:.5f}" for j in range(4))
            f.write(f"{y[i]} {feats}\n")
    return X


@pytest.mark.parametrize("layout", ["csr", "dense"])
def test_fm_predict_on_a_host_batch(tmp_path, layout):
    """``tests/test_fm.py:52``: ``FMLearner.predict`` on a
    ``to_device=False`` batch, against the reference's predictions and
    the float64 oracle at rtol 2e-5."""
    X = write_interaction_libsvm(tmp_path / "m.libsvm")
    rng = np.random.default_rng(0)
    p = {"b": np.float32(0.03), "w": rng.normal(size=4).astype(np.float32),
         "v": rng.normal(scale=0.5, size=(4, 3)).astype(np.float32)}
    kw = dict(batch_rows=256, layout=layout, min_nnz_bucket=2048,
              dense_dtype="float32", to_device=False)
    with ref_di.DeviceRowBlockIter(str(tmp_path / "m.libsvm"),
                                   **kw) as it:
        ref_batch = next(iter(it))
    with di.DeviceRowBlockIter(str(tmp_path / "m.libsvm"), device="cpu",
                               **kw) as it:
        batch = next(iter(it))
    assert isinstance(batch.tree()["aux"], np.ndarray)
    want = np.asarray(RefFM(num_features=4, k=3).predict(
        RefFMParams(b=jnp.asarray(p["b"]), w=jnp.asarray(p["w"]),
                    v=jnp.asarray(p["v"])), ref_batch)).reshape(-1)
    got = FMLearner(num_features=4, k=3, device="cpu").predict(
        fm_params_from_numpy(p, device="cpu"), batch).numpy().reshape(-1)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    s1, s2 = X @ p["v"], (X * X) @ (p["v"] * p["v"])
    oracle = p["b"] + X @ p["w"] + 0.5 * ((s1 * s1).sum(-1) - s2.sum(-1))
    np.testing.assert_allclose(got[:256], oracle, rtol=2e-5, atol=2e-5)


def write_ranking_libsvm(path, queries=60, docs=8, features=6, seed=4):
    """``tests/test_ranking_learner.py``'s shape: graded labels from a
    hidden linear score, ``docs`` documents a query."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=features)
    with open(path, "w") as f:
        for q in range(queries):
            X = rng.normal(size=(docs, features))
            rel = np.digitize(X @ w, [-1.0, 0.0, 1.0])
            for i in range(docs):
                feats = " ".join(f"{j}:{X[i, j]:.4f}"
                                 for j in range(features))
                f.write(f"{rel[i]} qid:{q} {feats}\n")


def pairwise_accuracy(w, batches):
    """The reference test's accuracy, over host batches' numpy leaves."""
    good = total = 0
    for b in batches:
        t = di.unpack_tree(b.tree())
        x = np.asarray(t["x"])
        margin = x.reshape(-1, x.shape[-1]).astype(np.float32) @ w
        qid, lab, wgt = (np.asarray(t[k]).reshape(-1)
                         for k in ("qid", "label", "weight"))
        for q in np.unique(qid):
            if q < 0:
                continue
            m = (qid == q) & (wgt > 0)
            mm, ll = margin[m], lab[m]
            for i in range(len(ll)):
                for j in range(len(ll)):
                    if ll[i] > ll[j]:
                        total += 1
                        good += mm[i] > mm[j]
    return good / max(total, 1)


def test_ranking_flow_on_host_batches(tmp_path):
    """``tests/test_ranking_learner.py:73``: host batches of a ranking
    file, stepped on and scored by both packages' pairwise learners: the
    losses, the parameters and the predictions at rtol 2e-5, the pairwise
    accuracy equal."""
    src = str(tmp_path / "rank.libsvm")
    write_ranking_libsvm(src)
    kw = dict(batch_rows=256, to_device=False, layout="dense")
    with ref_di.DeviceRowBlockIter(src, **kw) as it:
        ref_batches = list(it)
    with di.DeviceRowBlockIter(src, device="cpu", **kw) as it:
        batches = list(it)
    assert_host_equal(batches, ref_batches)
    ref_learner = RefLinear(num_features=6, objective="pairwise",
                            learning_rate=0.5)
    learner = LinearLearner(num_features=6, objective="pairwise",
                            learning_rate=0.5, device="cpu")
    ref_params, params = ref_learner.init(), learner.init()
    for _ in range(3):
        for rb, b in zip(ref_batches, batches):
            ref_params, ref_loss = ref_learner.step(ref_params, rb)
            params, loss = learner.step(params, b)
            np.testing.assert_allclose(float(loss), float(ref_loss),
                                       rtol=2e-5)
    got = linear_params_to_numpy(params)
    np.testing.assert_allclose(got["w"], np.asarray(ref_params.w),
                               rtol=2e-5, atol=1e-6)
    for rb, b in zip(ref_batches, batches):
        np.testing.assert_allclose(
            learner.predict(params, b).numpy(),
            np.asarray(ref_learner.predict(ref_params, rb)),
            rtol=2e-5, atol=1e-6)
    acc = pairwise_accuracy(got["w"], batches)
    assert acc == pairwise_accuracy(np.asarray(ref_params.w), ref_batches)
    assert acc > 0.8, acc


def test_linear_host_batches_step_as_device_batches(tmp_path):
    """A ``LinearLearner`` stepping on host batches follows the same
    trajectory as on the copied batches, on both margin paths, and its
    predictions equal the reference's on the same host batches."""
    uri, kw = lane(tmp_path, "crec")
    host = port_host(uri, **kw)
    with di.DeviceRowBlockIter(uri, batch_rows=BATCH_ROWS, device="cpu",
                               **kw) as it:
        dev = [di.to_device_batch(b, "cpu") for b in it]
    for path in ("segment", "dense"):
        learner = LinearLearner(9, margin_path=path, device="cpu")
        a = b = learner.init()
        for hb, db in zip(host, dev):
            a, la = learner.step(a, hb)
            b, lb = learner.step(b, db)
            assert float(la) == float(lb)
        assert torch.equal(a.w, b.w) and torch.equal(a.b, b.b)
    ref_learner = RefLinear(num_features=9)
    ref_params = RefLinearParams(w=jnp.asarray(a.w.numpy()),
                                 b=jnp.asarray(a.b.numpy()))
    for hb, rb in zip(host, ref_host(uri, **kw)):
        np.testing.assert_allclose(
            learner.predict(a, hb).numpy(),
            np.asarray(ref_learner.predict(ref_params, rb)), rtol=2e-5,
            atol=1e-6)
    # the parameters' device decides where the math runs
    moved = linear_params_from_numpy(linear_params_to_numpy(a),
                                     device="cpu")
    assert learner.predict(moved, host[0]).device.type == "cpu"


def test_shuffle_uri_flow(tmp_path):
    """``tests/test_native_parser.py:412``: a shuffled URI read as host
    batches visits every row once, in the reference's order."""
    p = tmp_path / "rowid.libsvm"
    p.write_text("".join(f"{i} 0:{i}.0\n" for i in range(2000)))
    uri = f"{p}?shuffle_parts=8&shuffle_seed=3"
    got, want = port_host(uri, batch_rows=256), ref_host(uri, batch_rows=256)
    labels = []
    for b in got:
        labels.extend(np.asarray(b.label).reshape(-1)[
            :b.total_rows].astype(int).tolist())
    assert sorted(labels) == list(range(2000))
    assert labels != list(range(2000))
    assert labels == [int(v) for b in want
                      for v in np.asarray(b.label).reshape(-1)[
                          :b.total_rows]]
    assert_host_equal(got, want)


class FakeLeases:
    """A heartbeat monitor's lease calls over ``n`` shards, in order."""

    def __init__(self, n):
        self.todo, self.done = list(range(n)), []

    def acquire_lease(self, epoch, timeout=None):
        return self.todo.pop(0) if self.todo else None

    def complete_lease(self, epoch, shard):
        self.done.append(shard)


def test_elastic_iterator_yields_host_batches(tmp_path):
    uri, kw = lane(tmp_path, "text_csr")
    leases = FakeLeases(4)
    got = list(di.ElasticDeviceRowBlockIter(
        uri, num_shards=4, monitor=leases, batch_rows=BATCH_ROWS,
        to_device=False, device="cpu", **kw))
    ref = list(ref_di.ElasticDeviceRowBlockIter(
        uri, num_shards=4, monitor=FakeLeases(4), batch_rows=BATCH_ROWS,
        mesh=None, to_device=False, **kw))
    assert leases.done == [0, 1, 2, 3]
    assert [s for s, _ in got] == [s for s, _ in ref]
    assert_host_equal([b for _, b in got], [b for _, b in ref])


# -- the reference's signatures ---------------------------------------------
def test_host_batcher_takes_the_references_positional_call(tmp_path):
    src = write_text(tmp_path / "s.libsvm", rows=1000, seed=9)
    want, got = [], []
    with RefParser(src, index64=True) as p:
        hb = ref_di.HostBatcher(p, 256, 4, 64, True)
        while (b := hb.next_batch()) is not None:
            want.append(b)
    with NativeParser(src, index64=True) as p:
        hb = di.HostBatcher(p, 256, 4, 64, True)
        assert hb.layout == "auto" and not hb.pin
        while (b := hb.next_batch()) is not None:
            got.append(b)
    assert_host_equal(got, want)
    assert got[0].tree()["aux"].shape[0] == 4


def test_process_part_and_data_mesh_take_the_references_arguments(
        monkeypatch):
    monkeypatch.setenv("DMLC_TASK_ID", "1")
    monkeypatch.setenv("DMLC_NUM_WORKER", "3")
    assert sharding.process_part(1) == sharding.process_part() == (1, 3)
    # a reference-style positional call binds the reference's names
    bound = inspect.signature(sharding.data_mesh).bind(1, "data")
    assert "device" not in bound.arguments
    mesh = sharding.data_mesh(1, "rows", "cpu")
    assert (mesh.size, mesh.axis_name, mesh.device.type) == (1, "rows",
                                                             "cpu")
    assert sharding.data_mesh(device="cpu").axis_name == "data"
    with pytest.raises(DMLCError, match="one device per rank"):
        sharding.data_mesh(4, device="cpu")


# -- the .crec fill from a mapping of the file (io/crec_map.py) --------------
# A local .crec file, whole or a byte-range part, is filled in place from a
# read-only mapping, and a
# pooled buffer's padding is written only where its previous fill left
# useful entries. Its planes must be the shared core's FillPacked's
# (NativeCsrRecBatcher) bit for bit.
def write_uneven(path, rows=700, features=40, seed=0, qid=False,
                 fields=False, constant=False):
    """libsvm (or libfm with ``fields``) rows whose lengths swing by block:
    64-row runs of long rows (up to 30 features), then of short ones (0-3,
    empty rows among them), so consecutive batches differ in nnz. With
    ``constant``: six features a row, as in Criteo's fixed fields, except
    rows 300-310 (two) and 520-529 (none)."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(rows):
            if constant:
                n = 2 if 300 <= i <= 310 else 0 if 520 <= i < 530 else 6
            else:
                n = rng.integers(10, 31) if (i // 64) % 2 == 0 else \
                    rng.integers(0, 4)
            keep = np.sort(rng.choice(features, n, replace=False))
            vals = rng.uniform(-2, 2, n)
            if fields:
                feats = " ".join(f"{j % 5}:{j}:{v:.5f}"
                                 for j, v in zip(keep, vals))
            else:
                feats = " ".join(f"{j}:{v:.5f}" for j, v in zip(keep, vals))
            head = f"{int(rng.integers(0, 3))} qid:{i // 7}" if qid else \
                f"{int(rng.random() < 0.5)}"
            f.write(f"{head} {feats}\n".replace("  ", " "))
    return str(path)


def uneven_crec(tmp_path, qid=False, fields=False, rows_per_record=37,
                constant=False):
    src = write_uneven(tmp_path / "u.txt", qid=qid, fields=fields,
                       constant=constant)
    uri = str(tmp_path / "u.crec")
    convert.rows_to_csr_recordio(src, uri, fmt="libfm" if fields else
                                 "libsvm", rows_per_record=rows_per_record)
    return uri


def fill_both(uri, D, epochs=2, batch_rows=128, part=0, npart=1):
    """Every fill of ``epochs`` epochs of part ``part`` of ``npart`` by the
    mapped fill into ONE reused buffer set and by the shared FillPacked
    into fresh buffers full of garbage: [(take, pad written, mapped planes,
    native planes)]."""
    from dmlc_core_tpu_torch.io.crec_map import (BufferState,
                                                 MappedCsrRecBatcher)
    from dmlc_core_tpu_torch.io.native import NativeCsrRecBatcher
    mapped = MappedCsrRecBatcher(uri, part=part, npart=npart,
                                 batch_rows=batch_rows, num_shards=D,
                                 min_nnz_bucket=64)
    native = NativeCsrRecBatcher(uri, part=part, npart=npart,
                                 batch_rows=batch_rows, num_shards=D,
                                 min_nnz_bucket=64)
    meta = mapped.meta()
    assert meta == native.meta()
    B, _, hq, hf = meta
    R = batch_rows // D
    big = np.full((D, 3 + hf, B), -5, np.int32)
    aux = np.full((D, 3 + hq, R), -5, np.int32)
    nrows = np.zeros(D, np.int32)
    held = BufferState(D, R, B)
    out = []
    for epoch in range(epochs):
        while True:
            nbig = np.full_like(big, 0x7f7f7f7f)
            naux = np.full_like(aux, 0x7f7f7f7f)
            nn = np.zeros(D, np.int32)
            want = native.fill_packed(nbig, naux, nn)
            take, pad = mapped.fill_packed(big, aux, nrows, held)
            assert take == want
            if take == 0:
                break
            out.append((take, pad, (big.copy(), aux.copy(), nrows.copy()),
                        (nbig, naux, nn)))
        assert mapped.bytes_read() == native.bytes_read()
        assert mapped.set_epoch(epoch + 1) == native.set_epoch(epoch + 1)
        mapped.before_first()
        native.before_first()
    mapped.close()
    native.close()
    return out


@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("planes", ["plain", "qid", "field",
                                    "constant_rows"])
def test_mapped_crec_fill_equals_fill_packed(tmp_path, D, planes):
    # constant_rows: most refills find their rows' ids in place
    uri = uneven_crec(tmp_path, qid=planes == "qid",
                      fields=planes == "field",
                      constant=planes == "constant_rows")
    fills = fill_both(uri, D)
    assert len(fills) == 2 * 6  # 700 rows: 6 batches an epoch, two epochs
    for take, _, got, want in fills:
        for g, w in zip(got, want):
            assert g.tobytes() == w.tobytes()
    nnz = [int(np.searchsorted(f[3][0][d, 0], 128 // D))
           for f in fills for d in range(D)]
    assert len(set(nnz)) > 2  # the shards' nnz swing from fill to fill


@pytest.mark.parametrize("npart", [2, 3, 5])
@pytest.mark.parametrize("D", [1, 2])
def test_mapped_crec_parts_equal_fill_packed(tmp_path, npart, D):
    # byte-range parts (dmlc-submit workers): each part's records are the
    # shared split's, and the parts together hold every row once
    uri = uneven_crec(tmp_path, fields=True)
    rows = 0
    for part in range(npart):
        fills = fill_both(uri, D, part=part, npart=npart)
        assert fills  # 19 records of 37 rows: every part holds some
        for take, _, got, want in fills:
            for g, w in zip(got, want):
                assert g.tobytes() == w.tobytes()
        rows += sum(f[0] for f in fills) // 2  # two epochs
    assert rows == 700


def test_crec_iterator_maps_a_part_of_a_local_file(tmp_path):
    uri = uneven_crec(tmp_path)
    for part in range(3):
        want = ref_host(uri, part=part, npart=3, min_nnz_bucket=64)
        with di.DeviceRowBlockIter(uri, part=part, npart=3,
                                   batch_rows=BATCH_ROWS, device="cpu",
                                   min_nnz_bucket=64, prefetch=0) as it:
            assert it.batcher._mapped
            got = [{k: v.numpy().copy() for k, v in b.tree().items()}
                   for b in it]
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            w = w.tree()
            assert set(g) == set(w)
            for k in w:
                assert g[k].tobytes() == np.asarray(w[k]).tobytes(), k


def test_mapped_crec_refill_with_fewer_nonzeros_pads_the_stale_tail(
        tmp_path):
    uri = uneven_crec(tmp_path)
    fills = fill_both(uri, 1)
    R = 128
    useful = [int(np.searchsorted(f[3][0][0, 0], R)) for f in fills]
    B = fills[0][3][0].shape[-1]
    # the first fill pads the fresh buffer's whole tail; each later one
    # pads only where the fill before it left useful entries
    assert fills[0][1] == B - useful[0]
    for i in range(1, len(fills)):
        assert fills[i][1] == max(0, useful[i - 1] - useful[i])
    shrink = [i for i in range(1, len(fills)) if useful[i] < useful[i - 1]]
    assert shrink
    for i in shrink:  # the stale tail reads as padding
        big = fills[i][2][0][0]
        tail = slice(useful[i], useful[i - 1])
        assert (big[0, tail] == R).all()
        assert not big[1:, tail].any()


def test_crec_iterator_pools_buffers_and_counts_the_padding_it_writes(
        tmp_path):
    uri = uneven_crec(tmp_path, fields=True)
    want = ref_host(uri, min_nnz_bucket=64)
    counter = telemetry.counter("crec_pad_entries_written")
    for prefetch in (0, 2):
        got, written = [], []
        before = counter.value
        with di.DeviceRowBlockIter(uri, batch_rows=BATCH_ROWS, device="cpu",
                                   min_nnz_bucket=64,
                                   prefetch=prefetch) as it:
            assert it.batcher._mapped
            for epoch in range(3):
                for batch in it:
                    got.append({k: v.numpy().copy()
                                for k, v in batch.tree().items()})
                    del batch  # the buffers go back to the pool
                it.before_first()
        # every epoch's batches are the reference's, bit for bit
        for i, g in enumerate(got):
            w = want[i % len(want)].tree()
            assert set(g) == set(w)
            for k in w:
                assert g[k].tobytes() == np.asarray(w[k]).tobytes(), k
        written = counter.value - before
        slots = sum(g["big"][0].shape[-1] for g in got)
        nnz = sum(int(np.searchsorted(g["big"][0, 0], BATCH_ROWS))
                  for g in got)
        # pooled buffers skip some of the padding the batches hold
        assert 0 < written < slots - nnz, (written, slots - nnz)


def test_crec_pad_counter_counts_every_written_entry(tmp_path):
    # one buffer, reused: the counter moves by exactly what each fill
    # padded, and a URI the mapping does not serve counts the shared
    # fill's whole padding
    uri = uneven_crec(tmp_path)
    counter = telemetry.counter("crec_pad_entries_written")
    for source in (uri, uri + "#" + str(tmp_path / "chunks")):
        batcher = di.CsrRecHostBatcher(source, batch_rows=BATCH_ROWS,
                                       min_nnz_bucket=64)
        assert batcher._mapped == ("#" not in source)
        prev = None
        while True:
            before = counter.value
            batch = batcher.next_batch()
            if batch is None:
                break
            useful = int(np.searchsorted(batch.row[0], BATCH_ROWS))
            B = batch.nnz_bucket
            if not batcher._mapped or prev is None:
                want = B - useful
            else:
                want = max(0, prev - useful)
            assert counter.value - before == want
            prev = useful
            batcher.recycle(batch)
        batcher.close()
