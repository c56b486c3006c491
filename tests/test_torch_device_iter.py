"""The port's device iterator against the reference's.

The same seeded libsvm file goes through the reference
``DeviceRowBlockIter`` and the port's. Host planes (``big``, ``aux``,
``x``) must be byte-equal; device leaves must equal ``np.asarray`` of the
reference's leaves exactly (the planes are copied, never recomputed).
"""

import numpy as np
import pytest
import torch

from dmlc_core_tpu.tpu import device_iter as ref_di
from dmlc_core_tpu.tpu.sharding import process_part as ref_process_part

from dmlc_core_tpu_torch import telemetry
from dmlc_core_tpu_torch.base import DMLCError
from dmlc_core_tpu_torch.device import device_iter as di
from dmlc_core_tpu_torch.device.sharding import process_part

# (layout, dense dtype): the csr lane with f32 values, the dense lane in
# f32 and bf16
LANES = [("csr", "float32"), ("dense", "float32"), ("dense", "bf16")]


def write_libsvm(path, rows=700, features=9, seed=0):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(rows):
            keep = np.flatnonzero(rng.random(features) < 0.7)
            vals = rng.uniform(-2, 2, len(keep))
            feats = " ".join(f"{j}:{v:.5f}" for j, v in zip(keep, vals))
            f.write(f"{int(rng.random() < 0.5)} {feats}\n")
    return str(path)


def bits(a):
    """Raw bytes of a numpy array or tensor (bf16 compared as bits)."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        a = a.numpy()
    a = np.asarray(a)
    if a.dtype.itemsize == 2:
        a = a.view(np.int16)
    return a.tobytes(), a.shape


def ref_batches(path, layout, dtype, to_device, **kw):
    with ref_di.DeviceRowBlockIter(path, batch_rows=128, mesh=None,
                                   layout=layout, dense_dtype=dtype,
                                   min_nnz_bucket=64, to_device=to_device,
                                   prefetch=0, **kw) as it:
        return [{k: np.array(v) for k, v in b.tree().items()} for b in it]


def port_batches(path, layout, dtype, prefetch=2, **kw):
    with di.DeviceRowBlockIter(path, batch_rows=128, layout=layout,
                               dense_dtype=dtype, min_nnz_bucket=64,
                               prefetch=prefetch, device="cpu", **kw) as it:
        return [{k: v.clone() for k, v in b.tree().items()} for b in it]


@pytest.mark.parametrize("layout,dtype", LANES)
def test_host_planes_byte_equal(tmp_path, layout, dtype):
    path = write_libsvm(tmp_path / "a.libsvm")
    want = ref_batches(path, layout, dtype, to_device=False)
    hb = di.NativeHostBatcher(path, batch_rows=128, layout=layout,
                              dense_dtype=dtype, min_nnz_bucket=64)
    got = []
    while (b := hb.next_batch()) is not None:
        got.append(b)
    hb.close()
    assert len(got) == len(want) == 6  # 5 full batches + 60 rows
    for g, w in zip(got, want):
        assert set(g.tree()) == set(w)
        for k in w:
            assert bits(g.tree()[k]) == bits(w[k]), k
        assert g.total_rows in (128, 700 - 5 * 128)
    # the named views decode the same planes as the reference's
    ref_named = ref_di.unpack_tree(want[-1])
    port_named = di.unpack_tree(got[-1].tree())
    assert set(port_named) == set(ref_named)
    for k in ref_named:
        assert bits(port_named[k]) == bits(ref_named[k]), k


@pytest.mark.parametrize("layout,dtype", LANES)
def test_device_leaves_equal_reference(tmp_path, layout, dtype):
    path = write_libsvm(tmp_path / "b.libsvm", seed=1)
    want = ref_batches(path, layout, dtype, to_device=True)
    got = port_batches(path, layout, dtype)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert bits(g[k]) == bits(w[k]), k
    if dtype == "bf16":
        assert got[0]["x"].dtype == torch.bfloat16


def test_unpack_shard_matches_reference(tmp_path):
    path = write_libsvm(tmp_path / "c.libsvm", seed=2)
    want = ref_batches(path, "csr", "float32", to_device=False)[0]
    got = port_batches(path, "csr", "float32")[0]
    ref_shard = ref_di.unpack_shard({k: v[0] for k, v in want.items()})
    port_shard = di.unpack_shard({k: v[0] for k, v in got.items()})
    assert set(port_shard) == set(ref_shard)
    for k in ref_shard:
        assert bits(port_shard[k]) == bits(ref_shard[k]), k
    assert port_shard["nrows"].dim() == 0
    assert port_shard["val"].dtype == torch.float32


@pytest.mark.parametrize("layout", ["csr", "dense"])
def test_prefetch_modes_agree(tmp_path, layout):
    path = write_libsvm(tmp_path / "d.libsvm", seed=3)
    sync = port_batches(path, layout, "float32", prefetch=0)
    for prefetch in (1, 2):
        threaded = port_batches(path, layout, "float32", prefetch=prefetch)
        assert len(threaded) == len(sync)
        for a, b in zip(sync, threaded):
            for k in a:
                assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("prefetch", [0, 2])
def test_state_restore_resumes_at_same_batch(tmp_path, prefetch):
    path = write_libsvm(tmp_path / "e.libsvm", seed=4)
    full = port_batches(path, "csr", "float32")
    kw = dict(batch_rows=128, layout="csr", min_nnz_bucket=64,
              prefetch=prefetch, device="cpu")
    with di.DeviceRowBlockIter(path, **kw) as it:
        stream = iter(it)
        for _ in range(2):
            next(stream)
        state = it.state()
    assert state["batches_consumed"] == 2
    with di.DeviceRowBlockIter(path, **kw) as it:
        it.restore(state)
        rest = [{k: v.clone() for k, v in b.tree().items()} for b in it]
    assert len(rest) == len(full) - 2
    for a, b in zip(rest, full[2:]):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    with di.DeviceRowBlockIter(path, **dict(kw, batch_rows=64)) as it:
        with pytest.raises(DMLCError, match="batch_rows"):
            it.restore(state)


def test_restore_past_end_raises(tmp_path):
    path = write_libsvm(tmp_path / "f.libsvm", rows=200, seed=5)
    with di.DeviceRowBlockIter(path, batch_rows=128, layout="csr",
                               device="cpu") as it:
        it.restore({"batches_consumed": 5})
        with pytest.raises(DMLCError, match="past end-of-data"):
            list(it)


def test_before_first_replays_epoch(tmp_path):
    path = write_libsvm(tmp_path / "g.libsvm", seed=6)
    with di.DeviceRowBlockIter(path, batch_rows=128, layout="csr",
                               min_nnz_bucket=64, device="cpu") as it:
        first = [b.big.clone() for b in it]
        it.before_first()
        second = [b.big.clone() for b in it]
        assert it.state()["epoch"] == 1
        # the native batcher counts bytes across epochs
        assert it.bytes_read() == 2 * (tmp_path / "g.libsvm").stat().st_size
    assert len(first) == len(second) == 6
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_lane_metrics_count_batches(tmp_path):
    path = write_libsvm(tmp_path / "h.libsvm", seed=7)
    telemetry.reset()
    got = port_batches(path, "csr", "float32")
    m = di._get_lane_metrics()
    assert m["batches"].value == len(got)
    # the CPU device aliases the staging buffers: counted as zero-copy
    assert m["zc_batches"].value == len(got)
    assert m["bytes"].value == sum(
        sum(v.numel() * v.element_size() for v in b.values()) for b in got)
    assert m["transfer_us"].count == len(got)


def test_pack_aux_matches_reference():
    rng = np.random.default_rng(8)
    D, R = 1, 16
    label = rng.random(R).astype(np.float32)
    weight = rng.random(R).astype(np.float32)
    qid = rng.integers(0, 5, R).astype(np.int32)
    nrows = np.array([11], np.int32)
    for emit_qid in (False, True):
        want = ref_di._pack_aux(label, weight, qid, nrows, D, R, emit_qid)
        got = di._pack_aux(label, weight, qid, nrows, D, R, emit_qid)
        assert got[0].tobytes() == want[0].tobytes()
        assert got[0].ctypes.data % 64 == 0


def test_pinned_staging_is_aligned():
    a = di._aligned_empty((3, 5, 7), np.int32)
    assert a.ctypes.data % 64 == 0 and a.flags["C_CONTIGUOUS"]
    assert di._next_pow2(1000, 64) == ref_di._next_pow2(1000, 64) == 1024
    assert di._next_pow2(3, 64) == 64


@pytest.mark.parametrize("kw,match", [
    (dict(fmt="crec"), "crec"), (dict(fmt="recd"), "recd"),
    (dict(index64=True), "index64"), (dict(csr_val_dtype="bf16"), "bf16"),
    (dict(mesh=object()), "multi-device")])
def test_unported_lanes_raise_naming_roadmap(tmp_path, kw, match):
    path = write_libsvm(tmp_path / "i.libsvm", rows=10)
    with pytest.raises(DMLCError, match=match) as e:
        di.DeviceRowBlockIter(path, device="cpu", **kw)
    assert "ROADMAP.md" in str(e.value)


def test_dense_dtype_refused():
    with pytest.raises(DMLCError, match="dense_dtype"):
        di._dense_dtype_of("float16")


@pytest.mark.parametrize("env", [
    {}, {"DMLC_TASK_ID": "2", "DMLC_NUM_WORKER": "5"},
    {"SLURM_PROCID": "1", "SLURM_NTASKS": "4"},
    {"PMI_RANK": "3", "PMI_SIZE": "4", "DMLC_ROLE": "server"}])
def test_process_part_matches_reference(monkeypatch, env):
    for k in ("DMLC_TASK_ID", "DMLC_NUM_WORKER", "OMPI_COMM_WORLD_RANK",
              "OMPI_COMM_WORLD_SIZE", "PMI_RANK", "PMI_SIZE",
              "SLURM_PROCID", "SLURM_STEP_NUM_TASKS", "SLURM_NTASKS",
              "DMLC_ROLE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert process_part() == ref_process_part()


def test_native_parser_feature_count_matches_reference(tmp_path):
    from dmlc_core_tpu.io.native import NativeParser as RefParser
    from dmlc_core_tpu_torch.io.native import NativeParser
    path = write_libsvm(tmp_path / "k.libsvm", rows=300, features=13,
                        seed=10)
    with RefParser(path) as ref:
        blocks = [(b.index.copy(), b.value.copy()) for b in ref]
    want = int(max(int(i.max()) for i, _ in blocks if len(i))) + 1
    with NativeParser(path) as parser:
        got = [(b.index.copy(), b.value.copy()) for b in parser]
        parser.before_first()
        assert parser.num_features() == want == 13
        assert parser.bytes_read() > 0
    for (gi, gv), (wi, wv) in zip(got, blocks):
        assert np.array_equal(gi, wi) and np.array_equal(gv, wv)


def test_spans_and_events_recorded(tmp_path):
    path = write_libsvm(tmp_path / "l.libsvm", rows=300, seed=11)
    telemetry.reset()
    telemetry.enable(True)
    port_batches(path, "csr", "float32", prefetch=0)
    names = {s["name"] for s in telemetry.spans()}
    assert {"device.stage", "device.put", "device.put.submit",
            "device.put.block"} <= names
    put = [s for s in telemetry.spans() if s["name"] == "device.put"]
    assert all(s["args"]["bytes"] > 0 for s in put)
    telemetry.flight_dump("probe")
    assert telemetry.events()[-1]["event"] == "flight-dump"
    assert telemetry.counter("telemetry_events_total",
                             {"event": "flight-dump"}).value == 1
    h = telemetry.histogram("device_stage_us")
    assert h.count == 3 and h.quantile(0.5) >= 1.0


@pytest.mark.parametrize("raw", [None, "", "12", "-3", "x1"])
def test_env_parsers_match_reference(monkeypatch, raw):
    from dmlc_core_tpu.tracker import wire as ref_wire
    from dmlc_core_tpu_torch.tracker import wire
    if raw is None:
        monkeypatch.delenv("DCT_PROBE_INT", raising=False)
    else:
        monkeypatch.setenv("DCT_PROBE_INT", raw)
    try:
        want = ref_wire.env_int_opt("DCT_PROBE_INT")
    except RuntimeError as e:
        with pytest.raises(RuntimeError, match="not an integer"):
            wire.env_int_opt("DCT_PROBE_INT")
        assert "not an integer" in str(e)
    else:
        assert wire.env_int_opt("DCT_PROBE_INT") == want
