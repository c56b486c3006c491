"""The port's instruments inside the training step, the host batch and the
epoch turn (``models/_dp.py``, ``device/device_iter.py``), on the CPU.

- The step: each phase histogram (``step_forward_us``,
  ``step_backward_us``, ``step_update_us``) and ``step_host_us`` rise by
  one a step, ``step_reduce_us`` by one only with a mesh; the
  ``dct.step*`` ranges appear only while a profiler records.
- The host batch: ``device_batch_nnz`` and ``device_batch_slots`` are
  exact on a hand-built two-shard batch through ``_stage``, and on a small
  ``.crec`` file whose last batch is partial.
- The epoch turn: ``device_epoch_turn_us`` and its ``device.epoch_turn``
  span once a ``before_first()``, with ``prefetch`` 0 and 2.
- With ``telemetry.enable(False)`` none of them moves.
- On a card (``cuda``-marked; skips here): the events resolve without
  ``torch.cuda.synchronize`` and come from a pool made once.

No JAX here: the ``cuda`` case runs on the card with ``--noconftest``.
"""

import numpy as np
import pytest
import torch

from dmlc_core_tpu_torch import telemetry
from dmlc_core_tpu_torch.device import device_iter as di
from dmlc_core_tpu_torch.device.sharding import data_mesh
from dmlc_core_tpu_torch.io.convert import rows_to_csr_recordio
from dmlc_core_tpu_torch.models import _dp
from dmlc_core_tpu_torch.models.fm import FMLearner
from dmlc_core_tpu_torch.models.linear import LinearLearner

PHASES = ("step_forward_us", "step_backward_us", "step_update_us")
NAMES = PHASES + ("step_reduce_us", "step_host_us", "device_batch_nnz",
                  "device_batch_slots", "device_epoch_turn_us")
FEATURES = 20
BATCH_ROWS = 256
ROWS = 700  # batches of 256, 256 and 188 rows


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def telemetry_on():
    was = telemetry.enabled()
    telemetry.enable(True)
    yield
    telemetry.enable(was)


def write_rows(path, rows=ROWS, seed=0):
    """libsvm rows of 1-6 features each; returns the row lengths."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 7, size=rows)
    with open(path, "w") as f:
        for i, n in enumerate(lens):
            cols = np.sort(rng.choice(FEATURES, size=n, replace=False))
            f.write(f"{i % 2} " + " ".join(
                f"{c}:{rng.uniform(0.1, 1):.3f}" for c in cols) + "\n")
    return lens


@pytest.fixture
def text_uri(tmp_path):
    path = tmp_path / "rows.libsvm"
    write_rows(path)
    return str(path)


def counts():
    return {n: telemetry.histogram(n).count for n in NAMES}


def sums():
    return {n: telemetry.histogram(n).sum for n in NAMES}


def moved(before):
    now = counts()
    return {n: now[n] - before[n] for n in NAMES}


def learner(kind, mesh=None):
    if kind == "linear":
        return LinearLearner(FEATURES, mesh=mesh, device="cpu")
    return FMLearner(FEATURES, k=4, mesh=mesh, device="cpu")


@pytest.mark.parametrize("kind", ["linear", "fm"])
def test_each_phase_rises_by_one_a_step(text_uri, telemetry_on, kind):
    lr = learner(kind)
    params = lr.init()
    with di.DeviceRowBlockIter(text_uri, batch_rows=BATCH_ROWS,
                               layout="csr", device="cpu",
                               prefetch=0) as it:
        for batch in it:
            before = counts()
            params, loss = lr.step(params, batch)
            got = moved(before)
            assert all(got[n] == 1 for n in PHASES + ("step_host_us",))
            assert got["step_reduce_us"] == 0
    assert all(telemetry.histogram(n).sum > 0 for n in PHASES)


def test_reduce_is_observed_with_a_mesh(text_uri, telemetry_on):
    mesh = data_mesh(device="cpu")
    lr = learner("fm", mesh=mesh)
    params = lr.init()
    with di.DeviceRowBlockIter(text_uri, batch_rows=BATCH_ROWS,
                               layout="csr", mesh=mesh, device="cpu",
                               prefetch=0) as it:
        batch = next(iter(it))
    before = counts()
    params, _ = lr.step(params, batch)
    got = moved(before)
    assert all(got[n] == 1 for n in PHASES + ("step_reduce_us",
                                                "step_host_us"))
    # the zero-weight step of a rank out of batches: the reduce alone (in
    # a world of one every rank is out, so nothing is applied)
    before = counts()
    lr.step(params, None)
    got = moved(before)
    assert lr.last_active == 0
    assert got["step_reduce_us"] == got["step_host_us"] == 1
    assert all(got[n] == 0 for n in PHASES)


def test_step_ranges_only_while_a_profiler_records(text_uri, telemetry_on):
    lr = learner("fm")
    params = lr.init()
    with di.DeviceRowBlockIter(text_uri, batch_rows=BATCH_ROWS,
                               layout="csr", device="cpu",
                               prefetch=0) as it:
        batches = list(it)
    assert _dp._profiled("dct.step") is _dp._NULL
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        params, _ = lr.step(params, batches[0])
    names = {e.name for e in prof.events()}
    assert {"dct.step", "dct.step.forward", "dct.step.backward",
            "dct.step.update"} <= names
    assert "dct.step.reduce" not in names


def test_nothing_is_observed_with_telemetry_off(text_uri, telemetry_on):
    lr = learner("linear")
    params = lr.init()
    before = counts()
    spans0 = len(telemetry.spans())
    telemetry.enable(False)
    for prefetch in (0, 2):
        with di.DeviceRowBlockIter(text_uri, batch_rows=BATCH_ROWS,
                                   layout="csr", device="cpu",
                                   prefetch=prefetch) as it:
            for _ in range(2):
                for batch in it:
                    params, _ = lr.step(params, batch)
                it.before_first()
            next(iter(it))
    assert moved(before) == dict.fromkeys(NAMES, 0)
    assert len(telemetry.spans()) == spans0


class _OneBatch:
    """A batcher that hands out one batch, then the end."""

    def __init__(self, batch):
        self._batch = batch

    def next_batch(self):
        batch, self._batch = self._batch, None
        return batch


def test_padding_is_exact_on_a_hand_built_batch(text_uri, telemetry_on):
    # two shards of R = 4 rows in an 8-entry bucket: 5 and 2 useful
    # nonzeros, padding (row R) at each plane's tail
    R = 4
    big = np.zeros((2, 3, 8), np.int32)
    big[0, 0] = [0, 0, 1, 2, 3, R, R, R]
    big[1, 0] = [0, 2, R, R, R, R, R, R]
    row, col, val, field = di._view_big(big)
    batch = di.PaddedBatch(row=row, col=col, val=val,
                           label=np.zeros((2, R), np.float32),
                           weight=np.ones((2, R), np.float32),
                           nrows=np.array([R, 3], np.int32), total_rows=7,
                           big=big)
    with di.DeviceRowBlockIter(text_uri, batch_rows=BATCH_ROWS,
                               device="cpu", prefetch=0) as it:
        real = it.batcher
        it.batcher = _OneBatch(batch)
        c0, s0 = counts(), sums()
        assert it._stage() is batch
        it.batcher = real
    got = moved(c0)
    assert got["device_batch_nnz"] == got["device_batch_slots"] == 1
    assert telemetry.histogram("device_batch_nnz").sum - \
        s0["device_batch_nnz"] == 7
    assert telemetry.histogram("device_batch_slots").sum - \
        s0["device_batch_slots"] == 16


@pytest.mark.parametrize("prefetch", [0, 2])
def test_padding_is_exact_on_a_crec_file(tmp_path, telemetry_on, prefetch):
    text = tmp_path / "rows.libsvm"
    lens = write_rows(text)
    crec = str(tmp_path / "rows.crec")
    rows_to_csr_recordio(str(text), crec)
    c0, s0 = counts(), sums()
    with di.DeviceRowBlockIter(crec, batch_rows=BATCH_ROWS, device="cpu",
                               prefetch=prefetch) as it:
        batches = list(it)
    assert [b.total_rows for b in batches] == [256, 256, 188]
    got = moved(c0)
    assert got["device_batch_nnz"] == got["device_batch_slots"] == 3
    assert telemetry.histogram("device_batch_nnz").sum - \
        s0["device_batch_nnz"] == int(lens.sum())
    assert telemetry.histogram("device_batch_slots").sum - \
        s0["device_batch_slots"] == 3 * batches[0].nnz_bucket


@pytest.mark.parametrize("prefetch", [0, 2])
def test_epoch_turn_once_a_before_first(text_uri, telemetry_on, prefetch):
    with di.DeviceRowBlockIter(text_uri, batch_rows=BATCH_ROWS,
                               layout="csr", device="cpu",
                               prefetch=prefetch) as it:
        assert len(list(it)) == 3
        for turn in range(1, 4):
            c0 = counts()
            ids = {s["id"] for s in telemetry.spans()}
            it.before_first()
            assert moved(c0)["device_epoch_turn_us"] == 0
            batches = iter(it)
            next(batches)
            assert moved(c0)["device_epoch_turn_us"] == 1
            rest = list(batches)
            assert len(rest) == 2
            assert moved(c0)["device_epoch_turn_us"] == 1
            spans = [s for s in telemetry.spans() if s["id"] not in ids
                     and s["name"] == "device.epoch_turn"]
            assert len(spans) == 1 and spans[0]["dur"] >= 0


@pytest.mark.cuda
def test_cuda_events_resolve_without_a_synchronize(tmp_path, monkeypatch,
                                                   telemetry_on):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    text = tmp_path / "rows.libsvm"
    write_rows(text, rows=4096)
    made = []
    real_event = torch.cuda.Event

    def counted_event(*a, **k):
        made.append(1)
        return real_event(*a, **k)

    def refuse(*a, **k):
        raise AssertionError("torch.cuda.synchronize called")

    lr = FMLearner(FEATURES, k=4, device="cuda")
    params = lr.init()
    c0 = counts()
    with di.DeviceRowBlockIter(str(text), batch_rows=BATCH_ROWS,
                               layout="csr", device="cuda") as it:
        batches = list(it)
    monkeypatch.setattr(torch.cuda, "Event", counted_event)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    steps = 0
    for _ in range(4):
        for batch in batches:
            params, loss = lr.step(params, batch)
            float(loss)  # the stream waits here, the host thread alone
            steps += 1
    got = moved(c0)
    assert got["step_host_us"] == steps
    # each step resolved once done, at its own end() or the next one's
    # (the loss read back finished it); the last may still be pending
    assert all(steps - 1 <= got[n] <= steps for n in PHASES)
    assert len(made) == _dp._PhaseTimer.POOL * (1 + len(_dp._PHASES))
