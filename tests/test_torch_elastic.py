"""The port's elastic training against the reference's.

``parallel/elastic.py`` (``STEP_ABORT_EXIT``, ``structured_abort``,
``StepWatchdog``), ``ElasticDeviceRowBlockIter`` and the tracker lease
source of ``RowBlockIter.create``'s elastic mode run in both packages on
the same seeded inputs: the same abort records, the same refusals, the
same shards and batches from the same tracker. Then an unsupervised mesh
world of two real processes (``tests/torch_mesh_worker.py``, which runs
``chip_smoke.py``'s run B worker): the survivor's own exit code is 41.
The supervised worlds under the port's ``submit`` (a worker SIGKILLed
holding a lease; a mesh rank SIGKILLed and the world relaunched from its
job checkpoint) are the ``job`` rehearsals of
``tests/test_torch_chip_smoke.py``.

Each world has its own timeout. The reference's native core comes from
the locked build (``tests/torch_reference_native.py``).
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

from dmlc_core_tpu import data as ref_data
from dmlc_core_tpu.base import DMLCError as RefError
from dmlc_core_tpu.parallel import elastic as ref_elastic
from dmlc_core_tpu.tpu import device_iter as ref_di
from dmlc_core_tpu.tracker.client import RendezvousClient as RefClient
from tests.torch_reference_native import reference_native  # noqa: F401

import chip_smoke as cs
from dmlc_core_tpu_torch import data
from dmlc_core_tpu_torch.base import DMLCError
from dmlc_core_tpu_torch.device import device_iter as di
from dmlc_core_tpu_torch.parallel import elastic
from dmlc_core_tpu_torch.tracker.client import RendezvousClient
from dmlc_core_tpu_torch.tracker.rendezvous import RabitTracker
from dmlc_core_tpu_torch.tracker.wire import TrackerAbortedError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
WORLD_TIMEOUT_S = 60


def write_libsvm(path, rows=1024, features=4, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (rows, features))
    y = (x @ rng.standard_normal(features) > 0).astype(int)
    with open(path, "w") as f:
        for i in range(rows):
            f.write(f"{y[i]} " + " ".join(
                f"{j}:{x[i, j]:.5f}" for j in range(features)) + "\n")
    return str(path)


class FakeMonitor:
    """The monitor surface the watchdog reads: ``aborted`` and check()."""

    def __init__(self):
        self.aborted = None

    def check(self):
        if self.aborted is not None:
            raise TrackerAbortedError(self.aborted)


def test_step_abort_exit_is_the_references():
    assert elastic.STEP_ABORT_EXIT == ref_elastic.STEP_ABORT_EXIT == 41


def test_structured_abort_record_fields_match(tmp_path, monkeypatch):
    monkeypatch.setenv("DMLC_TRACE_DUMP", str(tmp_path / "dumps"))
    recs = {}
    for name, mod in (("port", elastic), ("ref", ref_elastic)):
        path = tmp_path / f"{name}.jsonl"
        ran = []
        mod.structured_abort("peer lost", drains=[lambda: ran.append(1),
                                                  lambda: 1 / 0],
                             record_path=str(path), rank=3)
        assert ran == [1]  # a failing drain does not stop the abort
        recs[name] = json.loads(path.read_text())
    assert set(recs["port"]) == set(recs["ref"]) == {"ts", "reason", "rank",
                                                     "pid"}
    for k in ("reason", "rank", "pid"):
        assert recs["port"][k] == recs["ref"][k]


@pytest.mark.parametrize("where", ["step_begin", "step_end"])
def test_watchdog_raises_between_steps(where):
    for mod in (elastic, ref_elastic):
        mon = FakeMonitor()
        wd = mod.StepWatchdog(monitor=mon, step_deadline_ms=0).start()
        wd.step_begin(0)
        mon.aborted = "tracker gone"
        with pytest.raises(RuntimeError, match="tracker gone") as e:
            if where == "step_end":
                wd.step_end()
            else:
                wd.step_begin(1)
        assert type(e.value).__name__ == "TrackerAbortedError"
        wd.stop()


def test_watchdog_deadline_defaults_to_twice_dead_after(monkeypatch):
    monkeypatch.setenv("DMLC_TRACKER_DEAD_AFTER_MS", "700")
    monkeypatch.delenv("DMLC_STEP_DEADLINE_MS", raising=False)
    assert elastic.StepWatchdog().step_deadline_ms == \
        ref_elastic.StepWatchdog().step_deadline_ms == 1400


MID_STEP = textwrap.dedent("""
    import sys, time
    sys.path.insert(0, sys.argv[1])
    from {pkg}.parallel.elastic import StepWatchdog

    class Mon:
        aborted = None
        def check(self):
            pass

    mon = Mon()
    wd = StepWatchdog(monitor=mon, step_deadline_ms=100, rank=1,
                      drains=[lambda: print("drained", flush=True)],
                      abort_record=sys.argv[2]).start()
    wd.step_begin(7)
    mon.aborted = "peer died"   # the step below never finishes
    time.sleep(30)
""")


@pytest.mark.parametrize("pkg", ["dmlc_core_tpu_torch", "dmlc_core_tpu"])
def test_watchdog_ends_a_blocked_step_with_exit_41(tmp_path, pkg):
    record = tmp_path / "abort.jsonl"
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-c", MID_STEP.format(pkg=pkg), REPO, str(record)],
        capture_output=True, text=True, timeout=60,
        env=dict(os.environ, JAX_PLATFORMS="cpu",
                 DMLC_TRACE_DUMP=str(tmp_path)))
    assert proc.returncode == 41, proc.stderr[-2000:]
    assert time.monotonic() - t0 < 20
    assert "drained" in proc.stdout
    rec = json.loads(record.read_text())
    assert rec["rank"] == 1 and "step 7 blocked" in rec["reason"]


def test_elastic_iterators_refuse_without_a_monitor(tmp_path, monkeypatch):
    import dmlc_core_tpu.tracker.client as ref_client
    import dmlc_core_tpu_torch.tracker.client as port_client
    path = write_libsvm(tmp_path / "a.libsvm")
    # no heartbeat monitor in this process, whatever ran here before
    for mod in (ref_client, port_client):
        monkeypatch.setattr(mod, "current_monitor", lambda: None)
    monkeypatch.setenv("DMLC_TRACKER_NUM_SHARDS", "4")
    with pytest.raises(DMLCError) as port:
        di.ElasticDeviceRowBlockIter(path, device="cpu")
    with pytest.raises(RefError) as ref:
        ref_di.ElasticDeviceRowBlockIter(path, to_device=False)
    assert str(port.value) == str(ref.value)
    mon = FakeMonitor()
    monkeypatch.setenv("DMLC_TRACKER_NUM_SHARDS", "0")
    with pytest.raises(DMLCError) as port:
        di.ElasticDeviceRowBlockIter(path, monitor=mon, device="cpu")
    with pytest.raises(RefError) as ref:
        ref_di.ElasticDeviceRowBlockIter(path, monitor=mon)
    assert str(port.value) == str(ref.value)


def _leased_run(client_cls, consume, num_shards=4):
    """One tracker of the port with one client of ``client_cls``; the
    client's monitor goes to ``consume(monitor)``."""
    tracker = RabitTracker("127.0.0.1", 1, heartbeat_ms=100,
                           dead_after_ms=2000, num_shards=num_shards)
    tracker.start()
    try:
        c = client_cls("127.0.0.1", tracker.port)
        a = c.start(heartbeat=True)
        out = consume(c.heartbeat)
        c.shutdown(a.rank)
        tracker.join(timeout=30)
    finally:
        tracker.stop()
    return out


def test_elastic_device_iter_matches_reference(tmp_path):
    """Both packages' ElasticDeviceRowBlockIter, each fed by a client of
    its own package on the port's tracker: the same shards in the same
    order, and every batch's planes byte for byte."""
    path = write_libsvm(tmp_path / "a.libsvm")
    kw = dict(batch_rows=128, layout="csr", min_nnz_bucket=64, prefetch=0)

    def port(mon):
        it = di.ElasticDeviceRowBlockIter(path, num_shards=4, monitor=mon,
                                          device="cpu", **kw)
        return [(s, {k: v.numpy().tobytes() for k, v in b.tree().items()})
                for s, b in it]

    def ref(mon):
        it = ref_di.ElasticDeviceRowBlockIter(path, num_shards=4,
                                              monitor=mon, to_device=False,
                                              mesh=None, **kw)
        return [(s, {k: np.asarray(v).tobytes()
                     for k, v in b.tree().items()}) for s, b in it]

    got = _leased_run(RendezvousClient, port)
    want = _leased_run(RefClient, ref)
    shards = [s for s, _ in got]
    assert shards == sorted(shards) and set(shards) == {0, 1, 2, 3}
    assert got == want


def test_elastic_abort_drain_from_another_thread(tmp_path):
    """A watchdog thread drains the in-flight shard's pipeline while the
    consumer holds a batch: the drain returns within its deadline, is
    counted, and the iterator still closes."""
    from dmlc_core_tpu_torch import telemetry
    path = write_libsvm(tmp_path / "a.libsvm", rows=4096)
    before = telemetry.counter("device_abort_drains_total").value

    def consume(mon):
        it = di.ElasticDeviceRowBlockIter(path, num_shards=2, monitor=mon,
                                          device="cpu", batch_rows=64,
                                          layout="csr", prefetch=2)
        stream = iter(it)
        shard, _ = next(stream)
        th = threading.Thread(target=it.abort_drain, args=("watchdog",))
        t0 = time.monotonic()
        th.start()
        th.join(timeout=10)
        took = time.monotonic() - t0
        stream.close()  # the generator's finally closes the pipeline
        return shard, th.is_alive(), took

    shard, alive, took = _leased_run(RendezvousClient, consume,
                                     num_shards=2)
    assert shard == 0 and not alive and took < 5
    assert telemetry.counter("device_abort_drains_total").value == before + 1


def test_rowblock_iter_elastic_uses_the_tracker_monitor(tmp_path,
                                                       monkeypatch):
    """``RowBlockIter.create`` in elastic mode with ``leases=None`` takes
    the process's heartbeat monitor in both packages, and yields the
    blocks ``LocalLeases`` gives."""
    path = write_libsvm(tmp_path / "a.libsvm")
    monkeypatch.setenv("DMLC_ELASTIC_SHARDS", "1")
    monkeypatch.setenv("DMLC_TRACKER_NUM_SHARDS", "4")

    def saved(pkg):
        def consume(_mon):
            import io
            out = []
            for b in pkg.RowBlockIter.create(path, shuffle_window=8,
                                             run_id=3):
                buf = io.BytesIO()
                b.save(buf)
                out.append(buf.getvalue())
            return out
        return consume

    got = _leased_run(RendezvousClient, saved(data))
    want = _leased_run(RefClient, saved(ref_data))
    local = [b for b in data.RowBlockIter.create(
        path, leases=data.LocalLeases(4), shuffle_window=8, run_id=3)]
    assert got == want and len(got) == len(local)


# -- a world of real processes ------------------------------------------------
def test_unsupervised_mesh_survivor_exits_41(tmp_path):
    """No supervisor: the test SIGKILLs rank 1 itself once both ranks
    stepped, and the survivor's own exit code is 41, with its abort
    record, within 2 x dead-after of the kill."""
    path = write_libsvm(tmp_path / "d.libsvm", rows=4096,
                        features=cs.FEATURES)
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({
        "uri": path, "device": "cpu", "batch_rows": 4,
        "scratch": str(tmp_path), "job": str(tmp_path / "job"),
        "steps": 1000, "kill_step": -1, "ckpt_steps": [2, 4, 6]}))
    tracker = RabitTracker("127.0.0.1", 2, heartbeat_ms=200,
                           dead_after_ms=2000, recover_grace_ms=500,
                           abort_on_lost=True)
    tracker.start()
    port = cs.free_port()
    procs = []
    try:
        for task in (0, 1):
            env = dict(os.environ, PYTHONPATH=REPO,
                       DMLC_TASK_ID=str(task), DMLC_ROLE="worker",
                       DMLC_NUM_WORKER="2",
                       DMLC_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                       DMLC_ABORT_RECORD=str(tmp_path / "abort.jsonl"),
                       DMLC_TRACE_DUMP=str(tmp_path / "dumps"),
                       DMLC_COLLECTIVE_TIMEOUT_MS="60000",
                       **{k: str(v) for k, v in
                          tracker.worker_envs().items()})
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(HERE, "torch_mesh_worker.py"),
                 str(spec)], env=env,
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                text=True))
        deadline = time.monotonic() + WORLD_TIMEOUT_S
        log = tmp_path / "steps_a0_r1.jsonl"
        while not (log.exists() and log.read_text().count("\n") >= 3):
            assert time.monotonic() < deadline and procs[1].poll() is None
            time.sleep(0.02)
        procs[1].send_signal(signal.SIGKILL)
        t_kill = time.monotonic()
        rc = procs[0].wait(timeout=WORLD_TIMEOUT_S)
        took = time.monotonic() - t_kill
        assert rc == 41, procs[0].stderr.read()[-3000:]
        assert took <= 4.0
        recs = [json.loads(line) for line in
                (tmp_path / "abort.jsonl").read_text().splitlines()]
        assert [rec["rank"] for rec in recs] == [0]
        with pytest.raises(TrackerAbortedError):
            tracker.join(timeout=30)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        tracker.stop()
