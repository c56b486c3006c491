"""The port's bench (``python -m dmlc_core_tpu_torch.bench``) against the
reference's ``bench.py``, on the CPU.

One module fixture runs, side by side, the port's smoke run on the CPU
(``--smoke --device cpu``: every lane, the device ones on the CPU), the
port's host-only smoke run (``--smoke --no-device``) and the reference's
(``bench.py --smoke --no-device``), each at 16,384 rows (a size no other
test's bench run writes, so no two processes generate one cache file) and
with its record in a file of its own. The tests read those runs: the
metric name and the ``extras`` keys (the exceptions are the ones the
README lists), the device lane's row count, the mesh lane's numbers and
the records ``scripts/benchdiff.py`` reads. The rest hold pieces to the
reference directly: the dataset bytes, the device lane's learner, the
kernel probe's inputs and plain output, and the load generator.
"""

import hashlib
import itertools
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax

from tests.torch_reference_native import reference_native  # noqa: F401

from dmlc_core_tpu_torch.bench import datasets, device_lane, kernel_probe
from dmlc_core_tpu_torch.bench import loadrig as port_loadrig
from dmlc_core_tpu_torch.ops import hopper_kernels as hk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
if SCRIPTS not in sys.path:
    sys.path.insert(0, SCRIPTS)
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import bench as ref_bench  # noqa: E402
import loadrig as ref_loadrig  # noqa: E402

ROWS = 16384

# the keys a run that puts the headline on a device adds, and those of a
# host-only headline (bench.py has the same split; README "Port bench")
DEVICE_RUN_KEYS = {
    "device", "hbm_ingest_bw_util", "hbm_ingest_bw_util_best",
    "device_bytes_per_sec", "attainable_pytree_bytes_per_sec",
    "attainable_contiguous_bytes_per_sec", "e2e_spread_rows_per_sec",
    "reps", "ncores", "rec_lane", "crec_lane", "recd_lane",
    "csr_to_dense_kernel", "device_lane", "mesh_lane", "serving_lane"}
HOST_ONLY_KEYS = {"device_skipped", "parse_simd_lane"}
# bench.py's device lane keys (:707-726, :830-846) less the compile-churn
# ones eager torch has no counterpart of, jax_profile_dir renamed
REF_DEVICE_LANE_KEYS = {
    "backend", "ndevices", "rows", "batch_rows", "reps",
    "hbm_ingest_rows_per_sec", "spread_rows_per_sec",
    "device_bytes_per_sec", "device_transfer_p50_us",
    "device_transfer_p99_us", "device_put_block_p99_us", "overlap_ratio",
    "stall_verdict", "hbm_ingest_bw_util", "hbm_ingest_bw_util_best",
    "zero_copy_bytes_per_sec", "attainable_pytree_bytes_per_sec",
    "zero_copy_batches_total", "zero_copy_fallbacks_total"}
REF_SERVING_LANE_KEYS = {  # bench.py:977-992
    "sustained_qps", "open_loop_qps", "open_loop_p50_ms",
    "open_loop_p99_ms", "open_loop_p999_ms", "service_p99_ms", "completed",
    "errors", "client_shed", "server_shed", "distinct_shapes",
    "steady_new_shapes", "slo_burn_clean"}
REF_MESH_LANE_KEYS = {"steps_per_sec", "recovery_s", "nworkers", "steps",
                      "dead_after_ms"}  # bench.py:1171-1174
REF_LANE_SUMMARY_KEYS = {  # bench.py:1776-1787
    "rows_per_sec", "hbm_ingest_bw_util", "hbm_ingest_bw_util_best",
    "device_bytes_per_sec", "attainable_pytree_bytes_per_sec",
    "e2e_spread_rows_per_sec", "reps"}


def last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def smoke_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bench")
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("DMLC_", "DCT_"))}
    runs = {
        "port": [sys.executable, "-m", "dmlc_core_tpu_torch.bench",
                 "--smoke", "--device", "cpu"],
        "port_host": [sys.executable, "-m", "dmlc_core_tpu_torch.bench",
                      "--smoke", "--no-device"],
        "ref": [sys.executable, os.path.join(REPO, "bench.py"), "--smoke",
                "--no-device"],
    }
    procs = {}
    for name, cmd in runs.items():
        env = dict(base, JAX_PLATFORMS="cpu",
                   DMLC_BENCH_HISTORY=str(tmp / f"{name}.jsonl"))
        procs[name] = subprocess.Popen(
            cmd + [f"--rows={ROWS}"], cwd=REPO, env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    out = {}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=240)
            assert proc.returncode == 0, (name, stderr[-3000:])
            out[name] = {"stdout": stdout, "stderr": stderr,
                         "result": last_json(stdout),
                         "history": str(tmp / f"{name}.jsonl")}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


# -- (a) the datasets ----------------------------------------------------
def test_datasets_are_the_references_bytes(tmp_path, monkeypatch):
    monkeypatch.setattr(datasets, "CACHE_DIR", str(tmp_path / "port"))
    monkeypatch.setattr(ref_bench, "CACHE_DIR", str(tmp_path / "ref"))
    pairs = [(datasets.ensure_dataset, ref_bench.ensure_dataset),
             (datasets.ensure_csv_dataset, ref_bench.ensure_csv_dataset),
             (datasets.ensure_libfm_dataset,
              ref_bench.ensure_libfm_dataset)] + [
        (ours, dict(ref_bench.BINARY_LANES)[fmt])
        for fmt, ours in datasets.BINARY_LANES]
    assert [f for f, _ in datasets.BINARY_LANES] == [
        f for f, _ in ref_bench.BINARY_LANES]
    for rows in (1000, 10001):  # one chunk, and a chunk and a row
        for ours, theirs in pairs:
            a, b = ours(rows), theirs(rows)
            assert os.path.basename(a) == os.path.basename(b)
            digest = [hashlib.sha256(open(p, "rb").read()).hexdigest()
                      for p in (a, b)]
            assert digest[0] == digest[1], os.path.basename(a)
    # cached: a second call returns the file without writing it again
    before = os.path.getmtime(datasets.ensure_dataset(1000))
    assert os.path.getmtime(datasets.ensure_dataset(1000)) == before
    assert not [n for n in os.listdir(tmp_path / "port") if ".tmp" in n]


# -- (b) one JSON line with the reference's metric and keys -------------
def test_smoke_prints_the_references_metric_and_keys(smoke_runs):
    ref = smoke_runs["ref"]["result"]
    for name in ("port", "port_host"):
        res = smoke_runs[name]["result"]
        assert [line for line in smoke_runs[name]["stdout"].splitlines()
                if line.strip()] == [json.dumps(res)]
        assert res["metric"] == ref["metric"] == \
            "higgs_libsvm_ingest_rows_per_sec"
        assert res["unit"] == "rows/s" and res["value"] > 0
        assert isinstance(res["vs_baseline"], float)
    host, dev = (smoke_runs[n]["result"]["extras"]
                 for n in ("port_host", "port"))
    rex = ref["extras"]
    # host-only runs: the reference's keys, every nested key too
    assert set(host) == set(rex)
    for key in ("parse_pipeline_occupancy", "stall_attribution",
                "host_lane_rates", "cache_lane", "csv_lane", "libfm_lane",
                "recordio_roundtrip", "io_retry", "thread_scaling"):
        assert set(host[key]) == set(rex[key]), key
    assert set(host["remote_lane"]) == set(rex["remote_lane"])
    for key in ("range_scheduler", "client_io_retry", "origin"):
        assert set(host["remote_lane"][key]) == \
            set(rex["remote_lane"][key]), key
    # the device run on the CPU: the host-only headline's keys give way
    # to the device run's (README "Port bench")
    assert set(dev) == (set(rex) - HOST_ONLY_KEYS) | DEVICE_RUN_KEYS
    assert set(dev["parse_pipeline_occupancy"]) == \
        set(rex["parse_pipeline_occupancy"]) - {"headline"}
    assert set(dev["device_lane"]) == REF_DEVICE_LANE_KEYS
    assert set(dev["serving_lane"]) == REF_SERVING_LANE_KEYS
    assert set(dev["mesh_lane"]) == REF_MESH_LANE_KEYS
    for fmt in ("rec", "crec", "recd"):
        assert set(dev[f"{fmt}_lane"]) == REF_LANE_SUMMARY_KEYS
    assert dev["device"] == "cpu"
    assert dev["csr_to_dense_kernel"] == {"skipped": "device is cpu, not "
                                                     "cuda"}
    assert 0 < dev["hbm_ingest_bw_util"] <= 1.0
    assert 0 < dev["device_lane"]["hbm_ingest_bw_util"] <= 1.0
    assert dev["serving_lane"]["errors"] == 0
    assert dev["serving_lane"]["slo_burn_clean"] == 0


def test_chip_smoke_bench_gates_hold_on_the_cpu_run(smoke_runs):
    """``chip_smoke.py``'s gates on the bench's line and record, on the
    fixture's device run on the CPU (the card's run meets the same
    function at ``--rows 524288``)."""
    import chip_smoke as cs
    port = smoke_runs["port"]
    with open(port["history"]) as f:
        records = [json.loads(line) for line in f if line.strip()]
    cs.check_bench_result(port["result"], records, "cpu", ROWS)


def test_without_cuda_the_bench_refuses():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where CUDA is missing")
    proc = subprocess.run(
        [sys.executable, "-m", "dmlc_core_tpu_torch.bench", "--smoke"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2
    assert proc.stdout == ""
    assert "--device cpu" in proc.stderr


# -- (c) the device lane -------------------------------------------------
def test_device_lane_counts_rows_and_trains_as_the_reference(
        smoke_runs, tmp_path, monkeypatch):
    dl = smoke_runs["port"]["result"]["extras"]["device_lane"]
    # the lane raises on a short epoch; it ran the fixture's rows
    assert dl["rows"] == ROWS and dl["backend"] == "cpu"
    assert dl["hbm_ingest_rows_per_sec"] > 0 and dl["reps"] == 3

    from dmlc_core_tpu.models.linear import LinearLearner as RefLearner
    from dmlc_core_tpu.tpu.device_iter import DeviceRowBlockIter as RefIter
    rows, batch_rows, reps = 3000, 512, 2
    monkeypatch.setattr(ref_bench, "CACHE_DIR", str(tmp_path))
    path = ref_bench.ensure_dataset(rows)
    _, params, _ = device_lane.train_epochs(
        path, rows, torch.device("cpu"), batch_rows=batch_rows, reps=reps)
    learner = RefLearner(28, mesh=None, learning_rate=0.1)
    want = learner.init()
    with RefIter(path, batch_rows=batch_rows, mesh=None,
                 layout="csr") as it:
        for epoch in range(1 + reps):
            if epoch:
                it.before_first()
            for batch in it:
                want, _ = learner.step(want, batch)
    np.testing.assert_allclose(params.w.numpy(), np.asarray(want.w),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(params.b), float(want.b), rtol=1e-5)


# -- (d) the kernel probe ------------------------------------------------
class _Captured(Exception):
    pass


def test_kernel_probe_inputs_and_plain_output_match_the_pallas_kernel(
        monkeypatch):
    from dmlc_core_tpu.ops.pallas_kernels import csr_to_dense_pallas
    # bench.py's probe builds its inputs inside pallas_format_probe, which
    # runs on a TPU only: claim one and catch the three device_puts
    seen = []

    def capture(a, *args, **kw):
        seen.append(np.asarray(a))
        if len(seen) == 3:
            raise _Captured()
        return a

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jax, "device_put", capture)
    with pytest.raises(_Captured):
        ref_bench.pallas_format_probe()
    monkeypatch.undo()
    ours = kernel_probe.probe_inputs()
    for a, b in zip(ours, seen):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    row, col, val = ours
    want = np.asarray(csr_to_dense_pallas(row, col, val, 1024, 28))
    r, c, v = (torch.from_numpy(a) for a in ours)
    for got in (hk.csr_to_dense_reference(r, c, v, 1024, 28),
                hk.csr_to_dense_kernel(r, c, v, 1024, 28),
                kernel_probe.library_csr_to_dense(r, c, v, 1024, 28)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # off the card the probe has nothing to time
    assert kernel_probe.kernel_probe(torch.device("cpu")) == {
        "skipped": "device is cpu, not cuda"}
    # the bound is computed as PERF.md's kernel table computes it:
    # 28,672 row ids, column ids and values, and the f32 output
    ms, by = kernel_probe.bound_ms(r, c, 1024, 28)
    assert by == "bytes"
    assert ms == pytest.approx(4 * (3 * 28672 + 1024 * 28) / 3.35e12 * 1e3)


# -- (e) the load generator ----------------------------------------------
OPEN_KEYS = ["achieved_qps", "arrivals", "completed", "duration_s",
             "errors", "intended_us", "max_inflight", "max_lateness_ms",
             "mode", "offered_qps", "service_us", "shed"]
CLOSED_KEYS = ["achieved_qps", "completed", "duration_s", "errors", "mode",
               "service_us", "workers"]
PCT_KEYS = ["count", "mean", "p50", "p99", "p999"]


@pytest.mark.parametrize("rig", [ref_loadrig, port_loadrig],
                         ids=["reference", "port"])
def test_open_and_closed_loop_schedule_and_keys(rig):
    issued = []
    calls = itertools.count(1)

    def request():
        issued.append(time.monotonic())
        if next(calls) % 25 == 0:
            raise OSError("an error is a datum")
        return True

    qps = 400.0
    out = rig.open_loop(request, qps=qps, duration_s=0.25, max_inflight=4)
    assert sorted(out) == OPEN_KEYS and out["mode"] == "open"
    assert out["arrivals"] == out["completed"] == 100
    assert out["offered_qps"] == qps and out["errors"] == 4
    for clock in ("intended_us", "service_us"):
        assert sorted(out[clock]) == PCT_KEYS
        assert out[clock]["count"] == 100
    # never issued before its due time (the first may be late itself)
    slack = out["max_lateness_ms"] / 1e3 + 1e-3
    issued.sort()
    assert all(t - issued[0] >= k / qps - slack
               for k, t in enumerate(issued))
    # a ramp: 20 arrivals at 100/s, then 40 at 400/s
    out = rig.open_loop(lambda: True, 0, 0, phases=[(100, 0.2), (400, 0.1)])
    assert out["arrivals"] == 60 and out["offered_qps"] == 200.0
    out = rig.closed_loop(lambda: False, workers=3, duration_s=0.1)
    assert sorted(out) == CLOSED_KEYS and out["mode"] == "closed"
    assert out["errors"] == out["completed"] > 0 and out["workers"] == 3
    assert sorted(out["service_us"]) == PCT_KEYS


def test_score_payloads_are_the_reference_rigs_bytes():
    spec = "libsvm:rows=2,rows_max=8,features=16384,nnz=16,seed=7"
    ours, ctype = port_loadrig.score_payload_fn(spec)
    theirs, ref_ctype = ref_loadrig.score_payload_fn(spec)
    assert ctype == ref_ctype
    assert [ours() for _ in range(40)] == [theirs() for _ in range(40)]
    csv = "csv:rows=3,features=5,seed=2"
    assert port_loadrig.score_payload_fn(csv)[0]() == \
        ref_loadrig.score_payload_fn(csv)[0]()
    for bad in ("json:rows=1", "libsvm:rows=0", "libsvm:row=3"):
        with pytest.raises(ValueError):
            port_loadrig.parse_corpus_spec(bad)


# -- (f) the records -----------------------------------------------------
@pytest.mark.parametrize("name", ["port", "port_host", "ref"])
def test_records_pass_benchdiff_self_compare(smoke_runs, name):
    history = smoke_runs[name]["history"]
    with open(history) as f:
        (rec,) = [json.loads(line) for line in f]
    assert rec["metric"] == "higgs_libsvm_ingest_rows_per_sec"
    assert rec["smoke"] is True and rec["schema"] == 1
    lanes = {"cache_lane", "remote_lane", "csv_lane", "libfm_lane",
             "recordio_roundtrip", "host_lane_rates", "thread_scaling"}
    if name == "port":
        lanes |= {"rec_lane", "crec_lane", "recd_lane", "device_lane",
                  "mesh_lane", "serving_lane"}
    assert set(rec["lanes"]) == lanes
    proc = subprocess.run(
        [sys.executable, os.path.join(SCRIPTS, "benchdiff.py"),
         "--history", history, "--a", "-1", "--b", "-1"],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "0 regression(s)" in proc.stdout


# -- (g) the mesh lane ---------------------------------------------------
def test_mesh_lane_reports_steps_and_recovery(smoke_runs):
    ml = smoke_runs["port"]["result"]["extras"]["mesh_lane"]
    assert ml["nworkers"] == 2 and ml["steps"] == 20
    assert ml["steps_per_sec"] > 0
    assert math.isfinite(ml["recovery_s"]) and ml["recovery_s"] > 0
    # the record carries both for benchdiff's mesh_lane row
    with open(smoke_runs["port"]["history"]) as f:
        rec = json.loads(f.readline())
    assert set(rec["lanes"]["mesh_lane"]) == REF_MESH_LANE_KEYS
