"""The port stands alone: no JAX, no ml_dtypes, nothing of dmlc_core_tpu.

A subprocess whose ``sys.meta_path`` refuses those packages (and the
reference's load generator and test helpers) imports every module of
``dmlc_core_tpu_torch`` and ``chip_smoke`` (without running it).
Entry points called without ``device=`` where CUDA is missing raise rather
than run on the CPU, and ``chip_smoke.py`` exits non-zero there.
"""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from dmlc_core_tpu_torch.base import DMLCError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCKED_IMPORT_PROBE = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "ml_dtypes", "dmlc_core_tpu", "loadrig",
           "serving_util", "scripts", "tests")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
sys.path.insert(0, sys.argv[1])
import dmlc_core_tpu_torch
names = ["dmlc_core_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(dmlc_core_tpu_torch.__path__,
                                          "dmlc_core_tpu_torch.")]
# the fourth to twelfth slices' modules by name, so none can drop out
# unnoticed
for mod in ("qa", "qa.srcwalk", "qa.lint", "qa.contracts", "qa.analyze",
            "qa.gendoc", "bench", "bench.__main__", "bench.datasets", "bench.record",
            "bench.host_lanes", "bench.ingest", "bench.kernel_probe",
            "bench.device_lane", "bench.loadrig", "bench.serving_lane",
            "bench.remote_lane", "bench.mesh_worker", "bench.mesh_lane",
            "ops.attention", "parallel.axis", "parallel.ring",
            "parallel.pipeline_parallel", "models.transformer",
            "models.tp_transformer", "train_lm",
            "io.convert", "ops.ranking", "models.fm", "models.convert",
            "device.device_iter", "train", "parallel",
            "parallel.distributed", "device.sharding", "data", "config",
            "params", "registry", "utils.timer", "telemetry",
            "io.native", "io.tls_proxy", "tracker", "tracker.wire",
            "tracker.topology", "tracker.rendezvous", "tracker.client",
            "tracker.supervisor", "tracker.opts", "tracker.launchers",
            "tracker.submit", "tracker.bootstrap", "tracker.mesos_status",
            "tracker.event_log", "parallel.elastic"):
    assert "dmlc_core_tpu_torch." + mod in names, mod
for name in names:
    importlib.import_module(name)
# every package-level name, the lazy ones (utils' checkpoint names) too
for name in names:
    mod = sys.modules[name]
    if hasattr(mod, "__path__"):
        for attr in getattr(mod, "__all__", [
                a for a in dir(mod) if not a.startswith("_")]):
            getattr(mod, attr)
import chip_smoke
assert callable(chip_smoke.main)
leaked = sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("IMPORTED", len(names))
"""


def test_port_imports_without_jax_or_reference():
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED_IMPORT_PROBE, REPO],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    n = int(proc.stdout.split("IMPORTED")[1])
    assert n >= 71  # every module of the nine slices


BLOCK = BLOCKED_IMPORT_PROBE.split("import dmlc_core_tpu_torch\n")[0]

IMPORT_COST_PROBE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
mod = __import__(sys.argv[2], fromlist=["_"])
for attr in sys.argv[3:]:
    getattr(mod, attr)
print(json.dumps({"torch": "torch" in sys.modules,
                  "numpy": "numpy" in sys.modules}))
"""

# (module, names read from it, torch loaded, numpy loaded): the tracker,
# the bench's parse clients and origins start on these without paying
# for torch (2-3 s a process) or, where marked, numpy
IMPORT_COSTS = [
    ("dmlc_core_tpu_torch", ["Parameter", "Registry", "check_eq", "get_env",
                             "set_env", "DMLCError", "field", "ParamError",
                             "check", "__version__"], False, False),
    ("dmlc_core_tpu_torch.base", ["logger", "log_info", "check_ge"],
     False, False),
    ("dmlc_core_tpu_torch.tracker.rendezvous", ["RabitTracker"],
     False, False),
    ("dmlc_core_tpu_torch.tracker.submit", ["main"], False, False),
    ("dmlc_core_tpu_torch.params", ["Parameter"], False, False),
    ("dmlc_core_tpu_torch.registry", ["Registry"], False, False),
    ("dmlc_core_tpu_torch.telemetry", ["counter"], False, False),
    ("dmlc_core_tpu_torch.utils", ["Timer", "trace_span"], False, False),
    ("dmlc_core_tpu_torch.io", ["NativeParser", "rows_to_recordio",
                                "list_directory"], False, True),
    ("dmlc_core_tpu_torch.io.native", ["NativeParser"], False, True),
    ("dmlc_core_tpu_torch.io.convert", ["rows_to_recordio"], False, True),
    ("dmlc_core_tpu_torch.data", ["RowBlockIter"], False, True),
    ("dmlc_core_tpu_torch.utils", ["save_checkpoint"], True, True),
    ("dmlc_core_tpu_torch.utils.checkpoint", ["save_checkpoint"],
     True, True),
]


@pytest.mark.parametrize("module,attrs,torch_loaded,numpy_loaded",
                         IMPORT_COSTS,
                         ids=[f"{m}:{a[0]}" for m, a, _, _ in IMPORT_COSTS])
def test_import_cost_is_pinned(module, attrs, torch_loaded, numpy_loaded):
    proc = subprocess.run(
        [sys.executable, "-c", IMPORT_COST_PROBE, REPO, module, *attrs],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert (got["torch"], got["numpy"]) == (torch_loaded, numpy_loaded), got


SUBMIT_WORKER = BLOCK + r"""
import os
from dmlc_core_tpu_torch.tracker.client import RendezvousClient
c = RendezvousClient(os.environ["DMLC_TRACKER_URI"],
                     int(os.environ["DMLC_TRACKER_PORT"]))
a = c.start(heartbeat=True)
c.shutdown(a.rank)
leaked = sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED)
assert not leaked, leaked
with open(os.path.join(sys.argv[2], "worker%d" % a.rank), "w") as f:
    f.write("joined")
"""


def test_submit_runs_with_the_blocked_packages(tmp_path):
    """``python -m dmlc_core_tpu_torch.tracker.submit --cluster local``
    and its two workers, every process with the same import block."""
    worker = tmp_path / "worker.py"
    worker.write_text(SUBMIT_WORKER)
    submit = BLOCK + (
        "import runpy\n"
        "sys.argv = sys.argv[1:]\n"
        "runpy.run_module('dmlc_core_tpu_torch.tracker.submit',"
        " run_name='__main__')\n")
    proc = subprocess.run(
        [sys.executable, "-c", submit, REPO, "--cluster", "local",
         "--num-workers", "2", "--heartbeat-ms", "200", "--",
         sys.executable, str(worker), REPO, str(tmp_path)],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert sorted(p.name for p in tmp_path.glob("worker?")) == [
        "worker0", "worker1"]


@pytest.mark.parametrize("how", ["blocked", "plain"])
def test_bin_dmlc_submit_torch_runs_a_job(tmp_path, how):
    """``bin/dmlc-submit-torch --cluster local --num-workers 2`` and its
    two workers: once with every process under the import block (the
    script run through ``runpy``), once as the executable itself."""
    worker = tmp_path / "worker.py"
    worker.write_text(SUBMIT_WORKER)
    script = os.path.join(REPO, "bin", "dmlc-submit-torch")
    flags = ["--cluster", "local", "--num-workers", "2", "--heartbeat-ms",
             "200", "--", sys.executable, str(worker), REPO, str(tmp_path)]
    if how == "blocked":
        cmd = [sys.executable, "-c", BLOCK + (
            "import runpy\n"
            "script = sys.argv[2]\n"
            "sys.argv = sys.argv[2:]\n"
            "runpy.run_path(script, run_name='__main__')\n"
            "leaked = sorted(n for n in sys.modules "
            "if n.split('.')[0] in BLOCKED)\n"
            "assert not leaked, leaked\n"), REPO, script] + flags
    else:
        cmd = [script] + flags
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                          cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert sorted(p.name for p in tmp_path.glob("worker?")) == [
        "worker0", "worker1"]


def test_port_sources_name_no_blocked_package():
    # a second, static look: no import line anywhere in the port or in
    # chip_smoke.py reaches a blocked package
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO,
                                               "dmlc_core_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        for line in open(path):
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                if path.endswith("chip_smoke.py") and \
                        words[:4] == ["from", "tests", "import", "mock_s3"]:
                    continue  # the loopback S3, checked below
                if path.endswith(os.path.join("bench", "remote_lane.py")) \
                        and words == ["from", "tests", "import",
                                      "mock_origin"]:
                    continue  # the origin child's mocks, checked below
                top = words[1].split(".")[0]
                assert top not in ("jax", "jaxlib", "ml_dtypes",
                                   "dmlc_core_tpu", "loadrig",
                                   "serving_util", "scripts",
                                   "tests"), (path, line)


def test_chip_smokes_mock_s3_needs_no_blocked_package():
    """``chip_smoke.py``'s ``job`` phase serves its ``s3://`` data from
    ``tests/mock_s3.py`` in its own process: that mock (and the origin
    plumbing it starts) runs with JAX, ml_dtypes and the JAX package
    blocked."""
    probe = BLOCKED_IMPORT_PROBE.split("import dmlc_core_tpu_torch\n")[0]
    probe = probe.replace('"scripts", "tests")', '"scripts")') + (
        "from tests import mock_s3\n"
        "state, port, shutdown = mock_s3.serve()\n"
        "shutdown()\n"
        "leaked = sorted(n for n in sys.modules "
        "if n.split('.')[0] in BLOCKED)\n"
        "assert not leaked, leaked\n"
        "print('SERVED', port)\n")
    proc = subprocess.run([sys.executable, "-c", probe, REPO],
                          capture_output=True, text=True, timeout=120,
                          cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "SERVED" in proc.stdout


def test_bench_origin_child_needs_no_blocked_package(tmp_path):
    """The remote lane's origin child (``python -m
    dmlc_core_tpu_torch.bench.remote_lane origin``) serves the checkout's
    mock backends from ``tests/``: it and its pre-forked workers run with
    JAX, ml_dtypes and the JAX package blocked, and the port's
    ``fetch-client`` reads back the bytes it serves."""
    data = tmp_path / "blob.bin"
    data.write_bytes(np.random.default_rng(5).bytes(300_000))
    child = BLOCK.replace('"scripts", "tests")', '"scripts")') + (
        "import runpy\n"
        "sys.argv = ['remote_lane'] + sys.argv[2:]\n"
        "runpy.run_module('dmlc_core_tpu_torch.bench.remote_lane',"
        " run_name='__main__')\n")
    proc = subprocess.Popen(
        [sys.executable, "-c", child, REPO, "origin", "--backend", "s3",
         "--corpus", f"bucket/blob.bin=@{data}", "--workers", "2",
         "--ttl", "120"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=REPO)
    try:
        line = proc.stdout.readline()
        assert line.startswith("RIG_READY "), proc.stderr.read()[-3000:]
        ready = json.loads(line.split(" ", 1)[1])
        assert ready["backend"] == "s3" and len(ready["pids"]) == 2
        fetch = subprocess.run(
            [sys.executable, "-c", BLOCK + (
                "import runpy\n"
                "sys.argv = ['loadrig'] + sys.argv[2:]\n"
                "runpy.run_module('dmlc_core_tpu_torch.bench.loadrig',"
                " run_name='__main__')\n"), REPO, "fetch-client",
             "--uri", ready["uri"].replace("{key}", "bucket/blob.bin")],
            capture_output=True, text=True, timeout=120, cwd=REPO,
            env=dict(os.environ, **ready["env"]))
        assert fetch.returncode == 0, fetch.stderr[-3000:]
        got = json.loads(fetch.stdout.strip().splitlines()[-1])
        assert got["bytes"] == 300_000
        assert got["sha256"] == hashlib.sha256(data.read_bytes()).hexdigest()
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    assert proc.returncode == 0


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda, tmp_path):
    from dmlc_core_tpu_torch import train
    from dmlc_core_tpu_torch.device.device_iter import DeviceRowBlockIter
    from dmlc_core_tpu_torch.models.convert import (fm_params_from_numpy,
                                                    linear_params_from_numpy)
    from dmlc_core_tpu_torch.models.fm import FMLearner
    from dmlc_core_tpu_torch.models.linear import LinearLearner
    from dmlc_core_tpu_torch.serving import (ScoringModel, ScoringServer,
                                             save_model)
    from dmlc_core_tpu_torch.serving import __main__ as serve_cli
    p = tmp_path / "a.libsvm"
    p.write_text("1 0:1.0 1:2.0\n0 0:0.5\n")
    art = str(tmp_path / "m.ckpt")
    save_model(art, "linear", {"w": np.zeros(2, np.float32),
                               "b": np.zeros((), np.float32)}, 2)
    with pytest.raises(DMLCError, match="no CUDA device"):
        DeviceRowBlockIter(str(p))
    with pytest.raises(DMLCError, match="no CUDA device"):
        LinearLearner(2)
    with pytest.raises(DMLCError, match="no CUDA device"):
        FMLearner(2)
    with pytest.raises(DMLCError, match="no CUDA device"):
        LinearLearner(2, objective="pairwise")
    with pytest.raises(DMLCError, match="no CUDA device"):
        linear_params_from_numpy({"w": np.zeros(2), "b": 0.0})
    with pytest.raises(DMLCError, match="no CUDA device"):
        fm_params_from_numpy({"w": np.zeros(2), "b": 0.0,
                              "v": np.zeros((2, 2))})
    with pytest.raises(DMLCError, match="no CUDA device"):
        ScoringModel.load(art)
    with pytest.raises(DMLCError, match="no CUDA device"):
        ScoringServer(model_uri=art)
    with pytest.raises(DMLCError, match="no CUDA device"):
        serve_cli.main(["--model-uri", art])
    with pytest.raises(DMLCError, match="no CUDA device"):
        train.main([str(p), "--epochs", "1"])
    with pytest.raises(DMLCError, match="no CUDA device"):
        train.main([str(p), "--epochs", "1", "--model", "fm"])
    # the LM lane
    from dmlc_core_tpu_torch import train_lm
    from dmlc_core_tpu_torch.device.sharding import (host_data_mesh,
                                                     process_mesh)
    corpus = tmp_path / "c.txt"
    corpus.write_bytes(b"abcdefgh" * 64)
    with pytest.raises(DMLCError, match="no CUDA device"):
        process_mesh((("data", 1), ("seq", 1)))
    with pytest.raises(DMLCError, match="no CUDA device"):
        host_data_mesh()
    with pytest.raises(DMLCError, match="no CUDA device"):
        train_lm.main([str(corpus), "--seq", "16", "--steps", "1"])
    with pytest.raises(DMLCError, match="no CUDA device"):
        train_lm.main([str(corpus), "--seq", "16", "--steps", "1",
                       "--model", "tp", "--mesh", "data=1,model=1"])
    assert process_mesh((("data", 1),), device="cpu").device.type == "cpu"
    # an explicit device is honoured
    assert LinearLearner(2, device="cpu").init().w.device.type == "cpu"
    assert ScoringModel.load(art, device="cpu").device.type == "cpu"


def test_chip_smoke_fails_without_cuda_and_alone(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the script's refusal where CUDA is missing")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=alone,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
