"""The port stands alone: no JAX, no ml_dtypes, nothing of dmlc_core_tpu.

A subprocess whose ``sys.meta_path`` refuses those packages (and the
reference's load generator and test helpers) imports every module of
``dmlc_core_tpu_torch`` and ``chip_smoke`` (without running it).
Entry points called without ``device=`` where CUDA is missing raise rather
than run on the CPU, and ``chip_smoke.py`` exits non-zero there.
"""

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
# the fourth to sixth slices' modules by name, so none can drop out
# unnoticed
for mod in ("io.convert", "ops.ranking", "models.fm", "models.convert",
            "device.device_iter", "train", "parallel",
            "parallel.distributed", "device.sharding", "data", "config",
            "params", "registry", "utils.timer", "telemetry"):
    assert "dmlc_core_tpu_torch." + mod in names, mod
for name in names:
    importlib.import_module(name)
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
    assert n >= 40  # every module of the six slices


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
                top = words[1].split(".")[0]
                assert top not in ("jax", "jaxlib", "ml_dtypes",
                                   "dmlc_core_tpu", "loadrig",
                                   "serving_util", "scripts",
                                   "tests"), (path, line)


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
