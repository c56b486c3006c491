"""The port's training CLI against ``examples/train.py``.

``python -m dmlc_core_tpu_torch.train --device cpu`` on the 1,200-row file
of ``test_example_train.py`` prints the reference's per-epoch mean losses
at rtol 1e-5 (the two sum in f32 in different orders; the lines carry six
decimals). The reference runs on one JAX device here: on a mesh of D
devices its step applies D times the learning rate (ROADMAP.md section 3),
which the port's one-device step does not reproduce. Train, checkpoint and
``--resume`` go on from the right epoch, and a checkpoint taken inside an
epoch resumes to the losses of the run without the interruption.

In a 2-rank gloo world (real processes under the launcher env protocol,
each world with a 120-s timeout) every rank prints the same lines,
``--checkpoint`` writes a committed job checkpoint (a part per rank, the
ranks' parameters bit-identical), and ``--resume`` from a job checkpoint
committed inside an epoch gives the uninterrupted world's lines bit for
bit. A launcher env that names a part without a world is refused.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.torch_reference_native import reference_native  # noqa: F401
from tests.torch_world_worker import run_world, worker_argv

from dmlc_core_tpu_torch.base import DMLCError
from dmlc_core_tpu_torch import train as cli
from dmlc_core_tpu_torch.device.device_iter import DeviceRowBlockIter
from dmlc_core_tpu_torch.models.linear import LinearLearner
from dmlc_core_tpu_torch.utils.checkpoint import save_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMON = ["--batch-rows", "256"]


@pytest.fixture(autouse=True)
def _one_thread():
    # torch ops beside the native parser's spinning workers contend for
    # the cores; one intra-op thread keeps the CPU runs short
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_data(path):
    # test_example_train.py's file
    rng = np.random.default_rng(2)
    with open(path, "w") as f:
        for i in range(1200):
            x0 = rng.uniform(-1, 1)
            feats = " ".join([f"0:{x0:.4f}"] + [
                f"{j}:{rng.uniform(-1, 1):.4f}" for j in range(1, 5)])
            f.write(f"{1 if x0 > 0 else 0} {feats}\n")
    return str(path)


@pytest.fixture
def data(tmp_path):
    return _write_data(tmp_path / "d.libsvm")


def _losses(out):
    return [float(ln.split("mean loss ")[1].split(" ")[0])
            for ln in out.splitlines() if "mean loss" in ln]


def _run(cmd, env, cwd):
    out = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def test_cli_losses_match_reference(data, tmp_path):
    args = [data, "--epochs", "2", *COMMON]
    env = dict(os.environ, PYTHONPATH=REPO)
    ours = _run([sys.executable, "-m", "dmlc_core_tpu_torch.train", *args,
                 "--device", "cpu"], env, str(tmp_path))
    ref_env = dict(env, JAX_PLATFORMS="cpu", XLA_FLAGS="")
    ref = _run([sys.executable, os.path.join(REPO, "examples", "train.py"),
                *args], ref_env, str(tmp_path))
    assert [ln.split(":")[0] for ln in ours.splitlines()] == \
        ["epoch 0", "epoch 1"], ours
    assert [ln.split(" mean")[0] for ln in ours.splitlines()] == \
        [ln.split(" mean")[0] for ln in ref.splitlines() if "mean" in ln]
    np.testing.assert_allclose(_losses(ours), _losses(ref), rtol=1e-5)
    assert "over 5 batches" in ours


def test_cli_checkpoint_and_resume(data, tmp_path, capsys):
    ck = str(tmp_path / "ckpt.bin")
    cli.main([data, "--epochs", "2", *COMMON, "--checkpoint", ck,
              "--device", "cpu"])
    first = capsys.readouterr().out
    assert os.path.exists(ck)
    assert not os.path.exists(ck + ".commit")  # one process: a plain file
    cli.main([data, "--epochs", "3", *COMMON, "--resume", ck,
              "--device", "cpu"])
    resumed = capsys.readouterr().out.splitlines()
    assert len(resumed) == 1 and resumed[0].startswith("epoch 2:")
    cli.main([data, "--epochs", "3", *COMMON, "--device", "cpu"])
    whole = capsys.readouterr().out.splitlines()
    assert whole[:2] == first.splitlines()
    assert resumed[0] == whole[2]


def test_cli_mid_epoch_resume_matches_uninterrupted(data, tmp_path,
                                                    capsys):
    """A checkpoint written after k batches of epoch 0 with
    ``it.state()`` in its extra (how the reference's CLI reads one)
    resumes inside the epoch: the rest of epoch 0 and epoch 1 equal the
    uninterrupted run."""
    k = 2
    learner = LinearLearner(5, learning_rate=0.1, device="cpu")
    params = learner.init()
    losses = []
    with DeviceRowBlockIter(data, batch_rows=256, dense_dtype="bf16",
                            device="cpu") as it:
        for batch in it:
            params, loss = learner.step(params, batch)
            losses.append(float(loss))
            if len(losses) == k:
                ck = str(tmp_path / "mid.ckpt")
                save_checkpoint(ck, params, step=0,
                                extra={str(a): str(b)
                                       for a, b in it.state().items()})
    assert len(losses) == 5
    cli.main([data, "--epochs", "2", *COMMON, "--device", "cpu"])
    whole = capsys.readouterr().out.splitlines()
    assert _losses(whole[0]) == pytest.approx([np.mean(losses)], rel=1e-6)
    cli.main([data, "--epochs", "2", *COMMON, "--resume", ck,
              "--device", "cpu"])
    resumed = capsys.readouterr().out.splitlines()
    assert resumed[0].startswith("epoch 0:") and "over 3 batches" in \
        resumed[0]
    assert _losses(resumed[0]) == pytest.approx([np.mean(losses[k:])],
                                                rel=1e-6)
    assert resumed[1] == whole[1]


@pytest.mark.parametrize("extra_args,env,match", [
    (["--model", "fm"], {"DMLC_TASK_ID": "1", "DMLC_NUM_WORKER": "2"},
     "part 1 of 2, but this process's world has 1"),
    (["--objective", "pairwise"], {"JAX_COORDINATOR_ADDRESS": "h:1"},
     "JAX_NUM_PROCESSES is not"),
    ([], {"DMLC_TASK_ID": "0", "DMLC_NUM_WORKER": "2"},
     "part 0 of 2, but this process's world has 1"),
    ([], {"DMLC_COORDINATOR_ADDRESS": "localhost:1", "DMLC_NUM_WORKER": "2",
          "DMLC_TASK_ID": "5"}, "DMLC_TASK_ID=5 out of range"),
], ids=[f"extra_args{i}-env{i}-Multi-process data parallelism"
        for i in range(4)])
def test_cli_refuses_unported_lanes(data, monkeypatch, extra_args, env,
                                    match):
    """A launcher env that names a part of a world the process is not in
    (no coordinator), or a world it cannot join, is refused before any
    training: a worker must never train its part alone."""
    for k in ("JAX_COORDINATOR_ADDRESS", "DMLC_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(DMLCError, match=match):
        cli.main([data, *extra_args, "--device", "cpu"])


WORLD = ["--epochs", "2", *COMMON, "--device", "cpu"]


def _cli_world(tmp_path, args):
    """The CLI in a 2-rank gloo world; both ranks' stdout lines."""
    outs = run_world(lambda r: [sys.executable, "-m",
                                "dmlc_core_tpu_torch.train", *args],
                     cwd=str(tmp_path))
    return [o[0].splitlines() for o in outs]


@pytest.fixture(scope="module")
def world_run(tmp_path_factory):
    """The uninterrupted 2-rank world with --checkpoint: its data file,
    lines and job checkpoint's base."""
    d = tmp_path_factory.mktemp("world")
    data = _write_data(d / "d.libsvm")
    base = str(d / "job.ckpt")
    lines = _cli_world(d, [data, *WORLD, "--checkpoint", base])
    return data, lines, base


def test_cli_world_lines_and_job_checkpoint(world_run):
    _, (l0, l1), base = world_run
    assert l0 == l1 and len(l0) == 2, (l0, l1)
    assert [ln.split(":")[0] for ln in l0] == ["epoch 0", "epoch 1"]
    # 600 rows a part in batches of 256 / 2 ranks
    assert all("over 5 batches" in ln for ln in l0)
    with open(base + ".commit") as f:
        marker = json.load(f)
    assert marker == {"schema": 1, "step": 2, "npart": 2,
                      "parts": [f"{base}.step2.part{p}of2"
                                for p in range(2)]}
    from dmlc_core_tpu_torch.utils.checkpoint import restore_checkpoint
    for step in (1, 2):
        parts = [restore_checkpoint(f"{base}.step{step}.part{p}of2")
                 for p in range(2)]
        (f0, s0, e0), (f1, s1, e1) = parts
        assert s0 == s1 == step
        # the replicas hold the same bits; each part its own position
        assert {k: v.tobytes() for k, v in f0.items()} == \
            {k: v.tobytes() for k, v in f1.items()}
        assert [(e["part"], e["npart"], e["batch_rows"], e["epoch"],
                 e["batches_consumed"]) for e in (e0, e1)] == \
            [(str(p), "2", "256", str(step), "0") for p in range(2)]


def test_cli_world_mid_epoch_resume_matches_uninterrupted(tmp_path,
                                                          world_run):
    data, (whole, _), _ = world_run
    k = 2
    mid = str(tmp_path / "mid.ckpt")
    spec = tmp_path / "mid.json"
    spec.write_text(json.dumps({"data": data, "features": 5, "lr": 0.1,
                                "batch_rows": 256, "k": k, "base": mid}))
    outs = [tmp_path / f"mid{r}.json" for r in range(2)]
    run_world(lambda r: worker_argv("ckpt_mid", spec, outs[r]))
    losses = json.loads(outs[0].read_text())["losses"]
    assert losses == json.loads(outs[1].read_text())["losses"]
    # the worker's epoch is the CLI's epoch 0, step for step
    assert whole[0] == (f"epoch 0: mean loss {float(np.mean(losses)):.6f} "
                        f"over {len(losses)} batches")
    r0, r1 = _cli_world(tmp_path, [data, *WORLD, "--resume", mid])
    assert r0 == r1
    assert r0[0] == (f"epoch 0: mean loss "
                     f"{float(np.mean(losses[k:])):.6f} over "
                     f"{len(losses) - k} batches")
    assert r0[1] == whole[1]


def _fm_start(tmp_path, features, k=4):
    """A step-0 checkpoint of FM parameters that both CLIs resume from:
    torch's and JAX's random streams differ, so the FM runs start from
    the same numpy parameters instead of each package's init."""
    from dmlc_core_tpu_torch.models.convert import fm_params_from_numpy
    rng = np.random.default_rng(6)
    p = {"b": np.float32(0.0), "w": np.zeros(features, np.float32),
         "v": rng.normal(scale=0.1, size=(features, k)).astype(np.float32)}
    ck = str(tmp_path / "fm0.ckpt")
    save_checkpoint(ck, fm_params_from_numpy(p, "cpu"), step=0)
    return ["--model", "fm", "--fm-rank", str(k), "--resume", ck]


def _ranking_file(tmp_path):
    rng = np.random.default_rng(3)
    path = tmp_path / "rank.libsvm"
    w_true = rng.normal(size=5)
    with open(path, "w") as f:
        for q in range(100):
            x = rng.normal(size=(12, 5))
            rel = np.argsort(np.argsort(x @ w_true)) // 3  # labels 0..3
            for d in range(12):
                feats = " ".join(f"{j}:{x[d, j]:.4f}" for j in range(5))
                f.write(f"{rel[d]} qid:{q} {feats}\n")
    return str(path)


@pytest.mark.parametrize("case", ["fm", "pairwise", "fm_pairwise", "crec",
                                  "drec"])
def test_cli_lanes_and_models_match_reference(data, tmp_path, case):
    """``--model fm``, ``--objective pairwise`` and ``.crec``/``.drec``
    URIs give the reference CLI's epoch losses at rtol 1e-5 (the
    reference on one JAX device)."""
    from dmlc_core_tpu_torch.io import convert
    uri, extra = data, []
    if case in ("fm", "fm_pairwise"):
        extra = _fm_start(tmp_path, 5)
    if case in ("pairwise", "fm_pairwise"):
        uri = _ranking_file(tmp_path)
        extra += ["--objective", "pairwise"]
    if case == "crec":
        uri = str(tmp_path / "d.crec")
        convert.rows_to_csr_recordio(data, uri)
        extra = ["--num-features", "5"]
    if case == "drec":
        uri = str(tmp_path / "d.drec")
        convert.rows_to_dense_recordio(data, uri)
        extra = ["--num-features", "5"]
    args = [uri, "--epochs", "2", *COMMON, *extra]
    env = dict(os.environ, PYTHONPATH=REPO)
    ours = _run([sys.executable, "-m", "dmlc_core_tpu_torch.train", *args,
                 "--device", "cpu"], env, str(tmp_path))
    ref = _run([sys.executable, os.path.join(REPO, "examples", "train.py"),
                *args], dict(env, JAX_PLATFORMS="cpu", XLA_FLAGS=""),
               str(tmp_path))
    assert len(_losses(ours)) == 2, ours
    assert [ln.split(" mean")[0] for ln in ours.splitlines()] == \
        [ln.split(" mean")[0] for ln in ref.splitlines() if "mean" in ln]
    np.testing.assert_allclose(_losses(ours), _losses(ref), rtol=1e-5)


def test_cli_fm_mid_epoch_resume_matches_uninterrupted(data, tmp_path,
                                                       capsys):
    """An FM checkpoint taken after k batches of epoch 0 resumes inside
    the epoch: the rest of epoch 0 and epoch 1 equal the run without the
    interruption."""
    from dmlc_core_tpu_torch.models.fm import FMLearner
    k = 3
    learner = FMLearner(5, k=4, learning_rate=0.1, device="cpu")
    params = learner.init()
    losses = []
    with DeviceRowBlockIter(data, batch_rows=256, dense_dtype="bf16",
                            device="cpu") as it:
        for batch in it:
            params, loss = learner.step(params, batch)
            losses.append(float(loss))
            if len(losses) == k:
                ck = str(tmp_path / "fm_mid.ckpt")
                save_checkpoint(ck, params, step=0,
                                extra={str(a): str(b)
                                       for a, b in it.state().items()})
    fm = ["--model", "fm", "--fm-rank", "4"]
    cli.main([data, "--epochs", "2", *COMMON, *fm, "--device", "cpu"])
    whole = capsys.readouterr().out.splitlines()
    assert _losses(whole[0]) == pytest.approx([np.mean(losses)], rel=1e-6)
    cli.main([data, "--epochs", "2", *COMMON, *fm, "--resume", ck,
              "--device", "cpu"])
    resumed = capsys.readouterr().out.splitlines()
    assert resumed[0].startswith("epoch 0:") and "over 2 batches" in \
        resumed[0]
    assert _losses(resumed[0]) == pytest.approx([np.mean(losses[k:])],
                                                rel=1e-6)
    assert resumed[1] == whole[1]
