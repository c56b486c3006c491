"""The port's checkpoint writer and reader against the reference's.

The same parameters, step and ``extra`` written through both packages
give the same bytes, for a ``LinearParams`` and for a ``save_model``
dict artifact; each package reads the other's file; ``restore_checkpoint``
returns the template's type, device and dtype and refuses a shape or
dtype mismatch; an injected local-filesystem fault leaves the previous
checkpoint whole (the reference's ``test_checkpoint_local_fault_matrix``
shapes, through the port's own fault plan); a remote save through the
mock S3 server uploads a temp object, verifies sizes, tombstones the
temp, and fails in a structured way when a verify keeps failing (the
reference's remote cases in ``tests/test_fs_fault.py``). The two-phase
job checkpoint writes the reference's parts and commit marker byte for
byte, refuses a torn set, a world-size mismatch and a mixed-step marker
(the reference's ``test_torn_job_checkpoint_refused``), and
``fast_forward`` skips as the reference's does.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

# starts the shared per-process mock-S3 server and pins the native S3
# endpoint env before either package's native core first reads it (the
# test_fs_fault.py convention)
from test_s3 import _STATE as S3_STATE

from dmlc_core_tpu.models.linear import LinearParams as RefParams
from dmlc_core_tpu.serving import model as ref_serving
from dmlc_core_tpu.utils import checkpoint as ref_ckpt
from tests.torch_reference_native import reference_native  # noqa: F401

from dmlc_core_tpu_torch import telemetry
from dmlc_core_tpu_torch.base import DMLCError
from dmlc_core_tpu_torch.io import native
from dmlc_core_tpu_torch.models.convert import (linear_params_from_numpy,
                                                linear_params_to_numpy)
from dmlc_core_tpu_torch.models.linear import LinearParams
from dmlc_core_tpu_torch.serving import model as serving
from dmlc_core_tpu_torch.utils import checkpoint as ckpt
from dmlc_core_tpu_torch.utils import fs_fault

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXTRA = {"batches_consumed": "3", "uri": "d.libsvm", "epoch": "1"}


@pytest.fixture(autouse=True)
def _clean_plans():
    """The fault plans are process-wide: every test starts and ends
    clean."""
    fs_fault.set_fs_fault_plan("")
    native.set_fs_fault_plan("")
    yield
    fs_fault.set_fs_fault_plan("")
    native.set_fs_fault_plan("")


def _numpy_params(seed, features=7):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=features).astype(np.float32),
            "b": np.asarray(rng.normal(), np.float32)}


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_linear_params_bytes_match_reference(tmp_path):
    p = _numpy_params(1)
    ours, ref = str(tmp_path / "ours.ckpt"), str(tmp_path / "ref.ckpt")
    ckpt.save_checkpoint(ours, linear_params_from_numpy(p, device="cpu"),
                         step=5, extra=EXTRA)
    ref_ckpt.save_checkpoint(
        ref, RefParams(w=jnp.asarray(p["w"]), b=jnp.asarray(p["b"])),
        step=5, extra=EXTRA)
    assert _read(ours) == _read(ref)
    # the keys are the reference's keystr spellings, in field order, and
    # the 0-d b is written with ndim 0 and dtype float32
    flat, step, extra = ref_ckpt.restore_checkpoint(ours)
    assert list(flat) == [".w", ".b"] and step == 5 and extra == EXTRA
    assert flat[".b"].shape == () and flat[".b"].dtype == np.float32


@pytest.mark.parametrize("kind", ["linear", "fm"])
def test_serving_artifact_bytes_match_reference(tmp_path, kind):
    p = _numpy_params(2)
    if kind == "fm":
        p["v"] = np.random.default_rng(3).normal(
            size=(7, 4)).astype(np.float32)
    ours, ref = str(tmp_path / "ours.ckpt"), str(tmp_path / "ref.ckpt")
    serving.save_model(ours, kind, {k: torch.from_numpy(v)
                                    for k, v in p.items()}, 7, step=9)
    ref_serving.save_model(ref, kind, p, 7, step=9)
    assert _read(ours) == _read(ref)
    flat, _, _ = ckpt.restore_checkpoint(ours)
    assert list(flat) == sorted(f"['{k}']" for k in p)  # dict keys sorted


def test_each_package_reads_the_other(tmp_path):
    p = _numpy_params(4)
    ref_file = str(tmp_path / "ref.ckpt")
    ref_ckpt.save_checkpoint(
        ref_file, RefParams(w=jnp.asarray(p["w"]), b=jnp.asarray(p["b"])),
        step=2, extra=EXTRA)
    like = LinearParams(w=torch.zeros(7), b=torch.zeros(()))
    got, step, extra = ckpt.restore_checkpoint(ref_file, like=like)
    assert step == 2 and extra == EXTRA
    np.testing.assert_array_equal(got.w.numpy(), p["w"])
    np.testing.assert_array_equal(got.b.numpy(), p["b"])

    ours = str(tmp_path / "ours.ckpt")
    ckpt.save_checkpoint(ours, got, step=3)
    ref_like = RefParams(w=jnp.zeros(7, jnp.float32),
                         b=jnp.zeros((), jnp.float32))
    back, step, _ = ref_ckpt.restore_checkpoint(ours, like=ref_like)
    assert step == 3
    np.testing.assert_array_equal(np.asarray(back.w), p["w"])
    np.testing.assert_array_equal(np.asarray(back.b), p["b"])

    # a serving artifact crosses too, and scores the same
    art = str(tmp_path / "art.ckpt")
    ref_serving.save_model(art, "linear", p, 7, step=6)
    m = serving.ScoringModel.load(art, device="cpu")
    assert m.step == 6 and m.kind == "linear"
    np.testing.assert_array_equal(m.params.w.numpy(), p["w"])


def test_restore_like_keeps_template_type_device_dtype(tmp_path):
    p = _numpy_params(5)
    path = str(tmp_path / "a.ckpt")
    params = linear_params_from_numpy(p, device="cpu")
    ckpt.save_checkpoint(path, params, step=1)
    like = LinearParams(w=torch.ones(7), b=torch.ones(()))
    got, _, _ = ckpt.restore_checkpoint(path, like=like)
    assert type(got) is LinearParams
    for leaf, tmpl in zip(got, like):
        assert leaf.device == tmpl.device and leaf.dtype == tmpl.dtype
        assert leaf.shape == tmpl.shape
    assert linear_params_to_numpy(got)["w"].tolist() == p["w"].tolist()
    # a dict template keeps its keys; numpy leaves stay numpy
    dict_path = str(tmp_path / "d.ckpt")
    ckpt.save_checkpoint(dict_path, p)
    got, _, _ = ckpt.restore_checkpoint(
        dict_path, like={"w": np.zeros(7, np.float32),
                         "b": np.zeros((), np.float32)})
    assert set(got) == {"w", "b"} and isinstance(got["w"], np.ndarray)


@pytest.mark.parametrize("like,match", [
    (LinearParams(w=torch.zeros(8), b=torch.zeros(())), "shape mismatch"),
    (LinearParams(w=torch.zeros(7, dtype=torch.float64),
                  b=torch.zeros(())), "dtype mismatch"),
    ({"w": torch.zeros(7), "b": torch.zeros(())}, "does not match"),
])
def test_restore_like_refuses_mismatch(tmp_path, like, match):
    path = str(tmp_path / "a.ckpt")
    ckpt.save_checkpoint(path, linear_params_from_numpy(_numpy_params(6),
                                                        device="cpu"))
    with pytest.raises(DMLCError, match=match):
        ckpt.restore_checkpoint(path, like=like)


def _failures():
    return telemetry.counter("ckpt_save_failures_total").value


# the reference's test_fs_fault.py LOCAL_CKPT_PLANS
LOCAL_CKPT_PLANS = [
    "write:fault=enospc,every=2",
    "write:fault=short_write,every=2",
    "write:fault=eio,every=3",
    "fsync:fault=fsync_fail,every=1",
    "rename:fault=eio,every=1",
    "rename:fault=torn_rename,every=1",
]


@pytest.mark.parametrize("plan", LOCAL_CKPT_PLANS)
def test_fault_leaves_previous_checkpoint_whole(tmp_path, plan):
    """Every local fault shape ends in a CheckpointError with no temp
    litter and no truncated checkpoint visible: the target restores
    completely (the old body, or a rename that landed) or is absent."""
    target = str(tmp_path / "model.ckpt")
    old, new = _numpy_params(7), _numpy_params(8)
    ckpt.save_checkpoint(target, old, step=7)
    fails = _failures()
    fs_fault.set_fs_fault_plan(plan)
    with pytest.raises(ckpt.CheckpointError):
        ckpt.save_checkpoint(target, new, step=8)
    fs_fault.set_fs_fault_plan("")
    assert _failures() == fails + 1
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]
    if os.path.exists(target):
        got, step, _ = ckpt.restore_checkpoint(target)
        want = old if step == 7 else new
        assert step in (7, 8)
        np.testing.assert_array_equal(got["['w']"], want["w"])
    ckpt.save_checkpoint(target, new, step=9)
    assert ckpt.restore_checkpoint(target)[1] == 9


def test_env_write_fault_leaves_previous_checkpoint_whole(tmp_path):
    """The plan read from DMLC_FS_FAULT_PLAN (a fresh process, where the
    env is consulted at first use): the failed save raises, the previous
    file keeps its bytes, no temp file is left."""
    target = str(tmp_path / "model.ckpt")
    ckpt.save_checkpoint(target, _numpy_params(9), step=1)
    before = _read(target)
    probe = ("import sys, numpy as np\n"
             f"sys.path.insert(0, {REPO!r})\n"
             "from dmlc_core_tpu_torch.utils import checkpoint as c\n"
             "try:\n"
             f"    c.save_checkpoint({target!r}, {{'w': np.ones(7, "
             "np.float32)}, step=2)\n"
             "except c.CheckpointError as e:\n"
             "    print('FAILED', e.phase)\n")
    env = dict(os.environ, DMLC_FS_FAULT_PLAN="write:fault=enospc,every=2")
    out = subprocess.run([sys.executable, "-c", probe], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "FAILED write"
    assert _read(target) == before
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]


# -- remote saves (mock S3) --------------------------------------------------
@pytest.fixture
def s3_keys():
    """Drop this file's objects from the shared mock afterwards: other
    suites in the process count the temp keys they find there."""
    yield
    for key in [k for k in S3_STATE.objects
                if k[1].startswith("torch-ckpt/")]:
        del S3_STATE.objects[key]


def test_remote_save_roundtrip_and_tombstoned_temp(s3_keys):
    uri = "s3://bkt/torch-ckpt/model.ckpt"
    p = _numpy_params(10)
    ckpt.save_checkpoint(uri, linear_params_from_numpy(p, device="cpu"),
                         step=11, extra={"lr": "0.1"})
    got, step, extra = ckpt.restore_checkpoint(
        uri, like=LinearParams(w=torch.zeros(7), b=torch.zeros(())))
    assert step == 11 and extra == {"lr": "0.1"}
    np.testing.assert_array_equal(got.w.numpy(), p["w"])
    # the reference reads the port's remote object too
    flat, step, _ = ref_ckpt.restore_checkpoint(uri)
    assert step == 11 and list(flat) == [".w", ".b"]
    tmp_keys = [k for (_b, k) in S3_STATE.objects
                if k.startswith("torch-ckpt/model.ckpt.tmp.")]
    assert tmp_keys, "the temp-object probe must have been uploaded"
    assert all(S3_STATE.objects[("bkt", k)] == b"" for k in tmp_keys)


def test_remote_temp_verify_failure_never_touches_target(monkeypatch,
                                                        s3_keys):
    monkeypatch.setenv("DMLC_CKPT_MAX_RETRY", "1")
    monkeypatch.setattr(ckpt, "path_info", lambda uri: (1, False))
    fails = _failures()
    with pytest.raises(ckpt.CheckpointError, match="size mismatch"):
        ckpt.save_checkpoint("s3://bkt/torch-ckpt/short.ckpt",
                             _numpy_params(11), step=1)
    assert _failures() == fails + 1
    assert ("bkt", "torch-ckpt/short.ckpt") not in S3_STATE.objects


def test_remote_target_verify_failure_warns_partial(monkeypatch, s3_keys):
    monkeypatch.setenv("DMLC_CKPT_MAX_RETRY", "1")
    real = ckpt.path_info
    monkeypatch.setattr(ckpt, "path_info", lambda uri: (
        (1, False) if uri.endswith(".ckpt") else real(uri)))
    with pytest.raises(ckpt.CheckpointError, match="partial"):
        ckpt.save_checkpoint("s3://bkt/torch-ckpt/torn.ckpt",
                             _numpy_params(12), step=1)


# -- two-phase job checkpoints ----------------------------------------------
def test_job_parts_and_marker_bytes_match_reference(tmp_path):
    p = _numpy_params(6)
    ours, ref = str(tmp_path / "ours" / "job"), str(tmp_path / "ref" / "job")
    os.makedirs(os.path.dirname(ours))
    os.makedirs(os.path.dirname(ref))
    for part in range(2):
        extra = dict(EXTRA, part=str(part), npart="2")
        got = ckpt.save_job_checkpoint(
            ours, linear_params_from_numpy(p, device="cpu"), 3, part, 2,
            extra=extra)
        want = ref_ckpt.save_job_checkpoint(
            ref, RefParams(w=jnp.asarray(p["w"]), b=jnp.asarray(p["b"])),
            3, part, 2, extra=extra)
        assert got == ckpt.job_part_uri(ours, 3, part, 2) == \
            want.replace(ref, ours) == f"{ours}.step3.part{part}of2"
        assert _read(got) == _read(want)
    assert ckpt.commit_job_checkpoint(ours, 3, 2) == \
        ckpt.job_commit_uri(ours) == f"{ours}.commit"
    ref_ckpt.commit_job_checkpoint(ref, 3, 2)
    # the marker names the parts by their URIs: the same JSON with the
    # other base
    assert _read(f"{ours}.commit") == \
        _read(f"{ref}.commit").replace(ref.encode(), ours.encode())
    assert json.loads(_read(f"{ours}.commit")) == {
        "schema": 1, "step": 3, "npart": 2,
        "parts": [f"{ours}.step3.part0of2", f"{ours}.step3.part1of2"]}
    like = LinearParams(w=torch.zeros(7), b=torch.zeros(()))
    for part in range(2):
        # each package restores the other's job
        got, step, extra = ckpt.restore_job_checkpoint(ref, part, 2,
                                                       like=like)
        np.testing.assert_array_equal(got.w.numpy(), p["w"])
        assert step == 3 and extra["part"] == str(part)
        flat, step, _ = ref_ckpt.restore_job_checkpoint(ours, part, 2)
        np.testing.assert_array_equal(flat[".w"], p["w"])


def test_torn_job_checkpoint_refused(tmp_path):
    base = str(tmp_path / "job.ckpt")
    like = {"w": np.zeros(4, np.float32)}
    p2 = {"w": np.arange(4, dtype=np.float32)}
    for part in range(2):
        ckpt.save_job_checkpoint(base, p2, 2, part, 2, extra={"tag": "a"})
    ckpt.commit_job_checkpoint(base, 2, 2)

    # torn step 4: only rank 0 published before the (simulated) crash
    ckpt.save_job_checkpoint(base, {"w": p2["w"] + 1}, 4, 0, 2)
    before = _read(ckpt.job_commit_uri(base))
    with pytest.raises(ckpt.CheckpointError, match="torn step-4 set"):
        ckpt.commit_job_checkpoint(base, 4, 2)
    assert _read(ckpt.job_commit_uri(base)) == before

    # restore on BOTH ranks falls back to the committed step
    for part in range(2):
        params, step, extra = ckpt.restore_job_checkpoint(base, part, 2,
                                                          like=like)
        assert step == 2
        assert extra["tag"] == "a"
        np.testing.assert_array_equal(params["w"], p2["w"])

    # no marker at all -> fresh start (None), not an error
    assert ckpt.restore_job_checkpoint(str(tmp_path / "never"), 0, 2,
                                       like=like) is None

    # world-size mismatch: a 2-rank commit refused on a 3-rank world
    with pytest.raises(DMLCError, match="committed by 2 rank"):
        ckpt.restore_job_checkpoint(base, 0, 3, like=like)

    # a marker that lies about the step (names parts holding another
    # step) is a mixed-step resume: refused
    marker = ckpt.job_commit_uri(base)
    with open(marker) as f:
        meta = json.load(f)
    meta["step"] = 4
    meta["parts"] = [ckpt.job_part_uri(base, 2, p, 2) for p in range(2)]
    with open(marker, "w") as f:
        json.dump(meta, f)
    with pytest.raises(DMLCError, match="mixed-step resume"):
        ckpt.restore_job_checkpoint(base, 0, 2, like=like)


def test_fast_forward():
    it = ckpt.fast_forward(iter(range(10)), 4)
    assert next(it) == 4 == next(ref_ckpt.fast_forward(iter(range(10)), 4))


def test_fast_forward_past_end_raises():
    with pytest.raises(DMLCError, match="exhausted after 3 of 5"):
        ckpt.fast_forward(iter(range(3)), 5)
