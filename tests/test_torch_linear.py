"""The port's linear learner against the reference's, step by step.

Both packages read the same seeded libsvm file with the same batch shape
(batch_rows=128, min_nnz_bucket=1024, as test_pallas_kernels.py's
trajectory test) and start from the same parameters, carried over as
numpy arrays. Per-step losses and final weights must agree at rtol 1e-5
(atol 1e-7 on weights), the reference trajectory test's own tolerances:
the two sides sum in f32 in different orders.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dmlc_core_tpu.models.linear import LinearLearner as RefLearner
from dmlc_core_tpu.models.linear import LinearParams as RefParams
from dmlc_core_tpu.tpu.device_iter import DeviceRowBlockIter as RefIter

from dmlc_core_tpu_torch.base import DMLCError
from dmlc_core_tpu_torch.device.device_iter import (DeviceRowBlockIter,
                                                    PaddedBatch)
from dmlc_core_tpu_torch.models.convert import linear_params_from_numpy
from dmlc_core_tpu_torch.models.linear import LinearLearner
from dmlc_core_tpu_torch.ops import hopper_kernels as hk

F = 6
ITER_KW = dict(batch_rows=128, min_nnz_bucket=1024)


@pytest.fixture
def libsvm(tmp_path):
    # the reference trajectory test's file: 512 rows, 6 dense features
    p = tmp_path / "m.libsvm"
    rng = np.random.default_rng(9)
    with open(p, "w") as f:
        for i in range(512):
            feats = " ".join(f"{j}:{rng.uniform(-1, 1):.4f}"
                             for j in range(F))
            f.write(f"{i % 2} {feats}\n")
    return str(p)


def ref_train(path, start=None, layout="csr", **kw):
    learner = RefLearner(F, mesh=None, **kw)
    params = learner.init() if start is None else RefParams(
        w=jnp.asarray(start["w"]), b=jnp.asarray(start["b"]))
    losses = []
    with RefIter(path, mesh=None, layout=layout, **ITER_KW) as it:
        for batch in it:
            params, loss = learner.step(params, batch)
            losses.append(float(loss))
    return losses, np.asarray(params.w), float(params.b)


def port_train(path, start=None, layout="csr", **kw):
    learner = LinearLearner(F, device="cpu", **kw)
    params = learner.init() if start is None else \
        linear_params_from_numpy(start, "cpu")
    losses = []
    with DeviceRowBlockIter(path, layout=layout, device="cpu",
                            **ITER_KW) as it:
        for batch in it:
            params, loss = learner.step(params, batch)
            losses.append(float(loss))
    return losses, params.w.numpy(), float(params.b)


def assert_same(got, want):
    assert len(got[0]) == len(want[0]) == 4
    assert np.all(np.isfinite(got[0]))
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("margin_path", ["segment", "dense"])
def test_trajectory_matches_reference(libsvm, monkeypatch, margin_path):
    if margin_path == "dense":
        # both packages' formatter switch: the Pallas kernel (interpret
        # mode) on the reference side, the kernel wrapper on the port's
        monkeypatch.setenv("DCT_CSR_TO_DENSE", "pallas")
    want = ref_train(libsvm, learning_rate=0.5, margin_path=margin_path)
    got = port_train(libsvm, learning_rate=0.5, margin_path=margin_path)
    assert_same(got, want)


def test_dense_margin_path_matches_segment(libsvm, monkeypatch):
    seg = port_train(libsvm, learning_rate=0.5)
    monkeypatch.setenv("DCT_CSR_TO_DENSE", "pallas")
    calls = []
    real = hk.csr_to_dense_kernel
    monkeypatch.setattr(hk, "csr_to_dense_kernel",
                        lambda *a: calls.append(1) or real(*a))
    dense = port_train(libsvm, learning_rate=0.5, margin_path="dense")
    assert len(calls) == 4  # the kernel wrapper, once per step
    assert_same(dense, seg)


@pytest.mark.parametrize("margin_path", ["segment", "dense"])
def test_from_carried_over_weights(libsvm, monkeypatch, margin_path):
    monkeypatch.setenv("DCT_CSR_TO_DENSE", "pallas")
    rng = np.random.default_rng(11)
    start = {"w": rng.normal(size=F).astype(np.float32),
             "b": np.float32(0.3)}
    kw = dict(learning_rate=0.2, l2=0.01, margin_path=margin_path)
    want = ref_train(libsvm, start, **kw)
    got = port_train(libsvm, start, **kw)
    assert_same(got, want)
    assert not np.allclose(got[1], start["w"])


@pytest.mark.parametrize("layout,objective", [("csr", "squared"),
                                              ("dense", "logistic"),
                                              ("dense", "squared")])
def test_objectives_and_dense_layout_match(libsvm, layout, objective):
    kw = dict(learning_rate=0.1, objective=objective)
    assert_same(port_train(libsvm, layout=layout, **kw),
                ref_train(libsvm, layout=layout, **kw))


@pytest.mark.parametrize("layout", ["csr", "dense"])
def test_predict_matches_reference(libsvm, layout):
    rng = np.random.default_rng(12)
    start = {"w": rng.normal(size=F).astype(np.float32),
             "b": np.float32(-0.2)}
    ref = RefLearner(F, mesh=None)
    port = LinearLearner(F, device="cpu")
    ref_p = RefParams(w=jnp.asarray(start["w"]), b=jnp.asarray(start["b"]))
    port_p = linear_params_from_numpy(start, "cpu")
    with RefIter(libsvm, mesh=None, layout=layout, **ITER_KW) as it:
        want = [np.asarray(ref.predict(ref_p, b)) for b in it]
    with DeviceRowBlockIter(libsvm, layout=layout, device="cpu",
                            **ITER_KW) as it:
        got = [port.predict(port_p, b).numpy() for b in it]
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.shape == w.shape == (1, 128)
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def test_params_carry_over_exactly():
    w = np.arange(5, dtype=np.float64) / 3
    p = linear_params_from_numpy({"w": w, "b": 1.5}, "cpu")
    assert p.w.dtype == p.b.dtype == torch.float32 and p.b.dim() == 0
    np.testing.assert_array_equal(p.w.numpy(), w.astype(np.float32))
    init = LinearLearner(5, device="cpu").init()
    assert float(init.w.abs().sum()) == 0.0 and init.w.shape == (5,)


def test_unported_options_raise(libsvm):
    with pytest.raises(DMLCError, match="ROADMAP.md"):
        port_train(libsvm, objective="pairwise")
    with pytest.raises(ValueError, match="unknown objective"):
        port_train(libsvm, objective="hinge")
    with pytest.raises(DMLCError, match="multi-device"):
        LinearLearner(F, mesh=object(), device="cpu")


def test_step_rejects_device_axis_mismatch():
    learner = LinearLearner(F, device="cpu")
    batch = PaddedBatch(big=torch.zeros(2, 3, 8, dtype=torch.int32),
                        aux=torch.zeros(2, 3, 4, dtype=torch.int32))
    with pytest.raises(ValueError, match="device axis D=2"):
        learner.step(learner.init(), batch)


@pytest.mark.parametrize("objective", ["logistic", "squared"])
def test_objective_gradients_match_reference(objective):
    # margins include exact zeros: the reference's gradient convention
    # there (jnp.abs slope +1, jnp.maximum tie halved) is mirrored
    import jax
    from dmlc_core_tpu.models.linear import objective_loss as ref_loss
    from dmlc_core_tpu_torch.models.linear import objective_loss
    rng = np.random.default_rng(13)
    m = rng.normal(size=32).astype(np.float32)
    m[::3] = 0.0
    shard = {"label": (rng.random(32) < 0.5).astype(np.float32),
             "weight": rng.random(32).astype(np.float32)}
    ref_shard = {k: jnp.asarray(v) for k, v in shard.items()}
    want = jax.grad(lambda x: ref_loss(x, ref_shard, 32, objective)[0])(
        jnp.asarray(m))
    mt = torch.from_numpy(m).requires_grad_(True)
    loss, wsum = objective_loss(
        mt, {k: torch.from_numpy(v) for k, v in shard.items()}, 32,
        objective)
    loss.backward()
    np.testing.assert_allclose(mt.grad.numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-7)
    want_loss = ref_loss(jnp.asarray(m), ref_shard, 32, objective)[0]
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-6)
