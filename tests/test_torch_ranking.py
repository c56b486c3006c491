"""The port's pairwise ranking loss and learner against the reference's.

``pairwise_logistic_loss`` values and gradients must equal JAX's at
rtol 1e-6 / atol 1e-7, at zero margins too, where every pair sits on the
tie: JAX's gradient there is -1.0 per pair term (``jnp.abs`` has slope +1
at 0 and ``jnp.maximum`` halves the tie), which the port mirrors. Three
pairwise steps of the linear learner and of the FM give the reference's
losses at rtol 1e-5 and parameters at rtol 1e-5 / atol 1e-7. The
reference's own ranking cases (``tests/test_ranking_learner.py``) are
ported on the CPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dmlc_core_tpu.models.fm import FMLearner as RefFM, FMParams as RefFMP
from dmlc_core_tpu.models.linear import LinearLearner as RefLinear
from dmlc_core_tpu.models.linear import LinearParams as RefLinP
from dmlc_core_tpu.ops.ranking import pairwise_logistic_loss as ref_loss
from dmlc_core_tpu.tpu.device_iter import DeviceRowBlockIter as RefIter
from tests.torch_reference_native import reference_native  # noqa: F401

from dmlc_core_tpu_torch.device.device_iter import (DeviceRowBlockIter,
                                                    unpack_tree)
from dmlc_core_tpu_torch.models.convert import (fm_params_from_numpy,
                                                fm_params_to_numpy,
                                                linear_params_to_numpy)
from dmlc_core_tpu_torch.models.fm import FMLearner
from dmlc_core_tpu_torch.models.linear import LinearLearner
from dmlc_core_tpu_torch.ops.ranking import pairwise_logistic_loss


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def loss_and_grad_both(m, label, qid, weight):
    """(port loss, port grad, ref loss, ref grad) of the mean pair loss."""
    def ref_mean(x):
        s, n = ref_loss(x, jnp.asarray(label), jnp.asarray(qid),
                        jnp.asarray(weight))
        return s / jnp.maximum(n, 1.0)
    want, want_g = jax.value_and_grad(ref_mean)(jnp.asarray(m))
    mt = torch.from_numpy(m).requires_grad_(True)
    s, n = pairwise_logistic_loss(mt, torch.from_numpy(label),
                                  torch.from_numpy(qid),
                                  torch.from_numpy(weight))
    got = s / torch.clamp(n, min=1.0)
    got.backward()
    return (float(got.detach()), mt.grad.numpy(), float(want),
            np.asarray(want_g))


def group_data(rng, R=48):
    label = rng.integers(0, 5, R).astype(np.float32)
    qid = np.repeat(np.arange(R // 8), 8).astype(np.int32)
    qid[-5:] = -1  # qid-less rows never pair
    weight = rng.uniform(0.5, 2.0, R).astype(np.float32)
    weight[-9:-5] = 0.0  # padding rows
    return label, qid, weight


def test_zero_margin_tie_gradient_is_minus_one():
    """One pair (row 0 above row 1) at margins 0: the pair's gradient in
    diff = m0 - m1 is -1.0, so d/dm0 = -1.0 and d/dm1 = +1.0 (a literal
    port with torch's abs would give -0.5)."""
    m = np.zeros(2, np.float32)
    label = np.array([1.0, 0.0], np.float32)
    qid = np.zeros(2, np.int32)
    w = np.ones(2, np.float32)
    got, g, want, wg = loss_and_grad_both(m, label, qid, w)
    np.testing.assert_allclose(wg, [-1.0, 1.0])
    np.testing.assert_array_equal(g, wg)
    assert got == pytest.approx(want) == pytest.approx(np.log(2.0))


@pytest.mark.parametrize("zero", [True, False])
def test_loss_and_gradients_match_reference(zero):
    rng = np.random.default_rng(21)
    label, qid, weight = group_data(rng)
    m = (np.zeros(len(label), np.float32) if zero
         else rng.normal(size=len(label)).astype(np.float32))
    if not zero:
        m[::5] = m[1::5][:len(m[::5])]  # some exact ties between rows
    got, g, want, wg = loss_and_grad_both(m, label, qid, weight)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(g, wg, rtol=1e-6, atol=1e-7)


def write_ranking_libsvm(path, queries=120, docs=8, features=6, seed=4):
    """Labels are the within-query rank under a hidden linear score."""
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=features)
    lines = []
    for q in range(queries):
        x = rng.normal(size=(docs, features))
        order = np.argsort(x @ w_true)
        rel = np.empty(docs, int)
        rel[order] = np.arange(docs)
        for d in range(docs):
            feats = " ".join(f"{j}:{x[d, j]:.5f}" for j in range(features))
            lines.append(f"{rel[d]} qid:{q} {feats}")
    path.write_text("\n".join(lines) + "\n")
    return w_true


@pytest.mark.parametrize("model", ["linear", "fm"])
@pytest.mark.parametrize("layout", ["dense", "csr"])
def test_three_pairwise_steps_match_reference(tmp_path, model, layout):
    src = tmp_path / "rank.libsvm"
    write_ranking_libsvm(src)
    kw = dict(batch_rows=256, layout=layout, min_nnz_bucket=2048,
              prefetch=0)
    rng = np.random.default_rng(2)
    if model == "linear":
        ref = RefLinear(6, objective="pairwise", learning_rate=0.5)
        port = LinearLearner(6, objective="pairwise", learning_rate=0.5,
                             device="cpu")
        rp = RefLinP(w=jnp.zeros(6), b=jnp.zeros(()))
        pp = port.init()
        to_np = linear_params_to_numpy
    else:
        p = {"b": np.float32(0.0), "w": np.zeros(6, np.float32),
             "v": rng.normal(scale=0.1, size=(6, 3)).astype(np.float32)}
        ref = RefFM(6, k=3, objective="pairwise", learning_rate=0.5)
        port = FMLearner(6, k=3, objective="pairwise", learning_rate=0.5,
                         device="cpu")
        rp = RefFMP(**{k: jnp.asarray(v) for k, v in p.items()})
        pp = fm_params_from_numpy(p, "cpu")
        to_np = fm_params_to_numpy
    want, got = [], []
    with RefIter(str(src), mesh=None, **kw) as it:
        for batch, _ in zip(it, range(3)):
            rp, loss = ref.step(rp, batch)
            want.append(float(loss))
    with DeviceRowBlockIter(str(src), device="cpu", **kw) as it:
        for batch, _ in zip(it, range(3)):
            pp, loss = port.step(pp, batch)
            got.append(float(loss))
    assert len(got) == 3
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for name, val in to_np(pp).items():
        np.testing.assert_allclose(val, np.asarray(getattr(rp, name)),
                                   rtol=1e-5, atol=1e-7, err_msg=name)


# -- the reference's own cases (tests/test_ranking_learner.py) ---------------
def pairwise_accuracy(w, batches):
    good = total = 0
    for b in batches:
        t = unpack_tree(b.tree())
        margin = t["x"].float().reshape(-1, t["x"].shape[-1]).numpy() @ w
        qid, lab, wgt = (t[k].reshape(-1).numpy()
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


def test_pairwise_learner_improves_ranking(tmp_path):
    src = tmp_path / "rank.libsvm"
    write_ranking_libsvm(src)
    learner = LinearLearner(num_features=6, objective="pairwise",
                            learning_rate=0.5, device="cpu")
    params = learner.init()
    losses = []
    for _ in range(6):
        with DeviceRowBlockIter(str(src), batch_rows=256, layout="dense",
                                device="cpu") as it:
            epoch = []
            for batch in it:
                params, loss = learner.step(params, batch)
                epoch.append(float(loss))
        losses.append(np.mean(epoch))
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0] * 0.8, losses
    with DeviceRowBlockIter(str(src), batch_rows=256, layout="dense",
                            device="cpu") as it:
        acc = pairwise_accuracy(params.w.numpy(), list(it))
    assert acc > 0.8, acc


def test_pairwise_requires_qid(tmp_path):
    src = tmp_path / "noq.libsvm"
    src.write_text("1 0:1.0\n0 1:1.0\n" * 64)
    learner = LinearLearner(num_features=2, objective="pairwise",
                            device="cpu")
    params = learner.init()
    with DeviceRowBlockIter(str(src), batch_rows=64, layout="dense",
                            device="cpu") as it:
        batch = next(iter(it))
        with pytest.raises(ValueError, match="needs qid"):
            learner.step(params, batch)


def test_pairwise_rejects_oversized_shards(tmp_path):
    src = tmp_path / "big.libsvm"
    src.write_text("".join(f"{i % 3} qid:{i // 8} 0:{i}.0\n"
                           for i in range(200)))
    learner = LinearLearner(num_features=1, objective="pairwise",
                            device="cpu")
    params = learner.init()
    with DeviceRowBlockIter(str(src), batch_rows=16384, layout="dense",
                            device="cpu") as it:
        batch = next(iter(it))
        with pytest.raises(ValueError, match="8192") as e:
            learner.step(params, batch)
    # the reference's message, word for word
    ref = RefLinear(num_features=1, objective="pairwise")
    with RefIter(str(src), batch_rows=16384, layout="dense") as it:
        with pytest.raises(ValueError) as ref_e:
            ref.step(ref.init(), next(iter(it)))
    assert str(e.value) == str(ref_e.value)


def test_pairwise_instance_weights_scale_pairs():
    margin = torch.tensor([2.0, 1.0, 0.0, -1.0])
    label = torch.tensor([1.0, 0.0, 1.0, 0.0])
    qid = torch.tensor([0, 0, 1, 1], dtype=torch.int32)
    s1, n1 = pairwise_logistic_loss(margin, label, qid, torch.ones(4))
    assert float(n1) == 2.0  # one ordered pair per query
    # weighting query 0's rows by 3 scales its pair by 9 (= w_i * w_j)
    w = torch.tensor([3.0, 3.0, 1.0, 1.0])
    s2, n2 = pairwise_logistic_loss(margin, label, qid, w)
    assert float(n2) == pytest.approx(9.0 + 1.0)
    per_pair_q0 = float(np.log1p(np.exp(-(2.0 - 1.0))))
    per_pair_q1 = float(np.log1p(np.exp(-(0.0 - (-1.0)))))
    assert float(s2) == pytest.approx(9 * per_pair_q0 + 1 * per_pair_q1,
                                      rel=1e-5)


def test_pairwise_masked_nonfinite_rows_stay_finite():
    # an overflowed qid-less row must not poison valid pairs via 0 * inf
    margin = torch.tensor([1.0, 0.0, float("inf")], requires_grad=True)
    label = torch.tensor([1.0, 0.0, 5.0])
    qid = torch.tensor([0, 0, -1], dtype=torch.int32)
    s, n = pairwise_logistic_loss(margin, label, qid, torch.ones(3))
    loss = s / torch.clamp(n, min=1.0)
    loss.backward()
    assert np.isfinite(float(loss))
    assert torch.isfinite(margin.grad[:2]).all()
