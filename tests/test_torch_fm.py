"""The port's factorization machine against the reference's.

Both packages start from the same numpy parameters (torch's and JAX's
random streams differ) and read the same seeded files, the reference on
one JAX device. Margins must agree at rtol 1e-5 / atol 1e-6 (float32 sums
in another order), and three steps of ``FMLearner`` give the same losses
at rtol 1e-5 and parameters at rtol 1e-5 / atol 1e-7. The reference's own
FM cases (``tests/test_fm.py``) are ported on the CPU.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dmlc_core_tpu.models.fm import FMLearner as RefFM, FMParams as RefParams
from dmlc_core_tpu.models.fm import _fm_margin_csr as ref_margin_csr
from dmlc_core_tpu.models.fm import _fm_margin_dense as ref_margin_dense
from dmlc_core_tpu.tpu.device_iter import DeviceRowBlockIter as RefIter
from tests.torch_reference_native import reference_native  # noqa: F401

from dmlc_core_tpu_torch.device.device_iter import DeviceRowBlockIter
from dmlc_core_tpu_torch.models.convert import (fm_params_from_numpy,
                                                fm_params_to_numpy)
from dmlc_core_tpu_torch.models.fm import (FMLearner, FMParams,
                                           _fm_margin_csr, _fm_margin_dense)
from dmlc_core_tpu_torch.models.linear import LinearLearner

F, K = 12, 4
ITER_KW = dict(batch_rows=128, min_nnz_bucket=2048, prefetch=0)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_libfm(path, rows=512, seed=0, fields=False):
    """y depends on a product of two features; about 60 % of the F
    features present in a row (libfm ``field:feature:value`` with
    ``fields``)."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(rows):
            keep = np.flatnonzero(rng.random(F) < 0.6)
            x = rng.uniform(-1, 1, F)
            y = int(x[0] * x[1] > 0)
            if fields:
                feats = " ".join(f"{j % 3}:{j}:{x[j]:.4f}" for j in keep)
            else:
                feats = " ".join(f"{j}:{x[j]:.4f}" for j in keep)
            f.write(f"{y} {feats}\n")
    return str(path)


def start_params(seed=1, scale=0.3, k=K):
    rng = np.random.default_rng(seed)
    return {"b": np.float32(0.05),
            "w": rng.normal(scale=0.1, size=F).astype(np.float32),
            "v": rng.normal(scale=scale, size=(F, k)).astype(np.float32)}


def ref_params(p):
    return RefParams(b=jnp.asarray(p["b"]), w=jnp.asarray(p["w"]),
                     v=jnp.asarray(p["v"]))


def test_margins_match_reference():
    rng = np.random.default_rng(3)
    p = start_params()
    R, nnz = 64, 400
    row = np.sort(rng.integers(0, R, nnz)).astype(np.int32)
    row[-30:] = R  # padding nonzeros
    col = rng.integers(0, F, nnz).astype(np.int32)
    val = rng.normal(size=nnz).astype(np.float32)
    want = ref_margin_csr(ref_params(p), jnp.asarray(row), jnp.asarray(col),
                          jnp.asarray(val), R)
    got = _fm_margin_csr(fm_params_from_numpy(p, "cpu"),
                         torch.from_numpy(row), torch.from_numpy(col),
                         torch.from_numpy(val), R)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    x = rng.normal(size=(3, R, F)).astype(np.float32)
    want = ref_margin_dense(ref_params(p), jnp.asarray(x))
    got = _fm_margin_dense(fm_params_from_numpy(p, "cpu"),
                           torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def run_both(uri, objective, layout, steps=3, dense_dtype="float32",
             **learner_kw):
    p = start_params()
    ref = RefFM(F, k=K, objective=objective, learning_rate=0.5,
                **learner_kw)
    port = FMLearner(F, k=K, objective=objective, learning_rate=0.5,
                     device="cpu", **learner_kw)
    rp, pp = ref_params(p), fm_params_from_numpy(p, "cpu")
    want, got = [], []
    with RefIter(uri, mesh=None, layout=layout, dense_dtype=dense_dtype,
                 **ITER_KW) as it:
        for batch, _ in zip(it, range(steps)):
            rp, loss = ref.step(rp, batch)
            want.append(float(loss))
    with DeviceRowBlockIter(uri, layout=layout, dense_dtype=dense_dtype,
                            device="cpu", **ITER_KW) as it:
        for batch, _ in zip(it, range(steps)):
            pp, loss = port.step(pp, batch)
            got.append(float(loss))
    return want, got, rp, pp


@pytest.mark.parametrize("objective", ["logistic", "squared"])
@pytest.mark.parametrize("layout,dtype", [("csr", "float32"),
                                          ("dense", "float32"),
                                          ("dense", "bf16")])
def test_three_steps_match_reference(tmp_path, objective, layout, dtype):
    uri = write_libfm(tmp_path / "a.libsvm")
    want, got, rp, pp = run_both(uri, objective, layout, dense_dtype=dtype,
                                 l2=0.01)
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-5)
    back = fm_params_to_numpy(pp)
    for name in FMParams._fields:
        np.testing.assert_allclose(back[name], np.asarray(getattr(rp, name)),
                                   rtol=1e-5, atol=1e-7, err_msg=name)


def test_libfm_fields_ride_along(tmp_path):
    # field ids travel as a plane (kb = 4) and do not change the FM math
    uri = write_libfm(tmp_path / "f.libfm", fields=True) + "?format=libfm"
    want, got, _, _ = run_both(uri, "logistic", "csr")
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_predict_matches_reference(tmp_path):
    uri = write_libfm(tmp_path / "p.libsvm", rows=300)
    p = start_params()
    ref, port = RefFM(F, k=K), FMLearner(F, k=K, device="cpu")
    for layout in ("csr", "dense"):
        with RefIter(uri, mesh=None, layout=layout, dense_dtype="float32",
                     **ITER_KW) as it:
            want = [np.asarray(ref.predict(ref_params(p), b)) for b in it]
        with DeviceRowBlockIter(uri, layout=layout, dense_dtype="float32",
                                device="cpu", **ITER_KW) as it:
            got = [port.predict(fm_params_from_numpy(p, "cpu"), b).numpy()
                   for b in it]
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g.shape == w.shape == (1, 128)
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def test_init_is_seeded_and_shaped():
    learner = FMLearner(7, k=3, init_scale=0.5, device="cpu")
    a, b = learner.init(seed=4), learner.init(seed=4)
    assert torch.equal(a.v, b.v) and not torch.equal(a.v,
                                                     learner.init(5).v)
    assert a.v.shape == (7, 3) and a.w.shape == (7,) and a.b.dim() == 0
    assert float(a.w.abs().sum()) == 0.0 and float(a.v.abs().sum()) > 0
    assert abs(float(a.v.std()) - 0.5) < 0.25


def test_params_round_trip_numpy():
    p = start_params()
    back = fm_params_to_numpy(fm_params_from_numpy(p, "cpu"))
    assert list(back) == ["b", "w", "v"]
    for k in p:
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], p[k])


def test_fm_checkpoint_bytes_equal_reference(tmp_path):
    """FMParams go through the port's checkpoint under the reference's
    key spellings and order (``.b``, ``.w``, ``.v``), byte for byte."""
    from dmlc_core_tpu.utils.checkpoint import save_checkpoint as ref_save
    from dmlc_core_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                                      save_checkpoint)
    p = start_params()
    ref_save(str(tmp_path / "ref.ckpt"), ref_params(p), step=3,
             extra={"k": "v"})
    params = fm_params_from_numpy(p, "cpu")
    save_checkpoint(str(tmp_path / "port.ckpt"), params, step=3,
                    extra={"k": "v"})
    assert (tmp_path / "port.ckpt").read_bytes() == \
        (tmp_path / "ref.ckpt").read_bytes()
    back, step, _ = restore_checkpoint(str(tmp_path / "ref.ckpt"),
                                       like=params)
    assert step == 3 and isinstance(back, FMParams)
    for a, b in zip(back, params):
        assert torch.equal(a, b)
    flat, _, _ = restore_checkpoint(str(tmp_path / "port.ckpt"))
    assert list(flat) == [".b", ".w", ".v"]


# -- the reference's own cases (tests/test_fm.py) ----------------------------
def fm_margin_oracle(b, w, V, X):
    s1 = X @ V
    s2 = (X * X) @ (V * V)
    return b + X @ w + 0.5 * ((s1 * s1).sum(-1) - s2.sum(-1))


def write_interaction_libsvm(path, rows=1024, seed=3):
    """y = 1 iff x0*x1 > 0: pure interaction, no linear signal."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, size=(rows, 4)).astype(np.float32)
    y = (X[:, 0] * X[:, 1] > 0).astype(int)
    with open(path, "w") as f:
        for i in range(rows):
            feats = " ".join(f"{j}:{X[i, j]:.5f}" for j in range(4))
            f.write(f"{y[i]} {feats}\n")
    return X, y


def test_fm_margin_matches_oracle_csr_and_dense(tmp_path):
    rng = np.random.default_rng(0)
    X, _ = write_interaction_libsvm(tmp_path / "m.libsvm", rows=256)
    learner = FMLearner(num_features=4, k=3, device="cpu")
    params = learner.init(seed=1)
    w = rng.normal(size=4).astype(np.float32)
    params = params._replace(w=torch.from_numpy(w))
    want = fm_margin_oracle(float(params.b), w, params.v.numpy(), X)
    for layout in ("csr", "dense"):
        with DeviceRowBlockIter(str(tmp_path / "m.libsvm"), batch_rows=256,
                                layout=layout, min_nnz_bucket=2048,
                                dense_dtype="float32", device="cpu") as it:
            batch = next(iter(it))
            got = learner.predict(params, batch).numpy().reshape(-1)
        np.testing.assert_allclose(got[:256], want, rtol=2e-5, atol=2e-5)


def test_fm_learns_interaction_linear_cannot(tmp_path):
    write_interaction_libsvm(tmp_path / "i.libsvm", rows=2048)
    uri = str(tmp_path / "i.libsvm")

    def train(learner, epochs=12):
        params = learner.init()
        losses = []
        with DeviceRowBlockIter(uri, batch_rows=512, layout="dense",
                                dense_dtype="float32", device="cpu") as it:
            for _ in range(epochs):
                for batch in it:
                    params, loss = learner.step(params, batch)
                    losses.append(float(loss))
                it.before_first()
        return losses

    fm_losses = train(FMLearner(num_features=4, k=4, learning_rate=0.5,
                                init_scale=0.3, device="cpu"))
    lin_losses = train(LinearLearner(num_features=4, learning_rate=0.5,
                                     device="cpu"))
    # the FM beats chance (log 2 = 0.693) decisively; the linear model
    # cannot express x0*x1
    assert fm_losses[-1] < 0.55, fm_losses[-1]
    assert lin_losses[-1] > 0.6, lin_losses[-1]
    assert fm_losses[-1] < lin_losses[-1] - 0.05


def test_fm_rejects_bad_rank():
    with pytest.raises(ValueError, match="k must be positive"):
        FMLearner(num_features=4, k=0, device="cpu")


def test_fm_refuses_a_mesh():
    from dmlc_core_tpu_torch.base import DMLCError
    with pytest.raises(DMLCError, match="multi-device"):
        FMLearner(4, mesh=object(), device="cpu")


# -- the FM kernel's plain version (ops/hopper_kernels.py) -------------------
# fm_csr_kernel takes fm_csr_reference for CPU tensors; on the card the
# kernel pair of csrc/fm_csr.cu computes the same margins and gradients
# (tests/test_torch_cuda.py holds them against this version there).
def sorted_shard(rng, lengths, bucket, repeat=False):
    """A shard as every batcher lays it out: row r's lengths[r] nonzeros
    in row order, padding (row R, col 0, val 0) at the tail. ``repeat``:
    each row's first column appears twice in it."""
    R = len(lengths)
    col = [rng.integers(0, F, n) for n in lengths]
    if repeat:
        for c in col:
            if len(c) >= 2:
                c[1] = c[0]
    nnz = int(sum(lengths))
    row = np.full(bucket, R, np.int32)
    row[:nnz] = np.repeat(np.arange(R), lengths)
    cols = np.zeros(bucket, np.int32)
    cols[:nnz] = np.concatenate(col) if nnz else []
    val = np.zeros(bucket, np.float32)
    val[:nnz] = rng.normal(size=nnz)
    return row, cols, val


def ref_margin_and_grads(p, row, col, val, R, g):
    """The reference's margins and the gradients of sum(g * margin) in b,
    w and v (jax.grad)."""
    import jax

    def loss(rp):
        m = ref_margin_csr(rp, jnp.asarray(row), jnp.asarray(col),
                           jnp.asarray(val), R)
        return jnp.sum(jnp.asarray(g) * m), m

    grads, m = jax.grad(loss, has_aux=True)(ref_params(p))
    return [np.asarray(m)] + [np.asarray(getattr(grads, k))
                              for k in ("b", "w", "v")]


def port_margin_and_grads(fn, p, row, col, val, R, g):
    leaves = [torch.from_numpy(np.asarray(p[k])).requires_grad_(True)
              for k in ("b", "w", "v")]
    m = fn(*leaves, torch.from_numpy(row), torch.from_numpy(col),
           torch.from_numpy(val), R)
    grads = torch.autograd.grad((m * torch.from_numpy(g)).sum(), leaves)
    return [m.detach().numpy()] + [t.numpy() for t in grads]


def assert_matches_reference(row, col, val, R, seed, k=K):
    from dmlc_core_tpu_torch.ops import hopper_kernels as hk
    p = start_params(seed, k=k)
    g = np.random.default_rng(seed).normal(size=R).astype(np.float32)
    want = ref_margin_and_grads(p, row, col, val, R, g)
    for fn in (hk.fm_csr_reference, hk.fm_csr_kernel):
        got = port_margin_and_grads(fn, p, row, col, val, R, g)
        for name, a, b in zip(("margin", "b", "w", "v"), got, want):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6,
                                       err_msg=name)


@pytest.mark.parametrize("case", ["padding_tail", "empty_rows",
                                  "repeated_column", "all_padding",
                                  "no_padding", "out_of_order",
                                  "rank_96"])
def test_fm_kernel_plain_version_matches_reference(case):
    rng = np.random.default_rng(11)
    R = 48
    lengths = rng.integers(1, 9, R)
    bucket = 512
    if case == "empty_rows":
        lengths[::5] = 0
        lengths[20:30] = 0
    if case == "all_padding":
        lengths[:] = 0
    if case == "no_padding":
        bucket = int(lengths.sum())
    row, col, val = sorted_shard(rng, lengths, bucket,
                                 repeat=case == "repeated_column")
    if case == "repeated_column":
        assert any(len(set(col[row == r])) < (row == r).sum()
                   for r in range(R))
    if case == "out_of_order":  # rows and padding shuffled together
        order = rng.permutation(bucket)
        row, col, val = row[order], col[order], val[order]
        assert np.any(np.diff(row) < 0)
    assert_matches_reference(row, col, val, R, seed=len(case),
                             k=96 if case == "rank_96" else K)


def test_fm_kernel_plain_version_on_two_shard_batches(tmp_path):
    # a 2-shard batch's shards, each a sorted shard with its own padding
    from dmlc_core_tpu_torch.device.device_iter import CsrRecHostBatcher
    from dmlc_core_tpu_torch.io.convert import rows_to_csr_recordio
    text = write_libfm(tmp_path / "s.libfm", rows=300, fields=True)
    crec = str(tmp_path / "s.crec")
    rows_to_csr_recordio(text, crec, fmt="libfm")
    batcher = CsrRecHostBatcher(crec, batch_rows=128, num_shards=2,
                                min_nnz_bucket=256)
    shards = 0
    while (batch := batcher.next_batch()) is not None:
        R = batch.rows_per_shard
        for d in range(2):
            assert_matches_reference(batch.row[d].copy(), batch.col[d].copy(),
                                      batch.val[d].copy(), R, seed=d)
            shards += 1
    batcher.close()
    assert shards == 6  # 300 rows: 3 batches of 2 shards, the last short


def test_fm_kernel_wrapper_refuses_bad_inputs():
    from dmlc_core_tpu_torch.base import DMLCError
    from dmlc_core_tpu_torch.ops import hopper_kernels as hk
    b, w, v = torch.tensor(0.0), torch.zeros(F), torch.zeros((F, K))
    r = torch.zeros(6, dtype=torch.int32)
    x = torch.zeros(6)
    with pytest.raises(DMLCError, match="int32 row/col"):
        hk.fm_csr_kernel(b, w, v, r.long(), r, x, 2)
    with pytest.raises(DMLCError, match="float32 b/w/v/val"):
        hk.fm_csr_kernel(b, w, v.double(), r, r, x, 2)
    with pytest.raises(DMLCError, match="three 1-D arrays of one length"):
        hk.fm_csr_kernel(b, w, v, r, r[:5], x, 2)
    with pytest.raises(DMLCError, match="w \\[F\\], v \\[F, K\\]"):
        hk.fm_csr_kernel(b, w[:5], v, r, r, x, 2)
    with pytest.raises(DMLCError, match="contiguous"):
        hk.fm_csr_kernel(b, w, v, r.repeat(2)[::2], r, x, 2)
    with pytest.raises(DMLCError, match="contiguous"):
        hk.fm_csr_kernel(b, w, v.t().contiguous().t(), r, r, x, 2)
    with pytest.raises(DMLCError, match="at least 1 factor"):
        hk.fm_csr_kernel(b, w, torch.zeros((F, 0)), r, r, x, 2)
    meta = [t.to("meta") for t in (b, w, v, r, r, x)]
    with pytest.raises(DMLCError, match="one CUDA device"):
        hk.fm_csr_kernel(*meta, 2)


def test_fm_learner_counts_kernel_steps_only_on_the_card(tmp_path):
    # on the CPU the plain version runs: the counter does not move
    from dmlc_core_tpu_torch import telemetry
    before = telemetry.counter("fm_kernel_steps").value
    uri = write_libfm(tmp_path / "c.libsvm", rows=256)
    run_both(uri, "logistic", "csr", steps=2)
    assert telemetry.counter("fm_kernel_steps").value == before
