"""The port on a CUDA card, held against the port on the CPU.

Every test here needs a GPU and skips with its reason without one. The
file imports neither JAX nor the JAX package, so it runs where only torch
is installed; the CPU-side parity with the reference is pinned by the other
``test_torch_*.py`` files, so agreeing with the port's CPU run (plain
versions) ties the card to the reference. On the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX.) The data-parallel
cases spawn worlds of ``tests/torch_world_worker.py``: one rank on NCCL,
and two ranks sharing the card over gloo (NCCL refuses two ranks on one
device).
"""

import json

import numpy as np
import pytest
import torch

# by module name, not as tests.torch_world_worker: pytest puts tests/ on
# sys.path, and a machine may have another top-level ``tests`` package
from torch_world_worker import run_world, worker_argv

from dmlc_core_tpu_torch.base import DMLCError
from dmlc_core_tpu_torch.device import device_iter as di
from dmlc_core_tpu_torch.models.linear import LinearLearner
from dmlc_core_tpu_torch.ops import hopper_kernels as hk

pytestmark = pytest.mark.cuda

TOL = dict(rtol=1e-6, atol=1e-6)
LANES = [("csr", "float32"), ("dense", "float32"), ("dense", "bf16")]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def random_csr(rng, R, F, nnz, pad=0):
    row = np.sort(rng.integers(0, R, nnz)).astype(np.int32)
    col = rng.integers(0, F, nnz).astype(np.int32)
    val = rng.normal(size=nnz).astype(np.float32)
    if pad:
        row = np.concatenate([row, np.full(pad, R, np.int32)])
        col = np.concatenate([col, np.zeros(pad, np.int32)])
        val = np.concatenate([val, np.full(pad, 3.0, np.float32)])
    return row, col, val


def write_libsvm(path, rows=700, features=9, seed=0):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(rows):
            keep = np.flatnonzero(rng.random(features) < 0.7)
            vals = rng.uniform(-2, 2, len(keep))
            feats = " ".join(f"{j}:{v:.5f}" for j, v in zip(keep, vals))
            f.write(f"{int(rng.random() < 0.5)} {feats}\n")
    return str(path)


@pytest.mark.parametrize("R,F,nnz,pad", [(8, 28, 100, 0), (64, 256, 4096, 9),
                                         (1024, 28, 28672, 0),
                                         (4096, 1024, 500, 3)])
def test_kernel_matches_plain_version(cuda_device, R, F, nnz, pad):
    rng = np.random.default_rng(R + nnz)
    row, col, val = random_csr(rng, R, F, nnz, pad=pad)
    host = [torch.from_numpy(a) for a in (row, col, val)]
    r, c, v = (t.to(cuda_device) for t in host)
    before = hk.csr_to_dense_kernel.launches
    got = hk.csr_to_dense_kernel(r, c, v, R, F)
    want = hk.csr_to_dense_reference(r, c, v, R, F)
    torch.cuda.synchronize()
    assert hk.csr_to_dense_kernel.launches == before + 1
    # a few duplicates per cell: atomics reorder those sums
    torch.testing.assert_close(got, want, **TOL)
    torch.testing.assert_close(got.cpu(),
                               hk.csr_to_dense_kernel(*host, R, F), **TOL)


def test_kernel_refuses_bad_inputs(cuda_device):
    r = torch.zeros(4, dtype=torch.int64, device=cuda_device)
    v = torch.zeros(4, dtype=torch.float32, device=cuda_device)
    with pytest.raises(DMLCError, match="int32/int32/float32"):
        hk.csr_to_dense_kernel(r, r, v, 2, 2)
    ri = r.int()
    with pytest.raises(DMLCError, match="one CUDA device"):
        hk.csr_to_dense_kernel(ri, ri.cpu(), v, 2, 2)
    with pytest.raises(DMLCError, match="contiguous"):
        hk.csr_to_dense_kernel(ri.repeat(2)[::2], ri, v, 2, 2)
    empty = hk.csr_to_dense_kernel(ri[:0], ri[:0], v[:0], 3, 2)
    assert empty.shape == (3, 2) and float(empty.abs().sum()) == 0.0


def padded(rng, lengths, F):
    """Rows in order with ``lengths[r]`` distinct columns each (ascending,
    as a libsvm line lists them), then padding (row == R, value 3.0) up to
    the next power of two."""
    R, nnz = len(lengths), int(sum(lengths))
    bucket = 1 << max(nnz - 1, 1).bit_length()
    row = np.full(bucket, R, np.int32)
    col = np.zeros(bucket, np.int32)
    val = np.full(bucket, 3.0, np.float32)
    row[:nnz] = np.repeat(np.arange(R, dtype=np.int32), lengths)
    col[:nnz] = np.concatenate(
        [np.sort(rng.choice(F, n, replace=False)) for n in lengths]
    ).astype(np.int32)
    val[:nnz] = rng.normal(size=nnz).astype(np.float32)
    return row, col, val


def run_kernel(row, col, val, R, F, device):
    """The kernel on the card and the plain version, on the same inputs."""
    r, c, v = (torch.from_numpy(a).to(device) for a in (row, col, val))
    return (hk.csr_to_dense_kernel(r, c, v, R, F),
            hk.csr_to_dense_reference(r, c, v, R, F))


@pytest.mark.parametrize("order", ["sorted", "unsorted"])
@pytest.mark.parametrize("R,F", [(1000, 28), (333, 27), (64, 200)])
def test_sorted_and_unsorted_match_plain_version(cuda_device, order, R, F):
    rng = np.random.default_rng(R + F)
    row, col, val = padded(rng, rng.integers(0, F + 1, R), F)
    if order == "unsorted":
        perm = rng.permutation(len(row))
        row, col, val = row[perm], col[perm], val[perm]
    got, want = run_kernel(row, col, val, R, F, cuda_device)
    # one add per cell onto zero: exact in any order
    assert torch.equal(got, want)


def test_empty_middle_rows(cuda_device):
    rng = np.random.default_rng(31)
    lengths = rng.integers(1, 29, 700)
    lengths[100:300] = 0  # a block of empty rows
    lengths[401::7] = 0   # single empty rows
    lengths[-70:] = 0     # and at the end, before the padding
    row, col, val = padded(rng, lengths, 28)
    got, want = run_kernel(row, col, val, 700, 28, cuda_device)
    assert torch.equal(got, want)
    assert float(got[100:300].abs().sum()) == 0.0


@pytest.mark.parametrize("R", [1, 3, 4, 65, 1027])
def test_width_27_rows_not_16_byte_multiples(cuda_device, R):
    rng = np.random.default_rng(R)
    row, col, val = padded(rng, np.full(R, 27), 27)
    got, want = run_kernel(row, col, val, R, 27, cuda_device)
    assert torch.equal(got, want)


def test_wide_rows(cuda_device):
    # hundreds of zero cells between nonzeros
    R, F = 70, 20000
    rng = np.random.default_rng(5)
    row, col, val = padded(rng, rng.integers(0, 40, R), F)
    got, want = run_kernel(row, col, val, R, F, cuda_device)
    assert torch.equal(got, want)


def test_output_is_zeroed_on_the_card(cuda_device):
    # the wrapper allocates with torch.empty: hand it a cached block full
    # of NaNs, and every cell no nonzero reaches must still come out 0
    R, F = 300, 28
    junk = torch.full((R, F), float("nan"), device=cuda_device)
    del junk
    rng = np.random.default_rng(9)
    row, col, val = padded(rng, rng.integers(0, 10, R), F)
    before = hk.csr_to_dense_kernel.launches
    got, want = run_kernel(row, col, val, R, F, cuda_device)
    assert torch.equal(got, want)
    assert hk.csr_to_dense_kernel.launches == before + 1
    # no nonzeros: the output is zeroed and no kernel is launched
    empty = torch.zeros(0, dtype=torch.int32, device=cuda_device)
    junk = torch.full((R, F), float("nan"), device=cuda_device)
    del junk
    out = hk.csr_to_dense_kernel(empty, empty, empty.float(), R, F)
    assert float(out.abs().sum()) == 0.0
    assert hk.csr_to_dense_kernel.launches == before + 1


def batches(path, layout, dtype, device, prefetch=2):
    with di.DeviceRowBlockIter(path, batch_rows=128, layout=layout,
                               dense_dtype=dtype, min_nnz_bucket=64,
                               prefetch=prefetch, device=device) as it:
        out = []
        for b in it:
            tree = b.tree()
            assert all(t.device.type == torch.device(device).type
                       for t in tree.values())
            out.append({k: t.cpu().clone() for k, t in tree.items()})
        return out


@pytest.mark.parametrize("layout,dtype", LANES)
@pytest.mark.parametrize("prefetch", [0, 2])
def test_cuda_batches_equal_cpu_batches(cuda_device, tmp_path, layout,
                                        dtype, prefetch):
    path = write_libsvm(tmp_path / "a.libsvm", seed=9)
    want = batches(path, layout, dtype, "cpu")
    got = batches(path, layout, dtype, "cuda", prefetch=prefetch)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        for k in w:
            assert torch.equal(g[k], w[k]), k


def test_staging_buffers_are_pinned(cuda_device, tmp_path):
    path = write_libsvm(tmp_path / "b.libsvm", seed=12)
    hb = di.NativeHostBatcher(path, batch_rows=128, layout="csr",
                              min_nnz_bucket=64, pin=True)
    b = hb.next_batch()
    hb.close()
    for v in b.tree().values():
        assert v.ctypes.data % 64 == 0
        assert torch.from_numpy(v).is_pinned()


def train(path, device, margin_path):
    learner = LinearLearner(6, learning_rate=0.5, margin_path=margin_path,
                            device=device)
    params = learner.init()
    losses = []
    with di.DeviceRowBlockIter(path, batch_rows=128, min_nnz_bucket=1024,
                               layout="csr", device=device) as it:
        for batch in it:
            params, loss = learner.step(params, batch)
            losses.append(float(loss))
    return losses, params.w.cpu().numpy(), float(params.b)


@pytest.mark.parametrize("margin_path", ["segment", "dense"])
def test_cuda_trajectory_matches_cpu(cuda_device, tmp_path, monkeypatch,
                                     margin_path):
    # the reference trajectory test's file and tolerances
    path = tmp_path / "m.libsvm"
    rng = np.random.default_rng(9)
    with open(path, "w") as f:
        for i in range(512):
            feats = " ".join(f"{j}:{rng.uniform(-1, 1):.4f}"
                             for j in range(6))
            f.write(f"{i % 2} {feats}\n")
    monkeypatch.setenv("DCT_CSR_TO_DENSE", "pallas")
    want = train(str(path), "cpu", margin_path)
    before = hk.csr_to_dense_kernel.launches
    got = train(str(path), "cuda", margin_path)
    launched = hk.csr_to_dense_kernel.launches - before
    assert launched == (4 if margin_path == "dense" else 0)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("prefetch", [0, 2])
def test_host_batches_on_cuda(cuda_device, tmp_path, monkeypatch, prefetch):
    """``to_device=False`` with the card as the device: unpinned numpy
    batches, nothing allocated on the card; a learner on the card steps on
    them through the kernel exactly as on the copied batches."""
    path = write_libsvm(tmp_path / "h.libsvm", seed=13)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    with di.DeviceRowBlockIter(path, batch_rows=128, layout="csr",
                               min_nnz_bucket=64, prefetch=prefetch,
                               to_device=False, device="cuda") as it:
        host = list(it)
    assert torch.cuda.memory_allocated() == mem0
    for b in host:
        for v in b.tree().values():
            assert isinstance(v, np.ndarray)
            assert not torch.from_numpy(v).is_pinned()
    want = batches(path, "csr", "float32", "cuda", prefetch=prefetch)
    assert len(host) == len(want)
    for h, w in zip(host, want):
        for k, v in h.tree().items():
            assert torch.equal(torch.from_numpy(v), w[k]), k
    monkeypatch.setenv("DCT_CSR_TO_DENSE", "pallas")
    learner = LinearLearner(9, margin_path="dense",
                            device="cuda")
    a = b = learner.init()
    before = hk.csr_to_dense_kernel.launches
    for h, w in zip(host, want):
        a, la = learner.step(a, h)
        b, lb = learner.step(b, di.PaddedBatch(
            total_rows=h.total_rows,
            **{k: v.to("cuda") for k, v in w.items()}))
        assert float(la) == float(lb)
    assert hk.csr_to_dense_kernel.launches - before == 2 * len(host)
    assert torch.equal(a.w, b.w) and a.w.device.type == "cuda"


@pytest.mark.parametrize("kind", ["linear", "fm"])
def test_scoring_model_on_cuda_matches_cpu(cuda_device, tmp_path, kind):
    """The serving forward with its parameters on the card equals the CPU
    run at rtol 1e-6: index_add_ sums a row's terms with atomics on the
    card, in an order that changes from run to run."""
    from dmlc_core_tpu_torch.serving.model import ScoringModel, save_model
    rng = np.random.default_rng(4)
    F, R = 300, 64
    # weights of a trained model's size: margins of order one, where the
    # f32 reordering error stays far below 1e-6 of the score
    params = {"w": rng.normal(scale=0.1, size=F).astype(np.float32),
              "b": np.asarray(0.1, np.float32)}
    if kind == "fm":
        params["v"] = rng.normal(scale=0.1, size=(F, 8)).astype(np.float32)
    uri = str(tmp_path / "m.ckpt")
    save_model(uri, kind, params, F)
    row, col, val = random_csr(rng, R, F + 5, 2000, pad=48)  # ids past F
    on_card = ScoringModel.load(uri)
    assert all(t.device.type == "cuda" for t in on_card.params)
    got = on_card.scores(row.astype(np.int64), col.astype(np.int64), val,
                         R)
    want = ScoringModel.load(uri, device="cpu").scores(row, col, val, R)
    assert got.shape == (R,) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def lane_uri(tmp_path, lane):
    """(uri, iterator kwargs) of one DeviceRowBlockIter lane over the
    seeded libsvm file."""
    from dmlc_core_tpu_torch.io import convert
    path = write_libsvm(tmp_path / "l.libsvm", seed=14)
    if lane == "crec":
        uri = str(tmp_path / "l.crec")
        convert.rows_to_csr_recordio(path, uri)
        return uri, {}
    if lane == "recd":
        uri = str(tmp_path / "l.drec")
        convert.rows_to_dense_recordio(path, uri)
        return uri, {"dense_dtype": "bf16"}
    if lane == "index64":
        return path, {"index64": True, "layout": "csr"}
    return path, {"layout": "csr", "csr_val_dtype": "bf16"}


@pytest.mark.parametrize("lane", ["bf16_values", "crec", "recd", "index64"])
def test_lane_batches_on_cuda_equal_cpu(cuda_device, tmp_path, lane):
    uri, kw = lane_uri(tmp_path, lane)
    out = {}
    for device in ("cpu", "cuda"):
        with di.DeviceRowBlockIter(uri, batch_rows=128, min_nnz_bucket=64,
                                   device=device, **kw) as it:
            out[device] = [{k: t.cpu().clone() for k, t in b.tree().items()}
                           for b in it]
    assert len(out["cuda"]) == len(out["cpu"]) == 6
    for g, w in zip(out["cuda"], out["cpu"]):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]), k
    if lane == "bf16_values":
        assert out["cuda"][0]["val"].dtype == torch.bfloat16


def steps_on(device, uri, learner, params, layout, n=3):
    """Losses and final parameters (numpy) of ``n`` steps on ``device``
    from ``params``."""
    params = type(params)(*(t.to(device) for t in params))
    losses = []
    with di.DeviceRowBlockIter(uri, batch_rows=128, layout=layout,
                               min_nnz_bucket=1024, device=device) as it:
        for batch, _ in zip(it, range(n)):
            params, loss = learner(device).step(params, batch)
            losses.append(float(loss))
    return losses, [t.cpu().numpy() for t in params]


@pytest.mark.parametrize("layout", ["csr", "dense"])
def test_fm_steps_on_cuda_match_cpu(cuda_device, tmp_path, layout):
    from dmlc_core_tpu_torch.models.fm import FMLearner
    path = write_libsvm(tmp_path / "f.libsvm", seed=15)
    init = FMLearner(9, k=4, init_scale=0.3, device="cpu").init(seed=2)

    def learner(device):
        return FMLearner(9, k=4, learning_rate=0.5, device=device)
    want = steps_on("cpu", path, learner, init, layout)
    got = steps_on("cuda", path, learner, init, layout)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    for g, w in zip(got[1], want[1]):  # b, w, v
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7)


def test_pairwise_steps_on_cuda_match_cpu(cuda_device, tmp_path):
    rng = np.random.default_rng(16)
    path = tmp_path / "r.libsvm"
    with open(path, "w") as f:
        for i in range(700):
            feats = " ".join(f"{j}:{rng.normal():.4f}" for j in range(9))
            f.write(f"{rng.integers(0, 5)} qid:{i // 30} {feats}\n")

    def learner(device):
        return LinearLearner(9, objective="pairwise", learning_rate=0.5,
                             device=device)
    init = learner("cpu").init()
    want = steps_on("cpu", str(path), learner, init, "dense")
    got = steps_on("cuda", str(path), learner, init, "dense")
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    for g, w in zip(got[1], want[1]):  # w, b
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7)


def dp_world(tmp_path, size, backend, case):
    """A ``dp`` world of ``size`` ranks on the card: (rank results)."""
    spec = tmp_path / f"spec_{backend}{size}.json"
    spec.write_text(json.dumps({"device": "cuda", "backend": backend,
                                "cases": [case]}))
    outs = [tmp_path / f"{backend}{size}_rank{r}.npz" for r in range(size)]
    run_world(lambda r: worker_argv("dp", spec, outs[r]), size=size,
              env={"DCT_CSR_TO_DENSE": "pallas"})
    res = []
    for o in outs:
        with np.load(o) as z:
            res.append({k: z[k] for k in z.files})
    return res


DP_CASE = dict(name="logistic", model="linear", objective="logistic",
               layout="csr", margin_path="dense", features=6, lr=0.5,
               batch_rows=128, bucket=1024)


def test_nccl_world_of_one_matches_no_mesh(cuda_device, tmp_path,
                                           monkeypatch):
    """One rank on NCCL steps as the learner without a mesh on the card
    (through the kernel, one launch a step); rtol 1e-5 (the dense margin
    adds once per cell, so the two are expected to agree bit for bit)."""
    path = write_libsvm(tmp_path / "n.libsvm", rows=512, features=6,
                        seed=4)
    (res,) = dp_world(tmp_path, 1, "nccl", dict(DP_CASE, files=[path]))
    monkeypatch.setenv("DCT_CSR_TO_DENSE", "pallas")
    learner = LinearLearner(6, learning_rate=0.5, margin_path="dense",
                            device="cuda")
    params, losses = learner.init(), []
    with di.DeviceRowBlockIter(path, batch_rows=128, min_nnz_bucket=1024,
                               layout="csr", prefetch=0,
                               device="cuda") as it:
        for batch in it:
            params, loss = learner.step(params, batch)
            losses.append(float(loss))
    assert len(losses) == 4 == int(res["logistic/kernel_launches"])
    assert int(res["logistic/all_reduce_calls"]) == 4
    np.testing.assert_allclose(res["logistic/losses"], losses, rtol=1e-5)
    np.testing.assert_allclose(res["logistic/param.w"],
                               params.w.cpu().numpy(), rtol=1e-5, atol=1e-7)


def test_gloo_world_shares_one_card(cuda_device, tmp_path, monkeypatch):
    """Two ranks on cuda:0 over gloo: bit-identical replicas, the kernel
    launched once a step on each rank, and the union of their batches
    stepped in one process on the card at rtol 1e-5."""
    rng = np.random.default_rng(8)
    shards = []
    for r in range(2):
        lines = []
        for _ in range(128):
            x = rng.uniform(-1, 1, 6)
            lines.append(f"{int(x[0] > 0)} " + " ".join(
                f"{j}:{x[j]:.4f}" for j in range(6)))
        shards.append(lines)
        (tmp_path / f"s{r}.libsvm").write_text("\n".join(lines) + "\n")
    files = [str(tmp_path / f"s{r}.libsvm") for r in range(2)]
    r0, r1 = dp_world(tmp_path, 2, "gloo", dict(DP_CASE, files=files))
    for k in r0:
        assert r0[k].tobytes() == r1[k].tobytes(), k
    assert int(r0["logistic/kernel_launches"]) == 2
    monkeypatch.setenv("DCT_CSR_TO_DENSE", "pallas")
    learner = LinearLearner(6, learning_rate=0.5, margin_path="dense",
                            device="cuda")
    params, losses = learner.init(), []
    for k in range(2):
        union = tmp_path / f"union{k}.libsvm"
        union.write_text("\n".join(shards[0][64 * k:64 * (k + 1)]
                                   + shards[1][64 * k:64 * (k + 1)]) + "\n")
        with di.DeviceRowBlockIter(str(union), batch_rows=128,
                                   min_nnz_bucket=1024, layout="csr",
                                   prefetch=0, device="cuda") as it:
            (batch,) = list(it)
            params, loss = learner.step(params, batch)
        losses.append(float(loss))
    np.testing.assert_allclose(r0["logistic/losses"], losses, rtol=1e-5)
    np.testing.assert_allclose(r0["logistic/param.w"],
                               params.w.cpu().numpy(), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("kind", ["lm", "tp"])
def test_lm_steps_on_cuda_match_cpu(cuda_device, kind):
    """The LM lane's models on a 1 x 1 mesh of the card against the same
    steps on the CPU: losses at rtol 1e-4, parameters at the reference's
    mesh tolerance (rtol 5e-4, atol 1e-5)."""
    from dmlc_core_tpu_torch.device.sharding import process_mesh
    from dmlc_core_tpu_torch.models.convert import lm_params_to_numpy
    from dmlc_core_tpu_torch.models.tp_transformer import (
        TPTransformerConfig, TPTransformerLM)
    from dmlc_core_tpu_torch.models.transformer import (TransformerConfig,
                                                        TransformerLM,
                                                        leaves)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 64, size=(3, 4, 129))

    def run(device):
        if kind == "lm":
            mesh = process_mesh((("data", 1), ("seq", 1)), device=device)
            model = TransformerLM(TransformerConfig(
                vocab=64, max_seq=128, embed=32, heads=4, layers=2), mesh,
                learning_rate=0.05)
        else:
            mesh = process_mesh((("data", 1), ("model", 1)), device=device)
            model = TPTransformerLM(TPTransformerConfig(
                vocab=64, max_seq=128, embed=32, heads=4, layers=2,
                moe_experts=4), mesh, learning_rate=0.05)
        params = model.init(seed=0)
        losses = []
        for t in toks:
            params, loss = model.step(params, t[:, :-1], t[:, 1:])
            losses.append(float(loss))
        assert next(iter(leaves(params))).device.type == mesh.device.type
        return losses, leaves(lm_params_to_numpy(params, model))

    (lc, pc), (lg, pg) = run("cpu"), run(cuda_device)
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    for a, b in zip(pg, pc):
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=1e-5)


def test_ring_attention_on_cuda_matches_dense(cuda_device):
    """An axis of one on the card: the contiguous and zigzag rings equal
    the dense oracle, values and input gradients (rtol 2e-4, atol
    2e-5)."""
    from dmlc_core_tpu_torch.ops.attention import mha_reference
    from dmlc_core_tpu_torch.parallel.ring import sequence_parallel_attention
    rng = np.random.default_rng(1)
    host = [torch.from_numpy(rng.normal(size=(2, 256, 4, 32)).astype(
        np.float32)) for _ in range(3)]
    w = torch.from_numpy(rng.normal(size=(2, 256, 4, 32)).astype(
        np.float32)).to(cuda_device)
    want = [t.to(cuda_device).requires_grad_() for t in host]
    (mha_reference(*want, causal=True) * w).sum().backward()
    for layout in ("contiguous", "zigzag"):
        got = [t.to(cuda_device).requires_grad_() for t in host]
        out = sequence_parallel_attention(*got, None, causal=True,
                                          layout=layout)
        (out * w).sum().backward()
        torch.testing.assert_close(
            out, mha_reference(*want, causal=True).detach(), rtol=2e-4,
            atol=2e-5)
        for a, b in zip(got, want):
            torch.testing.assert_close(a.grad, b.grad, rtol=2e-4,
                                       atol=2e-5)


def test_bench_kernel_probe_launches_and_checks_the_kernel(cuda_device):
    """The bench's kernel probe on the card: the kernel equals its plain
    version (rtol/atol 1e-5) before any timing, one warm and 5 timed
    launches, the library call beside it."""
    from dmlc_core_tpu_torch.bench.kernel_probe import kernel_probe
    before = hk.csr_to_dense_kernel.launches
    out = kernel_probe(cuda_device)
    assert out["launches"] == 6
    assert hk.csr_to_dense_kernel.launches == before + 7  # and the check
    assert out["max_abs_err"] <= 1e-5 and "check" in out
    assert (out["rows"], out["features"], out["nnz"]) == (1024, 28, 28672)
    assert 0 < out["kernel_ms"] <= out["kernel_ms_median"]
    assert 0 < out["library_ms"] <= out["library_ms_median"]
    assert out["speedup"] == pytest.approx(out["library_ms"]
                                           / out["kernel_ms"])
    assert out["bound_by"] == "bytes" and out["bound_ms"] < out["kernel_ms"]


def test_bench_ingest_share_divides_by_the_copy_probe(cuda_device, tmp_path,
                                                     monkeypatch):
    """The headline on the card: every row lands and is read on the card,
    and the bandwidth share is in (0, 1] with the pinned-copy probe, not
    the lane's own best epoch, setting its denominator (a probe that reads
    too low would hide behind the max()); the device lane counts every
    row, and its replay's copy probe sets its share's denominator too."""
    from dmlc_core_tpu_torch.bench import datasets, device_lane, ingest
    monkeypatch.setattr(datasets, "CACHE_DIR", str(tmp_path))
    rows = 40000
    path = datasets.ensure_dataset(rows)
    for fmt, lane_path in (("libsvm", path),
                           ("recd", datasets.ensure_drec_dataset(rows))):
        lane = ingest.run_lane(lane_path, rows, fmt, cuda_device,
                               batch_rows=8192, threads=0,
                               dense_dtype="bfloat16", reps=2)
        assert lane["rows_per_sec"] > 0, fmt
        assert 0 < lane["hbm_ingest_bw_util"] <= 1.0, (fmt, lane)
        assert 0 < lane["hbm_ingest_bw_util_best"] <= 1.0, (fmt, lane)
        best_epoch = (lane["device_bytes_per_sec"]
                      * lane["spread_rows_per_sec"][1] / lane["rows_per_sec"])
        assert lane["attainable_pytree_bytes_per_sec"] >= best_epoch, (
            fmt, lane)
    dl = device_lane.device_lane_probe(rows, cuda_device)
    assert dl["rows"] == rows and dl["backend"] == "cuda"
    assert 0 < dl["hbm_ingest_bw_util"] <= 1.0
    assert dl["zero_copy_batches_total"] == 0  # every batch is a copy
    # the best-epoch share divides by max(probe, best epoch)
    assert 0 < dl["hbm_ingest_bw_util_best"] < 1.0
