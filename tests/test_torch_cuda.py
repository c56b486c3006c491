"""The port on a CUDA card, held against the port on the CPU.

Every test here needs a GPU and skips with its reason without one. The
file imports neither JAX nor the JAX package, so it runs where only torch
is installed; the CPU-side parity with the reference is pinned by the other
``test_torch_*.py`` files, so agreeing with the port's CPU run (plain
versions) ties the card to the reference. On the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX.)
"""

import numpy as np
import pytest
import torch

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
