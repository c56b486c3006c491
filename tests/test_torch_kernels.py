"""The port's csr_to_dense against the reference's Pallas kernel.

Every case of test_pallas_kernels.py, pointed at the port: the same numpy
inputs go through ``csr_to_dense_pallas`` (interpret mode on the CPU, as
the reference's own tests run it) or the reference ``csr_to_dense``, and
through the port's ``csr_to_dense(impl="pallas")`` on CPU tensors, which
takes the kernel's plain version there. Tolerance 1e-6 (rtol and atol):
both sides accumulate in f32, in different orders. The kernel itself is
held against its plain version on a card by test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dmlc_core_tpu.ops.pallas_kernels import csr_to_dense_pallas
from dmlc_core_tpu.ops.sparse import csr_to_dense as ref_csr_to_dense

from dmlc_core_tpu_torch.base import DMLCError
from dmlc_core_tpu_torch.ops import hopper_kernels as hk
from dmlc_core_tpu_torch.ops.sparse import csr_to_dense

TOL = dict(rtol=1e-6, atol=1e-6)


def random_csr(rng, R, F, nnz, pad=0):
    row = np.sort(rng.integers(0, R, nnz)).astype(np.int32)
    col = rng.integers(0, F, nnz).astype(np.int32)
    val = rng.normal(size=nnz).astype(np.float32)
    if pad:
        row = np.concatenate([row, np.full(pad, R, np.int32)])
        col = np.concatenate([col, np.zeros(pad, np.int32)])
        val = np.concatenate([val, np.zeros(pad, np.float32)])
    return row, col, val


def jx(*arrs):
    return [jnp.asarray(a) for a in arrs]


def th(*arrs):
    return [torch.from_numpy(a) for a in arrs]


def port(row, col, val, R, F):
    return csr_to_dense(*th(row, col, val), R, F, impl="pallas").numpy()


@pytest.mark.parametrize("R,F,nnz", [(8, 28, 100), (17, 130, 999),
                                     (3, 5, 1), (64, 256, 4096)])
def test_matches_reference_kernel(R, F, nnz):
    rng = np.random.default_rng(R * F + nnz)
    row, col, val = random_csr(rng, R, F, nnz)
    want = np.asarray(csr_to_dense_pallas(*jx(row, col, val), R, F,
                                          chunk=128))
    np.testing.assert_allclose(port(row, col, val, R, F), want, **TOL)
    np.testing.assert_allclose(
        port(row, col, val, R, F),
        np.asarray(ref_csr_to_dense(*jx(row, col, val), R, F)), **TOL)


def test_padding_rows_dropped():
    rng = np.random.default_rng(0)
    row, col, val = random_csr(rng, 8, 16, 50, pad=30)
    val[-30:] = 5.0  # padding rows must drop even with non-zero values
    want = np.asarray(csr_to_dense_pallas(*jx(row, col, val), 8, 16,
                                          chunk=64))
    np.testing.assert_allclose(port(row, col, val, 8, 16), want, **TOL)


def test_duplicate_coordinates_sum():
    row = np.array([0, 0, 0], np.int32)
    col = np.array([2, 2, 2], np.int32)
    val = np.array([1.0, 2.0, 3.5], np.float32)
    got = port(row, col, val, 2, 4)
    ref = np.asarray(csr_to_dense_pallas(*jx(row, col, val), 2, 4))
    assert got[0, 2] == pytest.approx(6.5)
    assert np.abs(got).sum() == pytest.approx(6.5)
    np.testing.assert_allclose(got, ref, **TOL)


def test_empty_matrix():
    row = col = np.zeros(0, np.int32)
    val = np.zeros(0, np.float32)
    got = port(row, col, val, 4, 8)
    ref = np.asarray(csr_to_dense_pallas(*jx(row, col, val), 4, 8))
    assert got.shape == ref.shape == (4, 8)
    assert np.abs(got).sum() == 0.0


def test_csr_to_dense_impl_switch(monkeypatch):
    rng = np.random.default_rng(4)
    row, col, val = random_csr(rng, 16, 24, 200)
    want = np.asarray(ref_csr_to_dense(*jx(row, col, val), 16, 24))
    r, c, v = th(row, col, val)
    np.testing.assert_allclose(csr_to_dense(r, c, v, 16, 24).numpy(), want,
                               **TOL)
    np.testing.assert_allclose(
        csr_to_dense(r, c, v, 16, 24, impl="xla").numpy(), want, **TOL)
    np.testing.assert_allclose(
        csr_to_dense(r, c, v, 16, 24, impl="pallas").numpy(), want, **TOL)
    # one environment variable switches both packages onto the kernel
    monkeypatch.setenv("DCT_CSR_TO_DENSE", "pallas")
    calls = []
    real = hk.csr_to_dense_kernel
    monkeypatch.setattr(hk, "csr_to_dense_kernel",
                        lambda *a: calls.append(1) or real(*a))
    np.testing.assert_allclose(csr_to_dense(r, c, v, 16, 24).numpy(), want,
                               **TOL)
    np.testing.assert_allclose(
        np.asarray(ref_csr_to_dense(*jx(row, col, val), 16, 24)), want,
        **TOL)
    assert calls == [1]
    monkeypatch.setenv("DCT_CSR_TO_DENSE", "bogus")
    with pytest.raises(ValueError, match="csr_to_dense impl"):
        csr_to_dense(r, c, v, 16, 24)
    with pytest.raises(ValueError, match="csr_to_dense impl"):
        ref_csr_to_dense(*jx(row, col, val), 16, 24)
    # both impls drop ids past the end as the reference's two do, and
    # negative ids as its kernel does (its XLA scatter wraps those)
    monkeypatch.delenv("DCT_CSR_TO_DENSE")
    col[::5] = 24 + rng.integers(0, 40, len(col[::5]))
    row[2::9] = 17 + rng.integers(0, 40, len(row[2::9]))
    past_end = np.asarray(ref_csr_to_dense(*jx(row, col, val), 16, 24,
                                           impl="xla"))
    for impl in ("xla", "pallas"):
        np.testing.assert_allclose(
            csr_to_dense(*th(row, col, val), 16, 24, impl=impl).numpy(),
            past_end, **TOL)
    col[1::7] = -rng.integers(1, 24, len(col[1::7]))
    row[4::11] = -rng.integers(1, 16, len(row[4::11]))
    negative = np.asarray(csr_to_dense_pallas(*jx(row, col, val), 16, 24,
                                              chunk=128))
    keep = (row >= 0) & (col >= 0)
    np.testing.assert_allclose(
        negative, np.asarray(ref_csr_to_dense(
            *jx(row[keep], col[keep], val[keep]), 16, 24, impl="xla")),
        **TOL)
    for impl in ("xla", "pallas"):
        np.testing.assert_allclose(
            csr_to_dense(*th(row, col, val), 16, 24, impl=impl).numpy(),
            negative, **TOL)


def test_kernel_path_refuses_non_f32_values():
    rng = np.random.default_rng(5)
    row, col, val = random_csr(rng, 4, 6, 10)
    r, c, v = th(row, col, val)
    with pytest.raises(ValueError, match="float32 values only"):
        csr_to_dense(r, c, v.double(), 4, 6, impl="pallas")
    with pytest.raises(ValueError, match="float32 values only"):
        ref_csr_to_dense(*jx(row, col), jnp.asarray(val, jnp.int32), 4, 6,
                         impl="pallas")
    # the plain scatter keeps the value dtype, as the reference's does
    assert csr_to_dense(r, c, v.double(), 4, 6,
                        impl="xla").dtype == torch.float64


def test_out_of_range_ids_dropped():
    rng = np.random.default_rng(8)
    R, F = 16, 20
    row, col, val = random_csr(rng, R, F, 300)
    col[::7] = F + rng.integers(0, 200, len(col[::7]))  # past the lane pad
    col[3::11] = -rng.integers(1, 5, len(col[3::11]))
    row[5::13] = R + rng.integers(0, 50, len(row[5::13]))
    want = np.asarray(csr_to_dense_pallas(*jx(row, col, val), R, F,
                                          chunk=128))
    np.testing.assert_allclose(port(row, col, val, R, F), want, **TOL)


def test_oversized_output_has_no_guard_in_port(monkeypatch):
    # the reference's 12 MB VMEM guard sends this to the XLA scatter; the
    # port has no guard: the wrapper takes the same route at any size
    rng = np.random.default_rng(6)
    R, F = 4096, 1024
    row, col, val = random_csr(rng, R, F, 500)
    want = np.asarray(csr_to_dense_pallas(*jx(row, col, val), R, F))
    seen = []
    real = hk.csr_to_dense_reference
    monkeypatch.setattr(hk, "csr_to_dense_reference",
                        lambda *a: seen.append(a[3:]) or real(*a))
    np.testing.assert_allclose(port(row, col, val, R, F), want, **TOL)
    assert seen == [(R, F)]


def test_bench_probe_shape_matches():
    R, F = 1024, 28  # bench.py pallas_format_probe
    rng = np.random.default_rng(2)
    row, col, val = random_csr(rng, R, F, R * F)
    want = np.asarray(ref_csr_to_dense(*jx(row, col, val), R, F))
    np.testing.assert_allclose(port(row, col, val, R, F), want, **TOL)


def test_wrapper_raises_off_cpu_and_cuda():
    # a tensor that is neither on the CPU nor on a CUDA device: the wrapper
    # launches or raises, never falls back
    row = torch.zeros(4, dtype=torch.int32, device="meta")
    val = torch.zeros(4, dtype=torch.float32, device="meta")
    with pytest.raises(DMLCError, match="CUDA device"):
        hk.csr_to_dense_kernel(row, row, val, 2, 2)


def test_plain_version_keeps_launch_count():
    hk.reset_launch_counts()
    rng = np.random.default_rng(3)
    row, col, val = random_csr(rng, 8, 8, 40)
    hk.csr_to_dense_kernel(*th(row, col, val), 8, 8)
    assert hk.csr_to_dense_kernel.launches == 0
    assert set(hk.KERNELS) == {"csr_to_dense"}


def test_kernel_source_is_cuda_for_hopper():
    from dmlc_core_tpu_torch.base import BUILD_DIR
    src = open(hk.CSR_TO_DENSE_SOURCE).read()
    assert "__global__" in src and "atomicAdd" in src
    assert "_csr_scatter_kernel" in src  # names the TPU kernel it replaces
    # the column id and value are loaded beside the row id, not after it,
    # as streaming loads; the C function zeroes the output itself
    assert "__ldcs(col + i)" in src and "__ldcs(val + i)" in src
    assert "cudaMemsetAsync" in src
    assert "arch=compute_90a,code=sm_90a" in hk.NVCC_ARCH
    assert hk.CSR_TO_DENSE_LIB.startswith(BUILD_DIR)


# -- the segment ops of ops/sparse.py ----------------------------------------
def _segment_inputs(seed):
    rng = np.random.default_rng(seed)
    R, F, K, NF = 12, 10, 3, 4
    row, col, val = random_csr(rng, R, F, 90, pad=6)
    field = rng.integers(0, NF, len(row)).astype(np.int32)
    field[-6:] = 0
    w = rng.normal(size=F).astype(np.float32)
    W = rng.normal(size=(F, K)).astype(np.float32)
    Wf = rng.normal(size=(NF, F)).astype(np.float32)
    return R, row, col, val, field, w, W, Wf


@pytest.mark.parametrize("op", ["csr_matvec", "row_sdot", "csr_matmul_dense",
                                "field_aware_matvec"])
def test_segment_ops_and_grads_match_reference(op):
    # outputs and the gradient with respect to the weights, on random CSR
    # with padding and duplicates; the summation order differs
    import jax
    from dmlc_core_tpu.ops import sparse as ref_sparse
    from dmlc_core_tpu_torch.ops import sparse as port_sparse
    R, row, col, val, field, w, W, Wf = _segment_inputs(17)
    weights = {"csr_matvec": w, "row_sdot": w, "csr_matmul_dense": W,
               "field_aware_matvec": Wf}[op]
    cot = np.random.default_rng(1).normal(
        size=(R,) + weights.shape[1:2] * (op == "csr_matmul_dense")
    ).astype(np.float32)

    def call(mod, asarr, p):
        args = [asarr(row), asarr(col)]
        if op == "field_aware_matvec":
            args.append(asarr(field))
        return getattr(mod, op)(*args, asarr(val), p, R)

    def ref_obj(p):
        return jnp.sum(call(ref_sparse, jnp.asarray, p) * cot)

    want_y = call(ref_sparse, jnp.asarray, jnp.asarray(weights))
    want_g = jax.grad(ref_obj)(jnp.asarray(weights))
    p = torch.from_numpy(weights.copy()).requires_grad_(True)
    y = call(port_sparse, torch.from_numpy, p)
    (y * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_g),
                               rtol=1e-5, atol=1e-6)
