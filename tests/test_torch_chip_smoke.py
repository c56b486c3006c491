"""chip_smoke.py's kernel cases, bound and summary checks, on the CPU.

The script itself needs a CUDA card; what it holds the kernel to (the plain
version on its cases, the memory-traffic bound) is checked here, where the
port's wrapper takes the plain version for CPU tensors.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from dmlc_core_tpu_torch.ops import hopper_kernels as hk

NAMES = ("probe_1024x28", "train_65536x28", "duplicates_4096x28",
         "duplicates_9_per_cell_4096x28", "padding_out_of_range_1024x28",
         "heavy_duplicates_1024x28", "empty_64x28", "libsvm_uneven_8192x28",
         "f27_16384x27", "wide_1024x20000", "train_unsorted_65536x28")


@pytest.fixture(scope="module")
def cases():
    return {c[0]: c for c in cs.kernel_cases(np.random.default_rng(0))}


def test_case_names(cases):
    assert tuple(cases) == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_plain_version_on_smoke_case(cases, name):
    _, row, col, val, R, F, tol, _ = cases[name]
    r, c, v = (torch.from_numpy(a) for a in (row, col, val))
    got = hk.csr_to_dense_kernel(r, c, v, R, F)  # CPU: the plain version
    assert got.shape == (R, F) and got.dtype == torch.float32
    ok, _ = cs.check_against_f64(got, r, c, v, R, F)
    assert ok
    if tol == "exact":  # one add per cell: the f32 values themselves
        keep = (row >= 0) & (row < R) & (col >= 0) & (col < F)
        want = np.zeros((R, F), np.float32)
        want[row[keep], col[keep]] = val[keep]
        assert np.array_equal(got.numpy(), want)


def test_bound_at_training_shape(cases):
    _, row, col, _, R, F, _, _ = cases["train_65536x28"]
    ms, by = cs.bound_ms(torch.from_numpy(row), torch.from_numpy(col), R, F)
    # 4 B x 2,097,152 row ids + 8 B x 1,835,008 kept nonzeros + 4 B x
    # 1,835,008 cells, at 3.35 TB/s
    assert by == "bytes"
    assert ms == pytest.approx((4 * 2097152 + 12 * 1835008) / 3.35e12 * 1e3)
    # the permuted batch needs the same bytes
    _, row, col, _, R, F, _, _ = cases["train_unsorted_65536x28"]
    assert cs.bound_ms(torch.from_numpy(row), torch.from_numpy(col), R,
                       F)[0] == pytest.approx(ms)
