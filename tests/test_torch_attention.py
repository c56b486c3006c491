"""The port's ``ops/attention.py`` against the JAX package's: the dense
oracle and the blockwise (online-softmax) variant, values and input
gradients, at the reference's rtol 2e-4, atol 2e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dmlc_core_tpu.ops.attention import blockwise_attention as ref_blockwise
from dmlc_core_tpu.ops.attention import mha_reference as ref_mha

from dmlc_core_tpu_torch.ops.attention import (blockwise_attention,
                                               mha_reference)

TOL = dict(rtol=2e-4, atol=2e-5)


def _qkv(seed, L, S, B=2, H=2, D=8):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, L, H, D)).astype(np.float32),
            rng.normal(size=(B, S, H, D)).astype(np.float32),
            rng.normal(size=(B, S, H, D)).astype(np.float32))


def _grads(fn, q, k, v, w):
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = fn(tq, tk, tv)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in (tq, tk, tv)]


@pytest.mark.parametrize("causal", [False, True])
def test_mha_reference_matches(causal):
    q, k, v = _qkv(7 + int(causal), 24, 24)
    w = np.random.default_rng(1).normal(size=q.shape).astype(np.float32)
    got, grads = _grads(lambda *a: mha_reference(*a, causal=causal),
                        q, k, v, w)
    want = ref_mha(q, k, v, causal=causal)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    want_g = jax.grad(lambda *a: (ref_mha(*a, causal=causal) * w).sum(),
                      (0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v))
    for a, b in zip(grads, want_g):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_blockwise_matches_reference(causal):
    # S = 70 is no multiple of the block: the padded keys are masked
    L, S = (24, 24) if causal else (24, 70)
    q, k, v = _qkv(7 + int(causal), L, S)
    w = np.random.default_rng(2).normal(size=q.shape).astype(np.float32)
    got, grads = _grads(lambda *a: blockwise_attention(
        *a, block_size=16, causal=causal), q, k, v, w)
    np.testing.assert_allclose(got, np.asarray(ref_blockwise(
        q, k, v, block_size=16, causal=causal)), **TOL)
    np.testing.assert_allclose(got, mha_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal).numpy(),
        **TOL)
    want_g = jax.grad(lambda *a: (ref_mha(*a, causal=causal) * w).sum(),
                      (0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v))
    for a, b in zip(grads, want_g):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


def test_output_keeps_the_query_dtype():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(3, 16, 16))
    for out in (mha_reference(q, k, v, causal=True),
                blockwise_attention(q, k, v, block_size=8, causal=True)):
        assert out.dtype == torch.bfloat16
        want = ref_mha(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                         for t in (q, k, v)), causal=True)
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=1e-2, atol=1e-2)
