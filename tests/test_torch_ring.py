"""The port's ring collectives, ring attention and axis collectives
against the JAX package's ``parallel/ring.py`` and ``ops/attention.py``.

One 4-rank gloo world of port workers (``tests/torch_lm_worker.py ring``,
real processes, 120-s timeout) runs every case once, on an axis of 2
ranks (ranks {0, 1} and {2, 3}) and on one of 4; the JAX side runs here
on the virtual CPU mesh. Held, as in the reference's ``test_ring.py``:

- ``sequence_parallel_attention`` against JAX's dense ``mha_reference``
  (and JAX's own ring on its mesh), causal and not, and zigzag, at rtol
  2e-4, atol 2e-5 — and its input GRADIENTS against ``jax.grad`` of the
  dense oracle at the same tolerance: the ring's backward through
  ``ppermute`` and the shard/gather transposes;
- ``ring_allreduce`` against the sum (rtol 1e-5, atol 1e-6);
- each hand-written transpose on its own: ``ppermute``'s gradient is the
  inverse permutation, ``psum``'s sums the ranks' cotangents,
  ``psum_bcast``'s is the identity (NOT P times it), ``copy_to_group``'s
  sums, each exact.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from dmlc_core_tpu.ops.attention import mha_reference as jax_mha
from dmlc_core_tpu.parallel.ring import sequence_parallel_attention as jspa
from dmlc_core_tpu.parallel.ring import zigzag_permutation as jzz
from tests.torch_world_worker import run_world

from dmlc_core_tpu_torch.parallel.ring import zigzag_permutation

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_lm_worker.py")
B, S, H, D = 2, 32, 2, 8
TOL = dict(rtol=2e-4, atol=2e-5)
CASES = ("dense", "causal", "zigzag")


def _inputs():
    rng = np.random.default_rng(11)
    inp = {}
    for p in (2, 4):
        inp[f"x{p}"] = rng.normal(size=(p, 5, 3)).astype(np.float32)
        inp[f"w{p}"] = rng.normal(size=(p, 5, 3)).astype(np.float32)
        inp[f"big{p}"] = rng.normal(size=(p, 7, 13)).astype(np.float32)
        for name in CASES:
            for c in "qkvw":
                inp[f"{name}{p}_{c}"] = rng.normal(
                    size=(B, S, H, D)).astype(np.float32)
    return inp


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("ring")
    inp = _inputs()
    np.savez(d / "in.npz", **inp)
    run_world(lambda r: [sys.executable, WORKER, "ring", str(d / "in.npz"),
                         str(d)], size=4, timeout=120)
    return inp, [dict(np.load(d / f"rank{r}.npz")) for r in range(4)]


def _ranks(p):
    """The ranks of each p-rank axis, and each one's position on it."""
    return [(r, r % p) for r in range(4)]


def _dense_and_grads(inp, name, p):
    q, k, v, w = (jnp.asarray(inp[f"{name}{p}_{c}"]) for c in "qkvw")
    causal = name != "dense"

    def loss(q, k, v):
        return (jax_mha(q, k, v, causal=causal) * w).sum()

    return jax_mha(q, k, v, causal=causal), jax.grad(loss, (0, 1, 2))(
        q, k, v)


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("name", CASES)
def test_sequence_parallel_attention_matches_dense(world, name, p):
    inp, outs = world
    want, grads = _dense_and_grads(inp, name, p)
    for r, _ in _ranks(p):
        np.testing.assert_allclose(outs[r][f"{name}{p}_o"],
                                   np.asarray(want), **TOL)
        for c, g in zip("qkv", grads):
            np.testing.assert_allclose(outs[r][f"{name}{p}_d{c}"],
                                       np.asarray(g), **TOL)


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("name", CASES)
def test_ring_matches_the_references_ring(world, name, p):
    inp, outs = world
    mesh = Mesh(np.array(jax.devices()[:p]), ("seq",))
    q, k, v = (jnp.asarray(inp[f"{name}{p}_{c}"]) for c in "qkv")
    got = jspa(q, k, v, mesh, causal=name != "dense",
               layout="zigzag" if name == "zigzag" else "contiguous")
    np.testing.assert_allclose(outs[0][f"{name}{p}_o"], np.asarray(got),
                               **TOL)


@pytest.mark.parametrize("p", [2, 4])
def test_ring_allreduce_matches_sum(world, p):
    inp, outs = world
    want = inp[f"big{p}"].sum(axis=0)
    for r, _ in _ranks(p):
        np.testing.assert_allclose(outs[r][f"allreduce{p}"], want,
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("p", [2, 4])
def test_ppermute_value_and_inverse_transpose(world, p):
    inp, outs = world
    x, w = inp[f"x{p}"], inp[f"w{p}"]
    for r, i in _ranks(p):
        # forward: rank i holds rank i-1's value
        np.testing.assert_array_equal(outs[r][f"ppermute_y{p}"],
                                      x[(i - 1) % p])
        # backward: rank i's input fed rank i+1's weighted loss
        np.testing.assert_array_equal(outs[r][f"ppermute_g{p}"],
                                      w[(i + 1) % p])


@pytest.mark.parametrize("p", [2, 4])
def test_psum_transposes(world, p):
    inp, outs = world
    x, w = inp[f"x{p}"], inp[f"w{p}"]
    for r, _ in _ranks(p):
        np.testing.assert_allclose(outs[r][f"psum_y{p}"], x.sum(0),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(outs[r][f"psum_bcast_y{p}"], x.sum(0),
                                   rtol=1e-6, atol=1e-6)
        # psum: each rank's cotangent is its own, the transpose sums them
        np.testing.assert_allclose(outs[r][f"psum_g{p}"], w.sum(0),
                                   rtol=1e-6, atol=1e-6)
        # psum_bcast of a replicated loss: the identity, not p times it
        np.testing.assert_array_equal(outs[r][f"psum_bcast_g{p}"], w[0])
        # copy_to_group: the ranks' partial cotangents summed
        np.testing.assert_allclose(outs[r][f"copy_g{p}"], w.sum(0),
                                   rtol=1e-6, atol=1e-6)


def test_zigzag_permutation_is_the_references():
    for s, p in ((32, 4), (32, 2), (64, 8)):
        assert zigzag_permutation(s, p).tolist() == \
            np.asarray(jzz(s, p)).tolist()
    with pytest.raises(ValueError, match="2\\*P"):
        zigzag_permutation(30, 4)


def test_single_rank_axis_is_the_dense_oracle():
    """An axis of one (group None) needs no world: the ring is the dense
    attention, zigzag included."""
    from dmlc_core_tpu_torch.ops.attention import mha_reference
    from dmlc_core_tpu_torch.parallel.ring import (
        ring_allreduce, sequence_parallel_attention)
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 8, 1, 4)).astype(
        np.float32)) for _ in range(3))
    for layout in ("contiguous", "zigzag"):
        got = sequence_parallel_attention(q, k, v, None, causal=True,
                                          layout=layout)
        torch.testing.assert_close(got, mha_reference(q, k, v, causal=True),
                                   rtol=2e-4, atol=2e-5)
    with pytest.raises(ValueError, match="CAUSAL"):
        sequence_parallel_attention(q, k, v, None, layout="zigzag")
    assert ring_allreduce(q, None) is q
