"""The port's GPipe schedule against the JAX package's
``parallel/pipeline_parallel.py`` and the sequential program.

One 4-rank gloo world of port workers (``tests/torch_lm_worker.py
pipeline``, 120-s timeout) runs the reference's ``test_pipeline_parallel``
cases: 4 stages × 4 microbatches forward, DP × PP on a ("data", "pipe") =
2 × 2 mesh, and the backward — each stage's gradient of the mean loss,
which must be the sequential program's, not P times it (the
``psum_bcast`` transpose). Values at the reference's rtol 1e-5,
atol 1e-5; gradients at its rtol 1e-4, atol 1e-5.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from dmlc_core_tpu.parallel.pipeline_parallel import pipeline_apply as ref_pp
from tests.torch_world_worker import run_world

from dmlc_core_tpu_torch.parallel.pipeline_parallel import pipeline_apply

try:
    from jax import shard_map
except ImportError:  # pre-0.5 jax spells it experimental
    from jax.experimental.shard_map import shard_map

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_lm_worker.py")


def stage_fn(w, x):
    return jnp.tanh(x @ w["a"]) @ w["b"] + x


def make_params(num_stages, D, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(0, 0.5, (num_stages, D, D)).astype(np.float32)
            for k in "ab"}


def sequential_apply(params, mb):
    out = []
    for m in range(mb.shape[0]):
        x = mb[m]
        for s in range(params["a"].shape[0]):
            x = stage_fn({"a": params["a"][s], "b": params["b"][s]}, x)
        out.append(x)
    return jnp.stack(out)


def _inputs():
    rng = np.random.default_rng(1)
    inp = {}
    for k, v in make_params(4, 16, 0).items():
        inp[f"fwd_{k}"] = v
    inp["fwd_mb"] = rng.normal(0, 1, (4, 8, 16)).astype(np.float32)
    for k, v in make_params(2, 8, 5).items():
        inp[f"dp_{k}"] = v
    inp["dp_mb"] = rng.normal(0, 1, (2, 3, 4, 8)).astype(np.float32)
    for k, v in make_params(4, 8, 2).items():
        inp[f"bwd_{k}"] = v
    inp["bwd_mb"] = rng.normal(0, 1, (4, 8, 8)).astype(np.float32)
    inp["bwd_target"] = rng.normal(0, 1, (4, 8, 8)).astype(np.float32)
    return inp


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipe")
    inp = _inputs()
    np.savez(d / "in.npz", **inp)
    run_world(lambda r: [sys.executable, WORKER, "pipeline",
                         str(d / "in.npz"), str(d)], size=4, timeout=120)
    return inp, [dict(np.load(d / f"rank{r}.npz")) for r in range(4)]


def _params(inp, prefix):
    return {k: jnp.asarray(inp[f"{prefix}_{k}"]) for k in "ab"}


def test_pipeline_matches_sequential_and_reference(world):
    inp, outs = world
    params, mb = _params(inp, "fwd"), jnp.asarray(inp["fwd_mb"])
    want = np.asarray(sequential_apply(params, mb))
    mesh = Mesh(np.array(jax.devices()[:4]), ("pipe",))
    ref = jax.jit(shard_map(
        lambda p, m: ref_pp(stage_fn, {k: v[0] for k, v in p.items()}, m),
        mesh=mesh, in_specs=({"a": P("pipe"), "b": P("pipe")}, P()),
        out_specs=P()))(params, mb)
    for out in outs:
        np.testing.assert_allclose(out["fwd"], want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out["fwd"], np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)


def test_pipeline_composes_with_data_axis(world):
    inp, outs = world
    params = _params(inp, "dp")
    for rank, out in enumerate(outs):
        d = rank // 2
        want = sequential_apply(params, jnp.asarray(inp["dp_mb"][d]))
        np.testing.assert_allclose(out["dp"], np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_pipeline_backward_gives_each_stage_the_sequential_gradient(world):
    inp, outs = world
    params = _params(inp, "bwd")
    mb, target = jnp.asarray(inp["bwd_mb"]), jnp.asarray(inp["bwd_target"])

    def seq_loss(p):
        return jnp.mean((sequential_apply(p, mb) - target) ** 2)

    loss, g = jax.value_and_grad(seq_loss)(params)
    for stage, out in enumerate(outs):
        np.testing.assert_allclose(out["bwd_loss"], float(loss), rtol=1e-5)
        for k in "ab":
            np.testing.assert_allclose(out[f"bwd_g{k}"],
                                       np.asarray(g[k][stage]), rtol=1e-4,
                                       atol=1e-5)


def test_one_stage_needs_no_world():
    rng = np.random.default_rng(4)
    w = {k: torch.from_numpy(rng.normal(0, 0.5, (8, 8)).astype(np.float32))
         for k in "ab"}
    mb = torch.from_numpy(rng.normal(0, 1, (3, 2, 8)).astype(np.float32))
    got = pipeline_apply(lambda p, x: torch.tanh(x @ p["a"]) @ p["b"] + x,
                         w, mb, None)
    want = sequential_apply({k: jnp.asarray(v.numpy()[None])
                             for k, v in w.items()}, jnp.asarray(mb.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
