"""The port's DP × SP ``TransformerLM`` against the JAX package's.

One 4-rank gloo world of port workers (``tests/torch_lm_worker.py
transformer``, 120-s timeout) trains on a ("data", "seq") = 2 × 2 mesh:
the ring over "seq", one all-reduce over both axes a step. Held to the
JAX package's steps on its 2 × 2 and 1 × 1 meshes (the reference's
``test_matches_single_device_oracle``): losses at rtol 1e-5, every
updated parameter at rtol 5e-4, atol 1e-5, and the four ranks' replicas
bit-identical. ``init(seed)`` is the reference's bit for bit, and a 1 × 1
mesh needs no world.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

from dmlc_core_tpu.models.transformer import TransformerConfig as RefConfig
from dmlc_core_tpu.models.transformer import TransformerLM as RefLM
from tests.torch_world_worker import run_world

from dmlc_core_tpu_torch.device.sharding import (host_data_mesh,
                                                 process_mesh)
from dmlc_core_tpu_torch.models.transformer import (TransformerConfig,
                                                    TransformerLM, leaves)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_lm_worker.py")
CFG = dict(vocab=17, max_seq=8, embed=16, heads=2, layers=2)
LR, SEED, STEPS = 0.1, 7, 3


def mesh2d(data, seq):
    devs = np.array(jax.devices()[:data * seq]).reshape(data, seq)
    return Mesh(devs, ("data", "seq"))


def batches():
    rng = np.random.default_rng(3)
    toks = rng.integers(0, CFG["vocab"], size=(STEPS, 2, CFG["max_seq"] + 1))
    return toks[:, :, :-1].astype(np.int32), toks[:, :, 1:].astype(np.int32)


def ref_run(data, seq):
    model = RefLM(RefConfig(**CFG), mesh2d(data, seq), learning_rate=LR)
    params = model.init(seed=SEED)
    losses = []
    for x, y in zip(*batches()):
        params, loss = model.step(params, x, y)
        losses.append(float(loss))
    return losses, [np.asarray(p) for p in jax.tree.leaves(params)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("lm")
    x, y = batches()
    np.savez(d / "in.npz", cfg=np.array(CFG, dtype=object), lr=LR,
             seed=SEED, tokens=x, labels=y)
    run_world(lambda r: [sys.executable, WORKER, "transformer",
                         str(d / "in.npz"), str(d)], size=4, timeout=120)
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(4)]


def _params(out):
    return [out[f"p{i}"] for i in range(len([k for k in out
                                             if k.startswith("p")]))]


@pytest.mark.parametrize("ref_mesh", [(2, 2), (1, 1)])
def test_mesh_step_matches_reference(world, ref_mesh):
    want_losses, want_params = ref_run(*ref_mesh)
    got = _params(world[0])
    np.testing.assert_allclose(world[0]["losses"], want_losses, rtol=1e-5)
    assert len(got) == len(want_params)
    for a, b in zip(got, want_params):
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=1e-5)


def test_replicas_are_bit_identical(world):
    first = _params(world[0])
    for out in world[1:]:
        assert np.array_equal(out["losses"], world[0]["losses"])
        for a, b in zip(_params(out), first):
            assert np.array_equal(a, b)


def test_init_is_the_references_bit_for_bit():
    cfg = dict(CFG, layers=3, embed=32, heads=4)
    ref = RefLM(RefConfig(**cfg), mesh2d(1, 1)).init(seed=11)
    mesh = process_mesh((("data", 1), ("seq", 1)), device="cpu")
    got = TransformerLM(TransformerConfig(**cfg), mesh).init(seed=11)
    want = jax.tree.leaves(ref)
    assert len(leaves(got)) == len(want)
    for a, b in zip(leaves(got), want):
        assert a.dtype == torch.float32 and a.device.type == "cpu"
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_single_rank_needs_no_world_and_learns():
    """1 × 1 on the CPU (no torch.distributed world): the reference's
    loss trajectory, and a learnable periodic stream's loss halves."""
    assert not torch.distributed.is_initialized()
    mesh = process_mesh((("data", 1), ("seq", 1)), device="cpu")
    model = TransformerLM(TransformerConfig(**CFG), mesh, learning_rate=LR)
    params = model.init(seed=SEED)
    losses = []
    for x, y in zip(*batches()):
        params, loss = model.step(params, x, y)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, ref_run(1, 1)[0], rtol=1e-5)

    cfg = TransformerConfig(vocab=8, max_seq=16, embed=32, heads=2,
                            layers=1)
    model = TransformerLM(cfg, mesh, learning_rate=0.5)
    params = model.init(seed=1)
    period = np.tile(np.arange(8, dtype=np.int32), 5)
    toks = np.stack([period[i:i + 16] for i in range(4)])
    labels = np.stack([period[i + 1:i + 17] for i in range(4)])
    first = None
    for _ in range(30):
        params, loss = model.step(params, toks, labels)
        first = float(loss) if first is None else first
    assert float(loss) < first * 0.5, (first, float(loss))


def test_mesh_axes_and_shapes_are_checked():
    mesh = process_mesh((("data", 1), ("model", 1)), device="cpu")
    with pytest.raises(ValueError, match="seq"):
        TransformerLM(TransformerConfig(**CFG), mesh)
    with pytest.raises(Exception, match="does not divide"):
        process_mesh((("data", 2), ("seq", 1)), device="cpu")
    with pytest.raises(Exception, match="bad mesh axes"):
        process_mesh((("data", 1), ("data", 1)), device="cpu")
    # the host mesh: this process's one device, no group
    host = host_data_mesh(device="cpu")
    assert (host.names, host.shape, host.size("data"),
            host.group_of("data"), host.npart) == (("data",), (1,), 1,
                                                   None, 1)
    assert host.size("seq") == 1 and host.index("seq") == 0
