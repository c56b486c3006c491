"""The port's DP × TP (+ MoE) ``TPTransformerLM`` against the JAX
package's GSPMD-partitioned one.

One 4-rank gloo world of port workers (``tests/torch_lm_worker.py tp``,
120-s timeout) trains a dense and a top-1 MoE model on a ("data",
"model") = 2 × 2 mesh: Megatron column/row splits with the hand-written
``copy_to_group`` / ``psum_bcast``, two experts a rank. Held to the JAX
package on its 2 × 2 and 1 × 1 meshes at the reference's
``test_tp_transformer.py`` tolerance (losses rtol 2e-5, atol 2e-5), the
gathered parameters at rtol 5e-4, atol 1e-5, the replicated parameters
bit-identical on every rank, and each rank's ``qkv`` shard holding the
q, k and v columns of ITS heads — not the reference's contiguous column
block, which at this shape straddles heads.
"""

import os
import sys

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from dmlc_core_tpu.models.tp_transformer import (TPTransformerConfig as
                                                 RefConfig)
from dmlc_core_tpu.models.tp_transformer import TPTransformerLM as RefLM
from tests.torch_world_worker import run_world

from dmlc_core_tpu_torch.device.sharding import process_mesh
from dmlc_core_tpu_torch.models.tp_transformer import (TPTransformerConfig,
                                                       TPTransformerLM)
from dmlc_core_tpu_torch.models.transformer import leaves

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_lm_worker.py")
CFGS = {"dense": dict(vocab=64, max_seq=32, embed=32, heads=4, layers=2),
        "moe": dict(vocab=64, max_seq=32, embed=32, heads=4, layers=1,
                    moe_experts=4)}
LR, SEED, STEPS = 0.1, 1, 3


def make_mesh(data, model):
    devs = np.array(jax.devices()[:data * model]).reshape(data, model)
    return Mesh(devs, ("data", "model"))


def toy_batch():
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 64, size=(8, 32), dtype=np.int32)
    return toks[:, :-1], toks[:, 1:]


def ref_run(name, data, model):
    m = RefLM(RefConfig(**CFGS[name]), make_mesh(data, model),
              learning_rate=LR)
    params = m.init(seed=SEED)
    x, y = toy_batch()
    losses = []
    for _ in range(STEPS):
        params, loss = m.step(params, x, y)
        losses.append(float(loss))
    return losses, [np.asarray(p) for p in jax.tree.leaves(params)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp")
    x, y = toy_batch()
    np.savez(d / "in.npz", dense_cfg=np.array(CFGS["dense"], dtype=object),
             moe_cfg=np.array(CFGS["moe"], dtype=object), lr=LR, seed=SEED,
             steps=STEPS, tokens=x, labels=y)
    run_world(lambda r: [sys.executable, WORKER, "tp", str(d / "in.npz"),
                         str(d)], size=4, timeout=120)
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(4)]


def _full(out, name):
    n = len([k for k in out if k.startswith(f"{name}_p")])
    return [out[f"{name}_p{i}"] for i in range(n)]


@pytest.mark.parametrize("ref_mesh", [(2, 2), (1, 1)])
@pytest.mark.parametrize("name", ["dense", "moe"])
def test_tp_steps_match_reference(world, name, ref_mesh):
    want_losses, want_params = ref_run(name, *ref_mesh)
    for out in world:
        np.testing.assert_allclose(out[f"{name}_losses"], want_losses,
                                   rtol=2e-5, atol=2e-5)
    got = _full(world[0], name)
    assert len(got) == len(want_params)
    for a, b in zip(got, want_params):
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=1e-5)
    assert want_losses[-1] < want_losses[0]


@pytest.mark.parametrize("name", ["dense", "moe"])
def test_replicas_are_bit_identical(world, name):
    first = _full(world[0], name)
    for out in world[1:]:
        assert np.array_equal(out[f"{name}_losses"],
                              world[0][f"{name}_losses"])
        for a, b in zip(_full(out, name), first):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("name", ["dense", "moe"])
def test_qkv_is_sharded_by_head(world, name):
    ref = RefLM(RefConfig(**CFGS[name]), make_mesh(1, 1)).init(seed=SEED)
    qkv = np.asarray(ref["layers"][0]["qkv"])            # [D, 3D]
    D, H = 32, 4
    heads = qkv.reshape(D, 3, H, D // H)
    for rank, out in enumerate(world):
        m = rank % 2                                       # model coord
        want = heads[:, :, 2 * m:2 * m + 2].reshape(D, -1)
        assert np.array_equal(out[f"{name}_qkv_shard0"], want)
        # the reference's P(None, "model") block holds other columns
        block = qkv[:, m * 3 * D // 2:(m + 1) * 3 * D // 2]
        assert not np.array_equal(want, block)


@pytest.mark.parametrize("name", ["dense", "moe"])
def test_init_is_the_references_bit_for_bit(name):
    ref = RefLM(RefConfig(**CFGS[name]), make_mesh(1, 1)).init(seed=5)
    mesh = process_mesh((("data", 1), ("model", 1)), device="cpu")
    got = TPTransformerLM(TPTransformerConfig(**CFGS[name]), mesh).init(5)
    want = jax.tree.leaves(ref)
    assert len(leaves(got)) == len(want)
    for a, b in zip(leaves(got), want):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_bad_mesh_and_head_split_rejected():
    mesh = process_mesh((("data", 1),), device="cpu")
    with pytest.raises(ValueError, match="model"):
        TPTransformerLM(TPTransformerConfig(heads=4), mesh)
