"""Data-parallel steps of a 2-rank port world against the reference's
ONE-device step on the union batch.

One gloo world of port workers (``tests/torch_world_worker.py``, real
processes, 120-s timeout) steps ``LinearLearner`` (logistic with the dense
margin, squared with the segment margin, pairwise on dense batches) and
``FMLearner`` on shards s0 and s1, two steps each, with ``batch_rows`` the
global batch (half of it a rank). Each step must equal the JAX package's
one-device learner stepping on the union of the two ranks' batches of
that step, from the same numpy parameters: losses at rtol 1e-5, parameters
at rtol 1e-5 / atol 1e-7 (the two sum in f32 in other orders). The
reference's D-device mesh is not the yardstick: it steps with D times the
learning rate (ROADMAP.md section 3). Both ranks' parameters are
bit-identical, and each step is one ``all_reduce``.

The same world runs an epoch over a file whose two parts hold 3 and 2
batches: it terminates (the short rank adds a zero-weight step) and equals
the union run step by step.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dmlc_core_tpu.models.fm import FMLearner as RefFM, FMParams as RefFMP
from dmlc_core_tpu.models.linear import LinearLearner as RefLinear
from dmlc_core_tpu.tpu.device_iter import DeviceRowBlockIter as RefIter
from tests.torch_reference_native import reference_native  # noqa: F401
from tests.torch_world_worker import run_world, worker_argv

from dmlc_core_tpu_torch.device.sharding import DataMesh
from dmlc_core_tpu_torch.io.native import NativeParser
from dmlc_core_tpu_torch.models.linear import LinearLearner

F, K = 6, 3
LOCAL = 64            # rows of a rank's batch
GLOBAL = 2 * LOCAL    # batch_rows: the global batch of the 2-rank world
LR = 0.5
RTOL, ATOL = 1e-5, 1e-7


def _rows_text(rng, rows, short=0, qid0=None):
    """libsvm lines: a label from a hidden linear rule; the first
    ``short`` rows hold 2 features, the rest all F; with ``qid0``, queries
    of 8 documents numbered from qid0 with labels their rank in 0..3."""
    lines = []
    for i in range(rows):
        x = rng.uniform(-1, 1, F)
        n = 2 if i < short else F
        y = int(x[0] + 0.5 * x[1] > 0)
        head = f"{y}"
        if qid0 is not None:
            head = f"{int(np.clip(2 + 2 * x[0], 0, 3))} qid:{qid0 + i // 8}"
        lines.append(head + " " + " ".join(f"{j}:{x[j]:.4f}"
                                           for j in range(n)))
    return lines


def _write(path, lines):
    path.write_text("\n".join(lines) + "\n")
    return str(path)


CASES = {
    "logistic": dict(model="linear", objective="logistic", layout="csr",
                     margin_path="dense"),
    "squared": dict(model="linear", objective="squared", layout="csr",
                    margin_path="segment"),
    "pairwise": dict(model="linear", objective="pairwise", layout="dense"),
    "fm": dict(model="fm", objective="logistic", layout="csr", k=K),
}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world's files, its spec and both ranks' results."""
    d = tmp_path_factory.mktemp("dp")
    rng = np.random.default_rng(17)
    shards = {r: _rows_text(rng, 2 * LOCAL) for r in range(2)}
    # disjoint queries, so pairs mined per rank are the union's pairs
    ranked = {r: _rows_text(rng, 2 * LOCAL, qid0=100 * r) for r in range(2)}
    start = {"b": np.float32(0.05),
             "w": rng.normal(scale=0.1, size=F).astype(np.float32),
             "v": rng.normal(scale=0.3, size=(F, K)).astype(np.float32)}
    np.savez(d / "fm_start.npz", **start)
    spec = {"cases": []}
    for name, case in CASES.items():
        src = ranked if name == "pairwise" else shards
        files = [_write(d / f"{name}{r}.libsvm", src[r]) for r in range(2)]
        spec["cases"].append(dict(
            case, name=name, files=files, features=F, lr=LR,
            batch_rows=GLOBAL, start=str(d / "fm_start.npz")
            if name == "fm" else None))
    # parts of 149 and 71 rows: 3 and 2 batches of LOCAL rows
    uneven = _write(d / "uneven.libsvm",
                    _rows_text(rng, 220, short=120))
    spec["uneven"] = dict(model="linear", objective="logistic",
                          layout="csr", margin_path="dense", features=F,
                          lr=LR, file=uneven, batch_rows=GLOBAL)
    spec_path = d / "spec.json"
    spec_path.write_text(json.dumps(spec))
    outs = [d / f"rank{r}.npz" for r in range(2)]
    run_world(lambda r: worker_argv("dp", spec_path, outs[r]))
    results = []
    for o in outs:
        with np.load(o) as z:
            results.append({k: z[k] for k in z.files})
    return {"dir": d, "spec": spec, "shards": shards, "ranked": ranked,
            "start": start, "results": results}


def _ref_learner(case):
    if case["model"] == "fm":
        return RefFM(F, k=K, objective=case["objective"], learning_rate=LR)
    return RefLinear(F, objective=case["objective"], learning_rate=LR,
                     margin_path=case.get("margin_path", "segment"))


def _ref_union_run(learner, params, case, steps_rows, d, tag):
    """The reference's one-device learner, one step per union batch (a
    file each, so a short step is never filled from the next)."""
    losses = []
    for k, lines in enumerate(steps_rows):
        path = _write(d / f"union_{tag}_{k}.libsvm", lines)
        with RefIter(path, mesh=None, batch_rows=GLOBAL,
                     layout=case["layout"], min_nnz_bucket=1024,
                     prefetch=0) as it:
            (batch,) = list(it)
            params, loss = learner.step(params, batch)
        losses.append(float(loss))
    return losses, params


def _ref_params_dict(params):
    return {f".{k}": np.asarray(v) for k, v in params._asdict().items()}


def _check_ranks_and_reference(res0, res1, name, want_losses, want_params):
    keys = sorted(k for k in res0 if k.startswith(f"{name}/param"))
    assert keys and keys == sorted(k for k in res1
                                   if k.startswith(f"{name}/param"))
    for k in keys:  # the replicas never drift: same bits on both ranks
        assert res0[k].tobytes() == res1[k].tobytes(), k
    np.testing.assert_array_equal(res0[f"{name}/losses"],
                                  res1[f"{name}/losses"])
    np.testing.assert_allclose(res0[f"{name}/losses"], want_losses,
                               rtol=RTOL, atol=0)
    for k in keys:
        field = k.split("/param")[1]
        np.testing.assert_allclose(res0[k], want_params[field], rtol=RTOL,
                                   atol=ATOL, err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_world_step_equals_one_device_union_step(world, name):
    case = CASES[name]
    src = world["ranked"] if name == "pairwise" else world["shards"]
    steps = [src[0][k * LOCAL:(k + 1) * LOCAL]
             + src[1][k * LOCAL:(k + 1) * LOCAL] for k in range(2)]
    learner = _ref_learner(case)
    if case["model"] == "fm":
        params = RefFMP(**{k: jnp.asarray(v)
                           for k, v in world["start"].items()})
    else:
        params = learner.init()
    want_losses, params = _ref_union_run(learner, params, case, steps,
                                         world["dir"], name)
    res0, res1 = world["results"]
    _check_ranks_and_reference(res0, res1, name, want_losses,
                               _ref_params_dict(params))
    # one all_reduce a step, on both ranks
    assert int(res0[f"{name}/all_reduce_calls"]) == 2
    assert int(res1[f"{name}/all_reduce_calls"]) == 2


def test_uneven_parts_epoch_terminates_and_equals_union_run(world):
    spec = world["spec"]["uneven"]
    parts = []
    with open(spec["file"]) as f:
        lines = f.read().splitlines()
    n0 = 0
    with NativeParser(spec["file"], part=0, npart=2) as p:
        for b in p:
            n0 += b.num_rows
    parts = [lines[:n0], lines[n0:]]
    res0, res1 = world["results"]
    local = [int(res0["uneven/local_batches"]),
             int(res1["uneven/local_batches"])]
    assert local == [-(-len(p) // LOCAL) for p in parts] == [3, 2]
    steps = [parts[0][k * LOCAL:(k + 1) * LOCAL]
             + parts[1][k * LOCAL:(k + 1) * LOCAL] for k in range(3)]
    learner = _ref_learner(spec)
    want_losses, params = _ref_union_run(learner, learner.init(), spec,
                                         steps, world["dir"], "uneven")
    assert len(res0["uneven/losses"]) == 3  # every rank stepped 3 times
    _check_ranks_and_reference(res0, res1, "uneven", want_losses,
                               _ref_params_dict(params))


def _cpu_mesh(size):
    return DataMesh(group=None, rank=0, size=size,
                    device=torch.device("cpu"))


def test_step_without_a_batch_needs_a_mesh():
    learner = LinearLearner(F, device="cpu")
    with pytest.raises(ValueError, match="zero-weight step"):
        learner.step(learner.init(), None)
    # a one-process mesh: the zero-weight step applies nothing when no
    # rank had a batch
    meshed = LinearLearner(F, mesh=_cpu_mesh(1), device="cpu")
    params = meshed.init()
    out, loss = meshed.step(params, None)
    assert meshed.last_active == 0 and out is params
    assert float(loss) == 0.0
