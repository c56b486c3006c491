"""The port's ``parallel/distributed.py`` against the reference's.

A 2-rank gloo world of port workers (``tests/torch_world_worker.py``,
real processes under the launcher env protocol, 120-s timeout) reads one
libsvm file by ``process_part``: its totals equal what the reference's
``NativeParser(part=r, npart=2)`` gives per part, summed here — the
quantities ``tests/distributed_worker.py`` reports — and every call of the
Rabit surface returns what the reference's would (``allreduce_tree`` in
ONE collective). In one process the surface is the identity, as the
reference's. The env protocol is read in the reference's order, with its
refusals of set but invalid values: ``init_process_group`` and
``jax.distributed.initialize`` are replaced by recorders, so both
packages' readings of the same environment are compared without starting
a world.
"""

import json

import numpy as np
import pytest
import torch

import jax

from dmlc_core_tpu.io.native import NativeParser as RefParser
from dmlc_core_tpu.parallel import distributed as ref_dist
from tests.torch_reference_native import reference_native  # noqa: F401
from tests.torch_world_worker import run_world, worker_argv

from dmlc_core_tpu_torch.base import DMLCError
from dmlc_core_tpu_torch.models.linear import LinearParams
from dmlc_core_tpu_torch.parallel import distributed as D

ENV_VARS = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
            "JAX_PROCESS_ID", "DMLC_COORDINATOR_ADDRESS", "DMLC_NUM_WORKER",
            "DMLC_TASK_ID", "DMLC_COLLECTIVE_TIMEOUT_MS")


def test_two_rank_world_exact_cover_and_collectives(tmp_path):
    rows = 1000
    data = tmp_path / "d.libsvm"
    rng = np.random.default_rng(5)
    with open(data, "w") as f:
        for i in range(rows):
            f.write(f"{i % 2} " + " ".join(
                f"{j}:{rng.uniform():.4f}" for j in range(6)) + "\n")
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"data": str(data)}))
    outs = [tmp_path / f"out{r}.json" for r in range(2)]
    run_world(lambda r: worker_argv("collectives", spec, outs[r]))
    r0, r1 = (json.loads(o.read_text()) for o in outs)

    # the reference's per-part reading of the same file, summed here
    want_rows, want_label = [], []
    for part in range(2):
        n, lab = 0, 0.0
        with RefParser(str(data), part=part, npart=2) as p:
            for b in p:
                n += b.num_rows
                lab += float(np.asarray(b.label).sum())
        want_rows.append(n)
        want_label.append(lab)
    assert (r0["rank"], r1["rank"]) == (0, 1)
    assert r0["world"] == r1["world"] == 2
    assert [(r["part"], r["npart"]) for r in (r0, r1)] == [(0, 2), (1, 2)]
    assert [r0["local_rows"], r1["local_rows"]] == want_rows
    assert [r0["local_label"], r1["local_label"]] == want_label
    assert sum(want_rows) == rows and min(want_rows) > 0
    for r in (r0, r1):
        assert r["total_rows"] == rows
        assert r["total_label"] == sum(want_label)
        assert r["max_rows"] == max(want_rows)
        assert r["bcast"] == 7  # root 0's rank*100+7
        # each rank passed [rank+1, -2*rank, 3]
        assert r["ops"] == {"sum": [3.0, -2.0, 6.0], "max": [2.0, 0.0, 3.0],
                            "min": [1.0, -2.0, 3.0],
                            "mean": [1.5, -1.0, 3.0]}
        assert r["int_mean"] == [1.5]  # numpy's mean of ints: float
        assert r["tree"] == {"w": [0.0, 3.0, 6.0], "b": 1.0, "n": [1, 10],
                             "types": ["LinearParams", "Tensor", "ndarray"]}
        assert r["tree_mean_w"] == [0.0, 1.5, 3.0]
        # the whole tree rode one packed all-gather, nothing else
        assert {k: v for k, v in r["tree_collectives"].items() if v} == \
            {"all_gather": 1}
        assert r["gathered"] == ["rank0:", "rank1:x"]
        assert r["collectives"]["barrier"] == 1


def test_single_process_identities(monkeypatch):
    for name in ENV_VARS:
        monkeypatch.delenv(name, raising=False)
    D.init_from_env(device="cpu")  # no launcher env: one process
    assert not torch.distributed.is_initialized()
    assert (D.rank(), D.world_size()) == (ref_dist.rank(),
                                          ref_dist.world_size()) == (0, 1)
    for x in (3, 2.5, np.arange(4, dtype=np.float32)):
        for op in ("sum", "max", "min", "mean"):
            got, want = D.allreduce(x, op), ref_dist.allreduce(x, op)
            assert isinstance(got, torch.Tensor)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="op must be one of"):
        D.allreduce(1.0, "prod")
    with pytest.raises(ValueError, match="op must be one of"):
        D.allreduce_tree({}, "prod")
    tree = LinearParams(w=torch.ones(3), b=torch.tensor(0.5))
    assert D.allreduce_tree(tree) is tree
    assert D.allgather_bytes(b"abc") == ref_dist.allgather_bytes(b"abc") \
        == [b"abc"]
    D.barrier()
    assert int(D.broadcast(41, root=0)) == int(ref_dist.broadcast(41)) == 41
    D.shutdown()  # a no-op outside a world


@pytest.fixture
def recorders(monkeypatch):
    """Clean launcher env; init_process_group and jax.distributed.initialize
    replaced by recorders of their arguments."""
    for name in ENV_VARS:
        monkeypatch.delenv(name, raising=False)
    calls = {"port": [], "ref": []}
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda **kw: calls["port"].append(kw))
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: calls["ref"].append(kw))
    return calls


def _both(recorders, **kw):
    D.init_from_env(**kw)
    ref_dist.init_from_env()
    port = [(c["init_method"], c["world_size"], c["rank"])
            for c in recorders["port"]]
    ref = [(f"tcp://{c['coordinator_address']}", c["num_processes"],
            c["process_id"]) for c in recorders["ref"]]
    return port, ref


@pytest.mark.parametrize("env,want", [
    ({}, []),
    ({"DMLC_COORDINATOR_ADDRESS": "h:9", "DMLC_NUM_WORKER": "3",
      "DMLC_TASK_ID": "2"}, [("tcp://h:9", 3, 2)]),
    # the JAX trio comes first
    ({"JAX_COORDINATOR_ADDRESS": "j:1", "JAX_NUM_PROCESSES": "2",
      "JAX_PROCESS_ID": "1", "DMLC_COORDINATOR_ADDRESS": "h:9",
      "DMLC_NUM_WORKER": "3", "DMLC_TASK_ID": "2"}, [("tcp://j:1", 2, 1)]),
    # a coordinator without a count and rank is a one-process job
    ({"DMLC_COORDINATOR_ADDRESS": "h:9"}, []),
    # garbage rank variables without a coordinator are never read
    ({"DMLC_TASK_ID": "x", "DMLC_NUM_WORKER": ""}, []),
])
def test_env_protocol_order(recorders, env, want, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    port, ref = _both(recorders, device="cpu")
    assert port == ref == want
    for c in recorders["port"]:
        assert c["backend"] == "gloo"
        assert c["timeout"].total_seconds() == 600.0


def test_backend_timeout_and_device_choice(recorders, monkeypatch):
    monkeypatch.setenv("DMLC_COORDINATOR_ADDRESS", "h:9")
    monkeypatch.setenv("DMLC_NUM_WORKER", "2")
    monkeypatch.setenv("DMLC_TASK_ID", "1")
    monkeypatch.setenv("DMLC_COLLECTIVE_TIMEOUT_MS", "2500")
    D.init_from_env(device="cpu", backend="gloo")
    (call,) = recorders["port"]
    assert call["backend"] == "gloo"
    assert call["timeout"].total_seconds() == 2.5
    # NCCL needs a card: asked for on the CPU it is refused, not swapped
    with pytest.raises(DMLCError, match="nccl backend needs a CUDA"):
        D.init_from_env(device="cpu", backend="nccl")
    with pytest.raises(DMLCError, match="backend must be"):
        D.init_from_env(device="cpu", backend="mpi")


@pytest.mark.parametrize("env,exc,match", [
    ({"JAX_COORDINATOR_ADDRESS": "j:1", "JAX_NUM_PROCESSES": "2",
      "JAX_PROCESS_ID": "x"}, RuntimeError, "JAX_PROCESS_ID='x'"),
    ({"JAX_COORDINATOR_ADDRESS": "j:1", "JAX_NUM_PROCESSES": "",
      "JAX_PROCESS_ID": "0"}, RuntimeError, "JAX_NUM_PROCESSES=''"),
    ({"DMLC_COORDINATOR_ADDRESS": "h:9", "DMLC_NUM_WORKER": "2",
      "DMLC_TASK_ID": "one"}, RuntimeError, "DMLC_TASK_ID='one'"),
    ({"DMLC_COORDINATOR_ADDRESS": "h:9", "DMLC_NUM_WORKER": "2",
      "DMLC_TASK_ID": "2"}, DMLCError, "DMLC_TASK_ID=2 out of range"),
    ({"JAX_COORDINATOR_ADDRESS": "j:1", "JAX_NUM_PROCESSES": "2"},
     DMLCError, "JAX_PROCESS_ID is not"),
])
def test_garbage_env_refused(recorders, monkeypatch, env, exc, match):
    """A set but invalid count or rank raises naming the variable, as the
    reference's wire.env_int_opt does, instead of a rank quietly running
    as a world of its own."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(exc, match=match):
        D.init_from_env(device="cpu")
    assert recorders["port"] == []
    if exc is RuntimeError:  # the reference's own parse refuses the same
        with pytest.raises(RuntimeError, match=match):
            ref_dist.init_from_env()


@pytest.mark.parametrize("size", [3, 4])
def test_allreduce_is_the_rank_ordered_reduction(tmp_path, size):
    """``allreduce`` in gloo worlds of 3 and 4 CPU ranks equals, bit for
    bit, the reference's ``_reduce_stack`` over the rank-ordered stack
    (the reference's host transport). With three or more ranks gloo's own
    order of summation differs: ``1.0, 1e8, -1e8`` sums to 1.0 there and
    to 0.0 in rank order."""
    rng = np.random.default_rng(size)
    cancel = [1.0, 1e8, -1e8] + [0.0] * (size - 3)
    cases = {
        "cancel": {"dtype": "float32", "values": [[v] for v in cancel]},
        "cancel_late": {"dtype": "float32",
                        "values": [[v] for v in cancel[1:] + cancel[:1]]},
        "random": {"dtype": "float32", "values": (
            rng.standard_normal((size, 4096)) * 10.0 ** rng.integers(
                -3, 8, (size, 4096))).astype(np.float32).tolist()},
        "ints": {"dtype": "int64",
                 "values": rng.integers(-1000, 1000, (size, 7)).tolist()},
        # one 0-d value a rank: the result stays 0-d, as the reference's
        "scalar": {"dtype": "float32", "values": cancel},
    }
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"cases": cases}))
    outs = [tmp_path / f"out{r}.npz" for r in range(size)]
    run_world(lambda r: worker_argv("allreduce", spec, outs[r]), size=size)
    got = [dict(np.load(o)) for o in outs]
    for name, case in cases.items():
        stack = np.asarray(case["values"], dtype=case["dtype"])
        for op in ("sum", "max", "min", "mean"):
            want = ref_dist._reduce_stack(stack, op)
            for r in range(size):
                g = got[r][f"{name}/{op}"]
                assert g.dtype == want.dtype and g.shape == want.shape
                assert g.tobytes() == want.tobytes(), (name, op, r)
    for r in range(size):
        assert got[r]["cancel/sum"].tolist() == [0.0]
        assert got[r]["cancel_late/sum"].tolist() == [1.0]
