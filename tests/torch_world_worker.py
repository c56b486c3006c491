"""One rank of a port ``torch.distributed`` world, and the launcher the
port's tests start such worlds with.

    python tests/torch_world_worker.py <mode> <spec.json> <out>

A rank reads the launcher env protocol (``DMLC_COORDINATOR_ADDRESS``,
``DMLC_NUM_WORKER``, ``DMLC_TASK_ID``) through the port's
``init_from_env`` and imports torch and the port only, so the same worker
runs where JAX is not installed. ``spec["device"]`` (default ``cpu``) and
``spec["backend"]`` pick where the world runs. Modes:

- ``collectives``: this rank's part of a libsvm file (exact cover by
  ``process_part``) and every call of the Rabit surface; a JSON result.
- ``dp``: learner steps on this rank's shard file of each case, with the
  step's collectives counted, and an epoch over a file whose parts hold
  different numbers of batches; an ``.npz`` result.
- ``allreduce``: ``allreduce`` of each of ``spec["cases"]`` (this rank's
  row of each case's values) under every op; an ``.npz`` result.
- ``ckpt_mid``: the training CLI's first epoch that commits a job
  checkpoint after ``spec["k"]`` steps and goes on to the end of the
  epoch; a JSON result with the per-step losses.

:func:`run_world` starts every rank of a world at once with its own
timeout, kills them all when one fails or the timeout passes, and returns
their outputs.
"""

import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(argv_of_rank, size: int = 2, timeout: float = 120.0,
              env=None, cwd=None):
    """Start ``size`` ranks (``argv_of_rank(rank)`` each) together under the
    env protocol on a free localhost port and wait at most ``timeout``
    seconds for all of them. Returns ``[(stdout, stderr)]`` in rank order;
    raises AssertionError, with every rank killed, when one exits non-zero
    or the world outlives its timeout. A port taken between its pick and
    rank 0's bind is retried once on another port. The port's native core
    is built first, outside the timeout: the ranks load it, and a fresh
    checkout's first build takes about a minute."""
    from dmlc_core_tpu_torch.io import native
    native.build()
    for attempt in range(2):
        port = _free_port()
        procs = []
        for r in range(size):
            penv = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                        DMLC_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                        DMLC_NUM_WORKER=str(size), DMLC_TASK_ID=str(r),
                        DMLC_COLLECTIVE_TIMEOUT_MS=str(int(timeout * 1000)))
            penv.update(env or {})
            procs.append(subprocess.Popen(
                argv_of_rank(r), env=penv, cwd=cwd, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        deadline = time.monotonic() + timeout
        outs = [None] * size
        try:
            for r, p in enumerate(procs):
                left = max(deadline - time.monotonic(), 0.1)
                outs[r] = p.communicate(timeout=left)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            for p in procs:
                p.communicate()
            raise AssertionError(f"a {size}-rank world outlived its "
                                 f"{timeout:.0f}-s timeout")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        if not failed:
            return outs
        if attempt == 0 and "address already in use" in outs[0][1].lower():
            continue
        r = failed[0]
        raise AssertionError(
            f"rank {r} of {size} exited {procs[r].returncode}:\n"
            f"{outs[r][1][-3000:]}")
    raise AssertionError("unreachable")


def worker_argv(mode: str, spec_path, out_path):
    """The argv of one rank of this worker."""
    return [sys.executable, os.path.abspath(__file__), mode, str(spec_path),
            str(out_path)]


# -- the rank's side ---------------------------------------------------------
def _count_collectives():
    """Wrap the torch.distributed calls the port makes with counters."""
    import torch.distributed as dist
    counts = {}

    def wrap(name):
        fn = getattr(dist, name)

        def counted(*a, **kw):
            counts[name] = counts.get(name, 0) + 1
            return fn(*a, **kw)
        setattr(dist, name, counted)

    for name in ("all_reduce", "all_gather", "broadcast", "barrier"):
        wrap(name)
    return counts


def _collectives(spec, out):
    import numpy as np
    import torch

    from dmlc_core_tpu_torch.device.sharding import process_part
    from dmlc_core_tpu_torch.io.native import NativeParser
    from dmlc_core_tpu_torch.models.linear import LinearParams
    from dmlc_core_tpu_torch.parallel import distributed as D

    D.init_from_env(device="cpu")
    counts = _count_collectives()
    part, npart = process_part()
    rows, label_sum = 0, 0.0
    with NativeParser(spec["data"], part=part, npart=npart) as p:
        for b in p:
            rows += b.num_rows
            label_sum += float(b.label.sum())
    me = D.rank()
    res = {"rank": me, "world": D.world_size(), "part": part,
           "npart": npart, "local_rows": rows, "local_label": label_sum,
           "total_rows": int(D.allreduce(rows)),
           "total_label": float(D.allreduce(label_sum)),
           "max_rows": int(D.allreduce(rows, op="max")),
           "bcast": int(D.broadcast(me * 100 + 7, root=0))}
    v = torch.tensor([me + 1.0, -2.0 * me, 3.0])
    res["ops"] = {op: D.allreduce(v, op).tolist()
                  for op in ("sum", "max", "min", "mean")}
    res["int_mean"] = D.allreduce(torch.tensor([me + 1]), "mean").tolist()
    tree = {"p": LinearParams(w=torch.arange(3.0) * (me + 1),
                              b=torch.tensor(float(me))),
            "n": np.array([me, 10 * me], np.int64)}
    before = dict(counts)
    got = D.allreduce_tree(tree, "sum")
    res["tree_collectives"] = {k: counts.get(k, 0) - before.get(k, 0)
                               for k in counts}
    res["tree"] = {"w": got["p"].w.tolist(), "b": float(got["p"].b),
                   "n": got["n"].tolist(),
                   "types": [type(got["p"]).__name__,
                             type(got["p"].w).__name__,
                             type(got["n"]).__name__]}
    res["tree_mean_w"] = D.allreduce_tree(tree, "mean")["p"].w.tolist()
    # payloads of different lengths, in rank order
    res["gathered"] = [b.decode() for b in D.allgather_bytes(
        (f"rank{me}:" + "x" * me).encode())]
    D.barrier()
    res["collectives"] = counts
    D.shutdown()
    with open(out, "w") as f:
        json.dump(res, f)


def _allreduce(spec, out):
    import numpy as np
    import torch

    from dmlc_core_tpu_torch.parallel import distributed as D

    D.init_from_env(device="cpu")
    me = D.rank()
    res = {}
    for name, case in spec["cases"].items():
        mine = np.asarray(case["values"][me], dtype=case["dtype"])
        for op in ("sum", "max", "min", "mean"):
            got = D.allreduce(torch.from_numpy(mine), op)
            res[f"{name}/{op}"] = got.numpy()
    D.shutdown()
    np.savez(out, **res)


def _learner(case, mesh, device):
    from dmlc_core_tpu_torch.models.fm import FMLearner
    from dmlc_core_tpu_torch.models.linear import LinearLearner
    if case["model"] == "fm":
        return FMLearner(case["features"], k=case["k"], mesh=mesh,
                         objective=case["objective"],
                         learning_rate=case["lr"], device=device)
    return LinearLearner(case["features"], mesh=mesh,
                         objective=case["objective"],
                         learning_rate=case["lr"],
                         margin_path=case.get("margin_path", "segment"),
                         device=device)


def _start(learner, case, device):
    import numpy as np
    from dmlc_core_tpu_torch.models.convert import fm_params_from_numpy
    if case.get("start"):
        with np.load(case["start"]) as z:
            return fm_params_from_numpy({k: z[k] for k in z.files}, device)
    return learner.init()


def _dp(spec, out):
    import numpy as np
    import torch

    from dmlc_core_tpu_torch.device.device_iter import DeviceRowBlockIter
    from dmlc_core_tpu_torch.device.sharding import data_mesh
    from dmlc_core_tpu_torch.ops import hopper_kernels as hk
    from dmlc_core_tpu_torch.parallel import distributed as D
    from dmlc_core_tpu_torch.train import train_epoch
    from dmlc_core_tpu_torch.utils.checkpoint import flatten_with_keys

    device = spec.get("device", "cpu")
    D.init_from_env(device=device, backend=spec.get("backend"))
    mesh = data_mesh(device=device)
    counts = _count_collectives()
    res = {}
    for case in spec["cases"]:
        learner = _learner(case, mesh, mesh.device)
        params = _start(learner, case, mesh.device)
        losses = []
        before = counts.get("all_reduce", 0)
        launches = hk.csr_to_dense_kernel.launches
        with DeviceRowBlockIter(case["files"][mesh.rank],
                                batch_rows=case["batch_rows"], mesh=mesh,
                                layout=case["layout"],
                                min_nnz_bucket=case.get("bucket", 1024),
                                prefetch=0) as it:
            for batch in it:
                params, loss = learner.step(params, batch)
                losses.append(float(loss))
        name = case["name"]
        res[f"{name}/losses"] = np.asarray(losses)
        res[f"{name}/all_reduce_calls"] = np.asarray(
            counts.get("all_reduce", 0) - before)
        res[f"{name}/kernel_launches"] = np.asarray(
            hk.csr_to_dense_kernel.launches - launches)
        for key, arr in flatten_with_keys(params):
            res[f"{name}/param{key}"] = arr
    uneven = spec.get("uneven")
    if uneven:
        learner = _learner(uneven, mesh, mesh.device)
        params = learner.init()
        with DeviceRowBlockIter(uneven["file"], part=mesh.rank,
                                npart=mesh.size,
                                batch_rows=uneven["batch_rows"], mesh=mesh,
                                layout=uneven["layout"],
                                min_nnz_bucket=uneven.get("bucket", 1024),
                                prefetch=0) as it:
            params, losses = train_epoch(learner, params, it)
            res["uneven/local_batches"] = np.asarray(it.batches_consumed)
        res["uneven/losses"] = np.asarray(losses)
        for key, arr in flatten_with_keys(params):
            res[f"uneven/param{key}"] = arr
    torch.distributed.barrier()
    D.shutdown()
    np.savez(out, **res)


def _ckpt_mid(spec, out):
    """The training CLI's logistic run (bf16 dense batches, the global
    batch split over the ranks) up to step k, a committed job checkpoint
    of each rank's position there, then the rest of the epoch."""
    from dmlc_core_tpu_torch.device.device_iter import DeviceRowBlockIter
    from dmlc_core_tpu_torch.device.sharding import data_mesh, process_part
    from dmlc_core_tpu_torch.models.linear import LinearLearner
    from dmlc_core_tpu_torch.parallel import distributed as D
    from dmlc_core_tpu_torch.utils.checkpoint import (commit_job_checkpoint,
                                                      save_job_checkpoint)

    D.init_from_env(device="cpu")
    part, npart = process_part()
    mesh = data_mesh(device="cpu")
    learner = LinearLearner(spec["features"], mesh=mesh,
                            learning_rate=spec["lr"], device="cpu")
    params = learner.init()
    losses = []
    with DeviceRowBlockIter(spec["data"], part=part, npart=npart, mesh=mesh,
                            batch_rows=spec["batch_rows"],
                            dense_dtype="bf16", device="cpu") as it:
        batches = iter(it)
        while True:
            stepped, loss = learner.step(params, next(batches, None))
            if learner.last_active == 0:
                break
            params = stepped
            losses.append(float(loss))
            if len(losses) == spec["k"]:
                st = {str(a): str(b) for a, b in it.state().items()}
                save_job_checkpoint(spec["base"], params, 0, part, npart,
                                    extra=st)
                D.barrier()
                if mesh.rank == 0:
                    commit_job_checkpoint(spec["base"], 0, npart)
    D.shutdown()
    with open(out, "w") as f:
        json.dump({"losses": losses}, f)


def main() -> None:
    mode, spec_path, out = sys.argv[1:4]
    sys.path.insert(0, REPO)
    import torch
    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    {"collectives": _collectives, "dp": _dp, "ckpt_mid": _ckpt_mid,
     "allreduce": _allreduce}[mode](
        spec, out)


if __name__ == "__main__":
    main()
