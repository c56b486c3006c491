"""Training CLI: data URI -> device batches -> linear learner or
factorization machine -> checkpoint/resume.

The port of ``examples/train.py``, with the same arguments and the same
``epoch N: mean loss ... over ... batches`` lines, plus ``--device``::

    python -m dmlc_core_tpu_torch.train data.libsvm --epochs 3
    python -m dmlc_core_tpu_torch.train ranking.libsvm --objective pairwise
    python -m dmlc_core_tpu_torch.train data.libfm --model fm --fm-rank 8
    python -m dmlc_core_tpu_torch.train data.crec --num-features 28
    python -m dmlc_core_tpu_torch.train data.libsvm --checkpoint ckpt.bin
    python -m dmlc_core_tpu_torch.train data.libsvm --resume ckpt.bin
    python -m dmlc_core_tpu_torch.train data.libsvm --device cpu

It trains on ``cuda`` unless ``--device`` names another device (without
CUDA it raises). Each epoch ends with a checkpoint of the parameters and
the iterator's position; ``--resume`` continues from the checkpoint's
epoch, and from inside an epoch when the checkpoint's ``extra`` holds a
mid-epoch position (``DeviceRowBlockIter.state()``). Dense batches carry
bfloat16 values, as in the reference. ``.crec``, ``.drec`` and ``.rec``
URIs take their binary lanes by suffix; the feature count of a ``.crec``
or ``.drec`` file is given with ``--num-features`` (the discovery pass
parses text and ``.rec`` only, as the reference's does).

Under a launcher the same command runs once per process, each on its own
part of the data. The launcher's env protocol (``DMLC_COORDINATOR_ADDRESS``
/ ``DMLC_NUM_WORKER`` / ``DMLC_TASK_ID``, or the ``JAX_*`` trio) starts a
``torch.distributed`` world (``--backend gloo`` to share one card between
ranks); the learners reduce every step over it, and ``--batch-rows`` is
the global batch, split over the ranks. Every rank steps the same number
of times an epoch — a rank whose part ran out adds a zero-weight step —
and prints the same lines, since the loss is the reduced one. In a world
``--checkpoint`` writes a job checkpoint, one part per rank holding that
rank's data position, committed by rank 0 after a barrier, and
``--resume`` restores this rank's part of the last committed step.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from dmlc_core_tpu_torch.base import DMLCError, resolve_device
from dmlc_core_tpu_torch.device.device_iter import DeviceRowBlockIter
from dmlc_core_tpu_torch.device.sharding import data_mesh, process_part
from dmlc_core_tpu_torch.io.native import NativeParser
from dmlc_core_tpu_torch.models.fm import FMLearner
from dmlc_core_tpu_torch.models.linear import LinearLearner
from dmlc_core_tpu_torch.parallel import distributed
from dmlc_core_tpu_torch.utils.checkpoint import (commit_job_checkpoint,
                                                  restore_checkpoint,
                                                  restore_job_checkpoint,
                                                  save_checkpoint,
                                                  save_job_checkpoint)

# mid-epoch resume keys of DeviceRowBlockIter.state() that are integers
_INT_STATE_KEYS = ("batches_consumed", "batch_rows", "part", "npart",
                   "epoch")
_STATE_KEYS = _INT_STATE_KEYS + ("uri", "fmt")


def train_epoch(learner, params, it):
    """One epoch of ``learner`` over ``it``: (params, per-step losses).

    With a mesh every rank steps until no rank has a batch left: a rank
    whose part ran out steps with ``batch=None`` (a zero-weight step), and
    the step in which no rank had a batch applies nothing and ends the
    epoch on every rank at once."""
    losses = []
    batches = iter(it)
    while True:
        batch = next(batches, None)
        if batch is None and learner.mesh is None:
            return params, losses
        stepped, loss = learner.step(params, batch)
        if learner.mesh is not None and learner.last_active == 0:
            return params, losses
        params = stepped
        losses.append(float(loss))


def main(argv=None) -> int:
    """CLI entry; returns the process exit code."""
    ap = argparse.ArgumentParser(
        description="train a linear model or a factorization machine on "
                    "the port's device path")
    ap.add_argument("uri", help="libsvm/csv/libfm/rec/crec/drec data URI "
                               "(file://, s3://, hdfs://, azure://)")
    ap.add_argument("--num-features", type=int, default=0,
                    help="0 = discover from the first epoch's max index")
    ap.add_argument("--model", default="linear", choices=("linear", "fm"),
                    help="linear learner or second-order factorization "
                         "machine")
    ap.add_argument("--fm-rank", type=int, default=8,
                    help="FM interaction-factor rank k")
    ap.add_argument("--objective", default="logistic",
                    choices=("logistic", "squared", "pairwise"))
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch-rows", type=int, default=4096)
    ap.add_argument("--learning-rate", type=float, default=0.1)
    ap.add_argument("--checkpoint", default="",
                    help="URI to write the model + data position each epoch")
    ap.add_argument("--resume", default="",
                    help="checkpoint URI to resume from (mid-epoch exact)")
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: cuda; raises "
                         "without CUDA)")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="collective backend of a multi-process world "
                         "(default: nccl on CUDA, gloo on the CPU; gloo "
                         "lets ranks share one card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    owns_world = not torch.distributed.is_initialized()
    distributed.init_from_env(device=device, backend=args.backend)
    try:
        return _train(args, device)
    finally:
        if owns_world:
            distributed.shutdown()


def _train(args, device) -> int:
    part, npart = process_part()
    mesh = (data_mesh(device=device) if torch.distributed.is_initialized()
            else None)
    world = 1 if mesh is None else mesh.size
    if npart != world:
        raise DMLCError(
            f"the launcher names part {part} of {npart}, but this "
            f"process's world has {world} rank(s): export "
            f"DMLC_COORDINATOR_ADDRESS with DMLC_NUM_WORKER and "
            f"DMLC_TASK_ID (or the JAX_COORDINATOR_ADDRESS trio), or a "
            f"worker trains on its part alone")
    if mesh is not None:
        device = mesh.device

    if args.num_features <= 0:
        # discovery pass over this part (a real deployment passes
        # --num-features); a world takes the largest id of every part
        mx = 0
        with NativeParser(args.uri, part=part, npart=npart) as p:
            for b in p:
                mx = max(mx, int(b.max_index))
        if mesh is not None:
            mx = int(distributed.allreduce(mx, "max"))
        args.num_features = mx + 1

    if args.model == "fm":
        learner = FMLearner(num_features=args.num_features, k=args.fm_rank,
                            mesh=mesh, objective=args.objective,
                            learning_rate=args.learning_rate, device=device)
    else:
        learner = LinearLearner(num_features=args.num_features, mesh=mesh,
                                objective=args.objective,
                                learning_rate=args.learning_rate,
                                device=device)
    params = learner.init()
    start_epoch = 0
    data_state = None
    if args.resume:
        if mesh is None:
            params, step, extra = restore_checkpoint(args.resume,
                                                     like=params)
        else:
            got = restore_job_checkpoint(args.resume, part, npart,
                                         like=params)
            if got is None:
                raise DMLCError(f"--resume {args.resume}: no committed job "
                                f"checkpoint (no commit marker)")
            params, step, extra = got
        start_epoch = step
        if "batches_consumed" in extra:
            # the epoch-boundary checkpoint records 0 batches, one taken
            # inside an epoch its position; the state is rebuilt from the
            # SAVED identity so restore() catches a resume under other
            # batch_rows/uri/part
            data_state = {k: int(extra[k]) if k in _INT_STATE_KEYS
                          else extra[k] for k in _STATE_KEYS if k in extra}

    it = DeviceRowBlockIter(args.uri, part=part, npart=npart, mesh=mesh,
                            batch_rows=args.batch_rows, dense_dtype="bf16",
                            device=device)
    try:
        for epoch in range(start_epoch, args.epochs):
            if data_state is not None:  # mid-epoch resume, once
                it.restore(data_state)
                data_state = None
            params, losses = train_epoch(learner, params, it)
            summary = (f"mean loss {float(np.mean(losses)):.6f} over "
                       f"{len(losses)} batches" if losses
                       else "no batches in this part")
            print(f"epoch {epoch}: {summary}", flush=True)
            it.before_first()
            if args.checkpoint:
                st = {str(k): str(v) for k, v in it.state().items()}
                if mesh is None:
                    save_checkpoint(args.checkpoint, params, step=epoch + 1,
                                    extra=st)
                    continue
                save_job_checkpoint(args.checkpoint, params, epoch + 1,
                                    part, npart, extra=st)
                distributed.barrier()
                if mesh.rank == 0:
                    commit_job_checkpoint(args.checkpoint, epoch + 1, npart)
    finally:
        it.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
