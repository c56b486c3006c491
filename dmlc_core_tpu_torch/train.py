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

A multi-process world raises and names the ROADMAP.md queue item that
ports it.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from dmlc_core_tpu_torch.base import DMLCError, resolve_device
from dmlc_core_tpu_torch.device.device_iter import DeviceRowBlockIter
from dmlc_core_tpu_torch.device.sharding import process_part
from dmlc_core_tpu_torch.io.native import NativeParser
from dmlc_core_tpu_torch.models.fm import FMLearner
from dmlc_core_tpu_torch.models.linear import LinearLearner
from dmlc_core_tpu_torch.utils.checkpoint import restore_checkpoint, \
    save_checkpoint

_MULTI_PROCESS = ("ROADMAP.md queue 1, 'Multi-process data parallelism via "
                  "torch.distributed'")
# mid-epoch resume keys of DeviceRowBlockIter.state() that are integers
_INT_STATE_KEYS = ("batches_consumed", "batch_rows", "part", "npart",
                   "epoch")
_STATE_KEYS = _INT_STATE_KEYS + ("uri", "fmt")


def _refuse_unported() -> None:
    if os.environ.get("JAX_COORDINATOR_ADDRESS") or \
            os.environ.get("DMLC_COORDINATOR_ADDRESS"):
        raise DMLCError(f"a multi-process world is not ported yet "
                        f"({_MULTI_PROCESS})")


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
    args = ap.parse_args(argv)

    _refuse_unported()
    device = resolve_device(args.device)
    part, npart = process_part()
    if npart > 1:
        raise DMLCError(f"a multi-process world ({npart} parts) is not "
                        f"ported yet ({_MULTI_PROCESS})")

    if args.num_features <= 0:
        # discovery pass over this part (a real deployment passes
        # --num-features)
        mx = 0
        with NativeParser(args.uri, part=part, npart=npart) as p:
            for b in p:
                mx = max(mx, int(b.max_index))
        args.num_features = mx + 1

    if args.model == "fm":
        learner = FMLearner(num_features=args.num_features, k=args.fm_rank,
                            objective=args.objective,
                            learning_rate=args.learning_rate, device=device)
    else:
        learner = LinearLearner(num_features=args.num_features,
                                objective=args.objective,
                                learning_rate=args.learning_rate,
                                device=device)
    params = learner.init()
    start_epoch = 0
    data_state = None
    if args.resume:
        params, step, extra = restore_checkpoint(args.resume, like=params)
        start_epoch = step
        if "batches_consumed" in extra:
            # the epoch-boundary checkpoint records 0 batches, one taken
            # inside an epoch its position; the state is rebuilt from the
            # SAVED identity so restore() catches a resume under other
            # batch_rows/uri/part
            data_state = {k: int(extra[k]) if k in _INT_STATE_KEYS
                          else extra[k] for k in _STATE_KEYS if k in extra}

    it = DeviceRowBlockIter(args.uri, part=part, npart=npart,
                            batch_rows=args.batch_rows, dense_dtype="bf16",
                            device=device)
    try:
        for epoch in range(start_epoch, args.epochs):
            if data_state is not None:  # mid-epoch resume, once
                it.restore(data_state)
                data_state = None
            losses = []
            for batch in it:
                params, loss = learner.step(params, batch)
                losses.append(float(loss))
            summary = (f"mean loss {float(np.mean(losses)):.6f} over "
                       f"{len(losses)} batches" if losses
                       else "no batches in this part")
            print(f"epoch {epoch}: {summary}", flush=True)
            it.before_first()
            if args.checkpoint:
                st = {str(k): str(v) for k, v in it.state().items()}
                save_checkpoint(args.checkpoint, params, step=epoch + 1,
                                extra=st)
    finally:
        it.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
