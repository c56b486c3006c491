"""The readings the limits of ``correct`` are set from, for one cell, at
the cell's own size, in one process:

    python3 benchmark/calibrate.py --workload <cell> --seeds <s1,s2,...> \\
        [--control-seeds <...>] [--fault-seeds <...>] [--tf32-seeds <...>] \\
        [--seconds S]

- sound: the cell's own run (a short window) on each seed; its compared
  numbers are the lower readings;
- control: the plain reference put in the program's place and computed
  in bfloat16, the precision below the configuration's float32, against
  the float64 reference on the same rows and parameters;
- fault (training cells): the program with half of each batch left out
  (the second half's weights zeroed, the mean taken over the rest);
- tf32 (training cells): the program with TF32 on for every step, the
  precision below float32 with TF32 off on the program's own path.

Prints one JSON line a reading, each number with where it was read
(``where``: the step of ``loss_gap``, the leaf that set a worst-leaf gap
and that leaf's program and reference norms), and a summary line last:
for each number its limit, the largest sound reading and the smallest
reading of each other kind, each also as a share of the limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import correct, harness  # noqa: E402


def control_train(found: dict, seed: int, device: str) -> dict:
    """The compared numbers of the bfloat16 reference in the program's
    place, against the float64 reference, with where each was read
    (:func:`correct.train_detail`)."""
    import torch
    cfg = found["config"]
    model = harness.part(found, "models", cfg["model"]["kind"])
    ref = harness.part(found, "reference", cfg["model"]["kind"])
    arr = harness.part(found, "datagen", cfg["data"]["generator"]).arrays(
        cfg["rows"], seed)
    p0 = model.leaves(model.init(cfg, seed, device))
    lo = ref.train(arr, p0, cfg["batch_rows"], 3, cfg["model"],
                   dtype=torch.bfloat16)
    lo["params"] = [lo["params"][0], lo["params"][1], lo["params"][3]]
    hi = ref.train(arr, p0, cfg["batch_rows"], 3, cfg["model"])
    return correct.train_detail(lo, hi, cfg["model"], model)


def control_serve(found: dict, seed: int, seconds: float) -> dict:
    """The bfloat16 reference's scores of the rows one run sends, against
    the float64 reference's."""
    import numpy as np
    import torch
    cfg, tf = found["config"], found["traffic"]
    model = harness.part(found, "models", cfg["model"]["kind"])
    ref = harness.part(found, "reference", cfg["model"]["kind"])
    n = int(round(tf["rate_qps"] * seconds))
    span = tf["rows_max"] - tf["rows_min"] + 1
    rows = int((tf["rows_min"] + np.arange(n) % span).sum())
    arr = harness.part(found, "datagen", cfg["data"]["generator"]).arrays(
        rows, seed)
    p = model.serving_params(cfg, seed)
    lo = ref.scores(arr, p, cfg["model"]["objective"], torch.bfloat16)
    hi = ref.scores(arr, p, cfg["model"]["objective"])
    return {"score_gap": correct.score_gap([lo], [hi])}


def _first_half(orig):
    def shard_loss(self, params, shard, rows):
        shard = dict(shard)
        w = shard["weight"].clone()
        w[rows // 2:] = 0
        shard["weight"] = w
        return orig(self, params, shard, rows)
    return shard_loss


@contextlib.contextmanager
def half_batch():
    """The port's learners with the second half of every shard's rows at
    weight 0, so each step averages over the first half."""
    from dmlc_core_tpu_torch.models.dlrm import DLRMLearner
    from dmlc_core_tpu_torch.models.fm import FMLearner
    from dmlc_core_tpu_torch.models.linear import LinearLearner
    saved = {cls: cls._shard_loss
             for cls in (LinearLearner, FMLearner, DLRMLearner)}
    for cls, orig in saved.items():
        cls._shard_loss = _first_half(orig)
    try:
        yield
    finally:
        for cls, orig in saved.items():
            cls._shard_loss = orig


@contextlib.contextmanager
def tf32():
    """Every step of the port's learners with TF32 on for matmuls and
    cuDNN (the DLRM learner turns it off when it is built, so it is set
    again before each step): the precision below float32 with TF32 off,
    on the program's own path."""
    import torch
    from dmlc_core_tpu_torch.models._dp import DataParallelModel
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    before = [f.allow_tf32 for f in flags]
    orig = DataParallelModel.step

    def step(self, params, batch):
        for f in flags:
            f.allow_tf32 = True
        return orig(self, params, batch)

    DataParallelModel.step = step
    try:
        yield
    finally:
        DataParallelModel.step = orig
        for f, b in zip(flags, before):
            f.allow_tf32 = b


@contextlib.contextmanager
def recorded(into: list):
    """``correct.train_gaps`` as the driver calls it, with each call's
    :func:`correct.train_detail` appended to ``into``."""
    orig = correct.train_gaps

    def train_gaps(prog, ref, model, adapter=None):
        into.append(correct.train_detail(prog, ref, model, adapter))
        return {k: v["value"] for k, v in into[-1].items()}

    correct.train_gaps = train_gaps
    try:
        yield
    finally:
        correct.train_gaps = orig


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--tf32-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args()
    found = harness.resolve(args.workload)
    harness.program_env(found)
    train = found["traffic"]["driver"] == "train_epochs"
    limits = found["config"]["limits"][found["traffic"]["driver"]]
    readings = {"sound": [], "control": [], "fault": [], "tf32": []}

    def emit(kind, seed, got, **extra):
        values = {k: v["value"] if isinstance(v, dict) else v
                  for k, v in got.items()}
        where = {k: {f: x for f, x in v.items() if f != "value"}
                 for k, v in got.items() if isinstance(v, dict)}
        readings[kind].append(values)
        print(json.dumps({"kind": kind, "seed": seed, **extra, **values,
                          "where": where}), flush=True)

    def run(kind, seeds, planted):
        """Runs of the cell with ``planted()`` around each."""
        for s in seeds:
            detail = []
            with planted(), recorded(detail):
                r = harness.run_cell(args.workload, s, args.seconds, False,
                                     "cuda")
            emit(kind, s, detail[-1] if detail else
                 {k: c["value"] for k, c in r["checks"].items()},
                 correct=r["correct"])

    run("sound", _seeds(args.seeds), contextlib.nullcontext)
    for s in _seeds(args.control_seeds):
        emit("control", s, control_train(found, s, "cuda") if train
             else control_serve(found, s, args.seconds))
    if train:
        run("fault", _seeds(args.fault_seeds), half_batch)
        run("tf32", _seeds(args.tf32_seeds), tf32)
    summary = {}
    for name, limit in limits.items():
        row = {"limit": limit}
        for kind, got in readings.items():
            vals = [v[name] for v in got]
            if vals:
                v = max(vals) if kind == "sound" else min(vals)
                row[kind + ("_max" if kind == "sound" else "_min")] = v
                row[kind + "_share_of_limit"] = v / limit
        summary[name] = row
    print(json.dumps({"summary": args.workload, **summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
