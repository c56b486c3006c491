"""The readings the limits of ``correct`` are set from, for one cell, at
the cell's own size, in one process:

    python3 benchmark/calibrate.py --workload <cell> --seeds <s1,s2,...> \\
        [--control-seeds <...>] [--fault-seeds <...>] [--seconds S]

- sound: the cell's own run (a short window) on each seed; its compared
  numbers are the lower readings;
- control: the plain reference put in the program's place and computed
  in bfloat16, the precision below the configuration's float32, against
  the float64 reference on the same rows and parameters;
- fault (training cells): the program with half of each batch left out
  (the second half's weights zeroed, the mean taken over the rest).

Prints one JSON line a reading and a summary line last: for each number
the largest sound reading and the smallest control and fault readings.
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
    place, against the float64 reference."""
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
    return correct.train_gaps(lo, hi, cfg["model"]["learning_rate"])


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
    from dmlc_core_tpu_torch.models.fm import FMLearner
    from dmlc_core_tpu_torch.models.linear import LinearLearner
    saved = {cls: cls._shard_loss for cls in (LinearLearner, FMLearner)}
    for cls, orig in saved.items():
        cls._shard_loss = _first_half(orig)
    try:
        yield
    finally:
        for cls, orig in saved.items():
            cls._shard_loss = orig


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args()
    seeds = [int(s) for s in args.seeds.split(",") if s]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    fseeds = [int(s) for s in args.fault_seeds.split(",") if s]
    found = harness.resolve(args.workload)
    harness.program_env(found)
    train = found["traffic"]["driver"] == "train_epochs"
    readings = {"sound": [], "control": [], "fault": []}

    def emit(kind, seed, values):
        readings[kind].append(values)
        print(json.dumps({"kind": kind, "seed": seed, **values}),
              flush=True)

    for s in seeds:
        r = harness.run_cell(args.workload, s, args.seconds, False,
                             "cuda")
        emit("sound", s, {k: c["value"] for k, c in r["checks"].items()})
    for s in cseeds:
        emit("control", s, control_train(found, s, "cuda") if train
             else control_serve(found, s, args.seconds))
    if train and fseeds:
        with half_batch():
            for s in fseeds:
                r = harness.run_cell(args.workload, s, args.seconds, False,
                                     "cuda")
                emit("fault", s,
                     {k: c["value"] for k, c in r["checks"].items()})
    summary = {}
    for name in found["config"]["limits"][found["traffic"]["driver"]]:
        summary[name] = {
            "sound_max": max((v[name] for v in readings["sound"]),
                             default=None),
            "control_min": min((v[name] for v in readings["control"]),
                               default=None),
            "fault_min": min((v[name] for v in readings["fault"]),
                             default=None)}
    print(json.dumps({"summary": args.workload, **summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
