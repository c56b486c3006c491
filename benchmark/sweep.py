"""The sweep that fixes a serving cell's rate: one server, set up as the
cell's run sets it up, then open loops at rising rates:

    python3 benchmark/sweep.py --workload criteo_fm.serve --seed <n> \\
        --rates 200,400,800 [--seconds 10]

For each rate it prints the achieved rate, p50 and p99, and the p99 of
the first and second half of the window's arrivals. The highest rate
the server sustains is the highest at which the achieved rate is within
2 % of the offered one, none failed, and p99 does not grow from the
first half to the second by more than a tenth (the p99 of half a window
is itself noisy); the cell's traffic file takes 0.8 of it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402
from benchmark.drivers import serve_open as so  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args()
    found = harness.resolve(args.workload)
    harness.program_env(found)
    cfg, tf = found["config"], found["traffic"]
    ctx = harness.Context(found, args.seed, args.seconds, False,
                          "cuda", 0.0, None)
    gen = ctx.part("datagen", cfg["data"]["generator"])
    model = ctx.part("models", cfg["model"]["kind"])
    rates = [float(r) for r in args.rates.split(",")]
    payloads, _, text = so.build_payloads(
        ctx, gen, int(max(rates) * args.seconds))
    d = ctx.cache("serve")
    path = os.path.join(d, "model.ckpt")
    model.save_serving(path, cfg, model.serving_params(cfg, args.seed))
    proc, port = so.start_server(ctx, path, os.path.join(d, "sweep.log"),
                                 None)
    try:
        so.warm_shapes(ctx, gen, port, text)
        best = None
        for rate in rates:
            m = int(rate * args.seconds)
            loop = so.open_loop(port, payloads[:m], rate,
                                tf["max_inflight"], 60, so.CTYPE)
            ok = np.array([s == 200 for s in loop["status"]])
            lat = loop["latency_s"] * 1e3
            done = np.where(ok, lat, np.inf)
            finish = loop["t0"] + np.arange(m) / rate + \
                np.nan_to_num(loop["latency_s"])
            achieved = ok.sum() / (finish.max() - loop["t0"])
            h = m // 2
            rec = {"rate": rate, "achieved": achieved,
                   "failed": int(m - ok.sum()),
                   "p50_ms": so.nearest_rank(done, 0.5),
                   "p99_ms": so.nearest_rank(done, 0.99),
                   "p99_first_half_ms": so.nearest_rank(done[:h], 0.99),
                   "p99_second_half_ms": so.nearest_rank(done[h:], 0.99)}
            rec["sustained"] = bool(
                achieved >= 0.98 * rate and rec["failed"] == 0
                and rec["p99_second_half_ms"]
                <= rec["p99_first_half_ms"] * 1.1)
            if rec["sustained"]:
                best = rate
            print(json.dumps(rec), flush=True)
        print(json.dumps({"highest_sustained": best,
                          "cell_rate": None if best is None
                          else 0.8 * best}), flush=True)
    finally:
        so.stop_server(proc)
    return 0


if __name__ == "__main__":
    sys.exit(main())
