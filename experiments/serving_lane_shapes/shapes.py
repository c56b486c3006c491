#!/usr/bin/env python3
"""Which batch sizes the bench's serving lane meets after its warm-up.

    python3 experiments/serving_lane_shapes/shapes.py [--device cuda]
        [--runs 3] [--smoke]

Runs ``dmlc_core_tpu_torch.bench.serving_lane.run_serving_lane`` ``--runs``
times. For each run it prints the lane's JSON line, then the server's
``serve_batch_rows`` histogram (real rows per micro-batch, cumulative
log2 buckets up to 256) as it stood when the lane read the shape census
after the warm-up and again after the open loop. The closed loops (2 and
8 clients of at most 8 rows each) form no batch of over 64 rows while
the open loop's 64 in flight do; the warm-up's one request of each of
2, 4, ..., 256 rows puts a batch in every bucket first, so the first
reading already counts batches of over 64 rows and the lane's
``steady_new_shapes`` is 0.
"""

import argparse
import http.client
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from dmlc_core_tpu_torch.bench import serving_lane  # noqa: E402


def batch_rows_buckets(port: int) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", "/metrics")
        text = conn.getresponse().read().decode()
    finally:
        conn.close()
    out = {}
    for line in text.splitlines():
        if line.startswith('serve_batch_rows_bucket{le="'):
            le = line.split('"')[1]
            if le != "+Inf" and int(le) <= 256:
                out[le] = int(float(line.split()[-1]))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args()
    readings = []
    scrape = serving_lane.scrape_metric

    def scrape_with_histogram(port: int, name: str) -> float:
        if name == "serve_distinct_shapes":
            readings.append(batch_rows_buckets(port))
        return scrape(port, name)

    serving_lane.scrape_metric = scrape_with_histogram
    for _ in range(args.runs):
        readings.clear()
        lane = serving_lane.run_serving_lane(args.device, smoke=args.smoke)
        after_warm, after_open = readings
        print(json.dumps({"lane": lane, "batch_rows_after_warm": after_warm,
                          "batch_rows_after_open_loop": after_open}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
