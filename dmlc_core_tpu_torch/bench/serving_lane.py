"""The serving lane (``bench.py:873-997``): ``python -m
dmlc_core_tpu_torch.serving`` out of process, driven by the port's load
generator.

The reference lane's configuration: a linear model over 16,384 features
(``default_rng(7)`` weights), buckets ``16,64,256``, a 2 ms batch delay,
shedding past 500 ms of lateness, and ``POST /score`` payloads of 2 to 8
libsvm rows of 16 nonzeros (``bench.loadrig.score_payload_fn``). A
2-client warm-up, one request at each padded shape the lane's batches can
reach (:data:`PRIME_ROWS`), an 8-client closed loop (the sustained QPS),
then an open loop at 0.7 x sustained with 64 in flight: its percentiles
on the intended-time clock, errors, sheds, and the shape census
(``serve_distinct_shapes``, no new shape after the warm-up). A healthy
server at 0.7 x sustained must not page: an SLO fast-burn trip fails the
lane. The server runs on the bench's device.
"""

from __future__ import annotations

import http.client
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

from dmlc_core_tpu_torch.base import REPO_ROOT
from dmlc_core_tpu_torch.bench import loadrig
from dmlc_core_tpu_torch.serving.model import save_model

FEATURES = 1 << 14
SERVER_ARGS = ["--rows-buckets", "16,64,256", "--batch-delay-ms", "2",
               "--shed-lateness-ms", "500"]
CORPUS = f"libsvm:rows=2,rows_max=8,features={FEATURES},nnz=16,seed=7"
# A micro-batch holds at most 256 rows (the largest bucket) of 16
# nonzeros, and is padded to (rows bucket 16|64|256, nnz bucket: a power
# of two of at least 256). Both buckets change only at a power of two of
# the row count, so one request of each of these sizes, sent alone, meets
# every shape the lane's batches can reach. The closed loops cannot: 8
# clients of at most 8 rows never form a batch of over 64 rows, while the
# open loop's 64 in flight do.
PRIME_ROWS = (2, 4, 8, 16, 32, 64, 128, 256)


def scrape_metric(port: int, name: str) -> float:
    """One metric off the server's ``/metrics`` (label series summed; 0.0
    when absent)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", "/metrics")
        text = conn.getresponse().read().decode()
    finally:
        conn.close()
    total = 0.0
    for line in text.splitlines():
        if line.startswith(name + " ") or line.startswith(name + "{"):
            total += float(line.split()[-1])
    return total


def run_serving_lane(device: str, smoke: bool = False,
                     sampler=None) -> dict:
    """The lane's numbers (see the module docstring)."""
    rng = np.random.default_rng(7)
    tmp = tempfile.mkdtemp(prefix="bench-serving-")
    server = None
    try:
        uri = os.path.join(tmp, "model.ckpt")
        save_model(uri, "linear",
                   {"w": rng.normal(size=FEATURES).astype(np.float32),
                    "b": np.float32(0.0)}, FEATURES)
        server = subprocess.Popen(
            [sys.executable, "-m", "dmlc_core_tpu_torch.serving",
             "--model-uri", uri, *SERVER_ARGS, "--device", device],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
            cwd=REPO_ROOT)
        line = ""
        deadline = time.time() + 120
        while time.time() < deadline:
            line = server.stdout.readline()
            if line.startswith("SERVE_READY") or not line:
                break
        if not line.startswith("SERVE_READY"):
            raise RuntimeError("serving lane: the server never came ready")
        port = int(line.split("port=")[1].split()[0])
        if sampler is not None:
            sampler.watch("serving_server", server.pid)
        payload_fn, ctype = loadrig.score_payload_fn(CORPUS)
        url = f"http://127.0.0.1:{port}/score"
        fn = loadrig.http_request_fn(
            url, method="POST", headers={"Content-Type": ctype},
            payload_fn=payload_fn)
        # every bucket shape is first seen here, not in the measured loops
        loadrig.closed_loop(fn, workers=2, duration_s=1.0 if smoke else 3.0)
        for rows in PRIME_ROWS:
            prime, _ = loadrig.score_payload_fn(
                f"libsvm:rows={rows},features={FEATURES},nnz=16,seed=7")
            if not loadrig.http_request_fn(
                    url, method="POST", headers={"Content-Type": ctype},
                    payload_fn=prime)():
                raise RuntimeError(
                    f"serving lane: a {rows}-row warm-up request failed")
        sustained = loadrig.closed_loop(fn, workers=8,
                                        duration_s=2.0 if smoke else 6.0)
        sustained_qps = sustained["achieved_qps"]
        shapes_warm = scrape_metric(port, "serve_distinct_shapes")
        open_out = loadrig.open_loop(
            fn, qps=max(1.0, 0.7 * sustained_qps),
            duration_s=2.0 if smoke else 8.0, max_inflight=64)
        shapes_steady = scrape_metric(port, "serve_distinct_shapes")
        shed_total = (scrape_metric(port, "serve_shed_total")
                      or open_out["shed"])
        burn_trips = scrape_metric(port, "slo_page_trips_total")
        if burn_trips:
            raise RuntimeError(
                f"SLO page tripped {int(burn_trips)}x during the 0.7x "
                "open-loop phase: a healthy server must not burn")
        server.send_signal(signal.SIGTERM)
        try:
            server.wait(30)
        except subprocess.TimeoutExpired:
            server.kill()
        ii = open_out["intended_us"]
        return {
            "sustained_qps": round(sustained_qps, 1),
            "open_loop_qps": open_out["achieved_qps"],
            "open_loop_p50_ms": round(ii["p50"] / 1e3, 2),
            "open_loop_p99_ms": round(ii["p99"] / 1e3, 2),
            "open_loop_p999_ms": round(ii["p999"] / 1e3, 2),
            "service_p99_ms": round(open_out["service_us"]["p99"] / 1e3, 2),
            "completed": open_out["completed"],
            "errors": open_out["errors"],
            "client_shed": open_out["shed"],
            "server_shed": shed_total,
            "distinct_shapes": int(shapes_steady),
            "steady_new_shapes": int(shapes_steady - shapes_warm),
            "slo_burn_clean": int(burn_trips),
        }
    finally:
        if server is not None and server.poll() is None:
            server.kill()
            server.wait(10)
        shutil.rmtree(tmp, ignore_errors=True)
