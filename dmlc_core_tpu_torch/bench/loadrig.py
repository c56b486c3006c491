"""The port's counterpart of the reference's load rig
(``scripts/loadrig.py``): an open-loop load generator, its closed-loop
comparison mode, HTTP and generated-payload request functions, the
one-process-per-measurement clients and the out-of-process origins.

    python -m dmlc_core_tpu_torch.bench.loadrig origin --backend s3 \\
        --corpus KEY=@PATH [--workers N] [--latency-ms MS] \\
        [--reset-every N] [--get-500-every N] [--stall-every N] ...
    python -m dmlc_core_tpu_torch.bench.loadrig parse-client --uri URI \\
        [--fmt libsvm] [--nthread N] [--reps R]
    python -m dmlc_core_tpu_torch.bench.loadrig fetch-client --uri URI
    python -m dmlc_core_tpu_torch.bench.loadrig loadgen --url URL \\
        [--qps Q] [--duration-s S] [--workers W] [--closed-loop] \\
        [--score-corpus SPEC | --body-file F] ...

``origin`` serves a mock backend from pre-forked processes with the
reference's shaping and fault knobs (:func:`remote_lane.run_origin`; it
prints ``RIG_READY {json}``). Each client parses (or reads) a URI in a
fresh process, over the port's native core, and prints one JSON line: the
timing, the process's own CPU seconds and the range scheduler's telemetry
(``parse-client``), or the sha256 and length of the bytes
(``fetch-client``). ``loadgen`` drives HTTP load at ``--url``, open loop
by default, and prints :func:`open_loop`'s (or :func:`closed_loop`'s)
JSON.
"""

from __future__ import annotations

import argparse
import hashlib
import http.client
import json
import os
import random
import sys
import threading
import time
import urllib.parse
from typing import Optional

from dmlc_core_tpu_torch import telemetry


# -- open-loop load generator (scheduled arrivals, intended-time clock) --
def _percentiles(h) -> dict:
    return {"p50": h.quantile(0.50), "p99": h.quantile(0.99),
            "p999": h.quantile(0.999),
            "mean": round(h.sum / h.count, 1) if h.count else 0.0,
            "count": h.count}


def open_loop(request_fn, qps: float, duration_s: float, *,
              max_inflight: int = 16, shed_after_ms: float = 0.0,
              phases=None) -> dict:
    """Drive ``request_fn`` at a scheduled arrival rate and time each
    request from its intended start (coordinated-omission safe).

    Arrival ``i`` is due at ``t0 + i/qps`` whether or not the system
    keeps up: ``intended_us`` charges the wait a stall imposes on the
    arrivals queued behind it, ``service_us`` is the send-to-response
    clock that hides it; both are returned. ``phases`` ([(qps, seconds),
    ...]) overrides ``qps``/``duration_s`` for ramps. ``max_inflight``
    worker threads bound concurrency; with ``shed_after_ms`` > 0 an
    arrival already later than that is counted shed, not issued.
    ``request_fn`` returns truthy on success; an exception is an error.
    Returns achieved/offered QPS, counts, and p50/p99/p999/mean of both
    clocks (us)."""
    phases = list(phases) if phases else [(float(qps), float(duration_s))]
    offsets = []
    base = 0.0
    for ph_qps, ph_dur in phases:
        n = max(int(ph_qps * ph_dur), 0)
        offsets.extend(base + i / ph_qps for i in range(n))
        base += ph_dur
    intended = telemetry.Histogram("rig_intended_us", {})
    service = telemetry.Histogram("rig_service_us", {})
    lock = threading.Lock()
    state = {"next": 0, "done": 0, "errors": 0, "shed": 0,
             "max_late_ms": 0.0}
    t0 = time.monotonic() + 0.05  # every worker sees the same epoch

    req_c = telemetry.counter("rig_requests_total", {"mode": "open"})
    err_c = telemetry.counter("rig_errors_total", {"mode": "open"})
    shed_c = telemetry.counter("rig_shed_total", {"mode": "open"})
    t_int = telemetry.histogram("rig_intended_us")
    t_srv = telemetry.histogram("rig_service_us")

    def worker():
        while True:
            with lock:
                i = state["next"]
                if i >= len(offsets):
                    return
                state["next"] = i + 1
            due = t0 + offsets[i]
            now = time.monotonic()
            if now < due:
                time.sleep(due - now)
                now = time.monotonic()
            late_ms = (now - due) * 1e3
            with lock:
                state["max_late_ms"] = max(state["max_late_ms"], late_ms)
            if shed_after_ms and late_ms > shed_after_ms:
                with lock:
                    state["shed"] += 1
                shed_c.inc()
                continue
            t_issue = time.monotonic()
            try:
                ok = request_fn()
            except Exception:  # noqa: BLE001 - an error is the datum
                ok = False
            t_done = time.monotonic()
            intended.observe((t_done - due) * 1e6)
            service.observe((t_done - t_issue) * 1e6)
            t_int.observe((t_done - due) * 1e6)
            t_srv.observe((t_done - t_issue) * 1e6)
            req_c.inc()
            with lock:
                state["done"] += 1
                if not ok:
                    state["errors"] += 1

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(max(1, max_inflight))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if state["errors"]:
        err_c.inc(state["errors"])
    span = max(time.monotonic() - t0, 1e-9)
    return {
        "mode": "open",
        "offered_qps": round(len(offsets) / max(base, 1e-9), 1),
        "achieved_qps": round(state["done"] / span, 1),
        "duration_s": round(span, 3),
        "arrivals": len(offsets),
        "completed": state["done"],
        "errors": state["errors"],
        "shed": state["shed"],
        "max_inflight": max_inflight,
        "max_lateness_ms": round(state["max_late_ms"], 1),
        "intended_us": _percentiles(intended),
        "service_us": _percentiles(service),
    }


def closed_loop(request_fn, workers: int, duration_s: float) -> dict:
    """``workers`` callers issuing back to back for ``duration_s``: the
    rate sinks to what the system serves and queueing is never observed.
    The result has :func:`open_loop`'s shape, without the intended clock
    (a closed loop has no schedule to be late against)."""
    service = telemetry.Histogram("rig_service_us", {})
    lock = threading.Lock()
    state = {"done": 0, "errors": 0}
    deadline = time.monotonic() + duration_s
    req_c = telemetry.counter("rig_requests_total", {"mode": "closed"})
    err_c = telemetry.counter("rig_errors_total", {"mode": "closed"})

    def worker():
        while time.monotonic() < deadline:
            t_issue = time.monotonic()
            try:
                ok = request_fn()
            except Exception:  # noqa: BLE001 - an error is the datum
                ok = False
            service.observe((time.monotonic() - t_issue) * 1e6)
            req_c.inc()
            with lock:
                state["done"] += 1
                if not ok:
                    state["errors"] += 1
                    err_c.inc()

    t0 = time.monotonic()
    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(max(1, workers))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    span = max(time.monotonic() - t0, 1e-9)
    return {
        "mode": "closed",
        "achieved_qps": round(state["done"] / span, 1),
        "duration_s": round(span, 3),
        "completed": state["done"],
        "errors": state["errors"],
        "workers": workers,
        "service_us": _percentiles(service),
    }


def http_request_fn(url: str, timeout_s: float = 10.0, *,
                    method: str = "GET", body: Optional[bytes] = None,
                    headers: Optional[dict] = None, payload_fn=None,
                    on_status=None):
    """A request function for :func:`open_loop`/:func:`closed_loop`:
    ``method`` against ``url`` over a persistent connection per thread
    (reconnected after an error), True on a fully read 2xx. POST bodies
    come from ``payload_fn()`` per request, else ``body``;
    ``on_status(status)`` sees every completed response's status."""
    parsed = urllib.parse.urlsplit(url)
    path = parsed.path or "/"
    if parsed.query:
        path += "?" + parsed.query
    tls = threading.local()

    def request() -> bool:
        conn = getattr(tls, "conn", None)
        if conn is None:
            conn = http.client.HTTPConnection(parsed.hostname, parsed.port,
                                              timeout=timeout_s)
            tls.conn = conn
        try:
            payload = payload_fn() if payload_fn is not None else body
            conn.request(method, path, payload, headers or {})
            resp = conn.getresponse()
            resp.read()
            if on_status is not None:
                on_status(resp.status)
            return 200 <= resp.status < 300
        except Exception:
            try:
                conn.close()
            finally:
                tls.conn = None
            raise

    return request


def parse_corpus_spec(spec: str) -> dict:
    """``"libsvm:rows=4,features=64,nnz=8,seed=3"`` -> option dict:
    ``<fmt>[:k=v,...]`` with fmt libsvm|csv, ``rows`` a payload
    (``rows_max`` > ``rows`` makes sizes ragged), ``features`` the id
    space, ``nnz`` a row, ``seed``. Unknown keys are an error: a typo must
    not change the traffic."""
    fmt, _, tail = spec.partition(":")
    fmt = fmt.strip().lower()
    if fmt not in ("libsvm", "csv"):
        raise ValueError(f"corpus spec {spec!r}: fmt must be libsvm|csv")
    out = {"fmt": fmt, "rows": 4, "rows_max": 0, "features": 64,
           "nnz": 8, "seed": 0}
    for tok in tail.split(","):
        if not tok.strip():
            continue
        key, sep, val = tok.partition("=")
        key = key.strip()
        if not sep or key not in ("rows", "rows_max", "features", "nnz",
                                  "seed"):
            raise ValueError(f"corpus spec {spec!r}: bad token {tok!r}")
        out[key] = int(val)
    if out["rows"] <= 0 or out["features"] <= 0 or out["nnz"] <= 0:
        raise ValueError(f"corpus spec {spec!r}: rows/features/nnz "
                         "must be positive")
    return out


def score_payload_fn(spec: str):
    """``(payload_fn, content_type)`` generating request bodies from a
    corpus spec (:func:`parse_corpus_spec`). Request ``i`` (a counter of
    this function's) always gets the same payload for the same spec, the
    reference rig's bytes; with ``rows_max`` sizes cycle between ``rows``
    and ``rows_max``."""
    opts = parse_corpus_spec(spec)
    counter = [0]
    counter_lock = threading.Lock()
    ctype = ("application/x-libsvm" if opts["fmt"] == "libsvm"
             else "text/csv")

    def payload() -> bytes:
        with counter_lock:
            i = counter[0]
            counter[0] += 1
        rng = random.Random((opts["seed"] << 20) ^ i)
        rows = opts["rows"]
        if opts["rows_max"] > rows:
            rows += i % (opts["rows_max"] - rows + 1)
        lines = []
        for _ in range(rows):
            if opts["fmt"] == "libsvm":
                ids = rng.sample(range(opts["features"]),
                                 min(opts["nnz"], opts["features"]))
                feats = " ".join(f"{j}:{rng.uniform(-1, 1):.4f}"
                                 for j in sorted(ids))
                lines.append(f"{rng.randint(0, 1)} {feats}")
            else:
                lines.append(",".join(f"{rng.uniform(-1, 1):.4f}"
                                      for _ in range(opts["features"])))
        return ("\n".join(lines) + "\n").encode()

    return payload, ctype


# -- clients: one process a measurement ----------------------------------
def run_parse_client(args) -> int:
    """Parse ``--uri`` ``--reps`` times; print rows/s (best pass), this
    process's CPU seconds over the passes and its io_/parse_ counters and
    range-scheduler gauges and histograms."""
    from dmlc_core_tpu_torch.io.native import NativeParser

    best = None
    rows = 0
    cpu0 = os.times()
    wall0 = time.time()
    for _ in range(max(args.reps, 1)):
        t0 = time.time()
        got = 0
        with NativeParser(args.uri, nthread=args.nthread,
                          fmt=args.fmt) as p:
            for blk in p:
                got += blk.num_rows
        dt = time.time() - t0
        rows = got
        best = dt if best is None else min(best, dt)
    cpu1 = os.times()
    total_wall = time.time() - wall0
    snap = telemetry.snapshot(native=True)
    counters = {}
    for c in snap["counters"]:
        counters[c["name"]] = counters.get(c["name"], 0) + c["value"]
    gauges = {g["name"]: g["value"] for g in snap["gauges"]}
    hists = {h["name"]: {"count": h["count"], "sum": h["sum"]}
             for h in snap["histograms"]
             if h["name"].startswith("io_range")}
    print(json.dumps({
        "rows": rows, "best_dt": best, "total_dt": round(total_wall, 4),
        "rows_per_sec": round(rows / best, 1) if best else 0.0,
        "cpu_s": round((cpu1.user - cpu0.user)
                       + (cpu1.system - cpu0.system)
                       + (cpu1.children_user - cpu0.children_user)
                       + (cpu1.children_system - cpu0.children_system),
                       3),
        "counters": {k: v for k, v in counters.items()
                     if k.startswith(("io_", "parse_"))},
        "gauges": {k: v for k, v in gauges.items()
                   if k.startswith("io_range")},
        "range_hists": hists,
    }))
    return 0


def run_fetch_client(args) -> int:
    """Read ``--uri`` whole; print its sha256 and length."""
    from dmlc_core_tpu_torch.io.native import NativeStream
    t0 = time.time()
    with NativeStream(args.uri, "r") as s:
        data = s.read_all()
    print(json.dumps({"sha256": hashlib.sha256(data).hexdigest(),
                      "bytes": len(data),
                      "dt": round(time.time() - t0, 4)}))
    return 0


def run_loadgen(args) -> int:
    """Open- (default) or closed-loop HTTP load against ``--url``; prints
    the result JSON. ``--score-corpus`` POSTs generated payloads,
    ``--body-file`` a fixed body."""
    if args.score_corpus:
        payload_fn, ctype = score_payload_fn(args.score_corpus)
        fn = http_request_fn(args.url, args.timeout_s, method="POST",
                             headers={"Content-Type": ctype},
                             payload_fn=payload_fn)
    elif args.body_file:
        with open(args.body_file, "rb") as f:
            body = f.read()
        fn = http_request_fn(
            args.url, args.timeout_s, method=args.method, body=body,
            headers={"Content-Type": args.content_type}
            if args.content_type else None)
    else:
        fn = http_request_fn(args.url, args.timeout_s, method=args.method)
    if args.closed_loop:
        out = closed_loop(fn, args.workers, args.duration_s)
    else:
        out = open_loop(fn, args.qps, args.duration_s,
                        max_inflight=args.workers,
                        shed_after_ms=args.shed_after_ms)
    print(json.dumps(out))
    return 0


def run_origin(args) -> int:
    """The ``origin`` subcommand: :func:`remote_lane.run_origin`."""
    from dmlc_core_tpu_torch.bench.remote_lane import run_origin as run
    return run(args)


def add_origin_args(o) -> None:
    """The ``origin`` subcommand's flags, the reference rig's, with its
    defaults (``bench.remote_lane``'s own ``origin`` takes the same)."""
    o.add_argument("--backend", required=True,
                   choices=("s3", "azure", "webhdfs", "http"))
    o.add_argument("--corpus", action="append", default=[],
                   help="key=@path or key=<size>:<seed>; repeatable")
    o.add_argument("--port", type=int, default=0)
    o.add_argument("--workers", type=int, default=2)
    o.add_argument("--backlog", type=int, default=128)
    o.add_argument("--latency-ms", type=int, default=0)
    o.add_argument("--latency-block", type=int, default=256 * 1024)
    o.add_argument("--stall-every", type=int, default=0)
    o.add_argument("--stall-seconds", type=float, default=3.0)
    o.add_argument("--reset-every", type=int, default=0)
    o.add_argument("--get-500-every", type=int, default=0)
    o.add_argument("--get-truncate-every", type=int, default=0)
    o.add_argument("--slow-every", type=int, default=0)
    o.add_argument("--slow-ms", type=int, default=0)
    o.add_argument("--ignore-range", action="store_true")
    o.add_argument("--bad-content-range-every", type=int, default=0)
    o.add_argument("--ttl", type=float, default=600.0,
                   help="exit after this many seconds: an orphaned origin "
                        "never outlives its run")


def main(argv=None) -> int:
    """Command line: the rig's ``origin``, ``parse-client``,
    ``fetch-client`` and ``loadgen`` subcommands."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    o = sub.add_parser("origin", help="serve a mock backend out of "
                                      "process (pre-forked workers)")
    add_origin_args(o)
    o.set_defaults(fn=run_origin)
    pc = sub.add_parser("parse-client",
                        help="parse a URI in this fresh process; print "
                             "JSON timing + telemetry")
    pc.add_argument("--uri", required=True)
    pc.add_argument("--fmt", default="libsvm")
    pc.add_argument("--nthread", type=int, default=0)
    pc.add_argument("--reps", type=int, default=1)
    pc.set_defaults(fn=run_parse_client)
    fc = sub.add_parser("fetch-client",
                        help="raw-read a URI; print JSON sha256+bytes")
    fc.add_argument("--uri", required=True)
    fc.set_defaults(fn=run_fetch_client)
    lg = sub.add_parser("loadgen", help="open/closed-loop HTTP load")
    lg.add_argument("--url", required=True)
    lg.add_argument("--qps", type=float, default=100.0)
    lg.add_argument("--duration-s", type=float, default=5.0)
    lg.add_argument("--workers", type=int, default=16)
    lg.add_argument("--shed-after-ms", type=float, default=0.0)
    lg.add_argument("--timeout-s", type=float, default=10.0)
    lg.add_argument("--closed-loop", action="store_true")
    lg.add_argument("--method", default="GET",
                    help="HTTP method (POST needs --body-file or "
                         "--score-corpus)")
    lg.add_argument("--body-file", default="",
                    help="fixed request body read from this file")
    lg.add_argument("--content-type", default="",
                    help="Content-Type for --body-file requests")
    lg.add_argument("--score-corpus", default="",
                    help="generate POST payloads from a corpus spec, "
                         "e.g. libsvm:rows=4,features=64,nnz=8,seed=3")
    lg.set_defaults(fn=run_loadgen)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
