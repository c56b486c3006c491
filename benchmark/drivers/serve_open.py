"""Driver ``serve_open``: the port's scoring server out of process
(``python -m dmlc_core_tpu_torch.serving``), scored over HTTP by an open
loop at the fixed rate of the traffic file.

Set-up draws the served model from the seed, writes it with the port's
``save_model``, starts the server with the mix's arguments, builds every
request's libsvm payload from the configuration's generator (sizes a
fixed multiset, ordered by the seed), opens the loop's connections, and
sends one request alone for each padded shape the window's micro-batches
can reach. The window's arrival ``i`` is due ``i / rate`` seconds after
it opens; each latency runs from that due time to the reply, and every
one is kept. After the close every reply is waited for (up to
``answer_wait_s``) and every score is held against the reference. The
server is stopped in a ``finally``.

The harness process never touches the card: the server is the one
process on it. ``memory_peak_bytes`` is what ``nvidia-smi`` reads the
server's process to hold after the window (the caching allocator keeps
its peak reserved).
"""

from __future__ import annotations

import gc
import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time
from typing import List, Optional

import numpy as np

# the server's spans that name an idle gap of the card
SERVE_SPANS = ("serve.batch", "serve.parse", "serve.forward", "serve.reply")
FAILED_MS = 60e3   # the latency charged to a request that got no score
CTYPE = "application/x-libsvm"
SWITCH_INTERVAL_S = 0.0005


# -- the open loop (a copy of bench/loadrig.open_loop, every latency kept) --
class Client:
    """One keep-alive connection a worker thread."""

    def __init__(self, port: int, timeout_s: float):
        self.port = port
        self.timeout_s = timeout_s
        self.conn: Optional[http.client.HTTPConnection] = None

    def connect(self) -> None:
        self.conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                               timeout=self.timeout_s)
        self.conn.connect()

    def post(self, path: str, body: bytes, ctype: str):
        """(status, body); (None, error text) when no reply came."""
        try:
            if self.conn is None:
                self.connect()
            self.conn.request("POST", path, body,
                              {"Content-Type": ctype})
            resp = self.conn.getresponse()
            return resp.status, resp.read()
        except (OSError, http.client.HTTPException) as e:
            if self.conn is not None:
                self.conn.close()
            self.conn = None
            return None, repr(e).encode()


def open_loop(port: int, payloads: List[bytes], rate: float,
              max_inflight: int, wait_s: float, ctype: str) -> dict:
    """Arrival ``i`` is due at ``t0 + i / rate`` whether or not the server
    keeps up; ``max_inflight`` threads send. Returns each request's
    latency from its due time (s), status and body, and the loop's
    lateness."""
    n = len(payloads)
    lat = np.full(n, np.nan)
    status: list = [None] * n
    bodies: list = [b""] * n
    lock = threading.Lock()
    state = {"next": 0, "max_late_s": 0.0}
    clients = [Client(port, wait_s) for _ in range(max_inflight)]
    for c in clients:
        c.connect()
    t0 = time.perf_counter() + 0.05
    deadline = t0 + n / rate + wait_s

    def worker(client: Client) -> None:
        while True:
            with lock:
                i = state["next"]
                if i >= n:
                    return
                state["next"] = i + 1
            due = t0 + i / rate
            now = time.perf_counter()
            if now < due:
                time.sleep(due - now)
                now = time.perf_counter()
            if now > deadline:
                return
            with lock:
                state["max_late_s"] = max(state["max_late_s"], now - due)
            st, body = client.post("/score", payloads[i], ctype)
            lat[i] = time.perf_counter() - due
            status[i], bodies[i] = st, body

    threads = [threading.Thread(target=worker, args=(c,), daemon=True)
               for c in clients]
    # the load generator's own pauses would count as the server's
    # latency: no cyclic collection of the harness's objects, and a short
    # switch interval so a thread due to send gets the interpreter lock
    # promptly (the server is another process, untouched)
    gc.collect()
    gc.freeze()
    gc.disable()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(SWITCH_INTERVAL_S)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(max(deadline - time.perf_counter(), 0) + 5)
    finally:
        sys.setswitchinterval(switch)
        gc.enable()
        gc.unfreeze()
    for c in clients:
        if c.conn is not None:
            c.conn.close()
    return {"t0": t0, "latency_s": lat, "status": status, "body": bodies,
            "max_late_s": state["max_late_s"]}


def nearest_rank(values: np.ndarray, q: float) -> float:
    """The ``q`` quantile by nearest rank: a latency one request had."""
    v = np.sort(values)
    return float(v[max(int(np.ceil(q * len(v))) - 1, 0)])


# -- the server ---------------------------------------------------------------
def scrape(port: int) -> dict:
    """(sum, count) of every unlabeled histogram on ``/metrics``."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", "/metrics")
        text = conn.getresponse().read().decode()
    finally:
        conn.close()
    sums, counts = {}, {}
    for line in text.splitlines():
        name, _, value = line.partition(" ")
        if name.endswith("_sum"):
            sums[name[:-4]] = float(value)
        elif name.endswith("_count"):
            counts[name[:-6]] = float(value)
    return {k: (sums[k], counts.get(k, 0.0)) for k in sums}


def _smi(query: str) -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", query, "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return ""


def gpu_memory_of(pid: int) -> int:
    """Bytes ``nvidia-smi`` reads process ``pid`` to hold on the card, or,
    where it lists no process (a container's pids), the card's used
    memory: the server is the one process on it."""
    for line in _smi("--query-compute-apps=pid,used_memory").splitlines():
        parts = [p.strip() for p in line.split(",")]
        if len(parts) == 2 and parts[0] == str(pid):
            return int(float(parts[1]) * (1 << 20))
    used = _smi("--query-gpu=memory.used").split()
    return int(float(used[0]) * (1 << 20)) if used else 0


def start_server(ctx, model_path: str, log_path: str,
                 profile_out: Optional[str]):
    args = ["--model-uri", model_path, *ctx.traffic["server_args"],
            "--device", ctx.device]
    if profile_out:
        cmd = [sys.executable, os.path.join(ctx.found["bench_dir"],
                                            "serve_child.py"),
               profile_out, *args]
    else:
        cmd = [sys.executable, "-m", "dmlc_core_tpu_torch.serving", *args]
    log = open(log_path, "w")
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=log,
                            text=True, cwd=ctx.found["root"])
    log.close()
    deadline = time.time() + 300
    while time.time() < deadline:
        line = proc.stdout.readline()
        if line.startswith("SERVE_READY") or not line:
            break
    if not line.startswith("SERVE_READY"):
        stop_server(proc)
        raise RuntimeError("the scoring server never came ready; its log: "
                           + open(log_path).read()[-2000:])
    return proc, int(line.split("port=")[1].split()[0])


def stop_server(proc) -> None:
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(30)
    proc.stdout.close()


def wait_for(path: str, proc, timeout_s: float) -> None:
    """Until the server's wrapper has written ``path``."""
    deadline = time.time() + timeout_s
    while not os.path.exists(path):
        if proc.poll() is not None or time.time() > deadline:
            raise RuntimeError(f"the server never wrote {path}")
        time.sleep(0.05)


def warm_sizes(buckets, min_nnz: int, nnz_per_row: int,
               rows_min: int) -> List[int]:
    """One row count for each (rows bucket, nnz bucket) the server pads a
    micro-batch of ``rows_min`` to ``buckets[-1]`` rows to."""
    seen, out = set(), []
    for r in range(rows_min, buckets[-1] + 1):
        rb = next(b for b in buckets if r <= b)
        nb = 1
        while nb < max(min_nnz, r * nnz_per_row):
            nb *= 2
        if (rb, nb) not in seen:
            seen.add((rb, nb))
            out.append(r)
    return out


def build_payloads(ctx, gen, n: int):
    """``n`` requests' libsvm bodies of the configuration's rows: sizes
    a fixed multiset (``rows_min`` .. ``rows_max`` in turn), ordered by
    the seed; their row offsets; the rows' text."""
    tf = ctx.traffic
    span = tf["rows_max"] - tf["rows_min"] + 1
    sizes = np.random.default_rng(ctx.seed).permutation(
        tf["rows_min"] + np.arange(n) % span)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    text = gen.text_rows(int(offsets[-1]), ctx.seed, "libsvm")
    return ([text[offsets[i]:offsets[i + 1]].tobytes() for i in range(n)],
            offsets, text)


def warm_shapes(ctx, gen, port: int, text: np.ndarray) -> None:
    """One request alone for each padded shape the window can reach."""
    tf = ctx.traffic
    args = tf["server_args"]
    buckets = [int(b) for b in
               args[args.index("--rows-buckets") + 1].split(",")]
    warm = Client(port, tf["answer_wait_s"])
    try:
        for r in warm_sizes(buckets, tf["min_nnz_bucket"], gen.NNZ_PER_ROW,
                            tf["rows_min"]):
            st, body = warm.post("/score", text[:r].tobytes(), CTYPE)
            if st != 200:
                raise RuntimeError(f"warm-up request of {r} rows: {st} "
                                   f"{body[:200]!r}")
    finally:
        if warm.conn is not None:
            warm.conn.close()


# -- one run ------------------------------------------------------------------
def run(ctx) -> dict:
    from benchmark import correct, trace as tr
    cfg, tf = ctx.config, ctx.traffic
    gen = ctx.part("datagen", cfg["data"]["generator"])
    model = ctx.part("models", cfg["model"]["kind"])
    rate = float(tf["rate_qps"])
    n = int(round(rate * ctx.seconds))
    payloads, offsets, text = build_payloads(ctx, gen, n)
    rows = int(offsets[-1])

    d = ctx.cache("serve")
    model_path = os.path.join(d, "model.ckpt")
    params = model.serving_params(cfg, ctx.seed)
    model.save_serving(model_path, cfg, params)
    profile_out = os.path.join(d, "profile.json") if ctx.trace else None
    for stale in (profile_out, f"{profile_out}.started"):
        if profile_out and os.path.exists(stale):
            os.unlink(stale)
    ctx.mark("payloads_and_model")
    proc, port = start_server(ctx, model_path, os.path.join(d, "server.log"),
                              profile_out)
    ctx.mark("server_ready")
    try:
        warm_shapes(ctx, gen, port, text)
        before = scrape(port)
        setup_s = ctx.mark("warm_up")
        ctx.report_setup()
        if profile_out:
            proc.send_signal(signal.SIGUSR1)
            wait_for(profile_out + ".started", proc, 120)
        loop = open_loop(port, payloads, rate, tf["max_inflight"],
                         tf["answer_wait_s"], CTYPE)
        if profile_out:
            proc.send_signal(signal.SIGUSR2)
        after = scrape(port)
        peak = gpu_memory_of(proc.pid) if ctx.device == "cuda" else 0
        prof = None
        if profile_out:
            wait_for(profile_out, proc, 120)
            with open(profile_out) as f:
                prof = json.load(f)
    finally:
        stop_server(proc)

    lat = loop["latency_s"]
    ok = np.array([s == 200 for s in loop["status"]])
    answered = np.array([s is not None for s in loop["status"]])
    lat_ms = np.where(ok, lat * 1e3, np.fmax(np.nan_to_num(lat * 1e3),
                                             FAILED_MS))
    ref = ctx.part("reference", cfg["model"]["kind"]).scores(
        gen.arrays(rows, ctx.seed), params, cfg["model"]["objective"])
    served, expect, bad_reply = [], [], 0
    for i in np.flatnonzero(ok):
        got = json.loads(loop["body"][i]).get("scores")
        want = ref[offsets[i]:offsets[i + 1]]
        if got is None or len(got) != len(want):
            bad_reply += 1
            continue
        served.append(np.asarray(got))
        expect.append(want)
    gap = correct.score_gap(served, expect) if served else float("inf")
    out = {"metrics": {"setup_s": setup_s,
                       "serve_p50_ms": nearest_rank(lat_ms, 0.50),
                       "serve_p99_ms": nearest_rank(lat_ms, 0.99)},
           "attempted": n, "failed": int(n - ok.sum()),
           "memory_peak_bytes": peak,
           "ok": bool(answered.all()) and bad_reply == 0,
           "checks": correct.checks({"score_gap": gap}, ctx.limits())}
    print(f"serve: {int(ok.sum())} of {n} scored, p99 "
          f"{out['metrics']['serve_p99_ms']:.3f} ms, loop at most "
          f"{loop['max_late_s'] * 1e3:.3f} ms late, {bad_reply} bad "
          f"replies", file=sys.stderr)
    if prof is not None:
        hist = {k: (v[0] - before.get(k, (0.0, 0.0))[0],
                    v[1] - before.get(k, (0.0, 0.0))[1])
                for k, v in after.items()}
        out["trace"] = tr.TraceData(prof["window_s"], prof["busy_s"],
                                    prof["top_ops"], prof["idle_gaps"],
                                    {}, hist, {})
    return out
