"""The remote lane (``bench.py:303-466``) and its out-of-process origins
(``scripts/loadrig.py:66-247``).

The bench's libsvm bytes (up to ``cap_bytes``, whole lines) are served by
a mock S3 origin in processes of its own: one listener, ``workers``
pre-forked processes accepting from it, ``latency_ms`` injected before
every response head and every ``latency_block`` body bytes (a
latency-bandwidth-capped link). Every remote pass runs in its own
``bench.loadrig parse-client`` process. Reported: local, sequential and
ranged rows/s, the origin's ceiling with no injected latency, the range
scheduler's counters, and a CPU attribution of the ranged pass (client
against origin seconds, from /proc).

The origin child is this module run as a program (or ``python -m
dmlc_core_tpu_torch.bench.loadrig origin``, the same flags):

    python -m dmlc_core_tpu_torch.bench.remote_lane origin --backend s3 \\
        --corpus KEY=@PATH [--workers N] [--latency-ms MS] ...

with the reference rig's shaping and fault knobs (``--stall-every``,
``--reset-every``, ``--get-500-every``, ``--get-truncate-every``,
``--slow-every``, ``--ignore-range``, ``--bad-content-range-every``, ...).
It serves the checkout's own mock backends (``tests/mock_origin.py``);
the bench process imports that module only for its ``OriginConfig``.
When up it prints ``RIG_READY {"backend", "port", "pids", "env",
"uri"}``: the client env and the URI template (``{key}``) a client needs.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import select
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import types
from typing import Optional

from dmlc_core_tpu_torch.base import REPO_ROOT
from dmlc_core_tpu_torch.io.native import NativeParser


# -- the origin child ------------------------------------------------------
def _mock_origin():
    """The checkout's ``tests.mock_origin`` (a ``tests`` package installed
    elsewhere must not shadow it)."""
    here = os.path.join(REPO_ROOT, "tests")
    if here not in list(getattr(sys.modules.get("tests"), "__path__", [])):
        sys.modules["tests"] = types.ModuleType("tests")
        sys.modules["tests"].__path__ = [here]
    from tests import mock_origin
    return mock_origin


def _child_dies_with_parent() -> None:
    """PR_SET_PDEATHSIG: an orphaned origin worker never outlives its
    launcher (Linux; best effort)."""
    try:
        import ctypes
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)
    except (OSError, AttributeError):
        pass


def _ttl_exit(deadline: float) -> None:
    while time.monotonic() < deadline:
        time.sleep(1.0)
    os._exit(0)


def run_origin(args) -> int:
    """Bind, pre-fork ``--workers`` servers on the one listener, print
    ``RIG_READY``, serve until killed or ``--ttl`` runs out."""
    mock_origin = _mock_origin()
    config = mock_origin.OriginConfig(
        latency_ms=args.latency_ms, latency_block=args.latency_block,
        stall_every=args.stall_every, stall_seconds=args.stall_seconds,
        reset_every=args.reset_every, get_500_every=args.get_500_every,
        get_truncate_every=args.get_truncate_every,
        slow_every=args.slow_every, slow_ms=args.slow_ms,
        ignore_range=args.ignore_range,
        bad_content_range_every=args.bad_content_range_every,
        backlog=args.backlog, workers=args.workers)
    corpus = mock_origin.build_corpus(args.corpus)
    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    listener.bind(("127.0.0.1", args.port))
    listener.listen(config.backlog)
    port = listener.getsockname()[1]

    deadline = time.monotonic() + args.ttl
    pids = []
    for _ in range(max(args.workers, 1)):
        pid = os.fork()
        if pid == 0:
            _child_dies_with_parent()
            state, handler_cls = mock_origin.state_and_handler(args.backend)
            if hasattr(state, "port"):
                state.port = port
            mock_origin.load_corpus(args.backend, state, corpus)
            server = mock_origin.make_server(handler_cls, state, config,
                                             sock=listener)
            threading.Thread(target=_ttl_exit, args=(deadline,),
                             daemon=True).start()
            try:
                server.serve_forever()
            except KeyboardInterrupt:
                pass
            os._exit(0)
        pids.append(pid)

    def _term(signum, frame):
        for p in pids:
            try:
                os.kill(p, signal.SIGTERM)
            except OSError:
                pass
        raise SystemExit(0)

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    print("RIG_READY " + json.dumps({
        "backend": args.backend, "port": port, "pids": pids,
        "env": mock_origin.client_env(args.backend, port),
        "uri": mock_origin.uri_for(args.backend, port, "{key}")}),
        flush=True)
    try:
        while pids and time.monotonic() < deadline:
            try:
                done, _ = os.waitpid(-1, os.WNOHANG)
            except ChildProcessError:
                break
            if done:
                pids.remove(done)
            else:
                time.sleep(0.2)
    finally:
        _term(None, None)
    return 0


class OriginProcess:
    """A spawned origin (:func:`spawn_origin`): ``port``, worker ``pids``
    (for CPU attribution), :meth:`env` and :meth:`uri` for clients,
    :meth:`close`."""

    def __init__(self, proc: subprocess.Popen, ready: dict):
        self.proc = proc
        self.backend = ready["backend"]
        self.port = ready["port"]
        self.pids = list(ready["pids"])
        self._env = ready["env"]
        self._uri = ready["uri"]

    def env(self) -> dict:
        """Env vars a client process needs to reach this origin."""
        return dict(self._env)

    def uri(self, key: str) -> str:
        """Client URI of a corpus key."""
        return self._uri.replace("{key}", key)

    def cpu_seconds(self) -> float:
        """utime + stime of the launcher and every live worker (0.0 where
        /proc is missing)."""
        total = 0
        tick = os.sysconf("SC_CLK_TCK")
        for pid in [self.proc.pid] + self.pids:
            try:
                with open(f"/proc/{pid}/stat") as f:
                    rest = f.read().rsplit(")", 1)[1].split()
                total += int(rest[11]) + int(rest[12])
            except (OSError, IndexError, ValueError):
                pass
        return total / tick

    def close(self) -> None:
        """Terminate the origin's process tree."""
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=10)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def spawn_origin(backend: str, corpus_specs, config=None,
                 timeout_s: float = 30.0) -> OriginProcess:
    """Start the origin child and wait for its ``RIG_READY``.
    ``corpus_specs``: ``key=@path`` / ``key=size:seed`` strings;
    ``config``: a ``tests/mock_origin.py`` ``OriginConfig`` (default: its
    defaults, one worker), whose knobs become the child's flags."""
    config = config or _mock_origin().OriginConfig()
    cmd = [sys.executable, "-m", "dmlc_core_tpu_torch.bench.remote_lane",
           "origin", "--backend", backend]
    for spec in corpus_specs:
        cmd.extend(["--corpus", spec])
    cmd.extend(config.cli_args())
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True,
                            cwd=REPO_ROOT)
    deadline = time.monotonic() + timeout_s
    # select-gated reads: a wedged child that neither prints nor exits
    # surfaces as the timeout, not a readline hang
    while time.monotonic() < deadline:
        ready, _, _ = select.select([proc.stdout], [], [], 0.5)
        if ready:
            line = proc.stdout.readline()
            if line.startswith("RIG_READY "):
                return OriginProcess(proc, json.loads(line.split(" ", 1)[1]))
        if proc.poll() is not None:
            raise RuntimeError(f"origin died before RIG_READY "
                               f"(rc={proc.returncode})")
    proc.kill()
    proc.wait()
    raise RuntimeError("origin did not become ready in time")


# -- the lane --------------------------------------------------------------
def remote_lane_probe(path: str, nthread: int, latency_ms: int = 20,
                      cap_bytes: int = 8 << 20, concurrency: int = 12,
                      sampler=None) -> dict:
    """Sequential vs ranged vs local parse rates of the same bytes behind
    an out-of-process origin (see the module docstring)."""
    with open(path, "rb") as f:
        blob = f.read(cap_bytes)
    blob = blob[: blob.rfind(b"\n") + 1]  # whole lines only
    lane_rows = blob.count(b"\n")
    key = "bench/remote/data.libsvm"
    # at least two origin workers, more when the host has the cores
    workers = max(2, os.cpu_count() or 2)
    # one connection tops out at latency_block / latency_ms: a sequential
    # pass pays about 8 bursts whatever the payload's size
    latency_block = max(len(blob) // 8, 64 << 10)

    def local_pass(u):
        t0 = time.time()
        got = 0
        with NativeParser(u, nthread=nthread, fmt="libsvm") as p:
            for blk in p:
                got += blk.num_rows
        dt = time.time() - t0
        if got != lane_rows:
            raise RuntimeError(f"row count mismatch: {got} != {lane_rows}")
        return lane_rows / dt

    def client_pass(origin, env_extra, reps):
        env = dict(os.environ, **origin.env())
        env.update({k: str(v) for k, v in env_extra.items()})
        out = subprocess.run(
            [sys.executable, "-m", "dmlc_core_tpu_torch.bench.loadrig",
             "parse-client", "--uri", origin.uri(key), "--fmt", "libsvm",
             "--nthread", str(nthread), "--reps", str(reps)],
            capture_output=True, text=True, timeout=600, env=env,
            cwd=REPO_ROOT)
        if out.returncode != 0:
            raise RuntimeError("parse-client failed: "
                               + (out.stderr or "")[-300:])
        res = json.loads(out.stdout.strip().splitlines()[-1])
        if res["rows"] != lane_rows:
            raise RuntimeError(f"row count mismatch: {res['rows']} != "
                               f"{lane_rows}")
        return res

    ranged_env = {"DMLC_IO_RANGE": "1",
                  "DMLC_IO_RANGE_CONCURRENCY": str(concurrency)}
    origin_config = _mock_origin().OriginConfig
    tmp = tempfile.NamedTemporaryFile(suffix=".libsvm", delete=False)
    try:
        tmp.write(blob)
        tmp.close()
        spec = [f"{key}=@{tmp.name}"]
        local_rps = max(local_pass(tmp.name) for _ in range(2))
        # the origin's own ceiling: ranged reads with no injected latency
        with spawn_origin("s3", spec,
                          origin_config(workers=workers)) as org:
            ceiling_rps = client_pass(org, ranged_env, 2)["rows_per_sec"]
        with spawn_origin("s3", spec, origin_config(
                workers=workers, latency_ms=latency_ms,
                latency_block=latency_block)) as org:
            if sampler is not None:
                sampler.watch("remote_origin", org.proc.pid, *org.pids)
            seq_rps = client_pass(org, {"DMLC_IO_RANGE": "0"},
                                  2)["rows_per_sec"]
            origin_cpu0 = org.cpu_seconds()
            section = (sampler.section("remote_lane_ranged")
                       if sampler is not None else contextlib.nullcontext())
            with section:
                ranged = client_pass(org, ranged_env, 3)
            origin_cpu = round(org.cpu_seconds() - origin_cpu0, 3)
    finally:
        os.unlink(tmp.name)
    ranged_rps = ranged["rows_per_sec"]
    counters = ranged.get("counters", {})
    gauges = ranged.get("gauges", {})
    hb = ranged.get("range_hists", {}).get("io_range_bytes", {})
    sched = {
        "ranges_issued": int(counters.get("io_range_issued_total", 0)),
        "range_retries": int(counters.get("io_range_retried_total", 0)),
        "degraded_200": int(counters.get("io_range_degraded_200_total", 0)),
        "sched_range_kb": round(
            gauges.get("io_range_sched_bytes", 0) / 1024, 1),
        "sched_concurrency": int(
            gauges.get("io_range_sched_concurrency", 0)),
    }
    if hb.get("count"):
        sched["mean_range_kb"] = round(hb["sum"] / hb["count"] / 1024, 1)
    client_io = {k: int(counters.get(f"io_{k}_total", 0))
                 for k in ("requests", "retries", "timeouts", "giveups")}
    # which side's cores bind the ranged pass
    ncores = os.cpu_count() or 1
    wall = ranged.get("total_dt") or ranged["best_dt"]
    client_busy = ranged["cpu_s"] / wall if wall else 0.0
    origin_busy = origin_cpu / wall if wall else 0.0
    if client_busy + origin_busy >= 0.85 * ncores:
        verdict = ("client_core_saturated" if client_busy >= origin_busy
                   else "origin_core_saturated")
    else:
        verdict = "latency_bound"
    return {
        "bytes": len(blob),
        "rows": lane_rows,
        "latency_ms": latency_ms,
        "local_rows_per_sec": round(local_rps, 1),
        "sequential_rows_per_sec": round(seq_rps, 1),
        "ranged_rows_per_sec": round(ranged_rps, 1),
        "origin_ceiling_rows_per_sec": round(ceiling_rps, 1),
        "ranged_vs_sequential": round(ranged_rps / seq_rps, 2),
        "ranged_vs_local": round(ranged_rps / local_rps, 3),
        "ceiling_vs_local": round(ceiling_rps / local_rps, 3),
        "latency_hidden": round(ranged_rps / ceiling_rps, 3),
        "range_scheduler": sched,
        "client_io_retry": client_io,
        "origin": {
            "out_of_process": True,
            "workers": workers,
            "client_cpu_s": ranged["cpu_s"],
            "origin_cpu_s": origin_cpu,
            "ranged_wall_s": round(wall, 3),
            "ncores": ncores,
            "cpu_attribution": verdict,
        },
    }


def main(argv: Optional[list] = None) -> int:
    """Command line: ``origin`` serves a mock backend out of this checkout's
    ``tests/`` (the remote lane's child process)."""
    from dmlc_core_tpu_torch.bench.loadrig import add_origin_args
    ap = argparse.ArgumentParser(description="serve a mock backend out of "
                                             "process (pre-forked workers)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    add_origin_args(sub.add_parser("origin"))
    return run_origin(ap.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
