"""The mesh lane (``bench.py:1000-1176``): a 2-rank gloo world under the
port's tracker, stepped by :mod:`dmlc_core_tpu_torch.bench.mesh_worker`.

- ``steps_per_sec``: collective steps a second of an uninterrupted world,
  between the first and the last progress beat of rank 0, so the world's
  start (process start, ``import torch``, the rendezvous) is left out;
- ``recovery_s``: SIGKILL one rank of a supervised world mid-run, then
  the wall time from the kill to the first step the relaunched world
  writes: detection, teardown, a fresh coordinator, new processes.

The tracker runs in this process (``rendezvous.run_job`` in mesh mode);
the ranks run on the bench's device and share it over gloo.
"""

from __future__ import annotations

import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

from dmlc_core_tpu_torch.base import REPO_ROOT
from dmlc_core_tpu_torch.bench.datasets import CACHE_DIR
from dmlc_core_tpu_torch.tracker import rendezvous

NWORKERS = 2
DEAD_AFTER_MS = 1000  # the chaos world's liveness timeout


def read_progress(pdir: str, rank: int):
    """(step, pid) from ``rankN.progress``, or None."""
    try:
        with open(os.path.join(pdir, f"rank{rank}.progress")) as f:
            step, pid = f.read().split()
        return int(step), int(pid)
    except (OSError, ValueError):
        return None


def run_world(root: str, tag: str, device: str, steps_by_attempt,
              step_sleep: float, dead_after_ms: int, world_attempts: int,
              watch):
    """One tracked world; ``watch(pdir_of)`` observes it from this thread
    while ``run_job`` owns the tracker's. Every worker is gone when this
    returns."""
    procs_by_attempt = []

    def pdir_of(att: int) -> str:
        d = os.path.join(root, f"{tag}{att}")
        os.makedirs(d, exist_ok=True)
        return d

    def launch(nw, ns, envs, tracker=None):
        att = int(envs.get("DMLC_WORLD_ATTEMPT", "0"))
        n = steps_by_attempt[min(att, len(steps_by_attempt) - 1)]
        env = dict(os.environ)
        env.update({k: str(v) for k, v in envs.items()})
        env.update({"DMLC_ROLE": "worker", "PYTHONPATH": REPO_ROOT,
                    "DMLC_STEP_DEADLINE_MS": str(dead_after_ms)})
        ps = [subprocess.Popen(
            [sys.executable, "-m", "dmlc_core_tpu_torch.bench.mesh_worker",
             pdir_of(att), str(n), str(step_sleep), device],
            env=dict(env, DMLC_TASK_ID=str(i)), cwd=REPO_ROOT,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
            for i in range(nw)]
        procs_by_attempt.append(ps)

        def stop():
            for p in ps:
                if p.poll() is None:
                    p.kill()
        return stop

    errs = []

    def run():
        try:
            rendezvous.run_job(
                NWORKERS, 0, launch, host_ip="127.0.0.1", heartbeat_ms=150,
                dead_after_ms=dead_after_ms, num_shards=2 * NWORKERS,
                mesh=True, world_attempts=world_attempts)
        except Exception as e:  # noqa: BLE001 - raised below
            errs.append(e)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    ok = False
    try:
        out = watch(pdir_of)
        ok = True
    finally:
        # after a successful drive the world finishes cleanly (a worker
        # killed mid-shutdown reads as a lost rank and aborts the run just
        # measured); after a failed one, kill at once
        grace = time.monotonic() + (90 if ok else 0)
        for ps in procs_by_attempt:
            for p in ps:
                if p.poll() is None:
                    try:
                        p.wait(timeout=max(0.0, grace - time.monotonic()))
                    except subprocess.TimeoutExpired:
                        pass
                if p.poll() is None:
                    p.kill()
                    p.wait()
        th.join(timeout=60)
    if errs:
        raise errs[0]
    if th.is_alive():
        raise RuntimeError(f"mesh lane: the {tag} tracker never finished")
    return out


def mesh_lane_probe(device: str, smoke: bool = False) -> dict:
    """``{"steps_per_sec", "recovery_s", "nworkers", "steps",
    "dead_after_ms"}`` (see the module docstring)."""
    os.makedirs(CACHE_DIR, exist_ok=True)
    root = tempfile.mkdtemp(prefix="meshlane_", dir=CACHE_DIR)
    # the tracker runs here: its liveness knobs come from this env
    os.environ.setdefault("DMLC_TRACKER_RECOVER_GRACE_MS", "300")
    steps = 20 if smoke else 60
    try:
        def timed(pdir_of):
            pdir = pdir_of(0)
            beats = []  # (monotonic, step): one entry a step change
            deadline = time.monotonic() + 240
            while time.monotonic() < deadline:
                got = read_progress(pdir, 0)
                if got is not None and (not beats
                                        or got[0] != beats[-1][1]):
                    beats.append((time.monotonic(), got[0]))
                    if got[0] >= steps - 1:
                        break
                time.sleep(0.002)
            if len(beats) < 2 or beats[-1][1] <= beats[0][1]:
                raise RuntimeError(f"mesh lane: no steady window "
                                   f"({beats[:3]}...)")
            (t1, s1), (t2, s2) = beats[0], beats[-1]
            return (s2 - s1) / (t2 - t1)

        steps_per_sec = run_world(root, "steady", device, [steps], 0.0,
                                  2000, 0, timed)

        def chaos(pdir_of):
            p0 = pdir_of(0)
            deadline = time.monotonic() + 240
            while time.monotonic() < deadline:
                got = [read_progress(p0, r) for r in range(NWORKERS)]
                if all(g is not None and g[0] >= 1 for g in got):
                    break
                time.sleep(0.005)
            else:
                raise RuntimeError("mesh lane: attempt 0 never progressed")
            t_kill = time.monotonic()
            os.kill(got[0][1], signal.SIGKILL)
            p1 = pdir_of(1)
            deadline = time.monotonic() + 240
            while time.monotonic() < deadline:
                if any(read_progress(p1, r) is not None
                       for r in range(NWORKERS)):
                    return time.monotonic() - t_kill
                time.sleep(0.005)
            raise RuntimeError("mesh lane: the world never resumed")

        recovery_s = run_world(root, "chaos", device, [100000, 3], 0.05,
                               DEAD_AFTER_MS, 2, chaos)
        return {"steps_per_sec": round(steps_per_sec, 1),
                "recovery_s": round(recovery_s, 3),
                "nworkers": NWORKERS, "steps": steps,
                "dead_after_ms": DEAD_AFTER_MS}
    finally:
        shutil.rmtree(root, ignore_errors=True)
