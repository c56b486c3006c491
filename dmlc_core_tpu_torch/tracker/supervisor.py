"""Worker supervision: detect worker exit, relaunch under the old rank.

reference parity: the YARN AppMaster restarts failed
containers (reference tracker/yarn/src/main/java/.../ApplicationMaster.java)
and the rabit tracker re-links a restarted worker that reconnects with
cmd=recover under its old rank (reference tracker/dmlc_tracker/
tracker.py:312-316). dmlc-core's other launchers only retried a locally
spawned process in-line (local.py:12-49); nothing watched remote workers.

Here supervision is backend-agnostic. A task is (task_id, role,
start(attempt) -> handle) where a handle speaks the tiny Popen-like
protocol `poll() -> Optional[int]` / `terminate()`:

- local: the handle IS a subprocess.Popen
- kubernetes / yarn: `CommandTask` wraps the backend CLI — submit command
  to (re)launch, status command polled for exit (kubectl/yarn CLIs), so
  the same loop supervises containers it cannot signal directly

The supervisor relaunches a failed task with an incremented attempt number
(exported as DMLC_NUM_ATTEMPT, the reference env ABI) up to max_attempts;
the restarted worker is expected to rejoin the rendezvous with
cmd=recover + its old rank (dmlc_core_tpu_torch/tracker/client.py `start(
recover=True)`), which the tracker re-links without disturbing the rest of
the job (tested in tests/test_tracker.py).

Liveness integration (doc/robustness.md "Distributed job liveness") is
two-way via `attach_tracker`:

- tracker -> supervisor: the tracker's dead-rank notification triggers a
  PROACTIVE relaunch — a segfaulted container whose CLI status lags is
  restarted from the heartbeat signal, not the slow poll;
- supervisor -> tracker: a task that exhausts max_attempts tells the
  tracker to abort the job instead of leaving it waiting forever on a
  rank that will never return.

The port's own copy of ``dmlc_core_tpu/tracker/supervisor.py`` (it imports nothing of
the JAX package): the same names, env variables, CLI flags and wire
bytes, so a worker of either package joins the other's tracker.
"""

from __future__ import annotations

import logging
import subprocess
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

logger = logging.getLogger("dmlc_core_tpu_torch.tracker")

__all__ = ["WorkerSupervisor", "CommandTask"]


@dataclass
class _TaskState:
    task_id: int
    role: str
    start: Callable[[int], object]  # attempt -> handle
    attempt: int = 0
    handle: object = None
    done: bool = False
    # monotonic launch time of the CURRENT incarnation — lets the
    # dead-rank callback tell "this incarnation is the dead one" from
    # "the dead one was already replaced" (see _on_rank_dead)
    started_at: Optional[float] = None


class WorkerSupervisor:
    """Watches worker handles; relaunches nonzero exits up to max_attempts.

    Usage::

        sup = WorkerSupervisor(max_attempts=2)
        sup.add(task_id=0, role="worker", start=make_start_fn(0))
        sup.add(task_id=1, role="worker", start=make_start_fn(1))
        sup.run()   # blocks; raises if any task exhausts its attempts
    """

    def __init__(self, max_attempts: int = 2, poll_interval: float = 0.05):
        self.max_attempts = max_attempts
        self.poll_interval = poll_interval
        self._tasks: List[_TaskState] = []
        self._stop = threading.Event()
        # (task_id, attempt, returncode) log of observed failures — lets
        # tests and callers audit the restart history (returncode is None
        # when the restart came from a tracker dead-rank signal whose CLI
        # status had not caught up yet)
        self.failures: List[tuple] = []
        # task mutation happens on the watch thread AND the tracker's
        # dead-rank notifier thread once attach_tracker is used
        self._lock = threading.Lock()
        self._tracker = None
        self._proactive_relaunch: Optional[bool] = None
        self._rank_to_task: Callable[[int], int] = lambda rank: rank

    def add(self, task_id: int, role: str,
            start: Callable[[int], object]) -> None:
        """Register a task: (task_id, role, start(attempt) -> handle)."""
        self._tasks.append(_TaskState(task_id, role, start))

    def attach_tracker(self, tracker,
                       rank_to_task: Optional[Callable[[int], int]] = None,
                       proactive_relaunch: Optional[bool] = None) -> None:
        """Wire liveness both ways with a RabitTracker: subscribe to its
        dead-rank notifications for proactive relaunch, and report
        attempt exhaustion back as a job abort.

        The dead rank is mapped to a task by, in order: the task id the
        worker itself reported on the wire (RendezvousClient defaults
        its jobid to "task<DMLC_TASK_ID>", carried in the notification
        as info["task_id"] — authoritative, since ranks are assigned by
        host-sorted arrival and need NOT equal task ids), then
        `rank_to_task` (default: identity) for legacy workers that
        report no jobid.

        `proactive_relaunch=None` (default) relaunches on a dead-rank
        signal UNLESS the tracker runs the elastic data-plane — there the
        dead rank's shard leases migrate to the survivors and the epoch
        completes without the replacement, so a relaunch is optional
        capacity restoration, not a liveness requirement. Pass True/False
        to override either way (the watch loop's relaunch of nonzero
        exits is unaffected)."""
        self._tracker = tracker
        self._proactive_relaunch = proactive_relaunch
        if rank_to_task is not None:
            self._rank_to_task = rank_to_task
        tracker.on_rank_dead(self._on_rank_dead)

    def _find(self, task_id: int) -> Optional[_TaskState]:
        for t in self._tasks:
            if t.task_id == task_id:
                return t
        return None

    def _abort_tracker(self, reason: str) -> None:
        if self._tracker is not None:
            try:
                self._tracker.abort(reason)
            except Exception:
                logger.exception("tracker abort failed")

    def _relaunch_locked(self, t: _TaskState, rc, why: str) -> bool:
        """Record the failure and relaunch `t` under the next attempt
        (caller holds self._lock). Returns False when max_attempts is
        exhausted: supervision stops and the tracker is told to abort
        instead of waiting forever on the rank. The single copy of the
        restart bookkeeping shared by the status-poll path (watch) and
        the dead-rank-signal path (_on_rank_dead)."""
        self.failures.append((t.task_id, t.attempt, rc))
        t.attempt += 1
        if t.attempt > self.max_attempts:
            self._stop_locked()
            self._abort_tracker(
                f"task {t.task_id} ({t.role}) exhausted {t.attempt} "
                f"attempts ({why})")
            return False
        # tear the failed incarnation down before resubmitting — remote
        # backends may still have live pieces (a surviving container of a
        # partially-failed group, a foreground mesos-execute client); a
        # dead local Popen ignores it
        try:
            t.handle.terminate()
        except Exception:
            pass
        logger.warning("task %d (%s) %s; relaunching (attempt %d)",
                       t.task_id, t.role, why, t.attempt)
        t.handle = t.start(t.attempt)
        t.started_at = time.monotonic()
        return True

    def _on_rank_dead(self, rank: int, info: Dict[str, object]) -> None:
        """Tracker liveness callback: relaunch the dead rank's task NOW —
        ahead of the (possibly minutes-slow) status poll."""
        proactive = self._proactive_relaunch
        if proactive is None:
            # elastic tracker: the dead rank's leases migrate after the
            # grace window — the job completes without the relaunch
            proactive = not getattr(self._tracker, "elastic", False)
        if not proactive:
            logger.info(
                "rank %d dead signal: proactive relaunch skipped (elastic "
                "data-plane — leases migrate to the survivors)", rank)
            return
        task_id = info.get("task_id")  # wire-reported: authoritative
        if not isinstance(task_id, int):
            try:
                task_id = self._rank_to_task(rank)
            except Exception:
                logger.exception("rank_to_task mapping failed for rank %d",
                                 rank)
                return
        with self._lock:
            t = self._find(task_id)
            if t is None or t.done or self._stop.is_set():
                return
            # If the current incarnation was launched AFTER the dead
            # rank's last heartbeat, the dead incarnation is already
            # replaced (the watch loop's poll won the race) — relaunching
            # again would kill the healthy replacement mid-recover. A
            # CommandTask whose CLI status lags keeps its old started_at,
            # so the genuinely-dead case still relaunches.
            last_beat = info.get("last_beat_monotonic")
            if isinstance(last_beat, float) and t.started_at is not None \
                    and t.started_at > last_beat:
                logger.info(
                    "rank %d dead signal ignored: task %d already "
                    "relaunched since its last heartbeat", rank, t.task_id)
                return
            handle = t.handle
        # poll outside the lock (same rule as watch(): on CLI backends
        # this execs a status command that can hang)
        rc = None
        try:
            rc = handle.poll() if handle is not None else None
        except Exception:
            pass
        with self._lock:
            if t.done or self._stop.is_set() or t.handle is not handle:
                return  # resolved or replaced while we were polling
            try:
                # lock-ok: the relaunch must be atomic with the attempt
                # bookkeeping — two racing observers (watch poll + this
                # signal) would double-launch over one incarnation. The
                # tracker serve loop never takes the supervisor lock
                # (notifications arrive on the dedicated notifier thread),
                # so a slow submit delays supervision only.
                self._relaunch_locked(t, rc, f"rank {rank} marked dead")
            except Exception:
                logger.exception("proactive relaunch of task %d failed",
                                 t.task_id)
                # lock-ok: terminal teardown; serve loop never holds this
                # lock and abort() only sets a flag + wakes the self-pipe
                self._stop_locked()
                # lock-ok: abort() is flag-set + selector wake, not I/O
                self._abort_tracker(
                    f"relaunch of task {t.task_id} failed")

    def stop(self) -> None:
        """Stop watching and terminate every live handle."""
        # lock-ok: teardown must be atomic against a racing relaunch (a
        # handle replaced mid-stop would survive); the tracker serve loop
        # never holds the supervisor lock, so terminate()'s CLI exec can
        # delay only supervision, never the rendezvous
        with self._lock:
            self._stop_locked()

    def _stop_locked(self) -> None:
        self._stop.set()
        for t in self._tasks:
            if t.handle is not None and not t.done:
                try:
                    t.handle.terminate()
                except Exception:
                    pass

    def launch(self) -> None:
        """Start every task once, synchronously — submission errors (bad
        kubeconfig, missing binary, RBAC) raise in the CALLER, not in a
        background watch thread."""
        for t in self._tasks:
            t.handle = t.start(t.attempt)
            t.started_at = time.monotonic()

    def watch(self) -> None:
        """Poll launched handles until all complete; relaunch failures."""
        while not self._stop.is_set():
            all_done = True
            for t in self._tasks:
                with self._lock:
                    if t.done or self._stop.is_set():
                        continue
                    handle = t.handle
                # poll OUTSIDE the lock: on CLI backends it execs a
                # status command that can block for seconds (a hung
                # kubectl) — holding the lock would serialize stop() and
                # the tracker's dead-rank callback behind exactly the
                # slow poll the proactive path exists to bypass
                rc = handle.poll()
                with self._lock:
                    if t.done or self._stop.is_set():
                        continue
                    if t.handle is not handle:
                        # replaced meanwhile by a proactive relaunch; the
                        # rc belongs to the dead incarnation it already
                        # accounted for
                        all_done = False
                        continue
                    if rc is None:
                        all_done = False
                        continue
                    if rc == 0:
                        t.done = True
                        continue
                    # failed: relaunch under the same task id — the worker
                    # rejoins with cmd=recover and keeps its old rank.
                    # lock-ok: atomic with the attempt bookkeeping (the
                    # dead-rank signal path races this poll); the serve
                    # loop never takes the supervisor lock
                    if not self._relaunch_locked(
                            t, rc, f"exited with code {rc}"):
                        raise RuntimeError(
                            f"task {t.task_id} ({t.role}) failed with code "
                            f"{rc} after {t.attempt} attempts")
                    all_done = False
            if all_done:
                return
            time.sleep(self.poll_interval)

    def run(self) -> None:
        """launch() + watch() in the calling thread."""
        self.launch()
        self.watch()

    def watch_in_thread(self) -> threading.Thread:
        """watch() on a daemon thread; failures are LOGGED loudly (the
        caller is typically blocked in tracker.join(), so an exception in
        the thread would otherwise vanish silently)."""
        def _watch():
            try:
                self.watch()
            except Exception:
                logger.exception(
                    "worker supervision failed; the tracker may now wait "
                    "on workers that will never finish")

        th = threading.Thread(target=_watch, daemon=True)
        th.start()
        return th


class CommandTask:
    """Poll-by-CLI handle for backends whose workers are remote containers
    (kubernetes/yarn/mesos): `submit_cmd` (re)creates the task, `status_cmd`
    is polled and must exit 0 while running/succeeded-with-`succeeded_text`,
    and its stdout is matched against `succeeded_text` / `failed_text` to
    decide completion (the AppMaster's container-status watch, expressed
    over the backend CLI).

    `submit_async=True` launches the submit command without waiting — for
    clients that stay in the foreground while the application runs (the
    yarn distributedshell client, mesos-execute); a nonzero exit of that
    client counts as a failure signal, exit 0 is ignored (status text
    decides). `status_filter` restricts matching to output lines containing
    the filter, so list-style status commands (`yarn application -list`)
    only see this task's application."""

    def __init__(self, submit_cmd: Sequence[str], status_cmd: Sequence[str],
                 succeeded_text: str = "Succeeded",
                 failed_text: str = "Failed",
                 delete_cmd: Optional[Sequence[str]] = None,
                 submit_input: Optional[str] = None,
                 status_errors_tolerated: int = 3,
                 submit_async: bool = False,
                 status_filter: Optional[str] = None):
        self.status_cmd = list(status_cmd)
        self.succeeded_text = succeeded_text
        self.failed_text = failed_text
        self.delete_cmd = list(delete_cmd) if delete_cmd else None
        self.status_errors_tolerated = status_errors_tolerated
        self.status_filter = status_filter
        self._status_errors = 0
        self._proc: Optional[subprocess.Popen] = None
        if submit_async:
            self._proc = subprocess.Popen(
                list(submit_cmd), stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL)
        else:
            out = subprocess.run(list(submit_cmd), capture_output=True,
                                 input=submit_input,
                                 text=True)
            if out.returncode != 0:
                raise RuntimeError(
                    f"submission failed ({' '.join(submit_cmd)}): "
                    f"{out.stderr or out.stdout}")

    def poll(self) -> Optional[int]:
        """Popen-protocol status: None while running, 0 success, nonzero
        failure (status text first, then the async client's exit)."""
        out = subprocess.run(self.status_cmd, capture_output=True, text=True)
        if out.returncode != 0:
            # a transient CLI/API error must not restart a healthy task;
            # only a persistent inability to observe it counts as failure
            self._status_errors += 1
            if self._status_errors > self.status_errors_tolerated:
                logger.warning("status command failing persistently: %s",
                               out.stderr or out.stdout)
                return 1
            return None
        self._status_errors = 0
        text = (out.stdout or "") + (out.stderr or "")
        if self.status_filter is not None:
            text = "\n".join(line for line in text.splitlines()
                             if self.status_filter in line)
        if self.failed_text in text:
            return 1
        if self.succeeded_text in text:
            return 0
        # no verdict from status output: a foreground client that died
        # nonzero is the only remaining failure signal (its exit 0 just
        # means "submission done" for detach-style clients)
        if self._proc is not None:
            rc = self._proc.poll()
            if rc is not None and rc != 0:
                return rc
        return None  # still running

    def terminate(self) -> None:
        """Tear the task down: run delete_cmd and stop the async submit
        client."""
        if self.delete_cmd is not None:
            subprocess.run(self.delete_cmd, capture_output=True)
        if self._proc is not None and self._proc.poll() is None:
            try:
                self._proc.terminate()
            except Exception:
                pass


def popen_start_fn(command: Sequence[str], role: str, task_id: int,
                   envs: Dict[str, object],
                   base_env: Optional[Dict[str, str]] = None
                   ) -> Callable[[int], subprocess.Popen]:
    """start(attempt) factory for local subprocess workers, exporting the
    reference env ABI (DMLC_TASK_ID / DMLC_ROLE / DMLC_NUM_ATTEMPT)."""
    import os

    cmd = list(command)
    # executables in the cwd but not on PATH still launch (the reference
    # local launcher's './' normalization, local.py)
    if "/" not in cmd[0] and os.path.exists(cmd[0]):
        cmd[0] = "./" + cmd[0]

    def start(attempt: int) -> subprocess.Popen:
        env = dict(base_env if base_env is not None else os.environ)
        for k, v in envs.items():
            env[k] = str(v)
        env["DMLC_TASK_ID"] = str(task_id)
        env["DMLC_ROLE"] = role
        env["DMLC_NUM_ATTEMPT"] = str(attempt)
        env.setdefault("DMLC_JOB_CLUSTER", "local")
        return subprocess.Popen(" ".join(cmd), shell=True,
                                executable="/bin/bash", env=env)

    return start
