"""Rendezvous services: RabitTracker (tree/ring brokering) and PSTracker.

Behavior-compatible rebuild of reference tracker/dmlc_tracker/tracker.py:
- RabitTracker accepts worker connections, assigns ranks in host-sorted
  batches, serves tree/parent/ring topology, and brokers peer (host, port)
  handoffs until every link is up (tracker.py:254-320 accept loop,
  :80-135 assign_rank); supports print/shutdown/start/recover commands —
  `recover` re-links a restarted worker under its old rank (the failure-
  recovery path, SURVEY §5).
- PSTracker spawns the parameter-server scheduler process with
  DMLC_ROLE=scheduler + DMLC_PS_ROOT_URI/PORT (tracker.py:336-386).

Unlike the reference (and the previous build here), the serve loop is
EVENT-DRIVEN: a `selectors` loop pumps one protocol coroutine per
connection, so a slow or hung handshake no longer serializes the whole
rendezvous and the tracker observes time passing instead of blocking in
`accept()`. On top of that loop sits the liveness layer (doc/robustness.md
"Distributed job liveness"):

- workers hold a persistent heartbeat channel (wire.CMD_HEARTBEAT — a new
  command, so legacy start/recover/shutdown/print clients stay
  byte-compatible and are simply not liveness-tracked);
- a rank whose heartbeats stop for DMLC_TRACKER_DEAD_AFTER_MS is marked
  dead, dead-rank subscribers (WorkerSupervisor) are notified for
  proactive relaunch, and after a DMLC_TRACKER_RECOVER_GRACE_MS window
  with no cmd=recover the job is ABORTED: every live heartbeat channel
  receives the abort broadcast (workers raise instead of hanging in peer
  links), the tracker closes down, and join() raises a structured
  TrackerAbortedError naming the dead ranks;
- `state()` returns a thread-safe per-rank snapshot and `events` / the
  DMLC_TRACKER_EVENT_LOG JSONL file record assign/heartbeat/dead/recover/
  abort transitions for observability.

On top of liveness sits the ELASTIC DATA-PLANE (doc/robustness.md
"Elastic data-plane"): with ``num_shards > 0`` (DMLC_TRACKER_NUM_SHARDS /
``dmlc-submit --num-shards``) the dataset is pre-split into S logical
shards and workers lease them over the existing heartbeat channel
(wire.LEASE_* frames; every ping implicitly renews). When a rank dies and
its grace window expires, the tracker — instead of aborting — writes the
rank off as ``lost``, returns its leases to the pool for the survivors,
and finishes the job once every rank is shut down or lost; the epoch
completes without a relaunch. ``state()`` snapshots the lease table
atomically with the rank table under one lock, so a scrape during
reassignment can never observe a shard as both pooled and held.

The port's own copy of ``dmlc_core_tpu/tracker/rendezvous.py`` (it imports nothing of
the JAX package): the same names, env variables, CLI flags and wire
bytes, so a worker of either package joins the other's tracker.
"""

from __future__ import annotations

import json
import logging
import os
from collections import deque
import queue
import selectors
import socket
import struct
import subprocess
import threading
import time
from typing import Callable, Dict, List, Optional, Set

from dmlc_core_tpu_torch import telemetry
from dmlc_core_tpu_torch.tracker import minihttp, topology
from dmlc_core_tpu_torch.tracker.event_log import _EventLog
from dmlc_core_tpu_torch.tracker.wire import (CMD_HEARTBEAT, HEARTBEAT_ABORT,
                                        HEARTBEAT_BYE, LEASE_ACQUIRE,
                                        LEASE_COMPLETE, LEASE_DRAINED,
                                        LEASE_EMPTY, LEASE_GRANT,
                                        LEASE_RELEASE, MAGIC,
                                        TELEMETRY_PULL, TELEMETRY_PUSH,
                                        TELEMETRY_PUSH_MAX,
                                        TrackerAbortedError, addr_family,
                                        bind_free_port, env_float, env_int,
                                        guess_host_ip, resolve_ip)

logger = logging.getLogger("dmlc_core_tpu_torch.tracker")

__all__ = ["RabitTracker", "PSTracker", "TrackerAbortedError", "run_job",
           "start_standalone_tracker"]

# a protocol coroutine yields either an int (bytes it needs next) or _WAIT
# (parked until the tracker resumes it with a value: a batch-assigned rank,
# or None for a recomputation wake-up)
_WAIT = object()


class _Reject(Exception):
    """A protocol violation by one peer: log, close ITS socket, keep
    serving everyone else (never an assert — tracker.py:254-320's flaw)."""


def _r_int():
    data = yield 4
    return struct.unpack("@i", data)[0]


def _r_str(max_len: int = 1 << 20):
    n = yield from _r_int()
    if n < 0 or n > max_len:
        # without the cap a bogus 2 GB prefix would balloon the read
        # buffer; strings here are hostnames/job ids/log lines
        raise _Reject(f"invalid string length {n} on tracker wire")
    data = yield n
    return data.decode()


class _Conn:
    """One accepted connection: buffers + the protocol coroutine."""

    __slots__ = ("sock", "host", "inbuf", "outbuf", "gen", "want", "kind",
                 "rank", "jobid", "last_activity", "closed", "registered",
                 "drain_close")

    def __init__(self, sock: socket.socket, host: str):
        self.sock = sock
        self.host = host
        self.inbuf = bytearray()
        self.outbuf = bytearray()
        self.gen = None
        self.want = None            # int bytes needed, or _WAIT when parked
        self.kind = "proto"         # "proto" | "heartbeat" | "http"
        self.rank: Optional[int] = None
        self.jobid = "NULL"
        self.last_activity = time.monotonic()
        self.closed = False
        self.registered = False
        self.drain_close = False    # close as soon as outbuf drains (http)


class _WaitEntry:
    """A worker awaiting inbound peer dials (the old wait_conn record)."""

    __slots__ = ("host", "port", "wait_accept")

    def __init__(self, host: str, port: int, wait_accept: int):
        self.host = host
        self.port = port
        self.wait_accept = wait_accept


class _RankState:
    """Per-rank liveness/observability record behind state()."""

    __slots__ = ("phase", "last_beat", "dead_since", "restarts", "host",
                 "hb", "attempts", "jobid")

    def __init__(self, host: str = ""):
        self.phase = "assigned"     # assigned|alive|dead|shutdown
        self.last_beat: Optional[float] = None
        self.dead_since: Optional[float] = None
        self.restarts = 0
        self.attempts = 0           # assignment handshakes served
        self.host = host
        self.hb: Optional[_Conn] = None
        self.jobid = "NULL"         # the wire-reported launcher task id


class _EpochLeases:
    """One epoch's shard accounting: every shard is in EXACTLY one of
    pool / held / done at any instant (the invariant the lease-table
    snapshot exposes and the chaos suite asserts)."""

    __slots__ = ("pool", "held", "done", "reassigned")

    def __init__(self, num_shards: int):
        self.pool: List[int] = list(range(num_shards))  # FIFO, lowest first
        self.held: Dict[int, list] = {}   # shard -> [rank, expires_monotonic]
        self.done: Dict[int, int] = {}    # shard -> completing rank
        self.reassigned = 0               # leases reclaimed from their holder


class _LeaseManager:
    """Shard-lease bookkeeping for the elastic data-plane.

    All mutation happens under the TRACKER's lock — the same lock
    ``state()`` snapshots under, so the rank table and the lease table are
    always observed atomically (a scrape during reassignment can never see
    a shard as both pooled and held). Methods take the lock themselves;
    only :meth:`snapshot_locked` expects the caller to already hold it.

    Exactly-once contract: a shard counts as consumed only when its
    CURRENT holder completes it. A complete (or release) from a rank whose
    lease was already reclaimed and regranted is stale and ignored — the
    new holder's completion is the one that counts."""

    _KEEP_EPOCHS = 4  # stale epoch tables are GC'd as new epochs open

    def __init__(self, num_shards: int, ttl_ms: int, lock: threading.Lock):
        self.num_shards = num_shards
        self.ttl_ms = ttl_ms
        self._lock = lock
        self._epochs: Dict[int, _EpochLeases] = {}
        # rank -> {(epoch, shard)} it currently holds (renewal/reclaim index)
        self._by_rank: Dict[int, set] = {}

    def _epoch(self, epoch: int) -> _EpochLeases:
        ep = self._epochs.get(epoch)
        if ep is None:
            ep = self._epochs[epoch] = _EpochLeases(self.num_shards)
            for old in [e for e in self._epochs
                        if e <= epoch - self._KEEP_EPOCHS]:
                del self._epochs[old]
                for held in self._by_rank.values():
                    held.difference_update(
                        {p for p in held if p[0] == old})
        return ep

    def acquire(self, rank: int, epoch: int, now: float) -> int:
        """Grant the lowest pooled shard of `epoch` to `rank`; LEASE_EMPTY
        when nothing is free NOW (held shards may return if their holder
        dies — retry), LEASE_DRAINED when every shard is complete."""
        with self._lock:
            ep = self._epoch(epoch)
            if not ep.pool:
                return (LEASE_DRAINED if len(ep.done) >= self.num_shards
                        else LEASE_EMPTY)
            shard = ep.pool.pop(0)
            ep.held[shard] = [rank, now + self.ttl_ms / 1000.0]
            self._by_rank.setdefault(rank, set()).add((epoch, shard))
            return shard

    def renew(self, rank: int, now: float) -> None:
        """Extend every lease `rank` holds (piggybacked on its ping)."""
        with self._lock:
            for epoch, shard in self._by_rank.get(rank, ()):
                ep = self._epochs.get(epoch)
                if ep is not None and shard in ep.held \
                        and ep.held[shard][0] == rank:
                    ep.held[shard][1] = now + self.ttl_ms / 1000.0

    def release(self, rank: int, epoch: int, shard: int) -> bool:
        """Return an unfinished shard to the pool (False when stale)."""
        with self._lock:
            ep = self._epochs.get(epoch)
            if ep is None or ep.held.get(shard, [None])[0] != rank:
                return False
            del ep.held[shard]
            ep.pool.append(shard)
            self._by_rank.get(rank, set()).discard((epoch, shard))
            return True

    def complete(self, rank: int, epoch: int, shard: int):
        """Mark a shard consumed. Returns (ok, epoch_drained); ok=False
        means the lease was reclaimed meanwhile (stale completion)."""
        with self._lock:
            ep = self._epochs.get(epoch)
            if ep is None or ep.held.get(shard, [None])[0] != rank:
                return False, False
            del ep.held[shard]
            ep.done[shard] = rank
            self._by_rank.get(rank, set()).discard((epoch, shard))
            return True, len(ep.done) >= self.num_shards

    def reclaim_rank(self, rank: int) -> List[tuple]:
        """A rank written off (dead past its grace): every lease it holds
        returns to the pool. Returns the reclaimed (epoch, shard) pairs."""
        with self._lock:
            out = []
            for epoch, shard in sorted(self._by_rank.pop(rank, ())):
                ep = self._epochs.get(epoch)
                if ep is not None and ep.held.get(shard, [None])[0] == rank:
                    del ep.held[shard]
                    ep.pool.append(shard)
                    ep.reassigned += 1
                    out.append((epoch, shard))
            return out

    def reclaim_expired(self, now: float) -> List[tuple]:
        """TTL backstop: leases whose holder stopped renewing (silent
        channel — it would also be dead-marked when liveness is armed)
        return to the pool. Returns [(epoch, shard, rank)]."""
        with self._lock:
            out = []
            for epoch, ep in self._epochs.items():
                for shard in [s for s, h in ep.held.items() if now > h[1]]:
                    rank = ep.held.pop(shard)[0]
                    ep.pool.append(shard)
                    ep.reassigned += 1
                    self._by_rank.get(rank, set()).discard((epoch, shard))
                    out.append((epoch, shard, rank))
            return out

    def snapshot_locked(self) -> Dict[str, dict]:
        """Lease table for state() — the CALLER holds the tracker lock,
        so ranks and leases snapshot atomically."""
        return {str(epoch): {
                    "pool": sorted(ep.pool),
                    "held": {str(s): h[0] for s, h in ep.held.items()},
                    "done": sorted(ep.done),
                    "reassigned": ep.reassigned,
                } for epoch, ep in sorted(self._epochs.items())}


class RabitTracker:
    """The rendezvous server legacy Rabit workers dial into.

    Usable as a context manager: ``with RabitTracker(...) as t: ...`` —
    exit stops the serve loop and releases the port.
    """

    def __init__(self, host_ip: str, num_workers: int, port: int = 9091,
                 port_end: int = 9999,
                 heartbeat_ms: Optional[int] = None,
                 dead_after_ms: Optional[int] = None,
                 recover_grace_ms: Optional[int] = None,
                 event_log: Optional[str] = None,
                 num_shards: Optional[int] = None,
                 lease_ttl_ms: Optional[int] = None,
                 abort_on_lost: Optional[bool] = None):
        self.host_ip = host_ip
        self.num_workers = num_workers
        self.listener = bind_free_port(host_ip, port, port_end)
        self.port = self.listener.getsockname()[1]
        self.listener.listen(256)
        self.thread: Optional[threading.Thread] = None
        self.start_time: Optional[float] = None
        self.end_time: Optional[float] = None
        self.fatal_error: Optional[BaseException] = None

        # liveness knobs: ctor beats env; heartbeat_ms == 0 means the
        # tracker never asks workers to heartbeat (legacy behavior), but
        # a client that opens a channel anyway is still tracked
        self.heartbeat_ms = heartbeat_ms if heartbeat_ms is not None \
            else env_int("DMLC_TRACKER_HEARTBEAT_MS", 0)
        self.dead_after_ms = dead_after_ms if dead_after_ms is not None \
            else env_int("DMLC_TRACKER_DEAD_AFTER_MS",
                          4 * self.heartbeat_ms if self.heartbeat_ms else 0)
        # default grace must cover a realistic supervised relaunch (a
        # fresh Python worker needs ~1 s to rejoin; containers more) —
        # dead_after/2 alone would abort jobs the supervisor was about
        # to heal whenever dead_after is tuned aggressively low
        self.recover_grace_ms = recover_grace_ms \
            if recover_grace_ms is not None \
            else env_int("DMLC_TRACKER_RECOVER_GRACE_MS",
                          max(self.dead_after_ms // 2, 5000)
                          if self.dead_after_ms else 0)

        # observability
        self._lock = threading.Lock()
        self.events: List[Dict[str, object]] = []
        self._event_log = None
        path = event_log if event_log is not None \
            else os.environ.get("DMLC_TRACKER_EVENT_LOG")
        if path:
            self._event_log = _EventLog(
                path, env_int("DMLC_TRACKER_EVENT_LOG_MAX_BYTES", 16 << 20))
        # the tracker publishes into the unified telemetry plane: per-rank
        # gauges refresh lazily at snapshot/scrape time (doc/observability.md)
        telemetry.register_collector(self._publish_telemetry)
        self._ranks: Dict[int, _RankState] = {}

        # mesh step timelines (doc/observability.md "Step timelines"):
        # per-rank step durations harvested from the `mesh.step` spans
        # riding TELEMETRY_PUSH replies feed the straggler verdict
        self.straggler_factor = env_float("DMLC_TRACKER_STRAGGLER_FACTOR",
                                          2.0)
        self.straggler_min_steps = env_int(
            "DMLC_TRACKER_STRAGGLER_MIN_STEPS", 3)
        self._step_durs: Dict[int, "deque"] = {}
        self._step_hi: Dict[int, int] = {}
        self._wv_started = False

        # elastic data-plane: num_shards > 0 pre-splits the dataset into S
        # logical shard leases served over the heartbeat channel; ctor
        # beats env, 0 keeps the legacy static num_parts/part_index plane
        self.num_shards = num_shards if num_shards is not None \
            else env_int("DMLC_TRACKER_NUM_SHARDS", 0)
        # default TTL is the backstop for silent channels and must be
        # strictly LONGER than the primary dead+grace reclaim path, so a
        # dying rank's leases return via the lost-rank write-off (one
        # atomic reclaim per rank), not the per-lease expiry sweep
        self.lease_ttl_ms = lease_ttl_ms if lease_ttl_ms is not None \
            else env_int("DMLC_TRACKER_LEASE_TTL_MS",
                         2 * (self.dead_after_ms + self.recover_grace_ms)
                         if self.dead_after_ms else 30000)
        self._leases: Optional[_LeaseManager] = \
            _LeaseManager(self.num_shards, self.lease_ttl_ms, self._lock) \
            if self.num_shards > 0 else None
        # mesh mode: a written-off rank still reclaims its leases (so the
        # flight dump names what it held) but then ABORTS the world instead
        # of degrading — survivors of a SIGKILL'd mesh peer hold live
        # torch.distributed state that cannot absorb the dead rank's model
        # shards, so the only sound recovery is a supervised world relaunch
        # from the last committed job checkpoint (doc/robustness.md
        # "Elastic mesh training")
        self.abort_on_lost = abort_on_lost if abort_on_lost is not None \
            else env_int("DMLC_TRACKER_ABORT_ON_LOST", 0) != 0
        self._lost_ranks: Set[int] = set()
        self._dead_callbacks: List[Callable[[int, Dict[str, object]], None]] \
            = []
        self._notify_q: "queue.Queue" = queue.Queue()
        self._notify_thread: Optional[threading.Thread] = None

        # serve-loop state (only the loop thread mutates these)
        self._sel: Optional[selectors.BaseSelector] = None
        self._conns: Set[_Conn] = set()
        self._shutdown_ranks: Set[int] = set()
        self._wait_conn: Dict[int, _WaitEntry] = {}
        self._job_map: Dict[str, int] = {}
        self._pending: List[_Conn] = []
        self._todo: List[int] = []
        self._assigned: Set[int] = set()
        # ranks whose link dance COMPLETED (set after _assign_dance
        # returns): the elastic write-off is only safe once every dance
        # is done — a rank dying mid-dance leaves survivors parked in
        # peer accept()/recv() that only the abort broadcast unblocks
        self._linked: Set[int] = set()
        self._maps = None
        self._pending_ports: Set[int] = set()
        self._port_waiters: List[_Conn] = []
        self._later: List[Callable[[], None]] = []
        # in-flight cluster-telemetry pulls (serve loop only): one entry
        # per /metrics-or-/trace scrape awaiting TELEMETRY_PUSH replies,
        # resolved complete, partial at the deadline, or on conn close
        self._pulls: Dict[int, dict] = {}
        self._pull_seq = 0
        # how long a scrape waits for slow/legacy ranks before serving
        # what arrived (legacy clients ignore the pull frame entirely)
        self.scrape_timeout_ms = env_int("DMLC_TRACKER_SCRAPE_TIMEOUT_MS",
                                         2000)
        self._stop_requested = False
        self._abort_request: Optional[TrackerAbortedError] = None
        self._finished = False
        # self-pipe so stop()/abort() wake the selector immediately
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        logger.info("tracker listening on %s:%d", host_ip, self.port)

    # -- observability -------------------------------------------------------
    def _emit(self, event: str, **fields) -> None:
        rec = {"ts": time.time(), "event": event}
        rec.update(fields)
        with self._lock:
            self.events.append(rec)
            if self._event_log is not None:
                # lock-ok: local line-buffered append with OSError
                # swallowed — bounded by disk latency, never the network;
                # the lock is what keeps the JSONL mirror in event order
                self._event_log.write(json.dumps(rec) + "\n")
        # tracker events are just another telemetry stream: the same record
        # rides the snapshot's `events` list / events_jsonl() exposition
        telemetry.emit_event(event,
                             **{k: v for k, v in rec.items() if k != "event"})

    def _publish_telemetry(self) -> None:
        """Telemetry collector (runs at snapshot/scrape time): job-level
        gauges + per-rank phase / heartbeat-age / restart gauges, labeled
        ``{rank="<r>"}`` (doc/observability.md catalog)."""
        st = self.state()
        telemetry.gauge("tracker_num_workers").set(st["num_workers"])
        telemetry.gauge("tracker_alive").set(1 if st["alive"] else 0)
        telemetry.gauge("tracker_finished").set(1 if st["finished"] else 0)
        telemetry.gauge("tracker_aborted").set(1 if st["aborted"] else 0)
        for epoch, tbl in (st.get("leases") or {}).items():
            labels = {"epoch": epoch}
            telemetry.gauge("tracker_lease_pool", labels).set(
                len(tbl["pool"]))
            telemetry.gauge("tracker_lease_held", labels).set(
                len(tbl["held"]))
            telemetry.gauge("tracker_lease_done", labels).set(
                len(tbl["done"]))
            telemetry.gauge("tracker_lease_reassigned", labels).set(
                tbl["reassigned"])
        phase_code = {"assigned": 0, "alive": 1, "dead": 2, "shutdown": 3,
                      "lost": 4}
        for rank, info in st["ranks"].items():
            labels = {"rank": str(rank)}
            telemetry.gauge("tracker_rank_phase_code", labels).set(
                phase_code.get(info["phase"], -1))
            age = info["last_heartbeat_age_s"]
            telemetry.gauge("tracker_rank_heartbeat_age_seconds",
                            labels).set(-1 if age is None else age)
            telemetry.gauge("tracker_rank_restarts", labels).set(
                info["restarts"])
            telemetry.gauge("tracker_rank_attempts", labels).set(
                info["attempts"])
        verdict = self._straggler()
        telemetry.gauge("tracker_straggler_rank").set(
            verdict["rank"] if verdict["verdict"] == "straggler_bound"
            else -1)

    # how many recent step durations each rank's straggler vote sees; a
    # bounded window makes the verdict track the CURRENT regime (a rank
    # that was slow an hour ago and recovered must stop being named)
    STEP_WINDOW = 64

    def _harvest_steps(self, rank: int, doc: dict) -> None:
        """Fold one rank's ``mesh.step`` spans (riding its TELEMETRY_PUSH
        document) into the bounded per-rank step-duration window the
        straggler verdict reads. Span ids are monotonic per process, so a
        high-water mark dedupes spans re-exported across scrapes; a max
        id BELOW the mark means the worker restarted with a fresh span
        counter, and the mark resets so the new incarnation counts."""
        spans = doc.get("spans")
        if not isinstance(spans, list):
            return
        steps = [s for s in spans if isinstance(s, dict)
                 and s.get("name") == "mesh.step"]
        if not steps:
            return
        with self._lock:
            hi = self._step_hi.get(rank, 0)
            ids = []
            for s in steps:
                try:
                    ids.append(int(s.get("id", 0)))
                except (TypeError, ValueError):
                    ids.append(0)
            if max(ids) < hi:
                hi = 0
            durs = self._step_durs.setdefault(
                rank, deque(maxlen=self.STEP_WINDOW))
            for s, sid in zip(steps, ids):
                if sid <= hi:
                    continue
                try:
                    durs.append(float(s.get("dur", 0.0)))
                except (TypeError, ValueError):
                    continue
            self._step_hi[rank] = max([hi] + ids)

    def _straggler(self) -> dict:
        """The current straggler verdict over the harvested per-rank step
        windows (``unknown`` until at least two ranks have reported
        ``straggler_min_steps`` steps each)."""
        with self._lock:
            durs = {r: list(d) for r, d in self._step_durs.items()}
        return telemetry.straggler_attribution(
            durs, factor=self.straggler_factor,
            min_steps=self.straggler_min_steps)

    def _straggler_tail(self) -> str:
        """A ``; straggler ...`` suffix for flight-dump reasons when a
        straggler is currently bound, else empty — dead-rank and abort
        postmortems name the rank that was dragging the mesh."""
        strag = self._straggler()
        if strag["verdict"] != "straggler_bound":
            return ""
        return (f"; straggler rank {strag['rank']} at "
                f"{strag['ratio']:.1f}x the peer median step")

    @property
    def elastic(self) -> bool:
        """True when the elastic data-plane (shard leases) is enabled."""
        return self._leases is not None

    def state(self) -> Dict[str, object]:
        """Thread-safe snapshot: per-rank phase / last-heartbeat age /
        restart counts plus job-level status. With the elastic data-plane
        enabled it also carries the live lease table — snapshotted under
        the SAME lock acquisition as the rank table, so a scrape during
        reassignment can never observe a shard as both pooled and held."""
        now = time.monotonic()
        with self._lock:
            ranks = {}
            for r, st in self._ranks.items():
                ranks[r] = {
                    "phase": st.phase,
                    "host": st.host,
                    "jobid": st.jobid,
                    "restarts": st.restarts,
                    "attempts": st.attempts,
                    "last_heartbeat_age_s":
                        None if st.last_beat is None else now - st.last_beat,
                }
            out = {
                "num_workers": self.num_workers,
                "port": self.port,
                "alive": self.alive(),
                "finished": self._finished,
                "aborted": self._abort_request is not None
                or isinstance(self.fatal_error, TrackerAbortedError),
                "heartbeat_ms": self.heartbeat_ms,
                "dead_after_ms": self.dead_after_ms,
                "recover_grace_ms": self.recover_grace_ms,
                "elastic": self._leases is not None,
                "num_shards": self.num_shards,
                "lost_ranks": sorted(self._lost_ranks),
                "ranks": ranks,
            }
            if self._leases is not None:
                out["lease_ttl_ms"] = self.lease_ttl_ms
                out["leases"] = self._leases.snapshot_locked()
            return out

    def on_rank_dead(self, callback: Callable[[int, Dict[str, object]], None]
                     ) -> None:
        """Subscribe to dead-rank notifications. The callback runs on a
        dedicated notifier thread (never the serve loop) with
        (rank, info_dict) — WorkerSupervisor uses this for proactive
        relaunch ahead of its own CLI status poll."""
        self._dead_callbacks.append(callback)

    def _notify_dead(self, rank: int) -> None:
        if not self._dead_callbacks:
            return
        st = self._ranks.get(rank)
        info = {"rank": rank, "host": st.host if st else "",
                "restarts": st.restarts if st else 0,
                "jobid": st.jobid if st else "NULL",
                # same-process monotonic timestamp of the dead
                # incarnation's last heartbeat: lets the supervisor tell
                # a stale signal from a live one (_on_rank_dead)
                "last_beat_monotonic": st.last_beat if st else None}
        # ranks are assigned by host-sorted arrival, so rank !=
        # DMLC_TASK_ID in general; the wire-reported jobid ("task<N>",
        # RendezvousClient's default) is the authoritative mapping back
        # to the supervised task
        jobid = info["jobid"]
        if isinstance(jobid, str) and jobid.startswith("task") \
                and jobid[4:].isdigit():
            info["task_id"] = int(jobid[4:])
        if self._notify_thread is None:
            def drain():
                while True:
                    cb, r, inf = self._notify_q.get()
                    try:
                        cb(r, inf)
                    except Exception:
                        logger.exception("dead-rank callback failed")
            self._notify_thread = threading.Thread(target=drain, daemon=True)
            self._notify_thread.start()
        for cb in self._dead_callbacks:
            self._notify_q.put((cb, rank, info))

    # -- env / lifecycle -----------------------------------------------------
    def worker_envs(self) -> Dict[str, object]:
        """Env vars every worker needs (reference slave_envs,
        tracker.py:177-183), plus the liveness knobs when enabled so
        RendezvousClient auto-opens its heartbeat channel."""
        envs: Dict[str, object] = {"DMLC_TRACKER_URI": self.host_ip,
                                   "DMLC_TRACKER_PORT": self.port}
        if self.heartbeat_ms > 0:
            envs["DMLC_TRACKER_HEARTBEAT_MS"] = self.heartbeat_ms
            envs["DMLC_TRACKER_DEAD_AFTER_MS"] = self.dead_after_ms
        if self.num_shards > 0:
            # the data layer's elastic opt-in rides the same env ABI:
            # RowBlockIter.create switches to lease-driven iteration
            envs["DMLC_ELASTIC_SHARDS"] = 1
            envs["DMLC_TRACKER_NUM_SHARDS"] = self.num_shards
        return envs

    def start(self) -> None:
        """Begin serving worker connections on the tracker thread."""
        # rolling windows over the tracker's own registry: every scrape
        # surface gains window_* rates/quantiles (doc/observability.md
        # "SLO plane"); refcounted, released in _close_all
        telemetry.start_windowed_view()
        self._wv_started = True

        def guarded():
            try:
                self._serve(self.num_workers)
            except BaseException as e:  # surfaced by join()
                self.fatal_error = e
                logger.error("tracker failed: %s", e)
            finally:
                self._close_all()
        self.thread = threading.Thread(target=guarded, daemon=True)
        self.thread.start()

    def stop(self) -> None:
        """Unblock the serve loop and release the listener/port. Safe from
        any thread, idempotent, works whether or not start() was called —
        join() after stop() returns instead of raising TimeoutError with a
        leaked thread and port."""
        self._stop_requested = True
        self._wake()
        if self.thread is None:
            # never started: the bound port must still be released
            self._close_all()

    def abort(self, reason: str,
              dead_ranks: Optional[List[int]] = None) -> None:
        """Abort the job from any thread: broadcast to every live
        heartbeat channel, close down, and make join() raise a structured
        TrackerAbortedError. A supervisor that exhausted max_attempts
        calls this instead of leaving the tracker waiting on a rank that
        will never return."""
        if self._abort_request is None:
            self._abort_request = TrackerAbortedError(reason, dead_ranks)
        self._wake()
        if self.thread is None:
            self.fatal_error = self._abort_request
            self._close_all()

    def _wake(self) -> None:
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass

    def __enter__(self) -> "RabitTracker":
        if self.thread is None:
            self.start()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()
        if self.thread is not None:
            self.thread.join(timeout=10)

    def join(self, timeout: Optional[float] = None) -> None:
        """Block until every worker has shut down (job end). Raises
        TrackerAbortedError if the liveness layer (or a supervisor) gave
        the job up."""
        deadline = None if timeout is None else time.time() + timeout
        while self.thread is not None and self.thread.is_alive():
            self.thread.join(0.1)
            if deadline is not None and time.time() > deadline:
                raise TimeoutError("tracker did not finish in time")
        if isinstance(self.fatal_error, TrackerAbortedError):
            raise self.fatal_error
        if self.fatal_error is not None:
            raise RuntimeError("tracker serve loop failed") \
                from self.fatal_error

    def alive(self) -> bool:
        """True while the tracker thread is serving."""
        return self.thread is not None and self.thread.is_alive()

    # -- the event loop ------------------------------------------------------
    def _serve(self, num_workers: int) -> None:
        self._num_workers = num_workers
        handshake_timeout = env_float("DMLC_TRACKER_HANDSHAKE_TIMEOUT", 300.0)
        self._max_world = env_int("DMLC_TRACKER_MAX_WORLD", 1 << 20)

        sel = selectors.DefaultSelector()
        self._sel = sel
        self.listener.setblocking(False)
        sel.register(self.listener, selectors.EVENT_READ, "listener")
        sel.register(self._wake_r, selectors.EVENT_READ, "wake")

        while not self._finished:
            if self._stop_requested:
                logger.info("tracker stopped by request")
                return
            if self._abort_request is not None:
                self._do_abort(self._abort_request)
            for key, mask in sel.select(self._next_timeout(handshake_timeout)):
                if key.data == "listener":
                    self._accept_all()
                elif key.data == "wake":
                    try:
                        self._wake_r.recv(4096)
                    except OSError:
                        pass
                else:
                    conn = key.data
                    if mask & selectors.EVENT_WRITE:
                        self._flush(conn)
                    if mask & selectors.EVENT_READ and not conn.closed:
                        self._on_readable(conn)
            self._run_later()
            self._run_timers(handshake_timeout)

        self.end_time = time.time()
        logger.info("@tracker all workers finished")
        if self.start_time is not None:
            logger.info("@tracker %.3f secs between start and finish",
                        self.end_time - self.start_time)
        self._emit("finish", num_workers=self._num_workers)

    def _next_timeout(self, handshake_timeout: float) -> float:
        now = time.monotonic()
        deadline = now + 30.0
        with self._lock:
            items = list(self._ranks.items())
        for _, st in items:
            if st.phase == "alive" and self.dead_after_ms > 0 \
                    and st.last_beat is not None:
                deadline = min(deadline,
                               st.last_beat + self.dead_after_ms / 1000.0)
            elif st.phase == "dead" and st.dead_since is not None:
                deadline = min(deadline,
                               st.dead_since + self.recover_grace_ms / 1000.0)
        for conn in self._conns:
            # http conns are bounded in EVERY state (a scraper that never
            # reads its response parks at _WAIT and must still be swept)
            if conn.kind == "http" or (conn.kind == "proto"
                                       and isinstance(conn.want, int)):
                deadline = min(deadline,
                               conn.last_activity + handshake_timeout)
        for p in self._pulls.values():
            # a parked scrape must be served its partial view ON the
            # scrape deadline, not at the next 30 s tick
            deadline = min(deadline, p["deadline"])
        return max(0.0, deadline - now)

    def _run_later(self) -> None:
        while self._later:
            todo, self._later = self._later, []
            for fn in todo:
                fn()

    def _run_timers(self, handshake_timeout: float) -> None:
        now = time.monotonic()
        # a client that connected and went silent must not hold its rank
        # slot (or fds) forever; parked conns (awaiting the batch or a
        # peer's port) are exempt — they are waiting on the JOB, not
        # failing to speak
        # http conns time out in every state — including parked at _WAIT
        # awaiting response drain, where a stalled scraper would otherwise
        # hold its fd for the tracker's lifetime
        for conn in [c for c in self._conns
                     if (c.kind == "http" or (c.kind == "proto"
                                              and isinstance(c.want, int)))
                     and now - c.last_activity > handshake_timeout]:
            self._drop(conn, f"handshake timed out after "
                             f"{handshake_timeout:.0f}s")
        for seq in [s for s, p in self._pulls.items()
                    if now > p["deadline"]]:
            # scrape deadline: serve the ranks that replied (a legacy
            # client never answers the pull frame at all)
            self._resolve_pull(seq)
        if self._leases is not None:
            # TTL backstop (runs even with liveness disarmed): a holder
            # that stopped renewing — silent channel — forfeits its shards
            for epoch, shard, rank in self._leases.reclaim_expired(now):
                telemetry.counter("tracker_lease_reassigned_total").inc()
                self._emit("lease-expired", rank=rank, epoch=epoch,
                           shard=shard)
        if self.dead_after_ms <= 0:
            return
        with self._lock:
            items = list(self._ranks.items())
        dead_now = []
        for rank, st in items:
            if st.phase == "alive" and st.last_beat is not None and \
                    now - st.last_beat > self.dead_after_ms / 1000.0:
                dead_now.append(rank)
        for rank in dead_now:
            self._mark_dead(rank, now)
        expired = [r for r, st in items
                   if st.phase == "dead" and st.dead_since is not None
                   and now - st.dead_since > self.recover_grace_ms / 1000.0]
        if not expired:
            return
        if self._leases is not None:
            with self._lock:
                every_dance_done = len(self._linked) >= self._num_workers
            if every_dance_done:
                # elastic: degrade gracefully instead of failing loudly —
                # the rank is written off, its leases migrate to the
                # survivors, and the epoch completes without a relaunch.
                # _mark_lost FIRST even in mesh mode: the reclaim emits the
                # lease-reclaim events + flight dump that name exactly which
                # shards the dead rank held when it died
                for rank in expired:
                    self._mark_lost(rank)
                if self.abort_on_lost:
                    with self._lock:
                        lost = sorted(self._lost_ranks)
                    self._do_abort(TrackerAbortedError(
                        f"mesh rank(s) {sorted(expired)} lost mid-step: the "
                        f"surviving mesh cannot absorb their model shards; "
                        f"aborting the world for a supervised relaunch from "
                        f"the last committed checkpoint", lost))
                self._check_finished()
                return
            # a rank died before the rendezvous completed: survivors may
            # be parked in peer accept()/recv() waits that only the abort
            # broadcast unblocks — graceful degradation applies to the
            # data plane, never to a half-built link topology
        with self._lock:
            all_dead = [r for r, st in self._ranks.items()
                        if st.phase == "dead"]
        self._do_abort(TrackerAbortedError(
            f"rank(s) {sorted(expired)} missed the heartbeat deadline "
            f"({self.dead_after_ms} ms) and did not recover within the "
            f"grace window ({self.recover_grace_ms} ms)", all_dead))

    def _mark_dead(self, rank: int, now: float) -> None:
        st = self._ranks[rank]
        with self._lock:
            st.phase = "dead"
            st.dead_since = now
        age = (now - st.last_beat) * 1000.0 if st.last_beat else -1.0
        logger.warning("rank %d marked dead (no heartbeat for %.0f ms); "
                       "awaiting recover for %d ms", rank, age,
                       self.recover_grace_ms)
        self._emit("heartbeat-miss", rank=rank, age_ms=age)
        self._emit("dead", rank=rank, host=st.host)
        self._notify_dead(rank)

    def _mark_lost(self, rank: int) -> None:
        """Elastic write-off: a dead rank past its grace window stops
        blocking the job — its leases return to the pool for the
        survivors and the rank no longer owes a shutdown."""
        with self._lock:
            st = self._ranks.get(rank)
            if st is None or st.phase != "dead":
                return
            st.phase = "lost"
            st.dead_since = None
            self._lost_ranks.add(rank)
        reclaimed = self._leases.reclaim_rank(rank)
        telemetry.counter("tracker_lease_reassigned_total").inc(
            len(reclaimed))
        logger.warning(
            "rank %d written off (elastic): %d lease(s) returned to the "
            "pool; the job continues on the surviving workers", rank,
            len(reclaimed))
        self._emit("lost", rank=rank, reclaimed=len(reclaimed))
        for epoch, shard in reclaimed:
            self._emit("lease-reclaim", rank=rank, epoch=epoch, shard=shard)
        # flight recorder (doc/observability.md): the write-off ships its
        # own postmortem, and the dump reason itself names the shards the
        # dead rank held (the event ring carries the same facts, but the
        # reason line is what a human greps first)
        held = ", ".join(f"{e}:{s}" for e, s in reclaimed) or "none"
        telemetry.flight_dump(f"rank-lost: rank {rank} written off, "
                              f"{len(reclaimed)} lease(s) reclaimed "
                              f"(epoch:shard {held})"
                              f"{self._straggler_tail()}")

    def _check_finished(self) -> None:
        """Elastic finish rule (serve loop only): the job completes once
        every rank is checked out OR written off as lost — unless EVERY
        rank is lost, in which case nobody can finish the epoch and the
        job aborts loudly instead of idling forever."""
        if self._leases is None:
            return
        with self._lock:
            lost = set(self._lost_ranks)
        if len(lost) >= self._num_workers:
            self._do_abort(TrackerAbortedError(
                "every rank was written off as lost — no surviving worker "
                "can finish the epoch", sorted(lost)))
            return  # aborted is terminal: never also mark finished
        if self._maps is not None and not self._todo and \
                len(self._shutdown_ranks | lost) >= self._num_workers:
            self._finished = True

    def _beat(self, st: _RankState, rank: int) -> bool:
        """Record a liveness proof from `rank` (a ping or any lease
        frame); True when the beat revived a dead- or lost-marked rank."""
        with self._lock:
            st.last_beat = time.monotonic()
            if st.phase in ("dead", "lost"):
                # beats resumed inside (dead) or even after (lost) the
                # grace window: the rank is back — a lost rank's leases
                # were already reassigned, it simply resumes acquiring
                st.phase = "alive"
                st.dead_since = None
                self._lost_ranks.discard(rank)
                return True
            return False

    def _do_abort(self, err: TrackerAbortedError) -> None:
        """Broadcast the abort to every live heartbeat channel, close
        down, and surface the structured error through join()."""
        logger.error("aborting job: %s", err)
        self._emit("abort", reason=err.reason, dead_ranks=err.dead_ranks)
        # flight recorder: the abort path is exactly when the postmortem
        # matters; dumped AFTER the abort event so the ring carries it
        telemetry.flight_dump(
            f"tracker-abort: {err.reason}{self._straggler_tail()}")
        with self._lock:
            if self._event_log is not None:
                # fsync through to disk NOW: the abort path is exactly when
                # the process (or its node) is likeliest to die next.
                # lock-ok: terminal abort — the serve loop is the caller
                # and is about to raise out of _serve anyway
                self._event_log.flush()
        reason = err.reason.encode()
        frame = struct.pack("@i", HEARTBEAT_ABORT) + \
            struct.pack("@i", len(reason)) + reason
        for conn in list(self._conns):
            if conn.kind != "heartbeat" or conn.closed:
                continue
            try:
                # best-effort synchronous flush: the loop is about to exit,
                # so buffered-writes bookkeeping no longer applies
                conn.sock.setblocking(True)
                conn.sock.settimeout(1.0)
                conn.sock.sendall(bytes(conn.outbuf) + frame)
            except OSError:
                pass
        raise err

    # -- connection plumbing -------------------------------------------------
    def _accept_all(self) -> None:
        while True:
            try:
                fd, addr = self.listener.accept()
            except (BlockingIOError, OSError):
                return
            try:
                host = resolve_ip(addr[0])
            except OSError:
                host = addr[0]
            fd.setblocking(False)
            conn = _Conn(fd, host)
            conn.gen = self._proto(conn)
            self._conns.add(conn)
            self._sel.register(fd, selectors.EVENT_READ, conn)
            conn.registered = True
            self._advance(conn, None)  # run to the first `yield n`

    def _on_readable(self, conn: _Conn) -> None:
        try:
            data = conn.sock.recv(65536)
        except BlockingIOError:
            return
        except OSError as e:
            self._conn_eof(conn, e)
            return
        if not data:
            self._conn_eof(conn, None)
            return
        conn.inbuf += data
        if conn.kind == "http" and len(conn.inbuf) > 8192:
            # a scrape client has no business sending more than one small
            # request; unconsumed bytes on a parked conn would otherwise
            # buffer unboundedly
            self._drop(conn, "http client kept sending after its request")
            return
        conn.last_activity = time.monotonic()
        self._pump(conn)

    def _pump(self, conn: _Conn) -> None:
        while not conn.closed and isinstance(conn.want, int) \
                and len(conn.inbuf) >= conn.want:
            chunk = bytes(conn.inbuf[:conn.want])
            del conn.inbuf[:conn.want]
            self._step(conn, chunk)

    def _advance(self, conn: _Conn, value) -> None:
        """Resume a coroutine from outside the read path (initial start,
        batch assignment, port-waiter wake-up), then keep pumping: the
        bytes the resumed coroutine needs next may ALREADY be buffered —
        no further read event will announce them."""
        self._step(conn, value)
        self._pump(conn)

    def _step(self, conn: _Conn, value) -> None:
        try:
            conn.want = conn.gen.send(value)
        except StopIteration:
            self._close_conn(conn)
        except _Reject as e:
            self._drop(conn, str(e))
        except (ConnectionError, OSError, UnicodeDecodeError,
                ValueError) as e:
            self._drop(conn, str(e))

    def _send_bytes(self, conn: _Conn, data: bytes) -> None:
        conn.outbuf += data
        self._flush(conn)

    def _send_int(self, conn: _Conn, v: int) -> None:
        self._send_bytes(conn, struct.pack("@i", v))

    def _send_str(self, conn: _Conn, s: str) -> None:
        data = s.encode()
        self._send_bytes(conn, struct.pack("@i", len(data)) + data)

    def _flush(self, conn: _Conn) -> None:
        if conn.closed:
            return
        try:
            while conn.outbuf:
                sent = conn.sock.send(conn.outbuf)
                del conn.outbuf[:sent]
        except BlockingIOError:
            pass
        except OSError as e:
            self._conn_eof(conn, e)
            return
        if conn.drain_close and not conn.outbuf:
            # an http response fully on the wire: close now (the scrape
            # coroutine parked itself instead of returning, so the close
            # happens here — AFTER the bytes left, not before)
            self._close_conn(conn)
            return
        mask = selectors.EVENT_READ
        if conn.outbuf:
            mask |= selectors.EVENT_WRITE
        try:
            self._sel.modify(conn.sock, mask, conn)
        except (KeyError, ValueError, OSError):
            pass

    def _conn_eof(self, conn: _Conn, err: Optional[OSError]) -> None:
        if conn.kind == "heartbeat" and conn.rank is not None:
            st = self._ranks.get(conn.rank)
            if st is not None and st.hb is conn:
                st.hb = None
                if conn.rank not in self._shutdown_ranks and \
                        st.phase == "alive":
                    # no more beats will arrive; the dead-after clock keeps
                    # running from the last one (a SIGKILLed worker's OS
                    # sends this FIN immediately — detection starts now,
                    # not at the next poll)
                    logger.warning(
                        "heartbeat channel of rank %d closed unexpectedly",
                        conn.rank)
                    self._emit("heartbeat-lost", rank=conn.rank)
            self._close_conn(conn)
            return
        if conn.rank is not None and not self._finished:
            logger.warning(
                "worker %s died during rank %d handshake: %s "
                "(awaiting recover)", conn.host, conn.rank,
                err or "peer closed")
        elif err is not None:
            logger.warning("connection from %s failed: %s", conn.host, err)
        self._close_conn(conn)

    def _drop(self, conn: _Conn, why: str) -> None:
        if conn.rank is not None:
            logger.warning("worker %s died during rank %d handshake: %s "
                           "(awaiting recover)", conn.host, conn.rank, why)
        else:
            logger.warning("rejected connection from %s: %s", conn.host, why)
        self._close_conn(conn)

    def _close_conn(self, conn: _Conn) -> None:
        if conn.closed:
            return
        conn.closed = True
        self._conns.discard(conn)
        if conn in self._pending:
            self._pending.remove(conn)
        if conn in self._port_waiters:
            self._port_waiters.remove(conn)
        for seq in [s for s, p in self._pulls.items()
                    if p["conn"] is conn]:
            # the scrape died while parked: late pushes must not resume a
            # closed coroutine
            del self._pulls[seq]
        if conn.rank is not None and conn.kind == "proto":
            # a decision parked on this rank's port must not wait forever
            self._pending_ports.discard(conn.rank)
            self._later.append(self._resume_port_waiters)
        if conn.registered:
            try:
                self._sel.unregister(conn.sock)
            except (KeyError, ValueError, OSError):
                pass
            conn.registered = False
        try:
            # drain already-arrived bytes so close() sends FIN, not RST —
            # closing with unread data in the kernel buffer resets the
            # peer, and tests asserting a clean drop would flake on the
            # race
            conn.sock.setblocking(False)
            while conn.sock.recv(4096):
                pass
        except OSError:
            pass
        try:
            conn.sock.close()
        except OSError:
            pass

    def _close_all(self) -> None:
        for conn in list(self._conns):
            self._close_conn(conn)
        for s in (self.listener, self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass
        with self._lock:
            if self._event_log is not None:
                self._event_log.close()
                self._event_log = None
        # a closed tracker must stop publishing gauges into scrapes
        telemetry.unregister_collector(self._publish_telemetry)
        if self._wv_started:
            self._wv_started = False
            telemetry.stop_windowed_view()

    # -- the tracker protocol, as one coroutine per connection ---------------
    def _proto(self, conn: _Conn):
        head = yield 4
        if head == b"GET ":
            # content-sniffed read-only scrape surface on the SAME port
            # (doc/observability.md): a legitimate worker frame starts with
            # the little-endian MAGIC int, never ASCII "GET ". The scrape
            # runs inside this coroutine like any other connection — it can
            # never block the rendezvous.
            yield from self._http_get(conn, head)
            return
        method = minihttp.sniff_method(head)
        if method is not None:
            # a real HTTP client speaking a method this read-only surface
            # doesn't serve (POST, PUT, ...): answer a loud 405 instead of
            # misreading ASCII as a worker frame and dropping the socket
            # with "invalid magic"
            yield from self._http_reject(conn, minihttp.HttpError(
                405, f"method {method} not allowed; "
                     "this surface serves GET only"))
            return
        magic = struct.unpack("@i", head)[0]
        if magic != MAGIC:
            raise _Reject(f"invalid magic {magic:#x}")
        self._send_int(conn, MAGIC)
        rank = yield from _r_int()
        world = yield from _r_int()
        jobid = yield from _r_str()
        cmd = yield from _r_str()
        conn.jobid = jobid

        if cmd == "print":
            msg = yield from _r_str()
            logger.info("%s", msg.strip())
            return
        if cmd == "shutdown":
            # only ranks that were actually handed out may check out: a
            # spoofed shutdown for a merely in-range rank would otherwise
            # end the rendezvous under live workers
            if rank not in self._assigned or rank in self._shutdown_ranks:
                raise _Reject(
                    f"rejecting shutdown: rank {rank} is " +
                    ("already shut down" if rank in self._shutdown_ranks
                     else "not an assigned rank"))
            self._shutdown_ranks.add(rank)
            self._rank_shutdown(rank)
            logger.debug("rank %d shut down", rank)
            if len(self._shutdown_ranks) == self._num_workers:
                self._finished = True
            else:
                # elastic: lost ranks owe no shutdown — this checkout may
                # have been the last one the job was waiting for
                self._check_finished()
            return
        if cmd == CMD_HEARTBEAT:
            if rank not in self._assigned:
                raise _Reject(
                    f"rejecting heartbeat: rank {rank} was never assigned")
            yield from self._hb_loop(conn, rank)
            return
        if cmd not in ("start", "recover"):
            raise _Reject(f"unknown command {cmd!r}")

        if self._maps is None:
            if cmd != "start":
                raise _Reject(f"rejecting {cmd}: no worker has started yet")
            if world > self._max_world:
                # the first start frame pins the world size; an unbounded
                # value would feed build_link_maps an O(n) allocation and
                # make the job unfinishable
                raise _Reject(
                    f"rejecting start: world_size {world} exceeds "
                    f"DMLC_TRACKER_MAX_WORLD={self._max_world}")
            if world > 0:
                self._num_workers = world
                self.num_workers = world
            self._maps = topology.build_link_maps(self._num_workers)
            self._todo = list(range(self._num_workers))
        elif world not in (-1, self._num_workers):
            raise _Reject(
                f"rejecting {cmd}: world_size {world} does not match "
                f"the job's {self._num_workers}")
        if rank >= 0 and rank not in self._assigned:
            # a preset rank (recover, or start claiming one) is only
            # honored for ranks this tracker actually handed out — an
            # unauthenticated claim would hijack the rank's topology slot
            # and reroute its peers' links
            raise _Reject(
                f"rejecting {cmd}: rank {rank} was never assigned")

        if rank < 0 and jobid != "NULL" and jobid in self._job_map:
            rank = self._job_map[jobid]
        if rank >= self._num_workers:
            raise _Reject(f"rejecting {cmd}: rank {rank} out of range")

        if rank == -1:
            self._pending.append(conn)
            self._later.append(self._maybe_assign_batch)
            rank = yield _WAIT  # resumed with the batch-assigned rank
            if jobid != "NULL":
                self._job_map[jobid] = rank
        else:
            self._rank_recovering(rank, cmd)
        yield from self._assign_dance(conn, rank)
        with self._lock:
            self._linked.add(rank)
        logger.debug("%s rank %d linked (%s)", cmd, rank, conn.host)

    def _maybe_assign_batch(self) -> None:
        if self._maps is None or not self._todo or \
                len(self._pending) != len(self._todo):
            return
        # batch assignment sorted by host for locality (reference
        # tracker.py:292-304)
        batch, self._pending = self._pending, []
        batch.sort(key=lambda c: c.host)
        for conn in batch:
            r = self._todo.pop(0)
            # the rank is handed out from here on (a worker dying
            # mid-handshake reclaims it via recover, which requires
            # membership in _assigned)
            self._assigned.add(r)
            with self._lock:
                st = self._ranks.setdefault(r, _RankState(conn.host))
                st.host = conn.host
            self._emit("assign", rank=r, host=conn.host)
            logger.debug("assigned rank %d to %s", r, conn.host)
            self._advance(conn, r)
        if not self._todo:
            logger.info("@tracker all %d workers started", self._num_workers)
            self.start_time = time.time()

    def _rank_recovering(self, rank: int, cmd: str) -> None:
        with self._lock:
            # about to re-dance: the rank is unlinked until it completes
            self._linked.discard(rank)
            st = self._ranks.setdefault(rank, _RankState())
            was_dead = st.phase == "dead"
            if cmd == "recover":
                st.restarts += 1
            # liveness re-arms when the restarted worker opens its new
            # heartbeat channel; until then the rank is merely assigned
            st.phase = "assigned"
            st.dead_since = None
            st.last_beat = None
            # a written-off rank that recovers is tracked again (its old
            # leases were already reassigned; it resumes acquiring fresh)
            self._lost_ranks.discard(rank)
        if cmd == "recover":
            self._emit("recover", rank=rank, was_dead=was_dead)

    def _rank_shutdown(self, rank: int) -> None:
        with self._lock:
            st = self._ranks.setdefault(rank, _RankState())
            st.phase = "shutdown"
            st.dead_since = None
            hb = st.hb
            st.hb = None
        if hb is not None:
            self._close_conn(hb)
        self._emit("shutdown", rank=rank)

    def _hb_loop(self, conn: _Conn, rank: int):
        conn.kind = "heartbeat"
        conn.rank = rank
        with self._lock:
            st = self._ranks.setdefault(rank, _RankState(conn.host))
            old = st.hb
            st.hb = conn
            st.last_beat = time.monotonic()
            st.phase = "alive"
        if old is not None:
            self._close_conn(old)
        self._emit("heartbeat-open", rank=rank, host=conn.host)
        # announce the ping interval the worker should hold
        self._send_int(conn, self.heartbeat_ms if self.heartbeat_ms > 0
                       else 1000)
        # the lease RPCs ride THIS channel (doc/robustness.md "Elastic
        # data-plane"): no second connection per renewal, and every lease
        # frame doubles as a liveness proof. Metric resolved once per
        # channel (registry contract: resolve, keep the pointer).
        renew_us = telemetry.histogram("lease_renew_us")
        while True:
            word = yield 4  # one int32 ping / lease command / graceful BYE
            val = struct.unpack("@i", word)[0]
            if val == LEASE_ACQUIRE:
                epoch = yield from _r_int()
                revived = self._beat(st, rank)
                grant = (self._leases.acquire(rank, epoch, time.monotonic())
                         if self._leases is not None else LEASE_DRAINED)
                self._send_bytes(conn, struct.pack("@ii", LEASE_GRANT,
                                                   grant))
                if grant >= 0:
                    self._emit("lease-grant", rank=rank, epoch=epoch,
                               shard=grant)
                if revived:
                    self._emit("revived", rank=rank)
                continue
            if val in (LEASE_RELEASE, LEASE_COMPLETE):
                epoch = yield from _r_int()
                shard = yield from _r_int()
                revived = self._beat(st, rank)
                if self._leases is not None:
                    if val == LEASE_RELEASE:
                        if self._leases.release(rank, epoch, shard):
                            self._emit("lease-release", rank=rank,
                                       epoch=epoch, shard=shard)
                    else:
                        ok, drained = self._leases.complete(rank, epoch,
                                                            shard)
                        self._emit("lease-complete" if ok
                                   else "lease-stale-complete",
                                   rank=rank, epoch=epoch, shard=shard)
                        if ok and drained:
                            self._emit("epoch-drained", epoch=epoch)
                if revived:
                    self._emit("revived", rank=rank)
                continue
            if val == TELEMETRY_PUSH:
                # a rank answering a scrape-time pull with its telemetry
                # document (doc/observability.md "Cluster aggregation");
                # the push is a liveness proof like any other frame
                n = yield from _r_int()
                if n < 0 or n > TELEMETRY_PUSH_MAX:
                    raise _Reject(
                        f"invalid telemetry push length {n} from rank "
                        f"{rank}")
                data = yield n
                revived = self._beat(st, rank)
                try:
                    doc = json.loads(data.decode())
                except (ValueError, UnicodeDecodeError):
                    doc = None  # a torn export degrades this rank's slice
                if not isinstance(doc, dict):
                    # valid-JSON-but-not-an-object must degrade the same
                    # way: the renderers assume a dict, and an exception
                    # out of a resumed scrape coroutine would kill the
                    # serve loop — one bad frame must never cost the job
                    doc = None
                if doc is not None:
                    self._harvest_steps(rank, doc)
                    self._telemetry_reply(rank, doc)
                if revived:
                    self._emit("revived", rank=rank)
                continue
            if val == HEARTBEAT_BYE:
                # graceful channel close (normal shutdown path): disarm
                # liveness for this rank — a BYE is teardown, never a
                # death, so no heartbeat-lost noise and no dead clock
                # left ticking between BYE and the shutdown cmd. Only
                # the CURRENT channel may disarm: a stale channel's
                # buffered BYE processed after its replacement opened
                # (the recover path) must not untrack the live rank.
                with self._lock:
                    if st.hb is conn:
                        st.hb = None
                        if st.phase in ("alive", "dead"):
                            st.phase = "assigned"
                            st.dead_since = None
                            st.last_beat = None
                self._emit("heartbeat-bye", rank=rank)
                return
            # a plain ping (any non-negative value): liveness proof plus
            # implicit renewal of every lease this rank holds
            revived = self._beat(st, rank)
            if self._leases is not None:
                t0 = time.perf_counter() if telemetry.enabled() else None
                self._leases.renew(rank, time.monotonic())
                if t0 is not None:
                    renew_us.observe((time.perf_counter() - t0) * 1e6)
            if revived:  # _emit takes the lock itself — never nest it
                self._emit("revived", rank=rank)

    def _assign_dance(self, conn: _Conn, rank: int):
        """Send the topology assignment and broker peer connections (the
        reference assign_rank handshake), concurrently with every other
        connection's dance."""
        tree_map, parent_map, ring_map = self._maps
        conn.rank = rank
        with self._lock:
            st = self._ranks.setdefault(rank, _RankState(conn.host))
            st.host = conn.host
            st.attempts += 1
            if conn.jobid != "NULL":
                st.jobid = conn.jobid
        neighbors = set(tree_map[rank])
        rprev, rnext = ring_map[rank]
        out = bytearray()
        out += struct.pack("@i", rank)
        out += struct.pack("@i", parent_map[rank])
        out += struct.pack("@i", len(tree_map))  # world size
        out += struct.pack("@i", len(neighbors))
        for r in neighbors:
            out += struct.pack("@i", r)
        for ring_peer in (rprev, rnext):
            if ring_peer != -1 and ring_peer != rank:
                neighbors.add(ring_peer)
                out += struct.pack("@i", ring_peer)
            else:
                out += struct.pack("@i", -1)
        self._send_bytes(conn, bytes(out))
        while True:
            ngood = yield from _r_int()
            if ngood < 0 or ngood > len(tree_map):
                raise _Reject(
                    f"rank {rank} reported {ngood} good links "
                    f"(world is {len(tree_map)})")
            good = set()
            for _ in range(ngood):
                good.add((yield from _r_int()))
            if not good.issubset(neighbors):
                # a peer claiming links it was never assigned is a
                # protocol violation — drop IT, not the tracker thread
                raise _Reject(
                    f"rank {rank} reported links {sorted(good - neighbors)} "
                    f"outside its neighbor set")
            bad = neighbors - good
            # Concurrency guard the blocking tracker never needed: a peer
            # whose decision said "await dials" but whose listen port has
            # not arrived yet is invisible in wait_conn — deciding THIS
            # worker now could tell both sides to wait for each other.
            # Park until every such peer's port lands, then recompute.
            while bad & self._pending_ports:
                self._port_waiters.append(conn)
                yield _WAIT
            dial = [r for r in bad if r in self._wait_conn]
            nwait = len(bad) - len(dial)
            out = bytearray()
            out += struct.pack("@i", len(dial))
            out += struct.pack("@i", nwait)
            for r in dial:
                e = self._wait_conn[r]
                host = e.host.encode()
                out += struct.pack("@i", len(host)) + host
                out += struct.pack("@i", e.port)
                out += struct.pack("@i", r)
            self._send_bytes(conn, bytes(out))
            if nwait > 0:
                self._pending_ports.add(rank)
            nerr = yield from _r_int()
            if nerr != 0:
                # worker retries the handshake round; this round's
                # decision is void
                self._pending_ports.discard(rank)
                self._later.append(self._resume_port_waiters)
                continue
            port = yield from _r_int()
            for r in dial:
                e = self._wait_conn.get(r)
                if e is None:
                    continue
                e.wait_accept -= 1
                if e.wait_accept == 0:
                    del self._wait_conn[r]
            if nwait > 0:
                self._wait_conn[rank] = _WaitEntry(conn.host, port, nwait)
            self._pending_ports.discard(rank)
            self._later.append(self._resume_port_waiters)
            return

    # -- cluster telemetry pulls (doc/observability.md) ----------------------
    def _start_telemetry_pull(self, conn: _Conn) -> Optional[int]:
        """Ask every live heartbeat channel for its rank's telemetry
        document and register `conn` (a parked http scrape) as the
        waiter. Returns the pull id, or None when no channel is live (the
        caller renders the tracker-only view immediately)."""
        chans: Dict[int, _Conn] = {}
        for c in list(self._conns):
            if c.kind == "heartbeat" and not c.closed \
                    and c.rank is not None:
                chans[c.rank] = c  # recover races: the latest channel wins
        if not chans:
            return None
        for c in chans.values():
            self._send_bytes(c, struct.pack("@i", TELEMETRY_PULL))
        self._pull_seq += 1
        self._pulls[self._pull_seq] = {
            "conn": conn, "want": set(chans), "got": {},
            "deadline": time.monotonic() + self.scrape_timeout_ms / 1000.0,
        }
        return self._pull_seq

    def _telemetry_reply(self, rank: int, doc: dict) -> None:
        """Route one rank's TELEMETRY_PUSH document to every pull waiting
        on it; a pull whose last rank replied resolves immediately."""
        for seq in [s for s, p in self._pulls.items() if rank in p["want"]]:
            p = self._pulls[seq]
            p["got"][rank] = doc
            p["want"].discard(rank)
            if not p["want"]:
                self._resolve_pull(seq)

    def _resolve_pull(self, seq: int) -> None:
        """Resume the parked scrape with whatever arrived (all ranks, or
        a partial set at the deadline — legacy clients never answer)."""
        p = self._pulls.pop(seq, None)
        if p is None or p["conn"].closed:
            return
        conn, got = p["conn"], p["got"]
        self._later.append(
            lambda: None if conn.closed else self._advance(conn, got))

    def _http_get(self, conn: _Conn, head: bytes):
        """Read-only HTTP scrape served from the rendezvous port (content-
        sniffed ``GET``): ``/metrics`` renders the JOB-WIDE telemetry view
        (tracker's own snapshot + per-rank series labeled ``rank=`` +
        ``job:`` sums, pulled from every live heartbeat channel at scrape
        time), ``/trace`` the merged Chrome-trace timeline with one lane
        per rank, ``/healthz`` a cheap liveness probe, ``/state`` the
        thread-safe state() JSON. Runs as a normal connection coroutine —
        byte-at-a-time header reads through the selectors loop, the
        telemetry pull parks at ``_WAIT`` until the ranks reply (or the
        scrape deadline serves a partial set), response buffered through
        outbuf, socket closed once it drains (drain_close)."""
        conn.kind = "http"
        req = bytearray(head)
        while b"\r\n\r\n" not in req:
            if len(req) > minihttp.MAX_REQUEST_HEAD:
                # loud 431 instead of a silent drop: the scraper sees WHY
                # its request was refused (doc/serving.md's mini-HTTP
                # discipline, shared with the scoring front end)
                logger.warning("oversized http request head from %s "
                               "(> %d bytes)", conn.host,
                               minihttp.MAX_REQUEST_HEAD)
                yield from self._http_reject(conn, minihttp.HttpError(
                    431, "request head exceeds "
                         f"{minihttp.MAX_REQUEST_HEAD} bytes"))
                return
            req += yield 1
        line = bytes(req).split(b"\r\n", 1)[0].decode("latin-1", "replace")
        parts = line.split()
        path = (parts[1] if len(parts) >= 2 else "/").split("?", 1)[0]
        if path in ("/metrics", "/trace"):
            # the job-wide view: pull every live rank's document over the
            # heartbeat channels, park until they land (or the deadline
            # degrades to the ranks that replied). Never triggers a
            # native build: telemetry.snapshot merges the native registry
            # only when its library is already loaded.
            replies: Dict[int, dict] = {}
            if self._start_telemetry_pull(conn) is not None:
                replies = yield _WAIT
            if path == "/metrics":
                body = telemetry.cluster_prometheus_text(replies).encode()
                status, ctype = 200, \
                    "text/plain; version=0.0.4; charset=utf-8"
            else:
                # the straggler verdict rides the merged timeline as a
                # job_meta record, so the one-timeline view names the
                # dragging rank next to its visibly-longer step spans
                body = (telemetry.cluster_trace_json(
                            replies, meta=self._straggler()) +
                        "\n").encode()
                status, ctype = 200, "application/json"
        elif path == "/healthz":
            st = self.state()
            alive_ranks = sum(1 for r in st["ranks"].values()
                              if r["phase"] == "alive")
            healthy = st["alive"] and not st["aborted"]
            body = (json.dumps({
                "status": "ok" if healthy else
                ("aborted" if st["aborted"] else "stopped"),
                "finished": st["finished"],
                "num_workers": st["num_workers"],
                "alive_ranks": alive_ranks,
                "lost_ranks": st["lost_ranks"],
            }) + "\n").encode()
            status = 200 if healthy else 503
            ctype = "application/json"
        elif path == "/state":
            body = (json.dumps(self.state()) + "\n").encode()
            status, ctype = 200, "application/json"
        else:
            body = b"not found; scrape /metrics, /trace, /state, " \
                   b"or /healthz\n"
            status, ctype = 404, "text/plain"
        resp = minihttp.render(status, body, ctype)
        conn.drain_close = True
        self._send_bytes(conn, resp)
        # park (never returns): _flush closes the socket once the response
        # drains — returning here would close it with bytes still buffered
        yield _WAIT

    def _http_reject(self, conn: _Conn, err: "minihttp.HttpError"):
        """Answer one HTTP error on a sniffed connection and park until
        the response drains (405 for non-GET methods, 431 for oversized
        request heads) — the client gets a structured refusal instead of
        a bare socket close."""
        conn.kind = "http"
        conn.drain_close = True
        self._send_bytes(conn, minihttp.render_error(err))
        yield _WAIT

    def _resume_port_waiters(self) -> None:
        waiters, self._port_waiters = self._port_waiters, []
        for conn in waiters:
            if not conn.closed:
                self._advance(conn, None)  # recompute its round decision


class PSTracker:
    """Launches the parameter-server scheduler (reference PSTracker)."""

    def __init__(self, host_ip: str, cmd: Optional[str],
                 port: int = 9091, port_end: int = 9999,
                 envs: Optional[Dict[str, object]] = None):
        self.cmd = cmd
        self.host_ip = host_ip
        self.thread: Optional[threading.Thread] = None
        if cmd is None:
            return
        # the probe binds the address the scheduler will bind: the
        # reference probes "" here, which getaddrinfo refuses, so its
        # PSTracker cannot start a scheduler (ROADMAP.md section 3)
        sock = bind_free_port(host_ip, port, port_end)
        self.port = sock.getsockname()[1]
        sock.close()  # scheduler process will re-bind it
        env = os.environ.copy()
        env["DMLC_ROLE"] = "scheduler"
        env["DMLC_PS_ROOT_URI"] = str(host_ip)
        env["DMLC_PS_ROOT_PORT"] = str(self.port)
        for k, v in (envs or {}).items():
            env[k] = str(v)
        self.thread = threading.Thread(
            target=lambda: subprocess.check_call(
                self.cmd, env=env, shell=True, executable="/bin/bash"),
            daemon=True)
        self.thread.start()

    def worker_envs(self) -> Dict[str, object]:
        """Env vars a PS-lite worker/server needs to find this tracker."""
        if self.cmd is None:
            return {}
        return {"DMLC_PS_ROOT_URI": self.host_ip,
                "DMLC_PS_ROOT_PORT": self.port}

    def join(self) -> None:
        """Block until every worker/server has checked out."""
        if self.thread is not None:
            while self.thread.is_alive():
                self.thread.join(0.1)

    def alive(self) -> bool:
        """True while the tracker thread is serving."""
        return self.thread is not None and self.thread.is_alive()


def _free_coordinator_port(host_ip: str) -> int:
    """A fresh ephemeral port for the world's ``torch.distributed`` store.

    Derived per world attempt — NEVER reused across a relaunch: a
    SIGKILL'd coordinator can leave its old port in TIME_WAIT (or held by
    an undead worker mid-teardown), and rank 0's ``TCPStore`` on a
    stale address is an EADDRINUSE or a silent cross-talk with the dead
    world. The kernel picks the port; the tiny bind-then-close race is
    acceptable for a coordinator that binds within milliseconds."""
    s = socket.socket(addr_family(host_ip), socket.SOCK_STREAM)
    try:
        s.bind((host_ip, 0))
        return s.getsockname()[1]
    finally:
        s.close()


def run_job(num_workers: int, num_servers: int, launch_fn, host_ip="auto",
            ps_cmd: Optional[str] = None,
            heartbeat_ms: Optional[int] = None,
            dead_after_ms: Optional[int] = None,
            num_shards: Optional[int] = None,
            mesh: bool = False,
            world_attempts: Optional[int] = None,
            abort_on_lost: Optional[bool] = None) -> None:
    """Start the right tracker and hand worker envs to a cluster launcher
    (reference tracker.submit, tracker.py:410-433). A launch_fn accepting
    a 4th argument receives the RabitTracker so supervising backends can
    wire dead-rank notifications both ways (supervisor.attach_tracker).

    ``mesh=True`` runs an elastic-mesh world (doc/robustness.md "Elastic
    mesh training"): workers get a ``DMLC_COORDINATOR_ADDRESS`` for
    ``torch.distributed`` (parallel.distributed.init_from_env), a
    lost rank aborts the world instead of degrading, and a
    TrackerAbortedError triggers a WHOLE-WORLD relaunch — fresh tracker,
    fresh coordinator port (the dead one may sit in TIME_WAIT), fresh
    worker processes resuming from the last committed job checkpoint — up
    to ``world_attempts`` times (env ``DMLC_TRACKER_WORLD_ATTEMPTS``).
    The launch_fn's return value, when callable, is invoked before each
    relaunch to stop the previous attempt's surviving processes
    (submit_local returns its supervisor's ``stop``)."""
    host_ip = guess_host_ip(host_ip)
    if num_servers == 0:
        attempts = world_attempts if world_attempts is not None \
            else env_int("DMLC_TRACKER_WORLD_ATTEMPTS", 2 if mesh else 0)
        attempt = 0
        while True:
            envs = {"DMLC_NUM_WORKER": num_workers,
                    "DMLC_NUM_SERVER": num_servers}
            tracker = RabitTracker(
                host_ip, num_workers,
                heartbeat_ms=heartbeat_ms,
                dead_after_ms=dead_after_ms,
                num_shards=num_shards,
                abort_on_lost=abort_on_lost if abort_on_lost is not None
                else (True if mesh else None))
            envs.update(tracker.worker_envs())
            if mesh:
                # the coordination service address is re-derived EVERY
                # attempt through the same ephemeral-bind path that
                # releases tracker ports (stop() -> _close_all): reusing
                # the dead world's port is the EADDRINUSE trap the
                # relaunch test pins
                envs["DMLC_COORDINATOR_ADDRESS"] = \
                    f"{host_ip}:{_free_coordinator_port(host_ip)}"
                envs["DMLC_WORLD_ATTEMPT"] = attempt
            tracker.start()
            stopper = None
            if tracker.alive():
                import inspect
                # pass the tracker only if launch_fn can BIND a 4th
                # positional arg — counting raw parameters would miscount
                # keyword-only / **kwargs signatures and crash
                # previously-working callbacks
                try:
                    inspect.signature(launch_fn).bind(
                        num_workers, num_servers, envs, tracker)
                    takes_tracker = True
                except (TypeError, ValueError):
                    takes_tracker = False
                if takes_tracker:
                    ret = launch_fn(num_workers, num_servers, envs, tracker)
                else:
                    ret = launch_fn(num_workers, num_servers, envs)
                stopper = ret if callable(ret) else None
            try:
                tracker.join()
                return
            except TrackerAbortedError:
                attempt += 1
                if attempt > attempts:
                    raise
                telemetry.counter("tracker_world_relaunches_total").inc()
                logger.warning(
                    "world attempt %d aborted; relaunching (%d attempt(s) "
                    "left)", attempt - 1, attempts - attempt + 1)
                # stop the dead world completely before binding the next:
                # surviving worker processes are torn down first (they
                # hold mesh state for a world that no longer exists), then
                # the tracker port is released through stop()
                if stopper is not None:
                    try:
                        stopper()
                    except Exception:
                        logger.exception("world stop callback failed")
                tracker.stop()
    else:
        envs = {"DMLC_NUM_WORKER": num_workers,
                "DMLC_NUM_SERVER": num_servers}
        ps = PSTracker(host_ip, ps_cmd, envs=envs)
        envs.update(ps.worker_envs())
        if ps.alive() or ps.cmd is None:
            launch_fn(num_workers, num_servers, envs)
        ps.join()


def start_standalone_tracker(num_workers: int, num_servers: int = 0,
                             host_ip=None) -> None:
    """Print the env block and serve (reference start_rabit_tracker,
    tracker.py:435-453)."""
    import sys
    envs = {"DMLC_NUM_WORKER": num_workers,
            "DMLC_NUM_SERVER": num_servers}
    tracker = RabitTracker(guess_host_ip(host_ip), num_workers)
    envs.update(tracker.worker_envs())
    tracker.start()
    sys.stdout.write("DMLC_TRACKER_ENV_START\n")
    for k, v in envs.items():
        sys.stdout.write(f"{k}={v}\n")
    sys.stdout.write("DMLC_TRACKER_ENV_END\n")
    sys.stdout.flush()
    tracker.join()
