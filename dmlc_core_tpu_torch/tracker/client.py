"""Worker-side rendezvous client.

The reference ships only the tracker half (the worker half lives in the
separate Rabit C++ library). This client implements the worker side of the
same wire protocol so that (a) the tracker is testable in-process with N
fake workers — the single-process multi-"host" simulation strategy the
reference applies to InputSplit (SURVEY §4) — and (b) Python workers can
join a legacy Rabit rendezvous without the C++ library.

Liveness (doc/robustness.md "Distributed job liveness"): when the tracker
exports DMLC_TRACKER_HEARTBEAT_MS (or ``start(heartbeat=True)``), the
client opens a persistent heartbeat channel after learning its rank. The
HeartbeatMonitor pings on the announced interval and listens for the
tracker's abort broadcast; on abort it slams every guarded socket so a
worker blocked in a peer link raises TrackerAbortedError within the
deadline instead of hanging forever. Every client-side socket op also
carries a timeout — a hung tracker or a peer that never dials fails the
worker within DMLC_TRACKER_CLIENT_TIMEOUT seconds, not never.

The port's own copy of ``dmlc_core_tpu/tracker/client.py`` (it imports nothing of
the JAX package): the same names, env variables, CLI flags and wire
bytes, so a worker of either package joins the other's tracker.
"""

from __future__ import annotations

import json
import os
import queue
import socket
import struct
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from dmlc_core_tpu_torch import telemetry
from dmlc_core_tpu_torch.tracker.wire import (CMD_HEARTBEAT, HEARTBEAT_ABORT,
                                        HEARTBEAT_BYE, HEARTBEAT_PING,
                                        LEASE_ACQUIRE, LEASE_COMPLETE,
                                        LEASE_DRAINED, LEASE_EMPTY,
                                        LEASE_GRANT, LEASE_RELEASE, MAGIC,
                                        TELEMETRY_PULL, TELEMETRY_PUSH,
                                        TrackerAbortedError, WireSocket,
                                        env_float, env_int)


def _default_timeout() -> float:
    """Deadline for every client-side blocking socket op (seconds).
    `0` disables the deadline (the native I/O deadline convention) — returned as inf,
    which `_sock_timeout` maps back to blocking mode."""
    t = env_float("DMLC_TRACKER_CLIENT_TIMEOUT", 300.0)
    return float("inf") if t <= 0 else t


def _sock_timeout(timeout: float):
    """A socket-API timeout for our deadline value: None (block forever)
    when the deadline is disabled — settimeout(0) would mean NON-BLOCKING
    and fail every op instantly."""
    return None if timeout == float("inf") else timeout


def _default_jobid() -> str:
    """The reference tracker's jobid convention: workers report their
    launcher task id on the wire (tracker.py job_map), which (a) lets a
    restarted task reclaim its old rank and (b) lets the tracker tell
    the supervisor WHICH task a dead rank belongs to — ranks are
    assigned by host-sorted arrival, so rank != DMLC_TASK_ID in
    general."""
    task = os.environ.get("DMLC_TASK_ID")
    return f"task{task}" if task else "NULL"


# the process's active HeartbeatMonitor — the lease endpoint the elastic
# data layer (data.RowBlockIter.create with DMLC_ELASTIC_SHARDS=1) resolves
# without threading the monitor through every constructor
_active_monitor: Optional["HeartbeatMonitor"] = None


def current_monitor() -> Optional["HeartbeatMonitor"]:
    """The HeartbeatMonitor of this process's most recent rendezvous (set
    by RendezvousClient when it opens the heartbeat channel, cleared on
    shutdown), or None. The elastic data layer uses it as the default
    lease source."""
    return _active_monitor


def _set_active_monitor(mon: Optional["HeartbeatMonitor"]) -> None:
    global _active_monitor
    _active_monitor = mon


@dataclass
class TopologyAssignment:
    rank: int
    parent: int
    world_size: int
    tree_neighbors: List[int]
    ring_prev: int
    ring_next: int
    # rank -> connected peer socket (tree + ring links)
    links: Dict[int, WireSocket] = field(default_factory=dict)


class HeartbeatMonitor:
    """The worker half of the liveness protocol: one daemon thread that
    pings the tracker on the announced interval and listens for the abort
    broadcast on the same channel.

    Blocking sockets registered with :meth:`guard` are closed when an
    abort lands, so a worker stuck in a peer accept()/recv() raises
    immediately; the caller then turns that OSError into the structured
    TrackerAbortedError via :meth:`check`.

    The elastic data-plane's lease RPCs (doc/robustness.md "Elastic
    data-plane") ride THIS channel — :meth:`acquire_lease` /
    :meth:`complete_lease` / :meth:`release_lease` frame onto the same
    socket (writes serialized against the ping thread), and renewal is
    implicit in every ping, so no second connection is ever opened per
    renewal."""

    def __init__(self, tracker_host: str, tracker_port: int, rank: int,
                 jobid: str = "NULL", timeout: Optional[float] = None):
        self.rank = rank
        self.aborted: Optional[str] = None
        self._closing = False
        self._lock = threading.Lock()
        self._guarded: List[socket.socket] = []
        # lease plumbing: sends interleave with pings under _send_lock;
        # LEASE_GRANT payloads parsed by the monitor thread land here
        self._send_lock = threading.Lock()
        self._grants: "queue.Queue[int]" = queue.Queue()
        self._lease_lock = threading.Lock()  # one in-flight acquire
        # epoch of the last LEASE_ACQUIRE sent: a grant that lands after
        # its ask timed out is an orphan — it must be RELEASED on drain,
        # or the tracker keeps it held (and every ping renews it) forever
        self._inflight_epoch: Optional[int] = None
        timeout = _default_timeout() if timeout is None else timeout
        self.timeout = timeout
        sock = socket.create_connection((tracker_host, tracker_port),
                                        timeout=_sock_timeout(timeout))
        sock.settimeout(_sock_timeout(timeout))
        ws = WireSocket(sock)
        try:
            ws.send_int(MAGIC)
            got = ws.recv_int()
            if got != MAGIC:
                raise ConnectionError(f"bad tracker magic {got:#x}")
            ws.send_int(rank)
            ws.send_int(-1)
            ws.send_str(jobid)
            ws.send_str(CMD_HEARTBEAT)
            interval_ms = ws.recv_int()
            if interval_ms <= 0:
                raise ConnectionError(
                    f"tracker announced invalid heartbeat interval "
                    f"{interval_ms} ms")
        except BaseException:
            # no thread owns the socket yet: a failed handshake (tracker
            # rejecting the rank, bad magic) must not leak the fd —
            # retry loops would accumulate one per attempt up to EMFILE
            ws.close()
            raise
        self.interval = interval_ms / 1000.0
        self._ws = ws
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"heartbeat-rank{rank}")
        self._thread.start()

    def guard(self, sock: socket.socket) -> None:
        """Close `sock` if the job aborts (unblocks whoever is blocked on
        it). Already-aborted monitors close it immediately."""
        with self._lock:
            if self.aborted is not None:
                try:
                    sock.close()
                except OSError:
                    pass
                return
            self._guarded.append(sock)

    def unguard(self, sock: socket.socket) -> None:
        """Stop tracking `sock` (it outlived the risky blocking phase)."""
        with self._lock:
            if sock in self._guarded:
                self._guarded.remove(sock)

    def check(self) -> None:
        """Raise TrackerAbortedError if the tracker aborted the job —
        call this when a guarded socket op fails, and periodically from
        long compute loops."""
        if self.aborted is not None:
            raise TrackerAbortedError(self.aborted)

    def wait(self, timeout: Optional[float] = None) -> Optional[str]:
        """Block until the job aborts (or `timeout` elapses); returns the
        abort reason or None. Also returns when the channel closes."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.aborted is None and self._thread.is_alive():
            step = 0.05
            if deadline is not None:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                step = min(step, left)
            self._thread.join(step)
        return self.aborted

    def close(self, graceful: bool = True) -> None:
        """Stop pinging and close the channel — never the abort path.

        `graceful=True` (normal job end) says BYE first, so the tracker
        disarms liveness for this rank instead of logging a lost
        channel. `graceful=False` (this worker is dying abnormally)
        closes abruptly: the tracker's dead-after clock MUST keep
        running so the failure is detected and the job aborted — a BYE
        here would silently untrack the dying rank and hang the job."""
        self._closing = True
        if graceful:
            try:
                # lock-ok: BYE serializes with pings; bounded by the
                # channel timeout, and this lock is worker-side only —
                # the tracker serve loop never waits on it
                with self._send_lock:
                    self._ws.send_int(HEARTBEAT_BYE)
            except OSError:
                pass
        try:
            self._ws.close()
        except OSError:
            pass
        self._thread.join(timeout=2)

    # -- elastic data-plane lease RPCs (same socket as the pings) ------------
    def _send_words(self, *vals: int) -> None:
        # lock-ok: serializing frame writes on the one socket IS this
        # lock's job; the send is bounded by the channel timeout and the
        # lock is worker-side only (never held by the tracker serve loop)
        with self._send_lock:
            self._ws.sock.sendall(struct.pack(f"@{len(vals)}i", *vals))

    def acquire_lease(self, epoch: int,
                      timeout: Optional[float] = None) -> Optional[int]:
        """Request one shard lease for `epoch` from the tracker.

        Returns the granted shard id, or None when the epoch is drained
        (every shard complete — end of epoch). While the pool is merely
        empty (held shards may return if their holder dies), the request
        is retried until `timeout` (default: the monitor's deadline)
        elapses, then TimeoutError. Raises TrackerAbortedError when the
        job aborts mid-wait."""
        deadline = time.monotonic() + \
            (self.timeout if timeout is None else timeout)
        acquire_us = telemetry.histogram("lease_acquire_us")
        # lock-ok: the guarded operation IS waiting for a grant — one
        # in-flight acquire per monitor is this lock's contract; every
        # wait is deadline-bounded and abortable, and the lock is
        # worker-side only (the tracker serve loop never takes it)
        with self._lease_lock:
            while True:
                self.check()
                while True:  # drain grants a timed-out earlier ask orphaned
                    try:
                        orphan = self._grants.get_nowait()
                    except queue.Empty:
                        break
                    if orphan >= 0 and self._inflight_epoch is not None:
                        # a real shard granted to an ask we gave up on:
                        # hand it straight back or it stays held by this
                        # (live, pinging, renewing) rank and the epoch
                        # can never drain. Acquires are serialized under
                        # _lease_lock, so the orphan belongs to the LAST
                        # sent ask's epoch; a mismatch is ignored
                        # tracker-side as stale.
                        self._send_words(LEASE_RELEASE,
                                         self._inflight_epoch, orphan)
                t0 = time.perf_counter()
                self._inflight_epoch = epoch
                self._send_words(LEASE_ACQUIRE, epoch)
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"rank {self.rank}: no lease grant within the "
                        f"deadline")
                try:
                    grant = self._grants.get(timeout=left)
                except queue.Empty:
                    self.check()
                    raise TimeoutError(
                        f"rank {self.rank}: tracker answered no lease "
                        f"request within the deadline")
                acquire_us.observe((time.perf_counter() - t0) * 1e6)
                if grant >= 0:
                    return grant
                if grant == LEASE_DRAINED:
                    return None
                # LEASE_EMPTY: nothing free NOW — a held shard may return
                # if its holder dies; poll again shortly
                self.check()
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"rank {self.rank}: lease pool stayed empty past "
                        f"the deadline")
                time.sleep(min(0.05, max(deadline - time.monotonic(), 0)))

    def complete_lease(self, epoch: int, shard: int) -> None:
        """Mark a fully-consumed shard done (the exactly-once checkout)."""
        self.check()
        self._send_words(LEASE_COMPLETE, epoch, shard)

    def release_lease(self, epoch: int, shard: int) -> None:
        """Return an unfinished shard to the pool (this worker is bailing
        out of it; another worker will pick it up)."""
        self.check()
        self._send_words(LEASE_RELEASE, epoch, shard)

    def _answer_telemetry_pull(self) -> None:
        """Ship this rank's telemetry snapshot back on the channel
        ([TELEMETRY_PUSH][len][json]; doc/observability.md "Cluster
        aggregation"). Best effort: a broken export must cost the tracker
        one timed-out pull, never this channel or this worker."""
        try:
            doc = telemetry.rank_export()
            payload = json.dumps(doc, separators=(",", ":")).encode()
            # lock-ok: one bounded frame write serialized against pings,
            # worker-side lock only (the tracker serve loop never waits
            # on it)
            with self._send_lock:
                self._ws.sock.sendall(
                    struct.pack("@ii", TELEMETRY_PUSH, len(payload)) +
                    payload)
        except OSError:
            raise  # channel-level failures follow the ping error path
        except Exception:
            pass  # a snapshot/serialization bug degrades the scrape only

    def _trip(self, reason: str) -> None:
        with self._lock:
            if self.aborted is None:
                self.aborted = reason
            guarded, self._guarded = self._guarded, []
        # flight recorder (doc/observability.md): the abort broadcast is
        # the worker's last chance to ship a postmortem — the span ring,
        # event ring, and metric snapshot land in $DMLC_TRACE_DUMP
        telemetry.flight_dump(f"abort: {reason}", rank=self.rank)
        # wake a lease waiter parked on the grant queue: its next loop
        # round turns the sentinel into the structured abort via check()
        self._grants.put(LEASE_EMPTY)
        for s in guarded:
            # shutdown() first: close() alone does NOT unblock a thread
            # already parked in accept()/recv() on this fd (Linux keeps
            # the syscall waiting on the orphaned descriptor); shutdown
            # forces those to return immediately
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass

    def _run(self) -> None:
        sock = self._ws.sock
        try:
            sock.settimeout(self.interval)
        except OSError:
            return
        # partial frames survive across interval timeouts: recv_all would
        # DROP bytes it already buffered when the ping clock fires, and a
        # tracker abort word split across TCP segments would desync the
        # channel forever — exactly when the abort matters most. The same
        # buffering covers the LEASE_GRANT payload word: a grant split
        # across segments parks in `buf` while pings keep flowing (lease
        # renewal must not stall on a slow grant).
        buf = b""
        grant_pending = False  # next word is a LEASE_GRANT payload
        while not self._closing:
            try:
                chunk = sock.recv(4 - len(buf))
                if not chunk:
                    if not self._closing:
                        self._trip("heartbeat channel to the tracker lost")
                    return
                buf += chunk
                if len(buf) < 4:
                    continue
                val = struct.unpack("@i", buf)[0]
                buf = b""
                if grant_pending:
                    grant_pending = False
                    self._grants.put(val)
                    continue
                if val == HEARTBEAT_ABORT:
                    sock.settimeout(5.0)
                    reason = self._ws.recv_str()
                    self._trip(reason)
                    return
                if val == LEASE_GRANT:
                    grant_pending = True
                    continue
                if val == TELEMETRY_PULL:
                    # the tracker's scrape surface is asking for this
                    # rank's snapshot (doc/observability.md "Cluster
                    # aggregation"); channel errors surface like a ping's
                    try:
                        self._answer_telemetry_pull()
                    except OSError:
                        if not self._closing:
                            self._trip(
                                "heartbeat channel to the tracker lost")
                        return
                    continue
                # any other tracker->worker frame is unexpected; ignore
            except socket.timeout:
                # the quiet interval elapsed: time to ping (which also
                # renews every lease this rank holds, tracker-side)
                try:
                    # lock-ok: ping serialized against lease frames;
                    # timeout-bounded, worker-side lock only
                    with self._send_lock:
                        self._ws.send_int(HEARTBEAT_PING)
                except OSError:
                    if not self._closing:
                        self._trip("heartbeat channel to the tracker lost")
                    return
            except (OSError, ConnectionError):
                if not self._closing:
                    self._trip("heartbeat channel to the tracker lost")
                return


class RendezvousClient:
    """Speaks the tracker protocol end-to-end, including peer-link setup."""

    def __init__(self, tracker_host: str, tracker_port: int,
                 jobid: Optional[str] = None,
                 timeout: Optional[float] = None):
        self.tracker_host = tracker_host
        self.tracker_port = tracker_port
        # default jobid = the launcher's DMLC_TASK_ID (reference
        # convention): reclaims the old rank on restart and maps a dead
        # rank back to its supervised task
        self.jobid = _default_jobid() if jobid is None else jobid
        self.timeout = _default_timeout() if timeout is None else timeout
        self.heartbeat: Optional[HeartbeatMonitor] = None

    def _dial_tracker(self, cmd: str, rank: int = -1,
                      world_size: int = -1) -> WireSocket:
        sock = socket.create_connection(
            (self.tracker_host, self.tracker_port),
            timeout=_sock_timeout(self.timeout))
        # every subsequent op inherits the deadline: a tracker that
        # accepts and goes mute must fail this worker, not hang it
        sock.settimeout(_sock_timeout(self.timeout))
        ws = WireSocket(sock)
        ws.send_int(MAGIC)
        got = ws.recv_int()
        if got != MAGIC:
            # a real error, not an assert — `python -O` strips asserts and
            # would let a protocol mismatch continue on garbage
            ws.close()
            raise ConnectionError(f"bad tracker magic {got:#x}")
        ws.send_int(rank)
        ws.send_int(world_size)
        ws.send_str(self.jobid)
        ws.send_str(cmd)
        return ws

    def log(self, message: str) -> None:
        """Route a message through the tracker log (cmd=print,
        reference tracker.py:269-272)."""
        ws = self._dial_tracker("print")
        ws.send_str(message)
        ws.close()

    def shutdown(self, rank: int) -> None:
        """Send the shutdown handshake and close the tracker connection."""
        if self.heartbeat is not None:
            # stop the monitor first so the tracker-side channel EOF is
            # unambiguous teardown, never a liveness trip mid-shutdown
            self.heartbeat.close()
            if current_monitor() is self.heartbeat:
                _set_active_monitor(None)
            self.heartbeat = None
        ws = self._dial_tracker("shutdown", rank=rank)
        ws.close()

    def _maybe_start_heartbeat(self, rank: int,
                               heartbeat: Optional[bool]) -> None:
        if heartbeat is None:
            heartbeat = env_int("DMLC_TRACKER_HEARTBEAT_MS", 0) > 0
        if not heartbeat:
            return
        if self.heartbeat is not None:
            self.heartbeat.close()
        self.heartbeat = HeartbeatMonitor(
            self.tracker_host, self.tracker_port, rank, jobid=self.jobid,
            timeout=self.timeout)
        _set_active_monitor(self.heartbeat)

    def start(self, rank: int = -1, world_size: int = -1,
              recover: bool = False,
              heartbeat: Optional[bool] = None) -> TopologyAssignment:
        """Join the rendezvous: receive topology, open the heartbeat
        channel (env-gated, see module docstring), establish peer links.

        Raises TrackerAbortedError when the tracker aborts the job while
        this worker is mid-link, and ConnectionError/OSError within
        `timeout` when the tracker or a peer hangs."""
        ws = self._dial_tracker("recover" if recover else "start",
                                rank=rank, world_size=world_size)
        my_rank = ws.recv_int()
        parent = ws.recv_int()
        world = ws.recv_int()
        num_tree = ws.recv_int()
        tree_neighbors = [ws.recv_int() for _ in range(num_tree)]
        rprev = ws.recv_int()
        rnext = ws.recv_int()
        assign = TopologyAssignment(my_rank, parent, world, tree_neighbors,
                                    rprev, rnext)
        expected = set(tree_neighbors)
        if rprev != -1:
            expected.add(rprev)
        if rnext != -1:
            expected.add(rnext)

        # rank is known: liveness starts BEFORE the link dance, so a hang
        # anywhere below is abortable by the tracker's broadcast
        self._maybe_start_heartbeat(my_rank, heartbeat)
        monitor = self.heartbeat
        if monitor is not None:
            monitor.guard(ws.sock)

        # listen for peers that will dial us
        listener = socket.socket()
        listener.bind(("", 0))  # all interfaces: peers dial our tracker-seen IP
        listener.listen(16)
        if monitor is not None:
            monitor.guard(listener)

        good: Dict[int, WireSocket] = {}
        # one deadline spans the whole link dance: a peer that never
        # dials must fail this worker in bounded time, not hang the
        # previously-untimed accept loop
        deadline = time.monotonic() + self.timeout
        try:
            links = self._link_dance(
                ws, assign, expected, good, listener, monitor, deadline)
        except BaseException:
            # a failed rendezvous must not leave a zombie: stop
            # heartbeating (a never-linked worker reporting "alive"
            # forever would defeat the dead-rank deadline) and close the
            # half-built peer links and the dance socket
            for ps in good.values():
                try:
                    ps.close()
                except OSError:
                    pass
            try:
                ws.close()
            except OSError:
                pass
            if monitor is not None:
                # abrupt, NOT graceful: this worker failed rendezvous
                # and is about to die — the tracker's dead-after clock
                # must keep running so the job aborts instead of
                # waiting forever on a rank that never linked
                monitor.close(graceful=False)
                if current_monitor() is monitor:
                    _set_active_monitor(None)
                self.heartbeat = None
            raise
        # the rendezvous deadline must not outlive the rendezvous: a
        # healthy peer may legitimately stay quiet longer than the dance
        # timeout during compute — links block indefinitely (the abort
        # broadcast, not a timer, is what unblocks them on failure)
        for ps in links.values():
            try:
                ps.sock.settimeout(None)
            except OSError:
                pass
        assign.links = links
        if monitor is not None:
            monitor.unguard(ws.sock)
        ws.close()
        return assign

    def _link_dance(self, ws, assign, expected, good, listener, monitor,
                    deadline) -> Dict[int, WireSocket]:
        """The dial/accept rounds of the rendezvous (split from start()
        so its failure cleanup is one place)."""
        try:
            while True:
                # the dial rounds honor the same dance deadline as the
                # accept loop: a peer advertising a blackholed address
                # must not keep the worker in retry rounds forever
                if monitor is not None:
                    monitor.check()
                if time.monotonic() > deadline:
                    raise ConnectionError(
                        f"rank {assign.rank}: peer links not established "
                        f"within {self.timeout:.0f}s")
                ws.send_int(len(good))
                for r in good:
                    ws.send_int(r)
                num_dial = ws.recv_int()
                num_wait = ws.recv_int()
                errors = 0
                for _ in range(num_dial):
                    host = ws.recv_str()
                    port = ws.recv_int()
                    peer_rank = ws.recv_int()
                    try:
                        ps = WireSocket(socket.create_connection(
                            (host, port), timeout=10))
                        ps.send_int(assign.rank)  # identify ourselves
                        good[peer_rank] = ps
                        if monitor is not None:
                            monitor.guard(ps.sock)
                    except OSError:
                        errors += 1
                ws.send_int(errors)
                if errors:
                    continue
                ws.send_int(listener.getsockname()[1])  # our accept port
                break

            # accept the peers the tracker told to dial us. The accept
            # timeout is SHORT and looped: old kernels do not wake a
            # blocked accept() even on shutdown()/close() of the listener
            # fd (verified on 4.4 — only connected sockets wake), so the
            # abort broadcast is observed between attempts instead
            for _ in range(num_wait):
                while True:
                    if monitor is not None:
                        monitor.check()  # abort -> structured error
                    left = deadline - time.monotonic()
                    if left <= 0:
                        raise ConnectionError(
                            f"rank {assign.rank}: peers never dialed "
                            f"within {self.timeout:.0f}s")
                    listener.settimeout(min(0.1, left))
                    try:
                        fd, _ = listener.accept()
                        break
                    except socket.timeout:
                        continue
                fd.settimeout(_sock_timeout(self.timeout))
                ps = WireSocket(fd)
                peer_rank = ps.recv_int()
                good[peer_rank] = ps
                if monitor is not None:
                    monitor.guard(fd)
        except (OSError, ConnectionError):
            if monitor is not None:
                monitor.check()  # abort broadcast -> structured error
            raise
        finally:
            if monitor is not None:
                monitor.unguard(listener)
            listener.close()

        if set(good) != expected:
            raise ConnectionError(
                f"rank {assign.rank}: linked peers {sorted(good)} != "
                f"assigned {sorted(expected)}")
        return good
