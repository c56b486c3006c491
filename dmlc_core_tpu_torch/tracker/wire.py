"""Rabit tracker wire protocol primitives.

Byte-compatible with the reference protocol (tracker/dmlc_tracker/
tracker.py:24-50 ExSocket + kMagic handshake) so legacy Rabit workers can
rendezvous against this tracker: native-endian 4-byte ints, length-prefixed
UTF-8 strings, magic 0xff99 exchanged on connect.

The port's own copy of ``dmlc_core_tpu/tracker/wire.py`` (it imports nothing of
the JAX package): the same names, env variables, CLI flags and wire
bytes, so a worker of either package joins the other's tracker.
"""

from __future__ import annotations

import socket
import struct
from typing import List, Optional

MAGIC = 0xFF99

# -- liveness protocol constants ---------------------------------------------
# A worker that opts into liveness opens a SECOND tracker connection with
# cmd="heartbeat" after receiving its rank. The channel carries int32 pings
# (worker -> tracker, any non-negative value) on the interval the tracker
# announces right after the handshake; the only tracker -> worker frames are
# HEARTBEAT_ABORT followed by a length-prefixed reason string, broadcast
# when the job is being torn down so workers raise instead of hanging in
# peer links, and LEASE_GRANT (below). Legacy clients never send
# cmd="heartbeat", so the original start/recover/shutdown/print byte stream
# is untouched.
CMD_HEARTBEAT = "heartbeat"
HEARTBEAT_PING = 1
HEARTBEAT_BYE = 2   # graceful channel close: disarms liveness, not a death
HEARTBEAT_ABORT = -86

# -- elastic data-plane lease frames (doc/robustness.md "Elastic data-plane")
# Shard leases ride the EXISTING heartbeat channel — no second connection
# per renewal, and every lease frame doubles as a liveness proof. All
# command words are negative so they can never collide with a ping (any
# non-negative int32). Worker -> tracker frames:
#   [LEASE_ACQUIRE][epoch]          ask for one shard of `epoch`
#   [LEASE_RELEASE][epoch][shard]   return an unfinished shard to the pool
#   [LEASE_COMPLETE][epoch][shard]  mark the shard consumed (exactly-once)
# The tracker answers an acquire with [LEASE_GRANT][shard] where `shard`
# is a shard id >= 0, LEASE_EMPTY (nothing free NOW — held shards may
# return if their holder dies; retry), or LEASE_DRAINED (every shard of
# the epoch is complete: end of epoch). Renewal is implicit: every ping
# (and every lease frame) extends all leases the rank holds.
LEASE_ACQUIRE = -90
LEASE_RELEASE = -91
LEASE_COMPLETE = -92
LEASE_GRANT = -93
LEASE_EMPTY = -1
LEASE_DRAINED = -2

# -- cluster telemetry frames (doc/observability.md "Cluster aggregation") --
# Piggybacked on the SAME heartbeat channel, same negative-word rule.
# Tracker -> worker: [TELEMETRY_PULL] (no payload) asks the rank for its
# telemetry snapshot; sent to every live channel when the tracker's HTTP
# scrape surface serves /metrics or /trace. Worker -> tracker:
# [TELEMETRY_PUSH][len][<len> bytes of JSON] — the rank_export() document
# (metrics + wall-clock spans + the process clock anchor). A push doubles
# as a liveness proof; a worker that never answers (legacy client) simply
# times the pull out — the scrape degrades to the ranks that replied.
TELEMETRY_PULL = -95
TELEMETRY_PUSH = -96
# a push beyond this is a corrupt frame, not telemetry (the rank_export
# span cap keeps real documents far below it)
TELEMETRY_PUSH_MAX = 8 << 20

# -- the machine-checked channel word registry --------------------------------
# Every COMMAND word the heartbeat channel can carry must be negative (a
# ping is ANY non-negative int32, so a non-negative command word would be
# indistinguishable from a ping), and no two words — command or sentinel —
# may share a value. Nothing used to enforce that invariant; now
# `scripts/analyze.py` Pass 4 (doc/analysis.md) does, against this
# registry: it checks every entry names its constant, every registered
# word is negative and collision-free, and every negative module constant
# IS registered (a new word added without a registry entry is a finding —
# unregistered words would dodge the collision check).
#
# HEARTBEAT_PING / HEARTBEAT_BYE are deliberately absent: they live in the
# ping space (non-negative) by design and are classified by value range,
# not by word. Sentinels are answer-frame values in the shard-id position
# (shard ids are >= 0), so they share the negative space with commands
# and must not collide with them either.
CHANNEL_COMMAND_WORDS = {
    "HEARTBEAT_ABORT": HEARTBEAT_ABORT,
    "LEASE_ACQUIRE": LEASE_ACQUIRE,
    "LEASE_RELEASE": LEASE_RELEASE,
    "LEASE_COMPLETE": LEASE_COMPLETE,
    "LEASE_GRANT": LEASE_GRANT,
    "TELEMETRY_PULL": TELEMETRY_PULL,
    "TELEMETRY_PUSH": TELEMETRY_PUSH,
}
CHANNEL_SENTINELS = {
    "LEASE_EMPTY": LEASE_EMPTY,
    "LEASE_DRAINED": LEASE_DRAINED,
}


def env_float(name: str, default: float, env=None) -> float:
    """Checked float env parse (the env_int rule for float-valued knobs
    like DMLC_TRACKER_HANDSHAKE_TIMEOUT): garbage text raises instead of
    silently disabling a deadline."""
    import os
    raw = (os.environ if env is None else env).get(name)
    if raw is None or raw == "":
        return default
    try:
        return float(raw)
    except ValueError:
        raise RuntimeError(f"{name}={raw!r} is not a number")


def env_enum(name: str, choices, default: Optional[str] = None,
             env=None) -> Optional[str]:
    """Checked enum env parse: a set value outside `choices` raises with
    the allowed set named (a typo'd DMLC_JOB_CLUSTER must fail in the
    container bootstrap, not silently select a default backend)."""
    import os
    raw = (os.environ if env is None else env).get(name)
    if raw is None or raw == "":
        return default
    if raw not in choices:
        raise RuntimeError(
            f"{name}={raw!r} is not one of {sorted(choices)}")
    return raw


def env_int(name: str, default: int, env=None) -> int:
    """Checked env parse shared by tracker/client/bootstrap: garbage text
    raises instead of silently becoming a value that disables a liveness
    deadline (the retry.h CheckedEnvInt rule, applied to the control
    plane). `env` defaults to os.environ (bootstrap validates its own
    computed dict)."""
    import os
    raw = (os.environ if env is None else env).get(name)
    if raw is None or raw == "":
        return default
    try:
        return int(raw)
    except ValueError:
        raise RuntimeError(f"{name}={raw!r} is not an integer")


def env_str(name: str, default: Optional[str] = None,
            env=None) -> Optional[str]:
    """String env knob read through the same checked gate as the numeric
    parsers (one registry, one doc table): unset or empty returns the
    default — path-valued knobs like DMLC_SERVE_ACCESS_LOG treat "" as
    "off", matching the event-log convention."""
    import os
    raw = (os.environ if env is None else env).get(name)
    if raw is None or raw == "":
        return default
    return raw


def env_int_opt(name: str, env=None):
    """Presence-gated checked parse for launcher rank/count variables:
    None when the variable is UNSET (the caller falls through to its next
    source), but a SET-but-invalid value — empty text included — raises
    naming the variable. `env_int`'s \"\"→default convention is wrong
    here: a templating bug exporting RANK=\"\" must kill the job, not
    silently shard it wrong."""
    import os
    e = os.environ if env is None else env
    if name not in e:
        return None
    try:
        return int(e[name])
    except ValueError:
        raise RuntimeError(f"{name}={e[name]!r} is not an integer")


class TrackerAbortedError(RuntimeError):
    """The tracker gave up on the job (dead ranks past their deadline, a
    supervisor that exhausted its attempts, or an explicit abort()).

    Raised by ``RabitTracker.join()`` on the launcher side and by
    ``RendezvousClient`` operations unblocked by the abort broadcast on the
    worker side — the structured, loud end the liveness layer guarantees
    instead of an indefinite hang."""

    def __init__(self, reason: str, dead_ranks: Optional[List[int]] = None):
        self.reason = reason
        self.dead_ranks = sorted(dead_ranks or [])
        msg = reason
        if self.dead_ranks:
            msg = f"{reason} (dead ranks: {self.dead_ranks})"
        super().__init__(msg)


class WireSocket:
    """Length-prefixed int/str framing over a TCP socket."""

    def __init__(self, sock: socket.socket):
        self.sock = sock

    def recv_all(self, nbytes: int) -> bytes:
        """Receive exactly `nbytes` bytes (raises on EOF)."""
        chunks = []
        got = 0
        while got < nbytes:
            chunk = self.sock.recv(min(nbytes - got, 4096))
            if not chunk:
                raise ConnectionError("peer closed during recv")
            got += len(chunk)
            chunks.append(chunk)
        return b"".join(chunks)

    def recv_int(self) -> int:
        """Receive one int32 (Rabit wire byte order)."""
        return struct.unpack("@i", self.recv_all(4))[0]

    def send_int(self, v: int) -> None:
        """Send one int32 (Rabit wire byte order)."""
        self.sock.sendall(struct.pack("@i", v))

    # strings on this protocol are hostnames/job ids/log lines; a length
    # beyond this is a corrupt or adversarial frame, not data — without
    # the cap a bogus 2 GB prefix would balloon recv_all and stall the
    # tracker's accept loop
    MAX_STR = 1 << 20

    def recv_str(self) -> str:
        """Receive a length-prefixed string (Rabit wire format)."""
        n = self.recv_int()
        if n < 0 or n > self.MAX_STR:
            raise ConnectionError(
                f"invalid string length {n} on tracker wire")
        return self.recv_all(n).decode()

    def send_str(self, s: str) -> None:
        """Send a length-prefixed string (Rabit wire format)."""
        data = s.encode()
        self.send_int(len(data))  # byte count, not character count
        self.sock.sendall(data)

    def settimeout(self, timeout) -> None:
        """Bound every subsequent blocking op on the underlying socket."""
        self.sock.settimeout(timeout)

    def close(self) -> None:
        """Close the underlying socket (idempotent)."""
        self.sock.close()


def resolve_ip(host: str) -> str:
    """Resolve a hostname to the IP the workers should dial."""
    return socket.getaddrinfo(host, None)[0][4][0]


def addr_family(addr: str):
    """AF_INET or AF_INET6 for the given host string."""
    return socket.getaddrinfo(addr, None)[0][0]


def guess_host_ip(host_ip=None) -> str:
    """Best-effort routable IP (reference tracker.py get_host_ip)."""
    if host_ip not in (None, "auto", "ip", "dns"):
        return host_ip
    if host_ip == "dns":
        return socket.getfqdn()
    try:
        ip = socket.gethostbyname(socket.getfqdn())
    except socket.gaierror:
        ip = socket.gethostbyname(socket.gethostname())
    if ip.startswith("127."):
        probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            probe.connect(("10.255.255.255", 1))  # no traffic sent
            ip = probe.getsockname()[0]
        except OSError:
            ip = "127.0.0.1"
        finally:
            probe.close()
    return ip


def bind_free_port(host: str, port_start: int = 9091, port_end: int = 9999
                   ) -> socket.socket:
    """Bind a listening socket on the first free port in the scan range
    (reference tracker.py:141-153)."""
    sock = socket.socket(addr_family(host), socket.SOCK_STREAM)
    for port in range(port_start, port_end):
        try:
            sock.bind((host, port))
            return sock
        except OSError:
            continue
    raise OSError(f"no free port in [{port_start}, {port_end})")
