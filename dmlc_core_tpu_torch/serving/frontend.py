"""Event-driven HTTP front end for the scoring server.

A copy of ``dmlc_core_tpu/serving/frontend.py``: a keep-alive
request/response server where one ``selectors`` loop pumps one protocol
coroutine per connection, a coroutine yields the
number of bytes it needs next (or the :data:`_HEAD` marker for "through
the blank line", or :data:`_WAIT` when parked awaiting the scorer's
reply), and responses are buffered through per-connection out-buffers so
a slow reader can never block the loop — or tear a response mid-write.

The loop thread owns all connection state. Worker threads (the scorer)
complete parked requests through :meth:`ReplySlot.send`, which enqueues
the rendered response and wakes the loop over a self-pipe; the loop
resumes the parked coroutine on its own thread. Shared HTTP plumbing
(head parsing, bounded sizes, response rendering) lives in
:mod:`dmlc_core_tpu_torch.tracker.minihttp`.
"""

import logging
import selectors
import socket
import threading
import time
from typing import Callable, Dict, Optional, Set

from dmlc_core_tpu_torch import telemetry
from dmlc_core_tpu_torch.tracker import minihttp

logger = logging.getLogger("dmlc_core_tpu_torch.serving")

# a connection coroutine yields an int (bytes it needs), _HEAD (bytes
# through the first CRLFCRLF, bounded by minihttp.MAX_REQUEST_HEAD), or
# _WAIT (parked until a ReplySlot completion resumes it)
_WAIT = object()
_HEAD = object()

#: Returned by a handler that parked the request (kept its
#: :class:`ReplySlot` for a later :meth:`ReplySlot.send`).
PENDING = object()


class _HeadOverflow(Exception):
    """Thrown into a coroutine whose request head outgrew the bound."""


def _count_reject(status: int) -> None:
    """Count one error response by status code (every render_error path
    feeds serve_rejects_total; sheds are ADDITIONALLY counted by reason
    in serve_shed_total — doc/observability.md)."""
    telemetry.counter("serve_rejects_total",
                      {"code": str(status)}).inc()


class _Conn:
    """One accepted connection: buffers + the protocol coroutine."""

    __slots__ = ("sock", "host", "inbuf", "outbuf", "gen", "want",
                 "closed", "drain_close", "last_activity", "inflight")

    def __init__(self, sock: socket.socket, host: str):
        self.sock = sock
        self.host = host
        self.inbuf = bytearray()
        self.outbuf = bytearray()
        self.gen = None
        self.want = None
        self.closed = False
        self.drain_close = False
        self.last_activity = time.monotonic()
        self.inflight = False       # a parked request owes a response


class Request:
    """One parsed HTTP request handed to the handler (loop thread)."""

    __slots__ = ("method", "path", "query", "headers", "body",
                 "arrival_us", "request_id", "slot")

    def __init__(self, method: str, path: str, query: str,
                 headers: Dict[str, str], body: bytes, arrival_us: float,
                 request_id: str = ""):
        self.method = method
        self.path = path
        self.query = query
        self.headers = headers
        self.body = body
        self.arrival_us = arrival_us    # perf-counter clock, µs
        # sanitized inbound X-Request-Id, or minted (minihttp.request_id);
        # echoed on every handler-level response
        self.request_id = request_id
        self.slot: Optional["ReplySlot"] = None


class ReplySlot:
    """Thread-safe completion handle for a parked (PENDING) request.

    Exactly one :meth:`send` per slot; extra calls are dropped (the
    breaker/drain paths can race a batch completion). Safe from any
    thread — the response is rendered here but written by the loop.
    """

    __slots__ = ("_fe", "_conn", "_keep", "_done", "request_id")

    def __init__(self, fe: "HttpFrontend", conn: _Conn, keep: bool,
                 request_id: str = ""):
        self._fe = fe
        self._conn = conn
        self._keep = keep
        self._done = False
        #: the request's id, echoed as X-Request-Id on the completion
        self.request_id = request_id

    def send(self, status: int, body: bytes,
             ctype: str = "application/json",
             extra_headers: Optional[Dict[str, str]] = None) -> None:
        """Complete the parked request with one full response."""
        if self._done:
            return
        self._done = True
        if self.request_id:
            extra_headers = dict(extra_headers or {},
                                 **{"X-Request-Id": self.request_id})
        self._fe._complete(self._conn, minihttp.render(
            status, body, ctype, keep_alive=self._keep,
            extra_headers=extra_headers))

    def send_error(self, err: minihttp.HttpError) -> None:
        """Complete the parked request with a structured error body."""
        if self._done:
            return
        self._done = True
        _count_reject(err.status)
        if self.request_id:
            err.headers = dict(err.headers or {},
                               **{"X-Request-Id": self.request_id})
        self._fe._complete(self._conn, minihttp.render_error(
            err, keep_alive=self._keep))


class HttpFrontend:
    """Keep-alive HTTP/1.1 server on a single selectors loop.

    ``handler(req)`` runs on the loop thread and must not block: it
    returns either a ``(status, body, ctype)`` tuple (optionally with a
    fourth extra-headers dict), a :class:`minihttp.HttpError`, or
    :data:`PENDING` after stashing ``req.slot`` for a worker thread.
    """

    def __init__(self, handler: Callable[[Request], object], *,
                 host: str = "127.0.0.1", port: int = 0,
                 max_body_bytes: int = 1 << 20,
                 idle_timeout_s: float = 120.0):
        self._handler = handler
        self.max_body_bytes = max_body_bytes
        self.idle_timeout_s = idle_timeout_s
        self.listener = socket.create_server((host, port), backlog=128)
        self.listener.setblocking(False)
        self.host = host
        self.port = self.listener.getsockname()[1]
        self._sel: Optional[selectors.BaseSelector] = None
        self._conns: Set[_Conn] = set()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._cmpl_lock = threading.Lock()
        self._completions: list = []
        self._stop = False
        self._accepting = True
        self._drain_deadline: Optional[float] = None
        self._thread: Optional[threading.Thread] = None
        self._m_requests = telemetry.counter("serve_requests_total")
        self._m_rejects = None      # labeled; resolved per code
        self._m_inflight = telemetry.gauge("serve_inflight")

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        """Run the selectors loop on a daemon thread."""
        self._thread = threading.Thread(target=self._serve,
                                        name="serve-frontend", daemon=True)
        self._thread.start()

    def stop(self, grace_s: float = 5.0) -> None:
        """Stop the loop: finish draining out-buffers for up to
        ``grace_s`` (never drop a response mid-write), then close every
        socket and join the thread."""
        self._drain_deadline = time.monotonic() + grace_s
        self._stop = True
        self._wake()
        if self._thread is not None:
            self._thread.join(grace_s + 5.0)

    def inflight(self) -> int:
        """Number of connections with a parked request owing a response."""
        return sum(1 for c in list(self._conns) if c.inflight)

    # -- loop --------------------------------------------------------------

    def _serve(self) -> None:
        sel = selectors.DefaultSelector()
        self._sel = sel
        sel.register(self.listener, selectors.EVENT_READ, "listener")
        sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        try:
            while True:
                if self._stop and self._drained():
                    return
                for key, mask in sel.select(0.25):
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
                self._run_completions()
                self._sweep_idle()
        finally:
            for conn in list(self._conns):
                self._close_conn(conn)
            for s in (self.listener, self._wake_r, self._wake_w):
                try:
                    s.close()
                except OSError:
                    pass
            try:
                sel.close()
            except OSError:
                pass

    def _drained(self) -> bool:
        """True once every out-buffer is on the wire (or the drain
        deadline passed): safe to tear the loop down."""
        if self._drain_deadline is not None and \
                time.monotonic() > self._drain_deadline:
            return True
        return not any(c.outbuf for c in self._conns if not c.closed)

    def _wake(self) -> None:
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass

    def _accept_all(self) -> None:
        while True:
            try:
                fd, addr = self.listener.accept()
            except (BlockingIOError, OSError):
                return
            if self._stop or not self._accepting:
                try:
                    fd.close()
                except OSError:
                    pass
                continue
            fd.setblocking(False)
            conn = _Conn(fd, addr[0])
            conn.gen = self._conn_gen(conn)
            self._conns.add(conn)
            self._sel.register(fd, selectors.EVENT_READ, conn)
            self._step(conn, None)      # run to the first yield

    def _on_readable(self, conn: _Conn) -> None:
        try:
            data = conn.sock.recv(65536)
        except BlockingIOError:
            return
        except OSError:
            self._close_conn(conn)
            return
        if not data:
            self._close_conn(conn)
            return
        conn.inbuf += data
        if len(conn.inbuf) > 2 * (minihttp.MAX_REQUEST_HEAD +
                                  self.max_body_bytes):
            # a client pipelining unboundedly past its parked request
            # would otherwise grow the buffer forever
            self._close_conn(conn)
            return
        conn.last_activity = time.monotonic()
        self._pump(conn)

    def _pump(self, conn: _Conn) -> None:
        while not conn.closed:
            if isinstance(conn.want, int):
                if len(conn.inbuf) < conn.want:
                    return
                chunk = bytes(conn.inbuf[:conn.want])
                del conn.inbuf[:conn.want]
                self._step(conn, chunk)
            elif conn.want is _HEAD:
                end = conn.inbuf.find(b"\r\n\r\n")
                if end < 0:
                    if len(conn.inbuf) > minihttp.MAX_REQUEST_HEAD:
                        self._throw(conn, _HeadOverflow())
                        continue
                    return
                if end + 4 > minihttp.MAX_REQUEST_HEAD:
                    self._throw(conn, _HeadOverflow())
                    continue
                chunk = bytes(conn.inbuf[:end + 4])
                del conn.inbuf[:end + 4]
                self._step(conn, chunk)
            else:                       # parked at _WAIT
                return

    def _step(self, conn: _Conn, value) -> None:
        try:
            conn.want = conn.gen.send(value)
        except StopIteration:
            self._close_conn(conn)
        except Exception:
            logger.exception("serving connection coroutine failed")
            self._close_conn(conn)

    def _throw(self, conn: _Conn, exc: Exception) -> None:
        try:
            conn.want = conn.gen.throw(exc)
        except StopIteration:
            self._close_conn(conn)
        except Exception:
            logger.exception("serving connection coroutine failed")
            self._close_conn(conn)

    def _run_completions(self) -> None:
        while True:
            with self._cmpl_lock:
                todo, self._completions = self._completions, []
            if not todo:
                return
            for conn, payload in todo:
                if conn.closed:
                    continue
                conn.inflight = False
                self._m_inflight.set(self.inflight())
                if conn.want is _WAIT and not conn.drain_close:
                    conn.want = None
                    self._step(conn, payload)
                    self._pump(conn)

    def _complete(self, conn: _Conn, payload: bytes) -> None:
        """Queue a rendered response for a parked connection (any
        thread) and wake the loop to deliver it."""
        with self._cmpl_lock:
            self._completions.append((conn, payload))
        self._wake()

    def _sweep_idle(self) -> None:
        now = time.monotonic()
        for conn in [c for c in self._conns if not c.inflight and
                     now - c.last_activity > self.idle_timeout_s]:
            self._close_conn(conn)

    # -- connection coroutine ---------------------------------------------

    def _conn_gen(self, conn: _Conn):
        while True:
            try:
                raw = yield _HEAD
            except _HeadOverflow:
                _count_reject(431)
                yield from self._finish(conn, minihttp.render_error(
                    minihttp.HttpError(
                        431, "request head exceeds "
                             f"{minihttp.MAX_REQUEST_HEAD} bytes")))
                return
            arrival_us = time.perf_counter() * 1e6
            try:
                method, path, query, headers = minihttp.parse_head(raw)
                nbody = minihttp.body_length(method, headers,
                                             self.max_body_bytes)
            except minihttp.HttpError as e:
                # head-level error: request framing is unknowable, so the
                # connection cannot be reused
                _count_reject(e.status)
                yield from self._finish(conn, minihttp.render_error(e))
                return
            body = b""
            if nbody:
                body = yield nbody
            keep = headers.get("connection", "keep-alive").lower() \
                != "close"
            self._m_requests.inc()
            rid = minihttp.request_id(headers.get("x-request-id"))
            req = Request(method, path, query, headers, body, arrival_us,
                          rid)
            slot = ReplySlot(self, conn, keep, rid)
            req.slot = slot
            try:
                result = self._handler(req)
            except minihttp.HttpError as e:
                result = e
            except Exception:
                logger.exception("serving handler failed on %s %s",
                                 method, path)
                result = minihttp.HttpError(500, "internal error")
            if result is PENDING:
                conn.inflight = True
                self._m_inflight.set(self.inflight())
                resp = yield _WAIT      # rendered bytes from ReplySlot
            elif isinstance(result, minihttp.HttpError):
                _count_reject(result.status)
                result.headers = dict(result.headers or {},
                                      **{"X-Request-Id": rid})
                resp = minihttp.render_error(result, keep_alive=keep)
            else:
                status, rbody, ctype = result[:3]
                extra = dict(result[3] if len(result) > 3 else {},
                             **{"X-Request-Id": rid})
                resp = minihttp.render(status, rbody, ctype,
                                       keep_alive=keep,
                                       extra_headers=extra)
            if not keep:
                yield from self._finish(conn, resp)
                return
            self._send(conn, resp)

    def _finish(self, conn: _Conn, resp: bytes):
        """Send a final response and park until it drains (the flush
        path closes the socket once the out-buffer empties — never
        mid-write)."""
        conn.drain_close = True
        self._send(conn, resp)
        yield _WAIT

    # -- write path --------------------------------------------------------

    def _send(self, conn: _Conn, data: bytes) -> None:
        conn.outbuf += data
        self._flush(conn)

    def _flush(self, conn: _Conn) -> None:
        if conn.closed:
            return
        try:
            while conn.outbuf:
                sent = conn.sock.send(conn.outbuf)
                del conn.outbuf[:sent]
                conn.last_activity = time.monotonic()
        except BlockingIOError:
            pass
        except OSError:
            self._close_conn(conn)
            return
        if conn.drain_close and not conn.outbuf:
            self._close_conn(conn)
            return
        mask = selectors.EVENT_READ
        if conn.outbuf:
            mask |= selectors.EVENT_WRITE
        try:
            self._sel.modify(conn.sock, mask, conn)
        except (KeyError, ValueError, OSError):
            pass

    def _close_conn(self, conn: _Conn) -> None:
        if conn.closed:
            return
        conn.closed = True
        conn.inflight = False
        self._conns.discard(conn)
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
        self._m_inflight.set(self.inflight())
