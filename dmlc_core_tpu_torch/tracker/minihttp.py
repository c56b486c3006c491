"""Shared mini-HTTP plumbing for content-sniffed sockets.

A copy of what the scoring front end
(:mod:`dmlc_core_tpu_torch.serving.frontend`) and the tracker's scrape
surface (:mod:`dmlc_core_tpu_torch.tracker.rendezvous`) need from
``dmlc_core_tpu/tracker/minihttp.py``: the bounded request-head
discipline (a loud 431 instead of a silent drop when headers overflow, a
405 instead of a reject when a known-but-unsupported method arrives),
request-id sanitizing, and minimal HTTP/1.1 response rendering — pure
byte-level helpers, no sockets, no loop.
"""

import os
import re
from typing import Dict, Optional, Tuple

# Hard ceiling on request line + headers (the terminating CRLFCRLF
# included). Small on purpose: both surfaces serve machine clients that
# send one short request; anything larger is a bug or abuse and gets a
# 431 so the sender can SEE why it was cut off.
MAX_REQUEST_HEAD = 8192

# First four bytes of every RFC 9110 method as it appears on the wire
# ("GET " and "PUT " include the mandatory space). A match means the
# peer is speaking HTTP — even if the surface doesn't serve that method,
# the polite answer is a 405, not a binary-protocol reject.
_METHOD_SNIFF: Dict[bytes, str] = {
    b"GET ": "GET",
    b"POST": "POST",
    b"PUT ": "PUT",
    b"HEAD": "HEAD",
    b"DELE": "DELETE",
    b"OPTI": "OPTIONS",
    b"PATC": "PATCH",
    b"TRAC": "TRACE",
    b"CONN": "CONNECT",
}

# Reason phrases for every status these mini-servers emit.
REASONS: Dict[int, str] = {
    200: "OK",
    204: "No Content",
    400: "Bad Request",
    404: "Not Found",
    405: "Method Not Allowed",
    411: "Length Required",
    413: "Content Too Large",
    429: "Too Many Requests",
    431: "Request Header Fields Too Large",
    500: "Internal Server Error",
    503: "Service Unavailable",
}


class HttpError(Exception):
    """A request that must be answered with an error status.

    Raised by :func:`parse_head` (and by callers' own validation) with
    the status to send; the message becomes the response body so the
    client sees WHY it was rejected instead of a bare reset.
    """

    def __init__(self, status: int, message: str,
                 headers: Optional[Dict[str, str]] = None):
        super().__init__(message)
        self.status = status
        #: extra response headers (e.g. ``Retry-After`` on a shed 429/503)
        self.headers = headers
        self.message = message


# accepted inbound X-Request-Id shape: anything else is replaced with a
# minted id (a request id lands in logs, traces, and response headers —
# it must never be a header-injection or log-forgery vector)
_REQUEST_ID_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")


def request_id(incoming: Optional[str] = None) -> str:
    """The request id for one inbound request: the client's
    ``X-Request-Id`` when it is well-formed (``[A-Za-z0-9._-]{1,64}`` —
    propagation across hops), else a freshly minted 16-hex-char id.
    Pure sanitize-or-mint; the caller owns echoing it on the reply."""
    if incoming and _REQUEST_ID_RE.match(incoming):
        return incoming
    return os.urandom(8).hex()


def sniff_method(head: bytes) -> Optional[str]:
    """HTTP method name if ``head`` (the first 4 bytes of a connection)
    starts an HTTP request line, else ``None`` (binary frame)."""
    return _METHOD_SNIFF.get(bytes(head[:4]))


def parse_head(raw: bytes) -> Tuple[str, str, str, Dict[str, str]]:
    """Parse a full request head (through ``CRLFCRLF``) into
    ``(method, path, query, headers)``.

    Header names are lower-cased; duplicate headers keep the LAST value
    (none of the headers these surfaces read are list-valued). Raises
    :class:`HttpError` 400 on a malformed request line or header.
    """
    head = raw.split(b"\r\n\r\n", 1)[0]
    lines = head.split(b"\r\n")
    parts = lines[0].decode("latin-1", "replace").split()
    if len(parts) != 3 or not parts[2].startswith("HTTP/"):
        raise HttpError(400, "malformed request line")
    method = parts[0].upper()
    target = parts[1]
    path, _, query = target.partition("?")
    headers: Dict[str, str] = {}
    for ln in lines[1:]:
        if not ln:
            continue
        name, sep, value = ln.partition(b":")
        if not sep or not name.strip():
            raise HttpError(400, "malformed header line")
        headers[name.strip().decode("latin-1", "replace").lower()] = \
            value.strip().decode("latin-1", "replace")
    return method, path, query, headers


def body_length(method: str, headers: Dict[str, str],
                max_body: int) -> int:
    """Validated request-body length for a parsed head.

    Enforces the mini-server body discipline: bodies require an explicit
    ``Content-Length`` (411 when a body-bearing method omits it, since
    neither surface implements chunked framing), bounded by ``max_body``
    (413). GET/HEAD/DELETE with no ``Content-Length`` return 0.
    """
    raw = headers.get("content-length")
    if raw is None:
        if method in ("POST", "PUT", "PATCH"):
            raise HttpError(411, "Content-Length required")
        return 0
    try:
        n = int(raw)
    except ValueError:
        raise HttpError(400, f"bad Content-Length {raw!r}")
    if n < 0:
        raise HttpError(400, f"bad Content-Length {raw!r}")
    if n > max_body:
        raise HttpError(413,
                        f"body of {n} bytes exceeds limit {max_body}")
    return n


def render(status: int, body: bytes, ctype: str = "text/plain",
           *, keep_alive: bool = False,
           extra_headers: Optional[Dict[str, str]] = None) -> bytes:
    """Render one complete HTTP/1.1 response.

    Always carries ``Content-Length`` (so clients can detect a torn
    write — a killed server can never produce a short body that still
    parses as success) and an explicit ``Connection`` header.
    """
    reason = REASONS.get(status, "Unknown")
    head = [f"HTTP/1.1 {status} {reason}",
            f"Content-Type: {ctype}",
            f"Content-Length: {len(body)}",
            f"Connection: {'keep-alive' if keep_alive else 'close'}"]
    for name, value in (extra_headers or {}).items():
        head.append(f"{name}: {value}")
    return ("\r\n".join(head) + "\r\n\r\n").encode("latin-1") + body


def render_error(err: HttpError, *, keep_alive: bool = False) -> bytes:
    """Render an :class:`HttpError` as a structured JSON error response."""
    # hand-rolled JSON keeps this module stdlib-free of imports the
    # tracker hot path doesn't already pay for; messages are ASCII
    msg = err.message.replace("\\", "\\\\").replace('"', '\\"')
    body = ('{"error": "%s", "status": %d}\n' % (msg, err.status)).encode()
    return render(err.status, body, "application/json",
                  keep_alive=keep_alive, extra_headers=err.headers)
