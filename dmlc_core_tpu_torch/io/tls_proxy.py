"""TLS-terminating helper: the https path for the native plain-HTTP client.

The reference reaches https origins (real S3/Azure/secure WebHDFS) through
libcurl+OpenSSL inside its clients (reference src/io/s3_filesys.cc curl
handles; src/io.cc:53 routes https to them). This image has no OpenSSL
dev headers for the native build, but Python's stdlib `ssl` works — so TLS
terminates HERE, in a small local relay, and the native client keeps its
plain-HTTP socket code:

    native client ──plain http──> 127.0.0.1:PORT ──TLS──> https origin

The native side (cpp/src/http.cc ResolveHttpRoute) connects to
``DCT_TLS_PROXY=host:port`` and sends ABSOLUTE-form requests
(``GET https://origin/path HTTP/1.1``); this helper opens TLS to the
origin, forwards the request origin-form with all end-to-end headers
(so S3 SIG4 signatures survive untouched), and streams the response back.

Trust configuration (env):
- ``DCT_TLS_CA``: extra CA bundle file trusted IN ADDITION to the system
  store (self-signed test servers, private CAs).
- ``DCT_TLS_INSECURE=1``: disable certificate verification (dev only).

Run standalone:  python -m dmlc_core_tpu_torch.io.tls_proxy [--port N]
In-process:      with TlsProxy() as addr: os.environ["DCT_TLS_PROXY"] = addr
Auto:            ensure_tls_proxy() — used by the io facade when it sees an
                 https:// URI and no helper is configured.

The port's own copy of ``dmlc_core_tpu/io/tls_proxy.py`` (it imports nothing of
the JAX package): the same names, env variables, CLI flags and wire
bytes, so a worker of either package joins the other's tracker.
"""

from __future__ import annotations

import http.client
import os
import ssl
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import urlsplit

from dmlc_core_tpu_torch.tracker.wire import env_float

__all__ = ["TlsProxy", "ensure_tls_proxy"]

# hop-by-hop headers never forwarded in either direction (RFC 7230 §6.1)
_HOP_BY_HOP = {"connection", "keep-alive", "proxy-authenticate",
               "proxy-authorization", "proxy-connection", "te", "trailer",
               "transfer-encoding", "upgrade"}


_ctx_cache: dict = {}
_ctx_lock = threading.Lock()


def _origin_context() -> ssl.SSLContext:
    """SSL context for origin connections, cached per trust config.

    Every relayed request is its own origin connection (Connection:
    close), so the context — a full system CA store load — must not be
    rebuilt per request on the hot ranged-read path. Keyed by the env
    values so runtime changes (tests rotating DCT_TLS_CA) still take
    effect."""
    key = (os.environ.get("DCT_TLS_CA"),
           os.environ.get("DCT_TLS_INSECURE"))
    with _ctx_lock:
        ctx = _ctx_cache.get(key)
        if ctx is None:
            ctx = ssl.create_default_context()
            if key[0]:
                ctx.load_verify_locations(cafile=key[0])
            if key[1] == "1":
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            _ctx_cache[key] = ctx
        return ctx


class _RelayHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):  # quiet: the client reports its own errors
        pass

    def _refuse(self, status: int, msg: str) -> None:
        body = msg.encode()
        self.send_response(status)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(body)
        self.close_connection = True

    def _relay(self) -> None:
        # absolute-form target only: this is a forwarding helper, not a
        # web server
        target = urlsplit(self.path)
        if target.scheme != "https" or not target.hostname:
            self._refuse(400, "expected absolute-form https:// request "
                              f"target, got {self.path!r}")
            return
        port = target.port or 443
        path = target.path or "/"
        if target.query:
            path += "?" + target.query
        # end-to-end request headers pass through; body per Content-Length
        # (the native client always sets one on uploads). The body STREAMS
        # to the origin in bounded pieces rather than being buffered whole:
        # parallel multipart uploads run one handler thread per part, and
        # part-sized (8-64 MB) buffers per thread multiply into real RSS.
        length = int(self.headers.get("Content-Length") or 0)
        try:
            conn = http.client.HTTPSConnection(
                target.hostname, port, context=_origin_context(),
                timeout=env_float("DCT_TLS_ORIGIN_TIMEOUT", 60.0))
            conn.putrequest(self.command, path, skip_host=True,
                            skip_accept_encoding=True)
            saw_host = False
            for k, v in self.headers.items():
                if k.lower() in _HOP_BY_HOP:
                    continue
                conn.putheader(k, v)
                saw_host = saw_host or k.lower() == "host"
            if not saw_host:
                conn.putheader("Host", target.netloc)
            # one origin connection per relayed request: announce it so
            # the origin never waits for a second request on this socket
            conn.putheader("Connection", "close")
            conn.endheaders()
            remaining = length
            while remaining > 0:
                piece = self.rfile.read(min(remaining, 65536))
                if not piece:
                    # client hung up mid-body: the origin sees a short
                    # body and fails the request itself; nothing to relay
                    raise OSError("client closed mid-upload with "
                                  f"{remaining} bytes unsent")
                conn.send(piece)
                remaining -= len(piece)
            resp = conn.getresponse()
        except (OSError, ssl.SSLError, http.client.HTTPException) as e:
            self._refuse(502, f"tls relay to {target.netloc} failed: {e}")
            return
        try:
            self.send_response(resp.status, resp.reason)
            sized = False
            for k, v in resp.getheaders():
                if k.lower() in _HOP_BY_HOP:
                    continue  # http.client already de-chunked the body
                if k.lower() == "content-length":
                    sized = True
                self.send_header(k, v)
            if not sized:
                # unsized origin body (chunked): delimit by closing
                self.send_header("Connection", "close")
                self.close_connection = True
            self.end_headers()
            if self.command != "HEAD":
                while True:
                    chunk = resp.read(65536)
                    if not chunk:
                        break
                    self.wfile.write(chunk)
        finally:
            conn.close()

    # one relay implementation serves every method the clients use
    do_GET = do_HEAD = do_PUT = do_POST = do_DELETE = _relay


class TlsProxy:
    """In-process TLS-terminating relay bound to 127.0.0.1.

    Context manager yielding its ``host:port`` address. Thread-based: each
    relayed request runs on its own thread (ThreadingHTTPServer), so
    parallel parser workers don't serialize on the helper.
    """

    def __init__(self, port: int = 0):
        self._srv = ThreadingHTTPServer(("127.0.0.1", port), _RelayHandler)
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        return f"127.0.0.1:{self._srv.server_address[1]}"

    def start(self) -> str:
        """Serve on a daemon thread; returns the ``host:port`` address."""
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        name="dct-tls-proxy", daemon=True)
        self._thread.start()
        return self.address

    def stop(self) -> None:
        """Shut the relay down and release its listening socket."""
        self._srv.shutdown()
        self._srv.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def __enter__(self) -> str:
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


_auto_proxy: Optional[TlsProxy] = None
_auto_lock = threading.Lock()


def ensure_tls_proxy(export_env: bool = True) -> str:
    """Address of a TLS helper for this process, starting one if needed.

    Returns ``DCT_TLS_PROXY`` untouched when the operator configured a
    helper; otherwise starts a process-wide singleton and returns its
    address. The NATIVE layer learns the address through the explicit
    C-ABI setter (io/native.py _route_https → dct_set_tls_proxy), not the
    env: mutating os.environ (setenv) while native request threads call
    getenv is undefined behavior in glibc. ``export_env`` additionally
    exports the address for Python-side consumers and subprocesses — it
    writes at most once (skipped when the value is already current), and
    callers that already publish natively pass False.
    """
    configured = os.environ.get("DCT_TLS_PROXY")
    if configured:
        return configured
    global _auto_proxy
    with _auto_lock:
        if _auto_proxy is None:
            _auto_proxy = TlsProxy()
            _auto_proxy.start()
        if (export_env
                and os.environ.get("DCT_TLS_PROXY") != _auto_proxy.address):
            # setenv is only safe while no native request thread can be
            # mid-getenv; the io facade therefore passes export_env=False
            # and publishes natively instead. This export path serves
            # Python-level callers that spawn subprocesses BEFORE touching
            # native io.
            os.environ["DCT_TLS_PROXY"] = _auto_proxy.address
        return _auto_proxy.address


def _main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="TLS-terminating relay for the native plain-HTTP "
                    "client (export DCT_TLS_PROXY=<printed address>)")
    ap.add_argument("--port", type=int, default=0,
                    help="listen port on 127.0.0.1 (default: ephemeral)")
    args = ap.parse_args(argv)
    proxy = TlsProxy(port=args.port)
    addr = proxy.start()
    print(f"DCT_TLS_PROXY={addr}", flush=True)
    try:
        threading.Event().wait()  # serve until killed
    except KeyboardInterrupt:
        proxy.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
