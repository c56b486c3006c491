"""The scoring server: admission control, micro-batching, degradation.

The port of ``dmlc_core_tpu/serving/server.py``, with every behaviour of
the reference. One :class:`HttpFrontend` loop admits requests; one scorer
thread gathers them into micro-batches, parses, pads to buckets, runs the
forward on the model's device (``cuda`` unless the caller passes
``device="cpu"``), and completes each request's reply slot. A forward
that fails on the device is a failure, answered 500 and counted by the
breaker; it is never retried on the CPU. The robustness plane
(doc/serving.md):

- **Bounded admission**: a queue of at most ``queue_max`` requests;
  past it the client gets an immediate 503 + ``Retry-After`` instead of
  unbounded queue growth.
- **Intended-time shedding**: at dequeue, a request whose age (time
  since ARRIVAL — not time in service) exceeds its lateness budget is
  answered 429 without being scored. Under overload this holds the
  admitted-request p99 at the configured target; the shed rate is the
  honest signal (coordinated-omission discipline, doc/benchmarks.md).
- **Circuit breaker**: consecutive model-forward failures open the
  breaker; while open, scores are shed 503 for a cooldown, then one
  half-open batch probes recovery.
- **Last-good model**: ``POST /reload`` loads a fresh artifact through
  the checkpoint layer (fs_fault/retry planes apply); a failed reload
  keeps the previous parameters serving, counted and evented.
- **Draining shutdown**: ``stop(drain=True)`` answers every admitted
  request, sheds new arrivals 503, and never drops a response
  mid-write; ``/readyz`` flips 503 the moment draining starts while
  ``/healthz`` stays 200 (liveness vs readiness).
"""

import collections
import json
import random
import threading
import time
from typing import Deque, List, Optional, Union

import logging

from dmlc_core_tpu_torch import telemetry
from dmlc_core_tpu_torch.base import resolve_device
from dmlc_core_tpu_torch.serving import batching
from dmlc_core_tpu_torch.serving.frontend import HttpFrontend, PENDING, \
    Request
from dmlc_core_tpu_torch.serving.model import ScoringModel
from dmlc_core_tpu_torch.tracker.event_log import _EventLog
from dmlc_core_tpu_torch.tracker.minihttp import HttpError
from dmlc_core_tpu_torch.tracker.wire import env_float, env_int, env_str

logger = logging.getLogger("dmlc_core_tpu_torch.serving")

#: circuit-breaker states as the serve_breaker_state gauge reports them
BREAKER_CLOSED, BREAKER_OPEN, BREAKER_HALF_OPEN = 0, 1, 2


class ServingConfig:
    """Knobs for one scoring server (env defaults, doc/parameters.md).

    Every numeric knob reads through the wire checked parses; the
    row-bucket ladder is a constructor/CLI argument (validated by
    :func:`batching.parse_buckets`), not an env knob.
    """

    def __init__(self, *,
                 max_body_bytes: Optional[int] = None,
                 queue_max: Optional[int] = None,
                 shed_lateness_ms: Optional[float] = None,
                 p99_target_ms: Optional[float] = None,
                 batch_max_rows: Optional[int] = None,
                 batch_delay_ms: Optional[float] = None,
                 breaker_threshold: Optional[int] = None,
                 breaker_cooldown_ms: Optional[float] = None,
                 min_nnz_bucket: Optional[int] = None,
                 drain_grace_s: Optional[float] = None,
                 idle_timeout_s: Optional[float] = None,
                 trace_sample: Optional[float] = None,
                 access_log: Optional[str] = None,
                 access_log_sample: Optional[float] = None,
                 access_log_max_bytes: Optional[int] = None,
                 rows_buckets: str = "16,64,256,1024",
                 tmp_dir: Optional[str] = None):
        def pick(value, fallback):
            return fallback if value is None else value
        self.max_body_bytes = pick(
            max_body_bytes, env_int("DMLC_SERVE_MAX_BODY_BYTES", 1048576))
        self.queue_max = pick(
            queue_max, env_int("DMLC_SERVE_QUEUE_MAX", 256))
        #: intended-time lateness budget (ms) a request may accumulate in
        #: the queue before it is shed 429; 0 disables shedding
        self.shed_lateness_ms = pick(
            shed_lateness_ms,
            env_float("DMLC_SERVE_SHED_LATENESS_MS", 200.0))
        #: the p99 the lateness budget defends — reported by /statz and
        #: pinned by the overload tests (budget + service headroom < p99)
        self.p99_target_ms = pick(
            p99_target_ms, env_float("DMLC_SERVE_P99_TARGET_MS", 400.0))
        self.batch_max_rows = pick(
            batch_max_rows, env_int("DMLC_SERVE_BATCH_MAX_ROWS", 256))
        self.batch_delay_ms = pick(
            batch_delay_ms, env_float("DMLC_SERVE_BATCH_DELAY_MS", 2.0))
        self.breaker_threshold = pick(
            breaker_threshold, env_int("DMLC_SERVE_BREAKER_THRESHOLD", 5))
        self.breaker_cooldown_ms = pick(
            breaker_cooldown_ms,
            env_float("DMLC_SERVE_BREAKER_COOLDOWN_MS", 1000.0))
        self.min_nnz_bucket = pick(
            min_nnz_bucket, env_int("DMLC_SERVE_MIN_NNZ_BUCKET", 256))
        self.drain_grace_s = pick(
            drain_grace_s, env_float("DMLC_SERVE_DRAIN_GRACE_S", 5.0))
        self.idle_timeout_s = pick(
            idle_timeout_s, env_float("DMLC_SERVE_IDLE_TIMEOUT_S", 120.0))
        #: fraction of admitted requests that record a full
        #: admit->queue->parse->forward->reply span chain (with an
        #: exemplar on serve_request_us); 0 disables request tracing
        self.trace_sample = pick(
            trace_sample, env_float("DMLC_SERVE_TRACE_SAMPLE", 0.01))
        #: structured JSONL access-log path ("" / unset = off)
        self.access_log = pick(
            access_log, env_str("DMLC_SERVE_ACCESS_LOG"))
        self.access_log_sample = pick(
            access_log_sample,
            env_float("DMLC_SERVE_ACCESS_LOG_SAMPLE", 1.0))
        self.access_log_max_bytes = pick(
            access_log_max_bytes,
            env_int("DMLC_SERVE_ACCESS_LOG_MAX_BYTES", 16 << 20))
        self.rows_buckets = batching.parse_buckets(rows_buckets)
        self.tmp_dir = tmp_dir or batching.scratch_dir()
        if self.batch_max_rows > self.rows_buckets[-1]:
            self.batch_max_rows = self.rows_buckets[-1]


class _ScoreReq:
    """One admitted score request awaiting the scorer."""

    __slots__ = ("slot", "payload", "fmt", "rows", "arrival_us",
                 "deadline_ms", "request_id", "trace_id")

    def __init__(self, slot, payload: bytes, fmt: str, rows: int,
                 arrival_us: float, deadline_ms: float,
                 request_id: str = "", trace_id: int = 0):
        self.slot = slot
        self.payload = payload
        self.fmt = fmt
        self.rows = rows
        self.arrival_us = arrival_us
        self.deadline_ms = deadline_ms
        self.request_id = request_id
        # root span id of the sampled trace chain (0 = unsampled); the
        # explicit cross-thread parent handle — the ring's thread-local
        # chain does not follow the request onto the scorer thread
        self.trace_id = trace_id


class _ReloadReq:
    """An admitted model-reload command (ordered with the score queue)."""

    __slots__ = ("slot", "uri")

    def __init__(self, slot, uri: Optional[str]):
        self.slot = slot
        self.uri = uri


class ScoringServer:
    """Batched online scoring on one port; see the module docstring.

    ``device`` is where a model loaded from ``model_uri`` (at
    :meth:`start` and on reload) lives: default ``cuda``, and without
    CUDA the constructor raises. A ``model`` passed in keeps its own
    device."""

    def __init__(self, model: Optional[ScoringModel] = None,
                 model_uri: Optional[str] = None, *,
                 host: str = "127.0.0.1", port: int = 0,
                 config: Optional[ServingConfig] = None, device=None):
        if model is None and model_uri is None:
            raise HttpError(500, "ScoringServer needs a model or a "
                                 "model_uri")
        self._device = model.device if model is not None else \
            resolve_device(device)
        self.config = config or ServingConfig()
        self._model = model
        self._model_uri = model_uri or (model.uri if model else "")
        self._cond = threading.Condition()
        self._queue: Deque[Union[_ScoreReq, _ReloadReq]] = \
            collections.deque()
        self._draining = False
        self._stopping = False
        self._breaker = BREAKER_CLOSED
        self._breaker_failures = 0
        self._breaker_opened_at = 0.0
        self._scorer: Optional[threading.Thread] = None
        self.frontend = HttpFrontend(
            self._handle, host=host, port=port,
            max_body_bytes=self.config.max_body_bytes,
            idle_timeout_s=self.config.idle_timeout_s)
        self._m_admitted = telemetry.counter("serve_admitted_total")
        self._m_scored = telemetry.counter("serve_scored_total")
        self._m_errors = telemetry.counter("serve_errors_total")
        self._m_depth = telemetry.gauge("serve_queue_depth")
        self._m_batches = telemetry.counter("serve_batches_total")
        self._m_batch_rows = telemetry.histogram("serve_batch_rows")
        self._m_batch_fill = telemetry.histogram("serve_batch_fill")
        self._m_parse_us = telemetry.histogram("serve_parse_us")
        self._m_forward_us = telemetry.histogram("serve_forward_us")
        self._m_request_us = telemetry.histogram("serve_request_us")
        self._m_access_dropped = telemetry.counter(
            "serve_access_log_dropped_total")
        # structured access log: the tracker event log's contained JSONL
        # sink (rotation + drop-and-count), pointed at its own counter
        self._access_log: Optional[_EventLog] = None
        if self.config.access_log:
            self._access_log = _EventLog(
                self.config.access_log, self.config.access_log_max_bytes,
                dropped=self._m_access_dropped)
        telemetry.gauge("serve_draining").set(0)
        telemetry.gauge("serve_breaker_state").set(BREAKER_CLOSED)

    # -- lifecycle ---------------------------------------------------------

    @property
    def port(self) -> int:
        """The bound TCP port (useful with ``port=0``)."""
        return self.frontend.port

    def start(self) -> None:
        """Load the model if needed, then start the scorer and loop."""
        if self._model is None:
            self._model = ScoringModel.load(self._model_uri,
                                            device=self._device)
        # rolling windows + SLO burn monitors over this process's
        # registry (doc/observability.md "SLO plane")
        telemetry.start_windowed_view(slo=True)
        self._scorer = threading.Thread(target=self._scorer_loop,
                                        name="serve-scorer", daemon=True)
        self._scorer.start()
        self.frontend.start()
        telemetry.emit_event("serve-start", port=self.port,
                             model=self._model.kind,
                             step=self._model.step)

    def stop(self, drain: bool = True,
             grace_s: Optional[float] = None) -> None:
        """Shut down: with ``drain`` answer every admitted request
        first; without it, shed the queue 503. Either way every
        completed response finishes its write before sockets close."""
        grace = self.config.drain_grace_s if grace_s is None else grace_s
        with self._cond:
            self._draining = True
            if not drain:
                self._shed_queue_locked("draining")
            self._stopping = True
            self._cond.notify_all()
        telemetry.gauge("serve_draining").set(1)
        telemetry.emit_event("serve-drain", drain=int(drain))
        if self._scorer is not None:
            self._scorer.join(grace + 30.0)
        deadline = time.monotonic() + grace
        while self.frontend.inflight() and time.monotonic() < deadline:
            time.sleep(0.01)
        self.frontend.stop(grace)
        telemetry.stop_windowed_view()
        if self._access_log is not None:
            self._access_log.close()

    def _shed_queue_locked(self, reason: str) -> None:
        while self._queue:
            req = self._queue.popleft()
            telemetry.counter("serve_shed_total",
                             {"reason": reason}).inc()
            req.slot.send_error(HttpError(503, f"shedding: {reason}"))
        self._m_depth.set(0)

    # -- handler (loop thread; must not block) -----------------------------

    def _handle(self, req: Request):
        if req.method == "GET":
            if req.path == "/healthz":
                return 200, b'{"status": "ok"}\n', "application/json"
            if req.path == "/readyz":
                return self._readyz()
            if req.path == "/metrics":
                return (200, telemetry.prometheus_text().encode(),
                        "text/plain; version=0.0.4; charset=utf-8")
            if req.path == "/statz":
                return 200, (json.dumps(self.statz()) + "\n").encode(), \
                    "application/json"
            if req.path == "/trace":
                return self._trace(req)
            raise HttpError(404, f"no such path {req.path}; serve "
                                 "endpoints: /score /reload /healthz "
                                 "/readyz /metrics /statz /trace")
        if req.method == "POST":
            if req.path == "/score":
                return self._admit_score(req)
            if req.path == "/reload":
                return self._admit_reload(req)
            raise HttpError(404, f"no such path {req.path}")
        raise HttpError(405, f"method {req.method} not allowed")

    def _readyz(self):
        # a paging SLO burn flips readiness exactly like the breaker: the
        # load balancer drains this replica until the burn clears (the
        # monitor's hysteresis is what un-flips it)
        slo_page = telemetry.slo_page_active()
        ready = self._model is not None and not self._draining \
            and not slo_page
        body = (json.dumps({
            "ready": ready,
            "draining": self._draining,
            "breaker": self._breaker,
            "slo_page": slo_page,
            "model_loaded": self._model is not None,
        }) + "\n").encode()
        return (200 if ready else 503), body, "application/json"

    def _trace(self, req: Request):
        # GET /trace: whole-process Chrome-trace doc; ?request_id= (the
        # echoed X-Request-Id) or ?span_id= (a histogram exemplar) pulls
        # one sampled request's span chain instead
        params = {}
        for part in req.query.split("&"):
            k, sep, v = part.partition("=")
            if sep:
                params[k] = v
        rid = params.get("request_id")
        sid = params.get("span_id")
        if not rid and not sid:
            return (200, telemetry.trace_json().encode(),
                    "application/json")
        span_list = telemetry.spans()
        root: Optional[int] = None
        if sid:
            try:
                root = int(sid)
            except ValueError:
                raise HttpError(400, f"bad span_id {sid!r}")
        else:
            for s in reversed(span_list):
                if s["name"] == "serve.request" and \
                        (s.get("args") or {}).get("request_id") == rid:
                    root = s["id"]
                    break
        chain = [s for s in span_list
                 if root is not None and
                 (s["id"] == root or s["parent"] == root)]
        if not chain:
            raise HttpError(404, "no sampled span chain for "
                                 f"{rid or sid!r} (tracing samples "
                                 "DMLC_SERVE_TRACE_SAMPLE of requests)")
        chain.sort(key=lambda s: s["ts"])
        body = (json.dumps({"root": root, "spans": chain}) + "\n").encode()
        return 200, body, "application/json"

    def _admit_score(self, req: Request):
        with telemetry.span("serve.admit", bytes=len(req.body)):
            fmt = batching.payload_format(
                req.headers.get("content-type", ""))
            rows = batching.count_rows(req.body)
            if rows == 0:
                raise HttpError(400, "empty payload: no data rows")
            if rows > self.config.rows_buckets[-1]:
                raise HttpError(413, f"payload of {rows} rows exceeds "
                                     "the largest batch bucket "
                                     f"{self.config.rows_buckets[-1]}")
            deadline_ms = self.config.shed_lateness_ms
            raw_deadline = req.headers.get("x-deadline-ms")
            if raw_deadline is not None:
                try:
                    deadline_ms = float(raw_deadline)
                except ValueError:
                    raise HttpError(400,
                                    f"bad X-Deadline-Ms {raw_deadline!r}")
            trace_id = 0
            if self.config.trace_sample > 0 and \
                    random.random() < self.config.trace_sample:
                trace_id = telemetry.new_span_id()
            shed: Optional[str] = None
            with self._cond:
                if self._draining:
                    shed = "draining"
                elif self._breaker_blocks_locked():
                    shed = "breaker"
                elif telemetry.slo_page_active():
                    # the burn signal as an admission input: while the
                    # SLO monitor pages, shed instead of queueing more
                    # work behind a blown budget (these sheds are
                    # excluded from the burn's bad count — see
                    # SloMonitor — so the page can clear)
                    shed = "slo_burn"
                elif len(self._queue) >= self.config.queue_max:
                    shed = "queue_full"
                else:
                    self._queue.append(_ScoreReq(
                        req.slot, req.body, fmt, rows, req.arrival_us,
                        deadline_ms, req.request_id, trace_id))
                    self._m_depth.set(len(self._queue))
                    self._cond.notify()
            if shed is not None:
                telemetry.counter("serve_shed_total",
                                  {"reason": shed}).inc()
                self._access(req.request_id, 503,
                             time.perf_counter() * 1e6 - req.arrival_us,
                             shed)
                raise HttpError(503, f"shedding: {shed}",
                                headers={"Retry-After": "1"})
            if trace_id:
                telemetry.emit_span(
                    "serve.admit", req.arrival_us,
                    time.perf_counter() * 1e6 - req.arrival_us,
                    parent=trace_id, bytes=len(req.body))
            self._m_admitted.inc()
            return PENDING

    def _admit_reload(self, req: Request):
        uri = None
        if req.body.strip():
            try:
                uri = json.loads(req.body).get("uri")
            except (ValueError, AttributeError):
                raise HttpError(400, 'reload body must be JSON like '
                                     '{"uri": "..."} (or empty)')
        with self._cond:
            if self._draining:
                raise HttpError(503, "shedding: draining")
            self._queue.append(_ReloadReq(req.slot, uri))
            self._m_depth.set(len(self._queue))
            self._cond.notify()
        return PENDING

    def _breaker_blocks_locked(self) -> bool:
        """True while the breaker refuses admission (cooldown running);
        flips to half-open — admitting one probe — once it lapses."""
        if self._breaker != BREAKER_OPEN:
            return False
        elapsed_ms = (time.monotonic() - self._breaker_opened_at) * 1e3
        if elapsed_ms < self.config.breaker_cooldown_ms:
            return True
        self._breaker = BREAKER_HALF_OPEN
        telemetry.gauge("serve_breaker_state").set(BREAKER_HALF_OPEN)
        telemetry.emit_event("serve-breaker", state="half-open")
        return False

    # -- scorer thread -----------------------------------------------------

    def _scorer_loop(self) -> None:
        while True:
            first = self._next_work()
            if first is None:
                return
            if isinstance(first, _ReloadReq):
                self._do_reload(first)
                continue
            batch = self._gather(first)
            try:
                self._run_batch(batch)
            except Exception:
                # the batch path must never kill the scorer: answer 500s
                # and keep serving
                logger.exception("serving batch failed")
                self._m_errors.inc()
                for r in batch:
                    r.slot.send_error(HttpError(500, "internal error"))

    def _next_work(self):
        with self._cond:
            while not self._queue and not self._stopping:
                self._cond.wait(0.25)
            if not self._queue:
                return None
            first = self._queue.popleft()
            self._m_depth.set(len(self._queue))
            return first

    def _gather(self, first: _ScoreReq) -> List[_ScoreReq]:
        """Micro-batch: take same-format score requests behind ``first``
        until ``batch_max_rows`` or the batching window closes."""
        batch = [first]
        rows = first.rows
        deadline = time.monotonic() + self.config.batch_delay_ms / 1e3
        with self._cond:
            while rows < self.config.batch_max_rows:
                if self._queue:
                    nxt = self._queue[0]
                    if not isinstance(nxt, _ScoreReq) or \
                            nxt.fmt != first.fmt or \
                            rows + nxt.rows > self.config.batch_max_rows:
                        break
                    self._queue.popleft()
                    batch.append(nxt)
                    rows += nxt.rows
                    continue
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._stopping:
                    break
                self._cond.wait(remaining)
            self._m_depth.set(len(self._queue))
        return batch

    def _shed_late(self, batch: List[_ScoreReq]) -> List[_ScoreReq]:
        """Intended-time lateness shed at dequeue: age is measured from
        ARRIVAL, so time spent queued behind an overload counts against
        the budget even though no service was attempted."""
        now_us = time.perf_counter() * 1e6
        kept: List[_ScoreReq] = []
        for r in batch:
            age_ms = (now_us - r.arrival_us) / 1e3
            if r.deadline_ms > 0 and age_ms > r.deadline_ms:
                telemetry.counter("serve_shed_total",
                                  {"reason": "late"}).inc()
                r.slot.send_error(HttpError(
                    429, f"shed: {age_ms:.0f}ms old exceeds the "
                         f"{r.deadline_ms:.0f}ms lateness budget",
                    headers={"Retry-After": "1"}))
                self._finish_request(r, 429)
            else:
                kept.append(r)
        return kept

    def _run_batch(self, batch: List[_ScoreReq]) -> None:
        batch = self._shed_late(batch)
        if not batch:
            return
        # sampled requests get explicit-parent child spans: this thread's
        # local chain belongs to serve.batch, the request's chain roots
        # at its trace_id minted on the frontend thread
        sampled = [r for r in batch if r.trace_id]
        dequeue_us = time.perf_counter() * 1e6
        for r in sampled:
            telemetry.emit_span("serve.queue", r.arrival_us,
                                dequeue_us - r.arrival_us,
                                parent=r.trace_id)
        with telemetry.span("serve.batch", requests=len(batch)) as sp:
            with telemetry.span("serve.parse"):
                t0 = time.perf_counter()
                group = batching.parse_group(
                    [r.payload for r in batch], batch[0].fmt,
                    self.config.tmp_dir)
                parse_us = (time.perf_counter() - t0) * 1e6
                self._m_parse_us.observe(parse_us)
            for r in sampled:
                telemetry.emit_span("serve.parse", t0 * 1e6, parse_us,
                                    parent=r.trace_id)
            scores = None
            fwd_err: Optional[HttpError] = None
            if group.num_rows > 0:
                try:
                    with telemetry.span("serve.forward",
                                        rows=group.num_rows):
                        t0 = time.perf_counter()
                        row, col, val, rb, nb = batching.pad_to_bucket(
                            group, self.config.rows_buckets,
                            self.config.min_nnz_bucket)
                        scores = self._model.scores(row, col, val, rb)
                        forward_us = (time.perf_counter() - t0) * 1e6
                        self._m_forward_us.observe(forward_us)
                    for r in sampled:
                        telemetry.emit_span("serve.forward", t0 * 1e6,
                                            forward_us,
                                            parent=r.trace_id)
                    self._m_batches.inc()
                    self._m_batch_rows.observe(group.num_rows)
                    self._m_batch_fill.observe(
                        100.0 * group.num_rows / rb)
                    sp.set_arg("rows_bucket", rb)
                    sp.set_arg("nnz_bucket", nb)
                    self._breaker_report(ok=True)
                except HttpError as e:
                    fwd_err = e
                except Exception as e:
                    logger.exception("model forward failed")
                    self._breaker_report(ok=False)
                    fwd_err = HttpError(
                        500, f"model forward failed: {e}")
            with telemetry.span("serve.reply"):
                self._reply(batch, group, scores, fwd_err)

    def _reply(self, batch, group, scores, fwd_err) -> None:
        step = self._model.step if self._model else -1
        reply_us = time.perf_counter() * 1e6
        for i, r in enumerate(batch):
            err = group.errors[i]
            if err is not None:
                r.slot.send_error(err)
                self._finish_request(r, err.status, reply_us)
                continue
            if fwd_err is not None:
                if fwd_err.status >= 500:
                    self._m_errors.inc()
                r.slot.send_error(fwd_err)
                self._finish_request(r, fwd_err.status, reply_us)
                continue
            lo, hi = group.slices[i]
            body = (json.dumps({
                "scores": [float(s) for s in scores[lo:hi]],
                "rows": hi - lo,
                "model_step": step,
            }) + "\n").encode()
            r.slot.send(200, body)
            self._m_scored.inc()
            self._finish_request(r, 200, reply_us)

    def _finish_request(self, r: _ScoreReq, status: int,
                        reply_start_us: Optional[float] = None) -> None:
        """Account one answered request on the intended-time clock; a
        sampled request also closes out its span chain (reply child +
        explicit root carrying the request id) and stamps the latency
        histogram's bucket exemplar."""
        now_us = time.perf_counter() * 1e6
        dur_us = now_us - r.arrival_us
        if r.trace_id:
            if reply_start_us is not None:
                telemetry.emit_span("serve.reply", reply_start_us,
                                    now_us - reply_start_us,
                                    parent=r.trace_id)
            self._m_request_us.observe(dur_us, trace_id=r.trace_id)
            telemetry.emit_span("serve.request", r.arrival_us, dur_us,
                                parent=0, span_id=r.trace_id,
                                status=status, rows=r.rows,
                                request_id=r.request_id)
        else:
            self._m_request_us.observe(dur_us)
            telemetry.emit_span("serve.request", r.arrival_us, dur_us,
                                status=status, rows=r.rows)
        if status == 200:
            cause = "scored"
        elif status == 429:
            cause = "late"
        elif status >= 500:
            cause = "error"
        else:
            cause = "reject"
        self._access(r.request_id, status, dur_us, cause)

    def _access(self, request_id: str, status: int, dur_us: float,
                cause: str) -> None:
        """Write one sampled structured access-log line (request id,
        status, intended-time latency, shed/breaker/error cause); the
        contained sink drops-and-counts on I/O failure."""
        log = self._access_log
        if log is None:
            return
        if self.config.access_log_sample < 1.0 and \
                random.random() >= self.config.access_log_sample:
            return
        log.write(json.dumps({
            "ts": time.time(), "request_id": request_id,
            "status": status, "latency_ms": round(dur_us / 1e3, 3),
            "cause": cause}) + "\n")

    def _breaker_report(self, ok: bool) -> None:
        with self._cond:
            if ok:
                changed = self._breaker != BREAKER_CLOSED
                self._breaker = BREAKER_CLOSED
                self._breaker_failures = 0
            else:
                self._breaker_failures += 1
                changed = (
                    self._breaker_failures >=
                    self.config.breaker_threshold and
                    self._breaker != BREAKER_OPEN)
                if self._breaker_failures >= \
                        self.config.breaker_threshold:
                    self._breaker = BREAKER_OPEN
                    self._breaker_opened_at = time.monotonic()
            state = self._breaker
            failures = self._breaker_failures
        if changed:
            telemetry.gauge("serve_breaker_state").set(state)
            telemetry.emit_event(
                "serve-breaker",
                state={BREAKER_CLOSED: "closed", BREAKER_OPEN: "open",
                       BREAKER_HALF_OPEN: "half-open"}[state])
            if state == BREAKER_OPEN:
                # a breaker trip is a postmortem moment: land the span
                # ring + metrics naming what tripped it (flight-recorder
                # trigger table, doc/observability.md)
                telemetry.flight_dump(
                    f"serve-breaker-open: {failures} consecutive "
                    f"forward failures >= threshold "
                    f"{self.config.breaker_threshold}")

    # -- reload ------------------------------------------------------------

    def _do_reload(self, req: _ReloadReq) -> None:
        uri = req.uri or self._model_uri
        try:
            fresh = self._model.reload(uri) if self._model \
                else ScoringModel.load(uri, device=self._device)
        except Exception as e:
            # last-good fallback: the previous parameters keep serving
            telemetry.counter("serve_model_reload_failures_total").inc()
            telemetry.emit_event("serve-reload-failed", uri=uri,
                                 error=str(e)[:200])
            logger.warning("model reload from %s failed (%s); serving "
                           "last-good step=%s", uri, e,
                           self._model.step if self._model else None)
            body = (json.dumps({
                "error": f"reload failed: {e}",
                "fallback": self._model.describe() if self._model
                else None,
            }) + "\n").encode()
            req.slot.send(503, body)
            return
        self._model = fresh
        self._model_uri = uri
        telemetry.counter("serve_model_reloads_total").inc()
        telemetry.emit_event("serve-reload", uri=uri, step=fresh.step)
        req.slot.send(200, (json.dumps(fresh.describe()) + "\n").encode())

    # -- introspection -----------------------------------------------------

    def statz(self) -> dict:
        """Thread-safe JSON summary for ``/statz``."""
        with self._cond:
            depth = len(self._queue)
            breaker = self._breaker
            draining = self._draining
        return {
            "queue_depth": depth,
            "queue_max": self.config.queue_max,
            "draining": draining,
            "breaker": breaker,
            "slo_page": telemetry.slo_page_active(),
            "trace_sample": self.config.trace_sample,
            "p99_target_ms": self.config.p99_target_ms,
            "shed_lateness_ms": self.config.shed_lateness_ms,
            "rows_buckets": list(self.config.rows_buckets),
            "model": self._model.describe() if self._model else None,
        }
