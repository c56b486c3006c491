"""The port's scoring plane against the reference's.

- ``ScoringModel``: the same artifact on the same padded batch through the
  JAX package's model and the port's (``device="cpu"``) agrees at rtol
  1e-6, for ``linear`` and ``fm``, libsvm and csv payloads, out-of-range
  feature ids included (the two sum in f32 in different orders).
- ``ScoringServer``: the cases of the reference's ``tests/test_serving.py``
  pointed at the port — scores against the trainer's math (atol 1e-5),
  keep-alive, the 4xx edges, 503 from the bounded queue, 429 for
  lateness, the breaker, reload with last-good, draining, ragged traffic
  with no new shapes, padding never leaking into scores, isolation of a
  bad payload, the access log and the breaker's flight dump, and a
  request's span chain found by its ``X-Request-Id``. Tests that hold the
  forward behind a gate while a second request waits set
  ``shed_lateness_ms=0`` unless lateness is what they test, so a loaded
  machine cannot turn the waiting request into a 429.
- The telemetry the server reads: window rates, the SLO burn latch, and
  the Prometheus text, which renders a snapshot exactly as the
  reference's renderer does.
- ``python -m dmlc_core_tpu_torch.serving --device cpu``: the
  ``SERVE_READY`` handshake, a score, and a SIGTERM drain with exit 0.
"""

import contextlib
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from dmlc_core_tpu import telemetry as ref_telemetry
from dmlc_core_tpu.serving import batching as ref_batching
from dmlc_core_tpu.serving.model import ScoringModel as RefModel
from tests.torch_reference_native import reference_native  # noqa: F401
from tests.serving_util import (AsyncReq, Client, ForwardGate,
                                expect_scores, raw_http, sigmoid)

from dmlc_core_tpu_torch import telemetry
from dmlc_core_tpu_torch.base import DMLCError
from dmlc_core_tpu_torch.serving import batching
from dmlc_core_tpu_torch.serving import model as serving_model
from dmlc_core_tpu_torch.serving.model import ScoringModel, save_model
from dmlc_core_tpu_torch.serving.server import (BREAKER_CLOSED,
                                                BREAKER_OPEN,
                                                ScoringServer,
                                                ServingConfig)
from dmlc_core_tpu_torch.tracker import minihttp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    # the native parser's workers spin after a block; torch ops beside
    # them on every core can run 100x slower
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def save_linear(tmp_path, features=32, step=1, seed=5, name=None):
    """A linear serving artifact written by the port; ``(uri, w, b)``."""
    rng = np.random.default_rng(seed)
    w = rng.normal(scale=0.5, size=features).astype(np.float32)
    b = np.array(rng.normal(scale=0.5), dtype=np.float32)
    uri = str(tmp_path / (name or f"model-step{step}.ckpt"))
    save_model(uri, "linear", {"w": w, "b": b}, features, step=step)
    return uri, w, b


@contextlib.contextmanager
def serving_server(uri, **cfg):
    """A started in-process port server on the CPU; always stopped."""
    srv = ScoringServer(model_uri=uri, config=ServingConfig(**cfg),
                        device="cpu")
    srv.start()
    try:
        yield srv
    finally:
        srv.stop(drain=False, grace_s=3.0)


def _shed(reason) -> int:
    return telemetry.counter("serve_shed_total", {"reason": reason}).value


def _score_lines(ctype):
    if ctype == "libsvm":
        # feature 40 lies past the model's 32: masked to zero weight
        return [b"1 0:0.5 3:-1.25 7:2.0\n0 1:1.0 40:3.0\n",
                b"1 2:0.25 30:0.75 31:-0.5\n"]
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 32)).astype(np.float32)
    return [("\n".join(",".join(f"{v:.6f}" for v in row) for row in x[:2])
             + "\n").encode(),
            (",".join(f"{v:.6f}" for v in x[2]) + "\n").encode()]


# ---------------------------------------------------------------------------
# the forward against the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["linear", "fm"])
@pytest.mark.parametrize("fmt", ["libsvm", "csv"])
def test_scoring_model_matches_reference(tmp_path, kind, fmt):
    rng = np.random.default_rng(11)
    params = {"w": rng.normal(size=32).astype(np.float32),
              "b": np.asarray(0.25, np.float32)}
    if kind == "fm":
        params["v"] = rng.normal(scale=0.3, size=(32, 4)).astype(
            np.float32)
    uri = str(tmp_path / "m.ckpt")
    save_model(uri, kind, params, 32, step=3)
    payloads = _score_lines(fmt)
    group = batching.parse_group(payloads, fmt, str(tmp_path))
    ref_group = ref_batching.parse_group(payloads, fmt, str(tmp_path))
    padded = batching.pad_to_bucket(group, (4, 16), 16)
    ref_padded = ref_batching.pad_to_bucket(ref_group, (4, 16), 16)
    for a, b in zip(padded, ref_padded):
        np.testing.assert_array_equal(a, b)
    row, col, val, rb, _ = padded
    ours = ScoringModel.load(uri, device="cpu")
    assert all(t.device.type == "cpu" and t.dtype == torch.float32
               for t in ours.params)
    got = ours.scores(row, col, val, rb)
    want = np.asarray(RefModel.load(uri).scores(row, col, val, rb))
    assert got.shape == want.shape == (rb,)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_scoring_model_refuses_bad_artifacts(tmp_path):
    uri = str(tmp_path / "plain.ckpt")
    from dmlc_core_tpu_torch.utils.checkpoint import save_checkpoint
    save_checkpoint(uri, {"w": np.zeros(3, np.float32)})
    with pytest.raises(DMLCError, match="not a serving model"):
        ScoringModel.load(uri, device="cpu")
    with pytest.raises(DMLCError, match="missing parameters"):
        ScoringModel("fm", {"w": np.zeros(3), "b": np.zeros(())}, 3,
                     device="cpu")
    with pytest.raises(DMLCError, match="unknown serving model kind"):
        save_model(uri, "tree", {}, 3)


# ---------------------------------------------------------------------------
# the reference's server cases, pointed at the port
# ---------------------------------------------------------------------------
def test_libsvm_scores_match_trainer_math(tmp_path):
    uri, w, b = save_linear(tmp_path)
    lines = ["1 0:0.5 3:-1.25 7:2.0",
             "0 1:1.0",
             "1 2:0.25 30:0.75 31:-0.5"]
    with serving_server(uri) as srv:
        cli = Client(srv.port)
        try:
            status, body = cli.score(lines)
            assert status == 200, body
            doc = json.loads(body)
            assert doc["rows"] == 3
            assert doc["model_step"] == 1
            np.testing.assert_allclose(doc["scores"],
                                       expect_scores(lines, w, b),
                                       atol=1e-5)
        finally:
            cli.close()


def test_csv_scores_match_trainer_math(tmp_path):
    features = 8
    uri, w, b = save_linear(tmp_path, features=features)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, features)).astype(np.float32)
    lines = [",".join(f"{v:.6f}" for v in row) for row in x]
    with serving_server(uri) as srv:
        cli = Client(srv.port)
        try:
            status, body = cli.score(lines, ctype="text/csv")
            assert status == 200, body
            want = sigmoid(x.astype(np.float64) @ w.astype(np.float64)
                           + float(b))
            np.testing.assert_allclose(json.loads(body)["scores"], want,
                                       atol=1e-4)
        finally:
            cli.close()


def test_keep_alive_connection_reuse(tmp_path):
    uri, _, _ = save_linear(tmp_path)
    with serving_server(uri) as srv:
        cli = Client(srv.port)
        try:
            for _ in range(3):
                assert cli.score(["1 0:1.0"])[0] == 200
            # a structured 4xx must not burn the connection either
            status, _ = cli.score(["1 0:1.0"], ctype="application/json")
            assert status == 400
            assert cli.score(["1 0:1.0"])[0] == 200
        finally:
            cli.close()


def test_endpoints_and_4xx_edges(tmp_path):
    uri, _, _ = save_linear(tmp_path)
    with serving_server(uri, rows_buckets="4",
                        max_body_bytes=4096) as srv:
        cli = Client(srv.port)
        try:
            status, body = cli.request("GET", "/healthz")
            assert status == 200
            status, body = cli.request("GET", "/readyz")
            assert status == 200 and json.loads(body)["ready"]
            status, body = cli.request("GET", "/statz")
            assert status == 200
            doc = json.loads(body)
            assert doc["rows_buckets"] == [4]
            assert doc["model"]["kind"] == "linear"
            status, body = cli.request("GET", "/metrics")
            assert status == 200
            assert b"serve_requests_total" in body
            # the port's native core's registry is merged in
            assert b"io_requests_total" in body
            status, body = cli.request("GET", "/trace")
            assert status == 200 and "traceEvents" in json.loads(body)
            status, body = cli.request("GET", "/nope")
            assert status == 404
            status, body = cli.request(
                "POST", "/score", b"\n\n",
                {"Content-Type": "application/x-libsvm"})
            assert status == 400 and b"empty payload" in body
            status, body = cli.score([f"1 0:{i}.0" for i in range(6)])
            assert status == 413 and b"largest" in body
            status, body = cli.score(["1 0:1.0"],
                                     headers={"X-Deadline-Ms": "soon"})
            assert status == 400 and b"X-Deadline-Ms" in body
            status, body = cli.score(
                ["1 " + " ".join(f"{j}:1.0" for j in range(3))] * 200)
            assert status == 413
        finally:
            cli.close()


def test_raw_socket_edges(tmp_path):
    """Missing Content-Length (411), oversized request head (431),
    malformed request line (400), unknown method (405)."""
    uri, _, _ = save_linear(tmp_path)
    with serving_server(uri) as srv:
        before = telemetry.counter("serve_rejects_total",
                                   {"code": "431"}).value
        got = raw_http(srv.port,
                       b"POST /score HTTP/1.1\r\nHost: a\r\n\r\n")
        assert b"411" in got.split(b"\r\n")[0]
        got = raw_http(srv.port,
                       b"GET / HTTP/1.1\r\nX-Pad: " + b"a" * 9000)
        assert b"431" in got.split(b"\r\n")[0]
        assert telemetry.counter("serve_rejects_total",
                                 {"code": "431"}).value == before + 1
        got = raw_http(srv.port, b"BANANA\r\n\r\n")
        assert b"400" in got.split(b"\r\n")[0]
        got = raw_http(srv.port, b"BREW /score HTTP/1.1\r\n"
                                 b"Connection: close\r\n\r\n")
        assert b"405" in got.split(b"\r\n")[0]
        cli = Client(srv.port)
        try:
            assert cli.request("GET", "/healthz")[0] == 200
        finally:
            cli.close()


def _wait_queued(srv, depth=1):
    deadline = time.monotonic() + 10
    while srv.statz()["queue_depth"] < depth:
        assert time.monotonic() < deadline
        time.sleep(0.005)


def _post(port, line, headers=None):
    h = {"Content-Type": "application/x-libsvm"}
    h.update(headers or {})
    return AsyncReq(port, "POST", "/score", line, h)


def test_bounded_queue_sheds_503(tmp_path):
    uri, _, _ = save_linear(tmp_path)
    with serving_server(uri, rows_buckets="4", queue_max=1,
                        batch_delay_ms=0.0, shed_lateness_ms=0.0,
                        breaker_threshold=1000) as srv:
        gate = ForwardGate(srv._model)
        gate.arm()
        before = _shed("queue_full")
        r1 = _post(srv.port, b"1 0:1.0\n")
        gate.wait_entered()             # r1 is inside the forward
        r2 = _post(srv.port, b"1 1:1.0\n")
        _wait_queued(srv)
        cli = Client(srv.port)
        try:
            status, body = cli.score(["1 2:1.0"])
            assert status == 503 and b"queue_full" in body
        finally:
            cli.close()
        assert _shed("queue_full") == before + 1
        gate.release()
        assert r1.result()[0] == 200
        assert r2.result()[0] == 200


def test_intended_time_lateness_shed_429(tmp_path):
    """A request queued past its budget is shed 429 at dequeue: the
    clock runs from arrival, so queue time counts."""
    uri, _, _ = save_linear(tmp_path)
    with serving_server(uri, rows_buckets="4",
                        batch_delay_ms=0.0) as srv:
        gate = ForwardGate(srv._model)
        gate.arm()
        before = _shed("late")
        r1 = _post(srv.port, b"1 0:1.0\n", {"X-Deadline-Ms": "0"})
        gate.wait_entered()
        r2 = _post(srv.port, b"1 1:1.0\n", {"X-Deadline-Ms": "1"})
        _wait_queued(srv)
        time.sleep(0.05)                # r2 ages past its 1 ms budget
        gate.release()
        assert r1.result()[0] == 200
        status, body = r2.result()
        assert status == 429 and b"lateness budget" in body
        assert _shed("late") == before + 1


def test_breaker_opens_half_opens_recovers(tmp_path):
    uri, _, _ = save_linear(tmp_path)
    with serving_server(uri, rows_buckets="4", batch_delay_ms=0.0,
                        breaker_threshold=2,
                        breaker_cooldown_ms=300.0) as srv:
        real = srv._model.scores

        def boom(row, col, val, num_rows):
            raise RuntimeError("injected forward fault")

        srv._model.scores = boom
        before = _shed("breaker")
        cli = Client(srv.port)
        try:
            for _ in range(2):
                status, body = cli.score(["1 0:1.0"])
                assert status == 500 and b"forward failed" in body
            assert telemetry.gauge("serve_breaker_state").value \
                == BREAKER_OPEN
            status, body = cli.score(["1 0:1.0"])
            assert status == 503 and b"breaker" in body
            assert _shed("breaker") == before + 1
            status, body = cli.request("GET", "/readyz")
            assert status == 200     # breaker alone is not unreadiness
            assert json.loads(body)["breaker"] == BREAKER_OPEN
            srv._model.scores = real
            time.sleep(0.35)
            status, body = cli.score(["1 0:1.0"])
            assert status == 200, body
            assert telemetry.gauge("serve_breaker_state").value \
                == BREAKER_CLOSED
        finally:
            cli.close()


def test_reload_swap_and_last_good_fallback(tmp_path):
    uri1, w1, b1 = save_linear(tmp_path, step=1, seed=5)
    uri2, w2, b2 = save_linear(tmp_path, step=2, seed=11)
    lines = ["1 0:0.5 4:-1.0"]
    with serving_server(uri1) as srv:
        cli = Client(srv.port)
        try:
            status, body = cli.score(lines)
            np.testing.assert_allclose(json.loads(body)["scores"],
                                       expect_scores(lines, w1, b1),
                                       atol=1e-5)
            ok_before = telemetry.counter(
                "serve_model_reloads_total").value
            status, body = cli.request(
                "POST", "/reload", json.dumps({"uri": uri2}).encode())
            assert status == 200 and json.loads(body)["step"] == 2
            assert telemetry.counter(
                "serve_model_reloads_total").value == ok_before + 1
            assert srv._model.device.type == "cpu"
            doc = json.loads(cli.score(lines)[1])
            assert doc["model_step"] == 2
            np.testing.assert_allclose(doc["scores"],
                                       expect_scores(lines, w2, b2),
                                       atol=1e-5)
            bad = tmp_path / "corrupt.ckpt"
            bad.write_bytes(b"\x00garbage, not a checkpoint\xff" * 8)
            fail_before = telemetry.counter(
                "serve_model_reload_failures_total").value
            status, body = cli.request(
                "POST", "/reload", json.dumps({"uri": str(bad)}).encode())
            assert status == 503
            doc = json.loads(body)
            assert "reload failed" in doc["error"]
            assert doc["fallback"]["step"] == 2
            assert telemetry.counter(
                "serve_model_reload_failures_total").value \
                == fail_before + 1
            assert any(e.get("event") == "serve-reload-failed"
                       for e in telemetry.events())
            status, body = cli.score(lines)
            assert status == 200
            assert json.loads(body)["model_step"] == 2
            status, body = cli.request("POST", "/reload", b"not json")
            assert status == 400
        finally:
            cli.close()


def test_draining_answers_admitted_sheds_rest(tmp_path):
    uri, _, _ = save_linear(tmp_path)
    with serving_server(uri, rows_buckets="4", batch_delay_ms=0.0,
                        shed_lateness_ms=0.0) as srv:
        gate = ForwardGate(srv._model)
        gate.arm()
        r1 = _post(srv.port, b"1 0:1.0\n")
        gate.wait_entered()
        r2 = _post(srv.port, b"1 1:1.0\n")
        _wait_queued(srv)
        import threading
        stopper = threading.Thread(
            target=lambda: srv.stop(drain=True, grace_s=15.0),
            daemon=True)
        stopper.start()
        deadline = time.monotonic() + 10
        while not srv.statz()["draining"]:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        cli = Client(srv.port)
        try:
            assert cli.request("GET", "/healthz")[0] == 200
            status, body = cli.request("GET", "/readyz")
            assert status == 503 and json.loads(body)["draining"]
            status, body = cli.score(["1 2:1.0"])
            assert status == 503 and b"draining" in body
        finally:
            cli.close()
        gate.release()
        assert r1.result()[0] == 200
        assert r2.result()[0] == 200
        stopper.join(30)
        assert not stopper.is_alive()


def test_ragged_traffic_steady_new_shapes_zero(tmp_path):
    """After one warm-up per bucket, ragged row counts add no new forward
    shape: padding to the ladder keeps the shape set finite."""
    uri, _, _ = save_linear(tmp_path)
    with serving_server(uri, rows_buckets="4,16", min_nnz_bucket=32,
                        batch_delay_ms=0.0) as srv:
        cli = Client(srv.port)
        try:
            for rows in (1, 5):
                assert cli.score([f"1 {i}:0.5" for i in range(rows)]
                                 )[0] == 200
            warm = serving_model.distinct_shapes()
            assert warm >= 2
            rng = np.random.default_rng(17)
            for _ in range(24):
                rows = int(rng.integers(1, 17))
                lines = [f"1 {int(rng.integers(0, 32))}:0.25"
                         for _ in range(rows)]
                assert cli.score(lines)[0] == 200
            assert serving_model.distinct_shapes() == warm
            assert telemetry.gauge("serve_distinct_shapes").value == warm
        finally:
            cli.close()


def test_padding_never_leaks_into_scores(tmp_path):
    uri, w, b = save_linear(tmp_path)
    line = "1 0:0.5 3:-1.25"
    with serving_server(uri, rows_buckets="4", min_nnz_bucket=16) as srv:
        cli = Client(srv.port)
        try:
            _, body1 = cli.score([line])
            _, body4 = cli.score([line, "0 1:1.0", "0 2:1.0", "1 5:0.5"])
            s1 = json.loads(body1)["scores"][0]
            s4 = json.loads(body4)["scores"][0]
            assert abs(s1 - s4) < 1e-6
            np.testing.assert_allclose(
                s1, expect_scores([line], w, b)[0], atol=1e-5)
        finally:
            cli.close()


def test_parse_buckets_validation():
    assert batching.parse_buckets("16,4,256") == (4, 16, 256)
    for bad in ("", "a,b", "0,4", "-2"):
        with pytest.raises(DMLCError):
            batching.parse_buckets(bad)


def test_payload_format_mapping():
    assert batching.payload_format("application/x-libsvm") == "libsvm"
    assert batching.payload_format("text/csv; charset=utf-8") == "csv"
    assert batching.payload_format("") == "libsvm"
    with pytest.raises(minihttp.HttpError) as ei:
        batching.payload_format("application/json")
    assert ei.value.status == 400


def test_parse_group_isolates_bad_payload(tmp_path):
    good = b"1 0:0.5 2:1.0\n0 1:0.25\n"
    bad = b"not_a_label 0:1.0\n"
    group = batching.parse_group([good, bad, good], "libsvm",
                                 str(tmp_path))
    assert group.errors[0] is None and group.errors[2] is None
    assert group.errors[1] is not None and group.errors[1].status == 400
    assert group.num_rows == 4
    assert group.slices[0] == (0, 2) and group.slices[2] == (2, 4)


def test_access_log_and_breaker_flight_dump(tmp_path, monkeypatch):
    """Every answered or shed request lands one JSONL access-log line,
    and a breaker trip writes a flight dump naming the consecutive
    failures against the threshold."""
    dump_dir = tmp_path / "dumps"
    monkeypatch.setenv("DMLC_TRACE_DUMP", str(dump_dir))
    alog = tmp_path / "access.jsonl"
    uri, _, _ = save_linear(tmp_path)
    with serving_server(uri, access_log=str(alog), batch_delay_ms=0.0,
                        breaker_threshold=2,
                        breaker_cooldown_ms=60000.0) as srv:
        cli = Client(srv.port)
        try:
            status, _ = cli.score(["1 0:1.0"],
                                  headers={"X-Request-Id": "acc-1"})
            assert status == 200

            def boom(row, col, val, num_rows):
                raise RuntimeError("injected forward fault")

            srv._model.scores = boom
            for _ in range(2):
                assert cli.score(["1 0:1.0"])[0] == 500
            status, body = cli.score(["1 0:1.0"])
            assert status == 503 and b"breaker" in body
        finally:
            cli.close()
    dumps = [json.load(open(dump_dir / f)) for f in os.listdir(dump_dir)]
    trips = [d for d in dumps
             if d["reason"].startswith("serve-breaker-open")]
    assert trips, [d["reason"] for d in dumps]
    assert "2 consecutive" in trips[0]["reason"]
    lines = [json.loads(ln) for ln in alog.read_text().splitlines() if ln]
    by_cause = {}
    for rec in lines:
        assert {"ts", "request_id", "status", "latency_ms",
                "cause"} <= set(rec), rec
        by_cause.setdefault(rec["cause"], []).append(rec)
    assert by_cause["scored"][0]["request_id"] == "acc-1"
    assert by_cause["scored"][0]["status"] == 200
    assert [r["status"] for r in by_cause["error"]] == [500, 500]
    assert by_cause["breaker"][0]["status"] == 503


def test_request_chain_from_trace_and_exemplar(tmp_path):
    """A scored request's echoed X-Request-Id finds its admit -> queue ->
    parse -> forward -> reply chain on /trace, and the latency
    histogram's exemplar names the same root."""
    import http.client
    uri, _, _ = save_linear(tmp_path)
    with serving_server(uri, trace_sample=1.0) as srv:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                          timeout=30.0)
        cli = Client(srv.port)
        try:
            conn.request("POST", "/score", b"0 0:1.0 3:2.5\n",
                         {"Content-Type": "application/x-libsvm",
                          "X-Request-Id": "pin-b.1"})
            resp = conn.getresponse()
            assert resp.status == 200 and b"scores" in resp.read()
            assert resp.getheader("X-Request-Id") == "pin-b.1"
            st, tbody = cli.request("GET", "/trace?request_id=pin-b.1")
            assert st == 200, tbody
            chain = json.loads(tbody)
            names = {s["name"] for s in chain["spans"]}
            assert {"serve.request", "serve.admit", "serve.queue",
                    "serve.parse", "serve.forward",
                    "serve.reply"} <= names, names
            root = [s for s in chain["spans"]
                    if s["name"] == "serve.request"][0]
            assert root["id"] == chain["root"]
            assert root["args"]["request_id"] == "pin-b.1"
            for s in chain["spans"]:
                if s["name"] != "serve.request":
                    assert s["parent"] == chain["root"], s
            hists = [h for h in telemetry.snapshot()["histograms"]
                     if h["name"] == "serve_request_us"]
            assert chain["root"] in (hists[0].get("exemplars")
                                     or {}).values()
            st, nf = cli.request("GET", "/trace?request_id=nope")
            assert st == 404 and b"no sampled span chain" in nf
        finally:
            conn.close()
            cli.close()


# ---------------------------------------------------------------------------
# the telemetry the server reads
# ---------------------------------------------------------------------------
def _gauges(name):
    return {tuple(sorted(g["labels"].items())): g["value"]
            for g in telemetry.snapshot()["gauges"] if g["name"] == name}


def test_window_rate_and_refcounted_view(monkeypatch):
    monkeypatch.setenv("DMLC_SLO_TICK_MS", "1000")
    telemetry.reset()
    view = telemetry.WindowedView(windows={"fast": 10.0})
    c = telemetry.counter("serve_scored_total")
    view.tick(now=100.0)
    c.inc(50)
    view.tick(now=110.0)
    key = (("name", "serve_scored_total"), ("window", "fast"))
    assert _gauges("window_rate")[key] == pytest.approx(5.0)
    v1 = telemetry.start_windowed_view()
    v2 = telemetry.start_windowed_view(slo=True)
    assert v1 is v2 and v1.slo is not None
    telemetry.stop_windowed_view()
    assert telemetry.windowed_view() is v1
    telemetry.stop_windowed_view()
    assert telemetry.windowed_view() is None


def test_slo_burn_latches_and_clears(monkeypatch):
    """A page latches only when every window burns at the fast multiple,
    ignores the monitor's own slo_burn sheds, and clears with
    hysteresis on the fastest window."""
    monkeypatch.setenv("DMLC_SLO_AVAILABILITY_TARGET", "0.9")
    telemetry.reset()
    mon = telemetry.SloMonitor()

    def deltas(good, bad, shed_slo=0.0, slow_good=None):
        fast = {("serve_scored_total", ()): float(good),
                ("serve_errors_total", ()): float(bad),
                ("serve_shed_total", (("reason", "slo_burn"),)): shed_slo}
        slow = dict(fast)
        if slow_good is not None:
            slow = {("serve_scored_total", ()): float(slow_good)}
        return {"fast": (10.0, fast, {}), "slow": (20.0, slow, {})}

    mon.evaluate(deltas(50, 50, slow_good=100))
    assert not mon.paging
    mon.evaluate(deltas(0, 100, shed_slo=1000.0))   # 10x budget, both
    assert not mon.paging                           # below 14.4x
    monkeypatch.setenv("DMLC_SLO_FAST_BURN", "5")
    mon = telemetry.SloMonitor()
    mon.evaluate(deltas(0, 100, shed_slo=1000.0))
    assert mon.paging and _gauges("slo_page")[()] == 1.0
    mon.evaluate(deltas(100, 0))
    assert not mon.paging and _gauges("slo_page")[()] == 0.0


def test_prometheus_text_renders_like_the_reference():
    snap = {"counters": [{"name": "serve_scored_total", "labels": {},
                          "value": 7},
                         {"name": "serve_shed_total",
                          "labels": {"reason": 'q"\\x'}, "value": 2}],
            "gauges": [{"name": "serve_queue_depth", "labels": {},
                        "value": 1.5}],
            "histograms": [{"name": "serve_request_us",
                            "labels": {"k": "v"}, "count": 3,
                            "sum": 700.5,
                            "buckets": [1] + [0] * 9 + [2] + [0] * 18}]}
    assert telemetry.prometheus_text(snap) == \
        ref_telemetry.prometheus_text(snap)


# ---------------------------------------------------------------------------
# the CLI entry
# ---------------------------------------------------------------------------
def test_cli_serve_ready_and_sigterm_drain(tmp_path):
    uri, w, b = save_linear(tmp_path)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "dmlc_core_tpu_torch.serving",
         "--model-uri", uri, "--port", "0", "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=str(tmp_path))
    try:
        line = proc.stdout.readline()
        assert line.startswith("SERVE_READY port="), \
            line + proc.stderr.read()
        port = int(line.split("port=")[1].split()[0])
        assert int(line.split("pid=")[1]) == proc.pid
        cli = Client(port)
        try:
            status, body = cli.score(["1 0:0.5 3:-1.25"])
            assert status == 200
            np.testing.assert_allclose(
                json.loads(body)["scores"],
                expect_scores(["1 0:0.5 3:-1.25"], w, b), atol=1e-5)
        finally:
            cli.close()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        proc.stderr.close()


def test_access_log_sink_rotates_and_contains_faults(tmp_path):
    """The access log's sink (the reference's _EventLog): rotation at the
    byte cap, and an injected write fault drops and counts the line
    instead of raising into the server."""
    from dmlc_core_tpu_torch.tracker.event_log import _EventLog
    from dmlc_core_tpu_torch.utils import fs_fault
    path = tmp_path / "a.jsonl"
    dropped = telemetry.counter("event_log_probe_dropped_total")
    before = dropped.value
    log = _EventLog(str(path), max_bytes=40, dropped=dropped)
    try:
        for i in range(3):
            log.write(json.dumps({"i": i, "pad": "x" * 10}) + "\n")
        assert (tmp_path / "a.jsonl.1").exists()
        fs_fault.set_fs_fault_plan("write:fault=eio,every=1")
        try:
            log.write('{"lost": true}\n')
        finally:
            fs_fault.set_fs_fault_plan("")
        assert dropped.value == before + 1
        log.write('{"kept": true}\n')
    finally:
        log.close()
    assert '"kept"' in path.read_text()
    assert '"lost"' not in path.read_text()


@pytest.mark.parametrize("fmt", ["libsvm", "csv"])
def test_mutated_payloads_parse_like_the_reference(tmp_path, fmt):
    """The reference fuzz suite's seeded mutations (1-3 random bytes of a
    valid 8-row payload), co-batched between two clean payloads: the
    port's parse_group gives the reference's slices, error statuses and
    rows, and the clean neighbours keep their rows."""
    rng = np.random.default_rng(101 if fmt == "libsvm" else 102)

    def valid(rows=8):
        if fmt == "csv":
            return ("\n".join(",".join(f"{rng.uniform(-1, 1):.4f}"
                                       for _ in range(32))
                              for _ in range(rows)) + "\n").encode()
        lines = []
        for _ in range(rows):
            ids = sorted(rng.choice(32, size=4, replace=False))
            lines.append(f"{int(rng.integers(0, 2))} " + " ".join(
                f"{int(j)}:{rng.uniform(-1, 1):.4f}" for j in ids))
        return ("\n".join(lines) + "\n").encode()

    base, clean = valid(), valid(3)
    rejected = 0
    for _ in range(40):
        data = bytearray(base)
        for _ in range(int(rng.integers(1, 4))):
            data[int(rng.integers(0, len(data)))] = int(rng.integers(0, 256))
        group = [clean, bytes(data), clean]
        ours = batching.parse_group(group, fmt, str(tmp_path))
        ref = ref_batching.parse_group(group, fmt, str(tmp_path))
        assert ours.slices == ref.slices
        assert [e and e.status for e in ours.errors] == \
            [e and e.status for e in ref.errors]
        assert ours.num_rows == ref.num_rows
        for a, b in ((ours.row, ref.row), (ours.col, ref.col),
                     (ours.val, ref.val)):
            np.testing.assert_array_equal(a, b)
        assert ours.errors[0] is None and ours.errors[2] is None
        rejected += ours.errors[1] is not None
    if fmt == "libsvm":
        assert rejected > 0  # the sweep reaches the isolation path
