"""The port's telemetry plane against the reference's.

Hand-built documents go through both packages' pure functions and must
come out equal: ``stall_attribution`` (one document a verdict),
``device_overlap_ratio`` (no transfer, hidden, exposed and overlapping
waits), ``straggler_attribution``, ``events_jsonl``, and the renderings
``prometheus_text``, ``cluster_prometheus_text`` and
``cluster_trace_json`` (equal strings, byte for byte). The same metrics
and spans recorded in both registries give the same derived gauges in
``snapshot``. The HELP catalog is the reference's word for word on every
shared name but ``serve_forward_us`` (the port's forward is eager), and
its other names are exactly the port-only catalog's
(``doc/torch/observability.md``), which a live snapshot leaves out before
it is rendered by both packages.
Collectors: a raising one is swallowed. ``HostResourceSampler`` gives
the reference's summary keys, and the same summary of the same samples.
``torch_profiler_capture`` on the CPU: nothing without
``DMLC_TORCH_PROFILE``; with it, the trace and anchor files, and a
span's ``record_function`` row lines up with the span through the
anchors (within 2 ms). The timer's spans aggregate as the reference's.
Every comparison here is exact unless it states a tolerance.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from dmlc_core_tpu import telemetry as ref_tel
from dmlc_core_tpu.utils import timer as ref_timer
from tests.torch_reference_native import reference_native  # noqa: F401

from dmlc_core_tpu_torch import telemetry as tel
from dmlc_core_tpu_torch.device.device_iter import torch_profiler_capture
from dmlc_core_tpu_torch.qa import contracts
from dmlc_core_tpu_torch.utils import timer

NB = tel.HIST_BUCKETS + 1
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# metrics the port alone registers (a step or a batch earlier in the same
# process registers them); the reference has no HELP line for them
PORT_ONLY = contracts.port_only_metrics(REPO)


def without_port_only(snap: dict) -> dict:
    """``snap`` less the port-only catalog's series."""
    return dict(snap, **{fam: [m for m in snap[fam]
                               if m["name"] not in PORT_ONLY]
                         for fam in ("counters", "gauges", "histograms")})


@pytest.fixture(autouse=True)
def _clean():
    # the port's native registry and span ring too: a parse run earlier in
    # the same process (another test file) leaves native spans that
    # rank_export() would carry
    tel.reset()
    ref_tel.reset(native=False)
    yield
    tel.reset()
    ref_tel.reset(native=False)


def _hist(name, total, labels=None, count=3):
    buckets = [0] * NB
    buckets[5] = count
    return {"name": name, "labels": labels or {}, "count": count,
            "sum": float(total), "buckets": buckets}


def _doc(**sums):
    return {"histograms": [_hist(k, v) for k, v in sums.items()]}


STALL_DOCS = {
    "unknown": _doc(),
    "compile_bound": _doc(device_compile_us=900, device_stage_us=100,
                          parse_stage_parse_us=50),
    "stage_bound": _doc(device_stage_us=1000, parse_stage_fill_us=100,
                        parse_stage_parse_us=100,
                        parse_stage_reassemble_wait_us=50),
    "transfer_bound": _doc(device_transfer_us=500, parse_stage_fill_us=100,
                           parse_stage_parse_us=200, device_stage_us=350),
    "consumer_bound": _doc(parse_stage_fill_us=300, parse_stage_parse_us=700,
                           parse_stage_reassemble_wait_us=10,
                           device_wait_us=5000),
    "fill_bound": _doc(parse_stage_fill_us=700, cache_read_us=100,
                       parse_stage_parse_us=300,
                       parse_stage_reassemble_wait_us=400),
    "parse_bound": _doc(parse_stage_fill_us=100, parse_stage_scan_us=50,
                        parse_stage_parse_us=900,
                        parse_stage_reassemble_wait_us=400,
                        device_stage_us=1500, device_transfer_us=20),
}


@pytest.mark.parametrize("verdict", sorted(STALL_DOCS))
def test_stall_attribution_matches_reference(verdict):
    doc = STALL_DOCS[verdict]
    # a labeled series never enters the sums
    doc = {"histograms": doc["histograms"] + [
        _hist("device_stage_us", 1e9, {"lane": "x"})]}
    got = tel.stall_attribution(doc)
    assert got == ref_tel.stall_attribution(doc)
    assert got["verdict"] == verdict
    assert tel.VERDICT_CODES == ref_tel.VERDICT_CODES


def _span(name, ts, dur):
    return {"name": name, "id": 1, "parent": 0, "tid": 0, "ts": ts,
            "dur": dur}


OVERLAP_CASES = {
    "no_transfer": ([_span("device.wait", 0, 10)], None),
    "zero_length": ([_span("device.put", 5, 0)], None),
    "hidden": ([_span("device.put", 0, 10), _span("device.wait", 20, 5)],
               1.0),
    "exposed": ([_span("device.put", 10, 10),
                 _span("device.wait", 0, 100)], 0.0),
    "overlapping_waits": ([_span("device.put", 0, 100),
                           _span("device.put", 200, 50),
                           _span("device.wait", 10, 30),
                           _span("device.wait", 20, 40),
                           _span("device.wait", 90, 130),
                           _span("device.stage", 0, 1000)], 70 / 150),
}


@pytest.mark.parametrize("case", sorted(OVERLAP_CASES))
def test_device_overlap_ratio_matches_reference(case):
    span_list, want = OVERLAP_CASES[case]
    got = tel.device_overlap_ratio(span_list)
    assert got == ref_tel.device_overlap_ratio(span_list)
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want, abs=1e-12)


@pytest.mark.parametrize("durs,kw", [
    ({}, {}),
    ({0: [100.0] * 5}, {}),
    ({0: [100.0] * 5, 1: [110.0] * 5}, {}),
    ({0: [100.0] * 5, 1: [100, 900, 800, 700], 2: [95.0] * 3}, {}),
    ({0: [100.0] * 5, 1: [300.0] * 2}, {}),
    ({0: [100.0, 100, 100], 1: [250.0, 260, 240]}, {"factor": 2.0}),
    ({0: [100.0] * 3, 1: [250.0] * 3}, {"factor": 3.0, "min_steps": 1}),
    ({0: [0.0] * 3, 1: [5.0] * 3}, {}),
])
def test_straggler_attribution_matches_reference(durs, kw):
    assert tel.straggler_attribution(durs, **kw) == \
        ref_tel.straggler_attribution(durs, **kw)


def _metric_doc(rng, rank=0):
    return {
        "counters": [
            {"name": "parse_chunks_read_total", "labels": {},
             "value": int(rng.integers(1, 100))},
            {"name": "serve_shed_total",
             "labels": {"reason": 'q"\\x\n'}, "value": 2 + rank},
            {"name": "spans_dropped_total", "labels": {"half": "python"},
             "value": 0},
            {"name": "odd_total", "labels": {}, "value": 1.25 * (rank + 1)}],
        "gauges": [
            {"name": "device_host_q_depth", "labels": {}, "value": 1.5},
            {"name": "stall_stage_occupancy", "labels": {"stage": "parse"},
             "value": float(rng.uniform())},
            {"name": "stall_verdict_code", "labels": {}, "value": 1},
            {"name": "device_overlap_ratio", "labels": {}, "value": -1.0}],
        "histograms": [
            {"name": "device_stage_us", "labels": {}, "count": 4,
             "sum": float(rng.uniform(0, 1e6)),
             "buckets": rng.integers(0, 3, NB).tolist()},
            {"name": "rowblock_batch_us", "labels": {"k": "v"}, "count": 2,
             "sum": 700.5, "buckets": [1] + [0] * 9 + [1] + [0] * 18}],
    }


def test_prometheus_text_matches_reference_byte_for_byte(
        python_parse_metrics):
    rng = np.random.default_rng(3)
    doc = _metric_doc(rng)
    assert tel.prometheus_text(doc) == ref_tel.prometheus_text(doc)
    # a live snapshot, derived gauges included, through both renderers
    tel.counter("parse_chunks_read_total").inc(3)
    tel.histogram("device_stage_us").observe(123)
    tel.emit_span("device.put", 10.0, 5.0)
    snap = without_port_only(tel.snapshot(native=False))
    names = [g["name"] for g in snap["gauges"]]
    assert names[-7:] == ["stall_stage_occupancy"] * 5 + [
        "stall_verdict_code", "device_overlap_ratio"]
    assert tel.prometheus_text(snap) == ref_tel.prometheus_text(snap)


def test_help_catalog_is_the_references():
    shared = set(tel.METRIC_HELP) & set(ref_tel.METRIC_HELP)
    differ = {k for k in shared if tel.METRIC_HELP[k] != ref_tel.METRIC_HELP[k]}
    assert differ == {"serve_forward_us"}
    assert PORT_ONLY and \
        set(tel.METRIC_HELP) - set(ref_tel.METRIC_HELP) == PORT_ONLY
    for name in ("stall_stage_occupancy", "stall_verdict_code",
                 "device_overlap_ratio", "rowblock_batch_us",
                 "host_cpu_busy_frac", "host_rss_bytes"):
        assert name in shared


@pytest.fixture
def python_parse_metrics():
    """The parse pipeline's metrics belong to the native half; Python-side
    ones of the same names, left in a registry, would shadow the native
    ones in every later snapshot of the process (the reference's
    ``tests/test_telemetry.py`` reads them), so they go when the test
    ends."""
    yield
    for mod in (tel, ref_tel):
        with mod._lock:
            for table in (mod._counters, mod._hists):
                for key in [k for k in table if k[0].startswith("parse_")]:
                    del table[key]


def test_derived_gauges_match_reference(python_parse_metrics):
    """The same observations and spans in both registries: the snapshot's
    stall and overlap gauges are equal."""
    for mod in (tel, ref_tel):
        mod.histogram("parse_stage_parse_us").observe(900)
        mod.histogram("parse_stage_fill_us").observe(100)
        mod.histogram("parse_stage_reassemble_wait_us").observe(300)
        mod.histogram("device_stage_us").observe(1500)
        mod.histogram("device_transfer_us").observe(40)
        mod.emit_span("device.put", 100.0, 50.0)
        mod.emit_span("device.wait", 120.0, 100.0)

    def derived(snap):
        return [g for g in snap["gauges"] if g["name"] in (
            "stall_stage_occupancy", "stall_verdict_code",
            "device_overlap_ratio")]

    got = derived(tel.snapshot(native=False))
    assert got == derived(ref_tel.snapshot(native=False))
    assert got[-2]["value"] == tel.VERDICT_CODES["parse_bound"]
    assert got[-1]["value"] == pytest.approx(20 / 50)


def test_cluster_renderings_match_reference():
    rng = np.random.default_rng(11)
    per_rank = {}
    for r in (1, 0, 2):
        doc = _metric_doc(rng, rank=r)
        per_rank[r] = {"pid": 1000 + r, "anchor": {"wall_us": 1, "perf_us": 0},
                       "metrics": doc,
                       "spans": [{"name": "train.step", "id": 7, "parent": 0,
                                  "tid": 3, "ts": 1000 * r, "dur": 50,
                                  "cat": "python", "args": {"rows": r}}]}
    local = _metric_doc(rng)
    assert tel.cluster_prometheus_text(per_rank, local) == \
        ref_tel.cluster_prometheus_text(per_rank, local)
    text = tel.cluster_prometheus_text(per_rank, local)
    assert "job:parse_chunks_read_total " + str(sum(
        d["metrics"]["counters"][0]["value"] for d in per_rank.values())) \
        in text
    local_trace = {"pid": 42, "anchor": {"wall_us": 5.0, "perf_us": 2.0},
                   "spans": [_span("device.wait", 10, 3)], "native": None}
    meta = {"verdict": "unknown", "rank": None}
    assert tel.cluster_trace_json(per_rank, local_trace, meta) == \
        ref_tel.cluster_trace_json(per_rank, local_trace, meta)
    assert tel.trace_json(local_trace) == ref_tel.trace_json(local_trace)


def test_rank_export_shape_and_events_jsonl():
    tel.emit_event("probe", n=1, ts=12.5)
    ref_tel.emit_event("probe", n=1, ts=12.5)
    tel.emit_span("device.put", 10.0, 5.0)
    doc = tel.rank_export(max_spans=4)
    assert set(doc) == set(ref_tel.rank_export()) == {
        "pid", "anchor", "metrics", "spans"}
    assert set(doc["metrics"]) == {"counters", "gauges", "histograms"}
    assert [s["name"] for s in doc["spans"]] == ["device.put"]
    snap = tel.snapshot(native=False)
    assert tel.events_jsonl(snap) == ref_tel.events_jsonl(snap) == \
        '{"ts": 12.5, "event": "probe", "n": 1}\n'
    assert tel.events_jsonl(snap) == ref_tel.events_jsonl(
        ref_tel.snapshot(native=False))


def test_flight_dump_carries_the_rank(tmp_path, monkeypatch):
    monkeypatch.setenv("DMLC_TRACE_DUMP", str(tmp_path))
    path = tel.flight_dump("probe", rank=3)
    with open(path) as f:
        doc = json.load(f)
    ref_path = ref_tel.flight_dump("probe", rank=3)
    with open(ref_path) as f:
        ref_doc = json.load(f)
    assert (doc["reason"], doc["rank"]) == ("probe", 3)
    assert set(doc) == set(ref_doc)
    assert tel.flight_dump("probe") != path


def test_collectors_run_and_a_raising_one_is_swallowed():
    g = tel.gauge("collected_probe")
    calls = []

    def good():
        calls.append(1)
        g.set(len(calls))

    def bad():
        raise RuntimeError("broken collector")

    tel.register_collector(bad)
    tel.register_collector(good)
    tel.register_collector(good)  # once only
    try:
        snap = tel.snapshot(native=False)
        assert calls == [1]
        (got,) = [x["value"] for x in snap["gauges"]
                  if x["name"] == "collected_probe"]
        assert got == 1
    finally:
        tel.unregister_collector(bad)
        tel.unregister_collector(good)
    tel.unregister_collector(good)  # absent: no-op
    tel.snapshot(native=False)
    assert calls == [1]


def test_host_resource_sampler_summary_like_reference():
    mine = tel.HostResourceSampler(interval_s=0.05).start()
    ref = ref_tel.HostResourceSampler(interval_s=0.05).start()
    time.sleep(0.2)
    a, b = mine.stop(), ref.stop()
    assert set(a) == set(b)
    # the same samples reduce to the same envelope
    fake = [{"t": 10.0 + i, "cpu": [(100 * i, 400 * i), (50 * i, 400 * i)],
             "rss": 1000 + i, "cached": 5 * i, "pids": {"self": 20 * i},
             "net": 7 * i, "disk": 512 * i} for i in range(4)]
    for s in (mine, ref):
        s.samples = list(fake)
    assert mine.summary() == ref.summary()
    assert mine.summary(11.0, 12.0) == ref.summary(11.0, 12.0)
    with mine.section("probe"):
        pass
    assert mine.sections["probe"] == {
        "unavailable": "fewer than 2 samples in window"}


def test_torch_profiler_capture_off_without_the_variable(monkeypatch):
    monkeypatch.delenv("DMLC_TORCH_PROFILE", raising=False)
    with torch_profiler_capture(device="cpu") as on:
        assert on is False


def test_torch_profiler_capture_writes_anchored_trace(tmp_path, monkeypatch):
    out = tmp_path / "prof"
    monkeypatch.setenv("DMLC_TORCH_PROFILE", str(out))
    with torch_profiler_capture(device="cpu") as on:
        with tel.span("probe.step"), \
                timer.trace_span("probe.step", profiler=True):
            torch.randn(64, 64) @ torch.randn(64, 64)
            time.sleep(0.02)
    assert on is True
    pid = os.getpid()
    assert sorted(os.listdir(out)) == [f"dmlc_anchor_{pid}.json",
                                       f"torch_trace_{pid}.json"]
    with open(out / f"dmlc_anchor_{pid}.json") as f:
        anchors = json.load(f)
    with open(out / f"torch_trace_{pid}.json") as f:
        trace = json.load(f)
    assert anchors["pid"] == pid
    for key in ("start", "stop"):
        assert set(anchors[key]) == {"wall_us", "perf_us"}
    assert anchors["stop"]["perf_us"] >= anchors["start"]["perf_us"]
    (row,) = [e for e in trace["traceEvents"]
              if e.get("name") == "probe.step" and e.get("ph") == "X"]
    (sp,) = [s for s in tel.spans() if s["name"] == "probe.step"]
    # the CPU profiler writes wall-clock times relative to the file's
    # base; the anchors carry them onto the spans' perf_counter clock
    base = trace.get("baseTimeNanoseconds", 0) / 1e3
    shift = anchors["start"]["wall_us"] - anchors["start"]["perf_us"]
    assert abs(row["ts"] + base - shift - sp["ts"]) < 2000.0
    assert abs(row["dur"] - sp["dur"]) < 2000.0
    (ev,) = [e for e in tel.events() if e["event"] == "torch-profile"]
    assert ev["dir"] == str(out) and ev["started"] is True


def test_timer_spans_aggregate_like_reference():
    timer.reset_span_totals()
    ref_timer.reset_span_totals()
    for mod in (timer, ref_timer):
        with mod.trace_span("stage.parse"):
            pass
        with pytest.raises(ValueError):
            with mod.trace_span("stage.fails"):
                raise ValueError("x")
        with mod.trace_span("stage.pad", profiler=True):
            pass
        t = mod.Timer()
        with t:
            pass
        assert t.total >= 0 and t.stop() == t.total
    got, want = timer.span_totals(), ref_timer.span_totals()
    assert {k: v["count"] for k, v in got.items()} == \
        {k: v["count"] for k, v in want.items()} == \
        {"stage.parse": 1, "stage.fails": 1, "stage.pad": 1}
    timer.reset_span_totals()
    ref_timer.reset_span_totals()
    assert timer.span_totals() == {}
