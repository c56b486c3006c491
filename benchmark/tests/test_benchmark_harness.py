"""The benchmark's harness on the CPU: the contract's shape of
``BENCHMARK.json``, lookup by name, the roofline's byte counts, the open
loop's exact percentiles, the generators, the isolation of the harness
and the reference, and small runs of every cell.

Run with ``python -m pytest benchmark/tests``. The cases marked ``cuda``
run on a card and skip elsewhere."""

from __future__ import annotations

import http.server
import json
import os
import re
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest

from benchmark import harness, roofline
from benchmark.datagen import criteo_like, higgs_like
from benchmark.drivers import serve_open

ROOT = harness.ROOT
SPEC = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SEED = 2 ** 31 + 12345
# small sizes for the CPU: same code, fewer rows
SMALL = {"config": {"rows": 4096, "batch_rows": 1024}}
SMALL_SERVE = {"traffic": {"rate_qps": 40}}


@pytest.fixture(autouse=True)
def _one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _all_names():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SPEC[key]:
            yield e["name"]
    for w in SPEC["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in SPEC["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(_all_names())))
def test_names_use_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_units_and_directions(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")


def test_contract_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert "setup_s" in [m["name"] for m in SPEC["end_to_end"]]
    for m in SPEC["end_to_end"]:
        assert 0 < m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    cells = {w["name"] for w in SPEC["workloads"]}
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    assert len({(w["config"], w["traffic"]) for w in SPEC["workloads"]}) \
        == len(cells)
    for p in SPEC["paths"]:
        assert os.path.isdir(os.path.join(ROOT, p))
    for c in SPEC["configs"]:
        assert c["file"].startswith(tuple(p + "/" for p in SPEC["paths"]))
        data = harness.load_json(os.path.join(ROOT, c["file"]))
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
    for m in SPEC["per_layer"]:
        assert set(m["workloads"]) <= cells


@pytest.mark.parametrize("metric", SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_cells_report_what_they_move(metric):
    for cell in metric["workloads"]:
        e2e, per_layer = harness.cell_metrics(SPEC, cell)
        assert metric["moves"] in [m["name"] for m in e2e], cell
        assert metric in per_layer


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_reports_setup_another_and_a_layer(cell):
    e2e, per_layer = harness.cell_metrics(SPEC, cell)
    names = [m["name"] for m in e2e]
    assert "setup_s" in names and len(names) >= 2 and per_layer


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a mix and a metric added as files, with entries in
    BENCHMARK.json, are found without editing any file there."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    cfg = harness.load_json(os.path.join(ROOT, "benchmark/configs/"
                                         "higgs_lr.json"))
    cfg["name"] = "tiny_lr"
    (root / "benchmark/configs/tiny_lr.json").write_text(json.dumps(cfg))
    (root / "benchmark/traffic/tiny_mix.json").write_text(json.dumps(
        {"driver": "train_epochs", "input": "text"}))
    (root / "benchmark/metrics/tiny_metric.py").write_text(
        "def read(t):\n    return 7.0\n")
    spec["configs"].append({"name": "tiny_lr", "source": "x",
                            "file": "benchmark/configs/tiny_lr.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "tiny_lr.mix", "config": "tiny_lr",
                              "traffic": "tiny_mix", "chips": 1,
                              "why": "x"})
    spec["per_layer"].append({"name": "tiny_metric", "unit": "ms",
                              "better": "lower", "source": "host_clock",
                              "layer": "x", "moves": "train_rows_per_s",
                              "workloads": ["tiny_lr.mix"]})
    harness.by_name(spec["end_to_end"], "train_rows_per_s",
                    "metric")["workloads"].append("tiny_lr.mix")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    found = harness.resolve("tiny_lr.mix", str(root))
    assert found["config"]["name"] == "tiny_lr"
    assert found["traffic"]["driver"] == "train_epochs"
    assert harness.driver_of(found).__file__.startswith(str(root))
    assert [m["name"] for m in found["per_layer"]] == ["tiny_metric"]
    assert harness.read_per_layer(found, None) == {
        "tiny_metric": {"value": 7.0, "unit": "ms"}}


def test_roofline_counts_worked_by_hand():
    # 65,536 x 28 in a 2,097,152-entry bucket: 8,388,608 bytes of row ids,
    # 1,835,008 kept nonzeros x 8 bytes, a 7,340,032-byte f32 output
    flops, nbytes = roofline.csr_to_dense_cost(2097152, 65536 * 28, 65536,
                                               28)
    assert nbytes == 30408704 and flops == 65536 * 28
    s, by = roofline.bound_s(flops, nbytes)
    assert by == "bytes" and abs(s - 30408704 / 3.35e12) < 1e-15
    assert abs(s * 1e6 - 9.077) < 1e-3
    # the FM step: 2,555,904 nonzeros of 65,536 rows, 10,000 columns, K 8
    f, b = roofline.fm_step_cost(65536, 2555904, 10000, 8)
    assert b == 2555904 * 12 + 65536 * 8 + 2 * 10000 * 9 * 4
    assert f == 2555904 * 68 + 65536 * 57 + 3 * 10000 * 9
    f, b = roofline.linear_step_cost(65536, 65536 * 28, 28)
    assert b == 65536 * 28 * 12 + 65536 * 8 + 2 * 29 * 4


def test_nearest_rank_percentiles():
    v = np.arange(1, 101, dtype=float)[::-1]
    assert serve_open.nearest_rank(v, 0.50) == 50.0
    assert serve_open.nearest_rank(v, 0.99) == 99.0
    assert serve_open.nearest_rank(np.array([3.0]), 0.99) == 3.0


class _Slow(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def do_POST(self):
        body = self.rfile.read(int(self.headers["Content-Length"]))
        # a request whose body says "slow" waits 40 ms
        if body.startswith(b"slow"):
            threading.Event().wait(0.04)
        out = b'{"scores": []}'
        self.send_response(200)
        self.send_header("Content-Length", str(len(out)))
        self.end_headers()
        self.wfile.write(out)

    def log_message(self, *a):
        pass


def test_open_loop_keeps_every_latency():
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Slow)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        payloads = [b"slow" if i % 10 == 9 else b"fast" for i in range(100)]
        out = serve_open.open_loop(srv.server_address[1], payloads, 50.0,
                                   8, 10.0, "text/plain")
    finally:
        srv.shutdown()
        srv.server_close()
    lat = out["latency_s"]
    assert out["status"] == [200] * 100 and np.isfinite(lat).all()
    assert (lat[9::10] >= 0.04).all()
    # p99 is a latency one request had, exactly, never a bucket edge, and
    # it lies in the slow tenth's range
    p99 = serve_open.nearest_rank(lat, 0.99)
    assert p99 in set(lat.tolist()) and p99 >= 0.04
    assert p99 == np.sort(lat)[98]


@pytest.mark.parametrize("gen", [higgs_like, criteo_like],
                         ids=["higgs_like", "criteo_like"])
def test_generators_repeat_for_a_seed(gen, tmp_path):
    a, b, c = (tmp_path / "a", tmp_path / "b", tmp_path / "c")
    gen.write(str(a), 3000, SEED)
    gen.write(str(b), 3000, SEED)
    gen.write(str(c), 3000, SEED + 1)
    assert a.read_bytes() == b.read_bytes() != c.read_bytes()
    x, y = gen.arrays(3000, SEED), gen.arrays(3000, SEED)
    for k in ("label", "col", "val"):
        assert np.array_equal(x[k], y[k])
    assert x["col"].shape == (3000, gen.NNZ_PER_ROW)


@pytest.mark.parametrize("rows", [1, 7, 3001, 140000])
def test_generators_write_chip_smokes_bytes(rows, tmp_path):
    """The frozen copies write what ``chip_smoke.py``'s generators write,
    across block boundaries of the threaded writer."""
    import chip_smoke
    pairs = [(chip_smoke.write_higgs_like, higgs_like.write),
             (chip_smoke.write_criteo_like, criteo_like.write)]
    for orig, copy in pairs:
        orig(str(tmp_path / "a"), rows, SEED)
        copy(str(tmp_path / "b"), rows, SEED)
        assert (tmp_path / "a").read_bytes() == (tmp_path / "b").read_bytes()


@pytest.mark.parametrize("gen,fmt", [(higgs_like, "libsvm"),
                                     (criteo_like, "libfm")],
                         ids=["higgs_like", "criteo_like"])
def test_arrays_are_what_the_parser_reads(gen, fmt, tmp_path):
    from dmlc_core_tpu_torch.io.native import NativeParser
    path = str(tmp_path / f"rows.{fmt}")
    gen.write(path, 2000, SEED, fmt)
    arr = gen.arrays(2000, SEED)
    got_col, got_val, got_y = [], [], []
    with NativeParser(f"{path}?format={fmt}") as p:
        for blk in p:
            got_col.append(np.asarray(blk.index, np.int64))
            got_val.append(np.asarray(blk.value, np.float64))
            got_y.append(np.asarray(blk.label, np.float64))
    assert np.array_equal(np.concatenate(got_col), arr["col"].ravel())
    assert np.array_equal(np.concatenate(got_y), arr["label"])
    np.testing.assert_allclose(np.concatenate(got_val), arr["val"].ravel(),
                               rtol=1e-7, atol=0)


def _imports_in_fresh_process(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_harness_drivers_and_metrics_load_no_jax():
    tops = _imports_in_fresh_process(
        "import glob, os\n"
        "from benchmark import harness, calibrate, trace, correct\n"
        "import dmlc_core_tpu_torch.serving.__main__\n"
        "f = harness.resolve('higgs_lr.text')\n"
        "for d in ('drivers', 'metrics', 'models', 'reference', 'datagen'):\n"
        "    for p in glob.glob(os.path.join(harness.BENCH_DIR, d, '*.py')):\n"
        "        n = os.path.basename(p)[:-3]\n"
        "        if n != '__init__':\n"
        "            harness.part(f, d, n)\n")
    assert "dmlc_core_tpu_torch" in tops
    assert not tops & set(harness.FORBIDDEN_MODULES)


def test_reference_imports_nothing_of_the_program():
    tops = _imports_in_fresh_process(
        "import benchmark.reference.linear, benchmark.reference.fm\n"
        "import benchmark.correct, benchmark.roofline\n"
        "import benchmark.datagen.higgs_like, benchmark.datagen.criteo_like")
    assert not tops & ({"dmlc_core_tpu_torch"} |
                       set(harness.FORBIDDEN_MODULES))


def test_no_card_no_result(tmp_path):
    """Without a card (or in a checkout that holds only the benchmark) a
    run prints no result and exits non-zero."""
    for cwd in (ROOT, tmp_path):
        if cwd == tmp_path:
            shutil.copytree(os.path.join(ROOT, "benchmark"),
                            tmp_path / "benchmark",
                            ignore=shutil.ignore_patterns(".cache"))
            shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
        out = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload",
             "higgs_lr.text", "--seed", "1", "--seconds", "1",
             "--trace", "0"], capture_output=True, text=True, cwd=cwd,
            timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        assert out.returncode != 0 and out.stdout.strip() == ""


def _check_small_run(r, spec, cell, trace):
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks" and r["failed"] == 0
    e2e, per_layer = harness.cell_metrics(spec, cell)
    if trace:
        assert set(r["metrics"]) <= {m["name"] for m in per_layer}
        assert r["metrics"] and "breakdown" in r
        assert r["device"]["window_s"] > 0
    else:
        # a CPU run has no card to read a device metric from
        assert set(r["metrics"]) == {m["name"] for m in e2e
                                     if m["source"] != "device_trace"}
        assert all(m["value"] > 0 for m in r["metrics"].values())


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_small_run_of_each_cell(cell, trace):
    r = harness.run_cell(cell, SEED + trace, 1.0, bool(trace), "cpu",
                         overrides=SMALL)
    _check_small_run(r, SPEC, cell, trace)


@pytest.mark.parametrize("trace", [0, 1])
def test_small_run_of_the_serving_cell(trace, serving_root, program_on_path):
    r = harness.run_cell("criteo_fm.serve", SEED + trace, 1.0, bool(trace),
                         "cpu", overrides=SMALL_SERVE, root=serving_root)
    spec = harness.load_json(os.path.join(serving_root, "BENCHMARK.json"))
    _check_small_run(r, spec, "criteo_fm.serve", trace)


def test_trace_analysis_on_a_synthetic_timeline():
    """Busy time merges overlapping device events; an annotation's device
    time counts the launches of its own thread and of the other
    kernel-launching thread (autograd's), not the copy thread's; an idle
    gap takes the name of the host span covering most of it."""
    from benchmark import trace

    def x(cat, name, tid, ts, dur, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "tid": tid, "ts": ts,
             "dur": dur}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    events = [
        x("user_annotation", "bench.step", 1, 100, 50),
        x("cuda_runtime", "cudaLaunchKernel", 1, 105, 1, 1),
        x("cuda_runtime", "cudaLaunchKernel", 2, 120, 1, 2),   # autograd
        x("cuda_runtime", "cudaMemcpyAsync", 3, 125, 1, 3),    # copies
        x("kernel", "fwd", 7, 110, 10, 1),
        x("kernel", "bwd", 7, 115, 20, 2),
        x("gpu_memcpy", "h2d", 8, 130, 40, 3),
    ]
    anchors = {"start": {"wall_us": 0.0, "perf_us": 0.0},
               "stop": {"wall_us": 1000.0, "perf_us": 1000.0}}
    spans = [{"name": "device.wait", "ts": 170.0, "dur": 200.0}]
    got = trace.analyze({"traceEvents": events}, anchors, 100.0, 400.0,
                        spans, ("bench.step",))
    assert got["busy_s"] == pytest.approx(60e-6)   # [110, 170]
    assert got["annotated_us"]["bench.step"] == [30.0]
    assert got["idle_gaps"][0] == ["device.wait", pytest.approx(230e-6)]
    assert got["window_s"] == pytest.approx(300e-6)
    # the card's compute: kernels (and memsets), the copy left out
    assert trace.device_time_us({"traceEvents": events}) == 30
