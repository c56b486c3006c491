"""chip_smoke.py's kernel cases, bound, data writers and phases, on the CPU.

The script itself needs a CUDA card; what it holds the kernel to (the plain
version on its cases, the memory-traffic bound) is checked here, where the
port's wrapper takes the plain version for CPU tensors, and every phase
runs here end to end at a small size (rows cut, widths kept).
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke as cs
from dmlc_core_tpu_torch.ops import hopper_kernels as hk

NAMES = ("probe_1024x28", "train_65536x28", "duplicates_4096x28",
         "duplicates_9_per_cell_4096x28", "padding_out_of_range_1024x28",
         "heavy_duplicates_1024x28", "empty_64x28", "libsvm_uneven_8192x28",
         "f27_16384x27", "wide_1024x20000", "train_unsorted_65536x28")


@pytest.fixture(scope="module")
def cases():
    return {c[0]: c for c in cs.kernel_cases(np.random.default_rng(0))}


def test_case_names(cases):
    assert tuple(cases) == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_plain_version_on_smoke_case(cases, name):
    _, row, col, val, R, F, tol, _ = cases[name]
    r, c, v = (torch.from_numpy(a) for a in (row, col, val))
    got = hk.csr_to_dense_kernel(r, c, v, R, F)  # CPU: the plain version
    assert got.shape == (R, F) and got.dtype == torch.float32
    ok, _ = cs.check_against_f64(got, r, c, v, R, F)
    assert ok
    if tol == "exact":  # one add per cell: the f32 values themselves
        keep = (row >= 0) & (row < R) & (col >= 0) & (col < F)
        want = np.zeros((R, F), np.float32)
        want[row[keep], col[keep]] = val[keep]
        assert np.array_equal(got.numpy(), want)


def test_bound_at_training_shape(cases):
    _, row, col, _, R, F, _, _ = cases["train_65536x28"]
    ms, by = cs.bound_ms(torch.from_numpy(row), torch.from_numpy(col), R, F)
    # 4 B x 2,097,152 row ids + 8 B x 1,835,008 kept nonzeros + 4 B x
    # 1,835,008 cells, at 3.35 TB/s
    assert by == "bytes"
    assert ms == pytest.approx((4 * 2097152 + 12 * 1835008) / 3.35e12 * 1e3)
    # the permuted batch needs the same bytes
    _, row, col, _, R, F, _, _ = cases["train_unsorted_65536x28"]
    assert cs.bound_ms(torch.from_numpy(row), torch.from_numpy(col), R,
                       F)[0] == pytest.approx(ms)


def test_surface_phase_rehearsal_on_cpu(tmp_path):
    """The ``surface`` phase's child on the CPU: the top-level import
    without torch or numpy, every package-level export, a batch through
    ``io``'s exports and ``ops.csr_to_dense`` (the plain version on the
    CPU, so no launch), and the tracker's line in the reference's
    format."""
    uri = str(tmp_path / "higgs_like.libsvm")
    cs.write_higgs_like(uri, 4096)
    out = cs.surface_phase(uri, device="cpu", rows=1024)
    assert not out["torch_after_import"] and not out["numpy_after_import"]
    assert out["rows"] == 1024 and out["equal"]
    assert out["launches"] == {"csr_to_dense": 0}
    assert out["exports"]["dmlc_core_tpu_torch.utils"] == 14
    assert cs.SURFACE_TRACKER_LINE.match(out["tracker_line"])


def test_serve_phase_rehearsal_on_cpu(tmp_path, monkeypatch):
    """The serve phase end to end on the CPU at a small size: the trained
    model through the checkpoint bit for bit, the in-process server's
    scores against float64 and the CPU forward, then the CLI server under
    a 1-s closed loop of the lane's traffic, drained by SIGTERM. Two
    clients co-batch at most 16 rows, so the one shape the warm-up makes
    is every shape the loop can make."""
    monkeypatch.setenv("DCT_CSR_TO_DENSE", "xla")  # train_phase sets it
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        data = cs.write_higgs_files(str(tmp_path), rows=4096)
        _, params = cs.train_phase(data["text"], device="cpu", rows=4096,
                                   batch_rows=1024)
        out = cs.serve_phase(str(tmp_path), params, device="cpu",
                             requests=8, warm_s=0.5, loop_s=1.0,
                             workers=2)
    finally:
        torch.set_num_threads(n)
    assert out["checkpoint"]["bit_exact"]
    assert out["higgs"]["model_device"] == "cpu"
    assert out["higgs"]["max_abs_err_vs_f64"] <= 1e-5
    assert out["higgs"]["max_rel_err_vs_cpu"] <= 1e-6
    lane = out["lane"]
    assert lane["completed"] > 0 and lane["errors"] == 0
    assert lane["distinct_shapes_after"] == lane["distinct_shapes_warm"]
    assert lane["drain_exit"] == 0
    for name in ("serve_forward_us", "serve_parse_us", "serve_request_us"):
        assert lane["server_us"][name]["count"] > 0
    assert out["launches"] == {"csr_to_dense": 0}


def test_lane_payloads_match_the_reference_generator():
    """chip_smoke's copy of the lane's payload generator gives the bytes
    of the reference's (scripts/loadrig.py) for the same spec."""
    import os
    import sys
    scripts = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    import loadrig
    fn, _ = loadrig.score_payload_fn(
        "libsvm:rows=2,rows_max=8,features=16384,nnz=16,seed=7")
    assert cs.lane_payloads(20) == [fn() for _ in range(20)]


@pytest.fixture
def one_thread(monkeypatch):
    monkeypatch.setenv("DCT_CSR_TO_DENSE", "xla")  # the phases set it
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_higgs_files_and_crec_kernel_case(tmp_path):
    data = cs.write_higgs_files(str(tmp_path), rows=3000)
    assert data["rows"] == 3000
    assert all(data["bytes"][k] > 0 for k in ("text", "crec", "drec"))
    name, row, col, val, R, F, tol, _ = cs.crec_kernel_case(data["crec"],
                                                           batch_rows=1024)
    assert (name, R, F, tol) == ("crec_batch_1024x28", 1024, 28, "exact")
    # every row holds the 28 columns; the rest of the bucket is padding
    assert len(row) >= 1024 * 28 and (row[1024 * 28:] == R).all()
    r, c, v = (torch.from_numpy(a) for a in (row, col, val))
    got = hk.csr_to_dense_kernel(r, c, v, R, F)
    want = np.zeros((R, F), np.float32)
    keep = row < R
    want[row[keep], col[keep]] = val[keep]
    assert np.array_equal(got.numpy(), want)
    # the same rows as the text file's first batch
    from dmlc_core_tpu_torch.io.native import NativeParser
    with NativeParser(data["text"]) as p:
        first = np.concatenate([b.value.copy() for b in p])[:1024 * 28]
    assert np.array_equal(val[:1024 * 28], first)


def test_criteo_writer_shape(tmp_path):
    path = str(tmp_path / "c.libfm")
    cs.write_criteo_like(path, 4000, seed=3)
    from dmlc_core_tpu_torch.io.native import NativeParser
    with NativeParser(path + "?format=libfm") as p:
        # a block's arrays are views, valid until the parser's next call
        blocks = [[a.copy() for a in (b.offset, b.field, b.index, b.value,
                                      b.label)] for b in p]
    lens, fields, ids, vals, labels = (
        np.concatenate([np.diff(b[0]) for b in blocks]),
        *(np.concatenate([b[i] for b in blocks]) for i in range(1, 5)))
    assert len(lens) == 4000 and (lens == 39).all()
    assert np.array_equal(fields, np.tile(np.arange(39), 4000))
    assert ids.max() < cs.CRITEO_FEATURES
    assert (ids.reshape(4000, 39)[:, :13] == np.arange(13)).all()
    assert (ids.reshape(4000, 39)[:, 13:] >= 13).all()
    assert (vals.reshape(4000, 39)[:, 13:] == 1).all()
    assert (vals.reshape(4000, 39)[:, :13] > 0).all()
    want = cs.criteo_like(4000, seed=3)
    assert np.array_equal(labels, want[0].astype(np.float32))
    np.testing.assert_allclose(vals.reshape(4000, 39), want[2], rtol=1e-6)
    assert 0.1 < labels.mean() < 0.4  # Criteo's click rate is about 1/4


def test_mslr_writer_shape(tmp_path):
    path = str(tmp_path / "m.libsvm")
    queries = cs.write_mslr_like(path, 6000, seed=5)
    from dmlc_core_tpu_torch.io.native import NativeParser
    with NativeParser(path) as p:
        blocks = [[a.copy() for a in (b.offset, b.qid, b.label, b.index)]
                  for b in p]
    lens, qid, labels, ids = (
        np.concatenate([np.diff(b[0]) for b in blocks]),
        *(np.concatenate([b[i] for b in blocks]) for i in range(1, 4)))
    assert len(lens) == 6000 and (lens == cs.MSLR_FEATURES).all()
    assert ids.max() == cs.MSLR_FEATURES - 1
    assert int(qid.max()) + 1 == queries and 6000 / queries > 80
    assert set(np.unique(labels)) == {0, 1, 2, 3, 4}
    share = np.bincount(labels.astype(int)) / 6000
    np.testing.assert_allclose(share, [0.52, 0.32, 0.13, 0.02, 0.01],
                               atol=0.02)


def test_new_phases_rehearsal_on_cpu(tmp_path, one_thread):
    """lanes, fm and rank end to end on the CPU at a small size: every
    lane's equality gates, the FM's CPU comparison, dense margin and
    serving check, the ranking epoch and its two refusals."""
    wd = str(tmp_path)
    data = cs.write_higgs_files(wd, rows=4096)
    run, params = cs.train_phase(data["text"], device="cpu", rows=4096,
                                 batch_rows=1024)
    lanes = cs.lanes_phase(data, {"losses": run["losses"],
                                  "w": params.w.numpy(),
                                  "b": float(params.b)},
                           device="cpu", batch_rows=1024)
    assert set(lanes["lanes"]) == {"text_dense_bf16", "recd", "text_csr",
                                   "index64", "crec",
                                   "text_csr_bf16_values"}
    assert lanes["lanes"]["recd"]["losses"] == \
        lanes["lanes"]["text_dense_bf16"]["losses"]
    assert lanes["launches"] == {"csr_to_dense": 0}  # CPU: plain version
    assert 0 < lanes["gaps"]["bf16_values_vs_f32_loss_max_rel"] < 1e-3
    fm = cs.fm_phase(wd, data, device="cpu", rows=2048, batch_rows=1024)
    assert fm["features"] == 1 << 20 and fm["fields"] == 39
    assert fm["nnz_bucket"] == 65536  # 1024 x 39 nonzeros, next power of 2
    assert fm["losses"][-1] < fm["losses"][0]
    assert fm["serve"]["max_abs_err_vs_f64"] <= 1e-5
    rank = cs.rank_phase(wd, data, device="cpu", rows=2048, batch_rows=512)
    assert rank["features"] == 136 and rank["steps"] == 4
    assert rank["losses"][0] == pytest.approx(np.log(2.0))
    assert rank["losses"][-1] < rank["losses"][0]
    assert set(rank["refusals"]) == {"oversized", "no_qid"}


def test_host_phase_rehearsal_on_cpu(tmp_path, one_thread):
    """The card's ``host`` phase on the CPU at a small size: both lanes'
    host epochs against their device epochs, the learner on host
    ``.crec`` batches against device batches, the bench's trees."""
    data = cs.write_higgs_files(str(tmp_path), rows=4096)
    host = cs.host_phase(data, device="cpu", batch_rows=1024)
    assert set(host["lanes"]) == {"text", "crec"}
    assert host["steps"] == 4 and len(host["losses"]) == 4
    assert host["launches"] == {"csr_to_dense": 0}  # CPU: plain version
    assert host["gaps"]["host_vs_device_batches"]["loss_max_rel"] == 0.0
    assert host["bench_trees"]["replay_first_pass_batches"] == 4
    assert os.environ["DCT_CSR_TO_DENSE"] == "pallas"


def test_dp_union_files_follow_the_world_steps(tmp_path):
    """The ``dp`` phase's union files: step k holds part 0's k-th batch of
    ``local`` rows, then part 1's, as the ranks' parsers split the file;
    the HIGGS-shaped file's part 0 holds one row more (the split starts
    part 1 after the middle line), so the last step is part 0's last row
    alone. The parser's rows of every step equal the parts' rows."""
    from dmlc_core_tpu_torch.io.native import NativeParser
    data = cs.write_higgs_files(str(tmp_path), rows=4096)
    counts, files = cs.write_unions(data["text"], str(tmp_path / "u"), 512)
    assert counts == [2049, 2047] and len(files) == 5

    def rows(uri, **kw):
        with NativeParser(uri, **kw) as p:
            return np.concatenate([b.value.copy() for b in p]).reshape(
                -1, cs.FEATURES)

    parts = [rows(data["text"], part=p, npart=2) for p in range(2)]
    for k, uri in enumerate(files):
        want = np.concatenate([parts[0][512 * k:512 * (k + 1)],
                               parts[1][512 * k:512 * (k + 1)]])
        assert np.array_equal(rows(uri), want), k
    assert len(rows(files[-1])) == 1
    _, first = cs.write_unions(data["text"], str(tmp_path / "f"), 512,
                               max_steps=2)
    assert len(first) == 2


def test_telemetry_phase_and_rowblock_epochs_rehearsal(tmp_path, one_thread):
    """The ``data`` phase's RowBlockIter epochs and the ``telemetry``
    phase on the CPU at a small size: the shard cache's replay bit for
    bit, the capture, the trace lined up with the step spans, the losses
    equal to ``train``'s, the exposition's derived gauges equal to the
    phase's own values. The CPU profiler records no device operation, so
    the busy share is 0 and the one idle gap is the whole epoch."""
    wd = str(tmp_path)
    data = cs.write_higgs_files(wd, rows=4096)
    rb = cs.rowblock_epochs(data["text"], str(tmp_path / "cache"))
    assert rb["rows"] == 4096 and rb["nnz"] == 4096 * cs.FEATURES
    assert rb["replay_bit_equal"] and rb["save_load_bit_equal"]
    first, second = rb["epochs"]
    assert first["cache"]["cache_transcodes_total"] == 1
    assert second["cache"]["cache_hits_total"] == 1
    assert first["pipeline_stats"]["blocks_delivered"] > 0
    assert second["pipeline_stats"] is None  # the replay lane: no pipeline
    run, _ = cs.train_phase(data["text"], device="cpu", rows=4096,
                            batch_rows=1024)
    tel = cs.telemetry_phase(data["text"], run["losses"], wd, device="cpu",
                             rows=4096, batch_rows=1024)
    assert tel["trace_clock"] == "wall" and tel["alignment_max_us"] < 2000
    assert tel["stall_verdict"] in ("parse_bound", "stage_bound",
                                    "consumer_bound", "fill_bound")
    assert 0.0 <= tel["device_overlap_ratio"] <= 1.0
    assert tel["device_busy_share"] == 0.0
    (gap,) = tel["timeline"]["idle_gaps"]
    assert gap["us"] == pytest.approx(tel["timeline"]["window_us"])
    assert {"train.step", "device.stage"} <= set(gap["covered_by_us"])
    assert tel["exposition"]["stall_verdict_code"] == \
        cs.telemetry.VERDICT_CODES[tel["stall_verdict"]]


def test_device_timeline_from_a_hand_made_trace():
    """Busy share, top operations and idle gaps of a hand-made trace on
    the spans' clock: two kernels overlapping, a memcpy, a host op that
    does not count, and an event outside the window."""
    trace = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": cs.KERNEL_SYMBOL + "(int)",
         "ts": 100, "dur": 50},
        {"ph": "X", "cat": "kernel", "name": "elementwise", "ts": 120,
         "dur": 60},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 400,
         "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0,
         "dur": 1000},
        {"ph": "X", "cat": "kernel", "name": "late", "ts": 5000,
         "dur": 10}]}
    spans = [{"name": "device.wait", "ts": 1180, "dur": 200},
             {"name": "train.step", "ts": 1000, "dur": 150},
             {"name": "other", "ts": 1000, "dur": 9000}]
    tl = cs.device_timeline(trace, 1000.0, 1000.0, 2000.0, spans)
    assert tl["busy_us"] == 80 + 100 and tl["busy_share"] == 0.18
    assert tl["kernel_launches"] == 1 and tl["device_events"] == 4
    assert [o["name"] for o in tl["top_ops"]][:2] == ["Memcpy HtoD",
                                                      "elementwise"]
    assert [g["us"] for g in tl["idle_gaps"]] == [500, 220, 100]
    assert tl["idle_gaps"][1]["covered_by_us"] == {"device.wait": 200}
    assert tl["idle_gaps"][2]["covered_by_us"] == {"train.step": 100}


def test_trace_clock_shift_detects_wall_and_monotonic():
    anchors = {"start": {"wall_us": 5e15, "perf_us": 1e9},
               "stop": {"wall_us": 5e15 + 1e6, "perf_us": 1e9 + 1e6}}
    wall = {"baseTimeNanoseconds": 4e18,
            "traceEvents": [{"ph": "X", "ts": 1e15 + 10, "dur": 1}]}
    shift, clock = cs.trace_clock_shift_us(wall, anchors)
    assert clock == "wall" and 1e15 + 10 + shift == pytest.approx(1e9 + 10)
    mono = {"traceEvents": [{"ph": "X", "ts": 1e9 + 10, "dur": 1}]}
    assert cs.trace_clock_shift_us(mono, anchors) == (0.0, "mono")
    with pytest.raises(cs.CheckFailed, match="unknown clock"):
        cs.trace_clock_shift_us(
            {"traceEvents": [{"ph": "X", "ts": 7.0, "dur": 1}]}, anchors)


def test_cluster_merge_in_a_two_rank_world(tmp_path):
    """The ``dp`` phase's cluster half in a 2-rank gloo world on the CPU:
    each rank ships ``rank_export()`` through ``allgather_bytes``; rank 0
    holds every ``job:`` counter to the ranks' sums and gives a straggler
    verdict over the ranks' step durations."""
    data = cs.write_higgs_files(str(tmp_path), rows=2048)
    task = {"name": "linear", "model": "linear", "uri": data["text"],
            "features": cs.FEATURES, "batch_rows": 512}
    res, _ = cs.run_dp_world(str(tmp_path), "two", 2, "gloo", "cpu", [task],
                             cluster=True)
    cluster = res[0]["cluster"]
    assert res[1]["cluster"] == {}
    assert cluster["ranks"] == [0, 1] and cluster["job_counters"] > 0
    assert cluster["job_counters_equal_rank_sums"], cluster["mismatches"]
    assert cluster["straggler"]["verdict"] in ("unknown", "straggler_bound")
    assert set(cluster["straggler"]["median_us"]) == {"0", "1"}


def test_cluster_check_catches_a_wrong_sum():
    doc = {"metrics": {"counters": [{"name": "a_total", "labels": {},
                                     "value": 2}],
                       "gauges": [], "histograms": []}}
    good = cs.cluster_check({0: doc, 1: doc}, {0: [1.0] * 3, 1: [1.0] * 3})
    assert good["job_counters_equal_rank_sums"] and good["job_counters"] == 1
    real = cs.telemetry.cluster_prometheus_text
    try:
        cs.telemetry.cluster_prometheus_text = lambda per_rank: real(
            per_rank).replace("job:a_total 4", "job:a_total 5")
        bad = cs.cluster_check({0: doc, 1: doc}, {})
    finally:
        cs.telemetry.cluster_prometheus_text = real
    assert not bad["job_counters_equal_rank_sums"]
    assert bad["mismatches"] == {"job:a_total{}": [5.0, 4]}


@pytest.fixture
def job_s3(tmp_path, one_thread):
    """The HIGGS-shaped file at 4,096 rows on the tests' mock S3 (the one
    ``tests/test_s3.py`` serves, which the native S3 client of this
    process is bound to)."""
    from test_s3 import _STATE
    data = cs.write_higgs_files(str(tmp_path), rows=4096)
    uri = f"s3://{cs.JOB_BUCKET}/higgs_like.libsvm"
    cs.upload(data["text"], uri)
    with open(data["text"], "rb") as f:
        assert _STATE.objects[(cs.JOB_BUCKET, "higgs_like.libsvm")] == \
            f.read()
    return str(tmp_path), data, uri


def test_job_run_a_rehearsal_on_cpu(job_s3):
    """Run A of the ``job`` phase on the CPU (16 shards of 256 rows, two
    workers, the victim SIGKILLed holding its second lease): its gates
    hold and its numbers are the ones the phase prints."""
    wd, data, uri = job_s3
    a = cs.job_run_a(wd, data, uri, "cpu", 128)
    assert sorted(sum(a["shards_per_task"].values(), [])) == \
        list(range(cs.JOB_SHARDS))
    assert a["victim"]["held_shard"] in a["shards_per_task"][1]
    assert a["rows"] == 4096 and a["relaunch"] in ("lost", "tracker-gone")
    assert a["relaunch_start_after_kill_ms"] > 0
    # the lease comes back only with the write-off: dead-after + grace
    assert cs.JOB_DEAD_MS <= a["kill_to_regrant_ms"] < 10_000
    assert a["launches"] == 0  # CPU: the plain version


def test_job_run_b_rehearsal_on_cpu(job_s3):
    """Run B of the ``job`` phase on the CPU (8 steps of 512 rows, rank 1
    SIGKILLed in step 5, the world relaunched from the step-4 job
    checkpoint on the mock S3): its gates hold."""
    wd, data, uri = job_s3
    b = cs.job_run_b(wd, data, uri, "cpu", 512)
    assert len(b["losses"]) == cs.JOB_STEPS and b["step4_bit_equal"]
    assert b["loss_max_rel"] <= 1e-5
    assert b["world_relaunches"] == 1
    assert b["kill_to_survivor_exit_ms"] <= 2 * cs.JOB_DEAD_MS
    assert b["survivor_cause"] in ("sigterm", "collective-error",
                                   "tracker-abort")
    assert len(b["abort_reasons"]) == 1  # one abort, whatever came first


def test_lm_phase_rehearsal_on_cpu(tmp_path, one_thread):
    """The ``lm`` phase end to end on the CPU at a small size (embed 32,
    seq 64, 1 layer; the card runs embed 128, seq 2048, 2 layers): both
    models on one rank, the 2-rank world of the ring, TP + MoE, zigzag,
    the pipeline and the K/V exchange held to the single rank and the
    dense programs, and the CLI under ``tracker.submit --mesh`` resumed
    from its step-3 commit."""
    out = cs.lm_phase(str(tmp_path), device="cpu", seq=64, embed=32,
                      layers=1)
    assert out["corpus"]["bytes"] > 300_000
    assert out["corpus"]["files"][0] == "SURVEY.md"
    assert out["launches"] == {"csr_to_dense": 0}
    for kind in ("lm", "tp"):
        single = out["single"][kind]
        assert len(single["losses"]) == cs.LM_STEPS
        assert single["peak_device_bytes"] is None  # no device on the CPU
        assert single["fp32_peak_share"] is None
        assert out["world"][kind]["loss_max_rel"] <= 2e-5
    assert out["world"]["kv_exchange"]["bytes"] == 2 * 8 * 32 * 32 * 4
    assert out["cli"]["resumed_losses"] == out["cli"]["losses"][3:]


def test_lm_step_flops_count_the_matmuls():
    sizes = {"seq": 2048, "embed": 128, "heads": 4, "layers": 2,
             "batch": 8, "steps": 6}
    B, S, D = 8, 2048, 128
    attn = 2 * B * S * D * 3 * D + 4 * B * S * S * D + 2 * B * S * D * D
    logits = 2 * B * S * D * 256
    assert cs.lm_step_flops("lm", sizes) == 3 * (
        2 * (attn + 4 * B * S * D * 4 * D) + logits)
    moe = 2 * B * S * D * 4 + 4 * B * S * 4 * D * 4 * D + 2 * B * S * 4 * D
    assert cs.lm_step_flops("tp", sizes) == 3 * (2 * (attn + moe) + logits)
