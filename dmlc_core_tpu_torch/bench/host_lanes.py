"""The bench's host lanes: parse rates, thread scaling and the lanes with
no device stage (``bench.py:269-298, 469-580, 1450-1475, 1905-1921,
2025-2044``), over the port's native core.

Every rate here is the host's: rows (or records) over wall seconds of a
pass that counts what it read and checks the count.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
import time
from typing import Optional, Tuple

from dmlc_core_tpu_torch import telemetry
from dmlc_core_tpu_torch.base import BUILD_DIR, REPO_ROOT, build_if_stale
from dmlc_core_tpu_torch.bench.datasets import BINARY_LANES, CACHE_DIR
from dmlc_core_tpu_torch.io.native import (NativeParser,
                                           NativeRecordIOReader,
                                           NativeRecordIOWriter,
                                           io_retry_stats)

# the parse pipeline's counters each occupancy row carries
OCCUPANCY_KEYS = ("occupancy_avg", "inflight_peak", "capacity", "workers",
                  "chunks_read", "reader_waits", "worker_waits",
                  "consumer_waits", "simd_lane")
SCALING_THREADS = (1, 2, 4, 8)
BENCH_PIPELINE = os.path.join(BUILD_DIR, "bench_pipeline")


def _check_rows(got: int, want: int) -> None:
    if got != want:
        raise RuntimeError(f"row count mismatch: {got} != {want}")


def parse_rows_per_sec(path: str, rows: int, nthread: int,
                       fmt: str = "auto", dense_dtype: str = "bfloat16",
                       stats_out: Optional[dict] = None
                       ) -> Tuple[float, float]:
    """(rows/s, seconds) of one host pass: parse for the text and ``rec``
    lanes, batch assembly for ``crec``/``recd`` (no parse stage, so
    ``nthread`` does not apply). With ``stats_out`` the parse pipeline's
    counters (``NativeParser.pipeline_stats``) are copied into it."""
    t0 = time.time()
    got = 0
    if fmt in ("recd", "crec"):
        from dmlc_core_tpu_torch.device.device_iter import (
            CsrRecHostBatcher, DenseRecHostBatcher)
        b = (DenseRecHostBatcher(path, dense_dtype=dense_dtype)
             if fmt == "recd" else CsrRecHostBatcher(path))
        try:
            while (batch := b.next_batch()) is not None:
                got += batch.total_rows
        finally:
            b.close()
    else:
        with NativeParser(path, nthread=nthread, fmt=fmt) as p:
            for blk in p:
                got += blk.num_rows
            if stats_out is not None:
                stats_out.update(p.pipeline_stats() or {})
    dt = time.time() - t0
    _check_rows(got, rows)
    return rows / dt, dt


def occupancy_row(stats: dict) -> dict:
    """The pipeline-occupancy counters out of a ``pipeline_stats()`` dict."""
    return {k: stats[k] for k in OCCUPANCY_KEYS if k in stats}


def thread_scaling(path: str, rows: int, fmt: str,
                   sampler) -> Tuple[dict, dict]:
    """Host rows/s at 1/2/4/8 parse workers, and the parse pipeline's
    occupancy at each, so a flat row names its binding stage."""
    scaling, occupancy = {}, {}
    for t in SCALING_THREADS:
        stats = {}
        with sampler.section(f"thread_scaling_{t}"):
            scaling[str(t)] = round(parse_rows_per_sec(
                path, rows, t, fmt=fmt, stats_out=stats)[0], 1)
        if stats:
            occupancy[str(t)] = occupancy_row(stats)
    return scaling, occupancy


def text_lane_probe(path: str, rows: int, nthread: int, fmt: str,
                    fmt_args: str = "") -> dict:
    """Host parse rate of a text lane, best of 3 passes."""
    best = None
    for _ in range(3):
        t0 = time.time()
        got = 0
        with NativeParser(path + fmt_args, nthread=nthread, fmt=fmt) as p:
            for blk in p:
                got += blk.num_rows
        dt = time.time() - t0
        _check_rows(got, rows)
        best = dt if best is None else min(best, dt)
    return {"rows_per_sec": round(rows / best, 1),
            "mb_per_sec": round(os.path.getsize(path) / best / 1e6, 1)}


def _bench_pipeline_sources() -> Tuple[str, list]:
    """(bench_pipeline.cc, the core's sources less the C API)."""
    src = os.path.join(REPO_ROOT, "cpp", "src")
    core = sorted(os.path.join(src, f) for f in os.listdir(src)
                  if f.endswith(".cc") and f != "capi.cc")
    return os.path.join(REPO_ROOT, "cpp", "test", "bench_pipeline.cc"), core


def bench_pipeline_command(out: str) -> list:
    """g++'s argv writing ``cpp/test/bench_pipeline.cc`` (the
    engine-level RecordIO round trip) to ``out``, as ``make -C cpp
    benchpipeline`` builds it."""
    main, core = _bench_pipeline_sources()
    return ["g++", "-O3", "-std=c++17", "-pthread", main, *core, "-o", out]


def build_bench_pipeline() -> Optional[str]:
    """Build :data:`BENCH_PIPELINE` when missing or stale (any
    ``cpp/src`` file or the program's source newer); returns the
    compiler's output when it built."""
    main, _ = _bench_pipeline_sources()
    src = os.path.join(REPO_ROOT, "cpp", "src")
    return build_if_stale(
        BENCH_PIPELINE, [main] + [os.path.join(src, f)
                                  for f in os.listdir(src)],
        bench_pipeline_command)


def recordio_roundtrip_probe(records: int = 200000, payload: int = 256,
                             native: bool = True) -> dict:
    """RecordIO write + read round trip, records/s through the Python
    binding and, with ``native``, engine to engine (``bench_pipeline rt``,
    the rate comparable to the reference C++ build's parity row)."""
    blob = (bytes(range(256)) * (payload // 256 + 1))[:payload]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "rt.rec")
        t0 = time.time()
        with NativeRecordIOWriter(path) as w:
            for _ in range(records):
                w.write_record(blob)
        t_write = time.time() - t0
        t0 = time.time()
        got = 0
        with NativeRecordIOReader(path) as r:
            for rec in r:
                if len(rec) != payload:
                    raise RuntimeError(f"record of {len(rec)} bytes, "
                                       f"wrote {payload}")
                got += 1
        t_read = time.time() - t0
    if got != records:
        raise RuntimeError(f"read {got} records, wrote {records}")
    out = {"records_per_sec": round(records / (t_write + t_read), 1),
           "write_records_per_sec": round(records / t_write, 1),
           "read_records_per_sec": round(records / t_read, 1),
           "payload_bytes": payload}
    if native:
        build_bench_pipeline()
        with tempfile.TemporaryDirectory() as d:
            r = subprocess.run(
                [BENCH_PIPELINE, "rt", str(records), str(payload),
                 os.path.join(d, "rt.rec")],
                capture_output=True, text=True, timeout=300, check=True)
        # "recordio_rt   NNN rec/s  (write ..., read ..., ...)"
        out["native_records_per_sec"] = float(r.stdout.split()[1])
    return out


def cache_lane_probe(path: str, rows: int, nthread: int) -> dict:
    """Parse once, serve many (cpp/src/shard_cache.h): epoch 1 parses the
    text and tees binary shards into a fresh cache directory, later
    epochs replay them through the mmap reader (best of 3)."""
    os.makedirs(CACHE_DIR, exist_ok=True)
    cdir = tempfile.mkdtemp(prefix="shardcache_", dir=CACHE_DIR)
    try:
        def one_epoch() -> float:
            t0 = time.time()
            got = 0
            with NativeParser(path, nthread=nthread, cache_dir=cdir) as p:
                for blk in p:
                    got += blk.num_rows
            dt = time.time() - t0
            _check_rows(got, rows)
            return rows / dt
        ep1 = one_epoch()
        ep2 = max(one_epoch() for _ in range(3))
        cache_bytes = sum(os.path.getsize(os.path.join(cdir, f))
                          for f in os.listdir(cdir))
        return {"epoch1_rows_per_sec": round(ep1, 1),
                "epoch2_rows_per_sec": round(ep2, 1),
                "replay_speedup": round(ep2 / ep1, 2),
                "cache_bytes": cache_bytes,
                "text_bytes": os.path.getsize(path)}
    finally:
        shutil.rmtree(cdir, ignore_errors=True)


def host_lane_rates(rows: int, threads: int, dense_dtype: str) -> dict:
    """Host rows/s of each binary lane (deserialize for ``rec``, batch
    assembly for ``crec``/``recd``), best of 2 passes each."""
    return {fmt: round(max(parse_rows_per_sec(
        ensure(rows), rows, threads, fmt=fmt, dense_dtype=dense_dtype)[0]
        for _ in range(2)), 1) for fmt, ensure in BINARY_LANES}


def observability() -> dict:
    """``io_retry`` (this process's remote-I/O counters under the
    reference's legacy keys) and ``parse_stage_mean_ms`` (mean ms of each
    parse stage over the run), from one telemetry snapshot."""
    out = {"io_retry": io_retry_stats()}
    stage_mean_ms = {}
    for h in telemetry.snapshot(native=True)["histograms"]:
        if h["name"].startswith("parse_stage_") and h["count"]:
            stage = h["name"][len("parse_stage_"):-len("_us")]
            stage_mean_ms[stage] = round(h["sum"] / h["count"] / 1e3, 3)
    if stage_mean_ms:
        out["parse_stage_mean_ms"] = stage_mean_ms
    return out
