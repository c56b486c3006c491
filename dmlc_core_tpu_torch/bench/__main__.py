"""``python -m dmlc_core_tpu_torch.bench``: the port's counterpart of
``bench.py`` (``bench.py:1353-2079``), with its flags and its one JSON
line ``{"metric": "higgs_<fmt>_ingest_rows_per_sec", "value", "unit",
"vs_baseline", "extras"}``.

    python -m dmlc_core_tpu_torch.bench [--rows N] [--smoke]
        [--device cuda|cpu] [--parse-only] [--no-device] [--format FMT]
        [--batch-rows N] [--threads N] [--reps N] [--dense-dtype bf16|f32]
        [--no-scaling-table] [--no-rec-lane] [--no-ledger]

Lanes, in order: the thread-scaling table; the headline (the lane's file
through ``DeviceRowBlockIter`` to a reduction on the device, or the host
parse alone with ``--parse-only``/``--no-device``); the secondary binary
lanes; the kernel probe, the device lane and the mesh lane, each in a
child process of this module (``--kernel-probe`` (alias
``--pallas-probe``), ``--device-lane``, ``--mesh-lane``); the serving
lane; the binary host rates, the cache, remote, csv, libfm and RecordIO
lanes. A failed lane fails the run. The result line goes to stdout, the
commentary to stderr, and the record to ``bench_history_torch.jsonl``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

from dmlc_core_tpu_torch import telemetry
from dmlc_core_tpu_torch.base import REPO_ROOT
from dmlc_core_tpu_torch.bench import host_lanes, ingest, record
from dmlc_core_tpu_torch.bench.datasets import (BINARY_LANES,
                                                ensure_csv_dataset,
                                                ensure_dataset,
                                                ensure_libfm_dataset)
from dmlc_core_tpu_torch.io.native import NativeParser


def parse_args(argv):
    ap = argparse.ArgumentParser(
        prog="python -m dmlc_core_tpu_torch.bench",
        description="HIGGS-shaped ingest to the device, its lanes and the "
                    "hand-written kernel; prints one JSON line")
    ap.add_argument("--smoke", action="store_true", help="tiny quick run")
    ap.add_argument("--rows", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the device lanes run (default cuda: "
                         "without CUDA the run fails)")
    ap.add_argument("--parse-only", action="store_true",
                    help="skip device placement (host parse throughput)")
    ap.add_argument("--batch-rows", type=int, default=65536)
    ap.add_argument("--threads", type=int, default=0,
                    help="parse workers (default 0 = one per core)")
    ap.add_argument("--reps", type=int, default=5,
                    help="timed e2e repetitions; the median is reported")
    ap.add_argument("--format", choices=("libsvm", "rec", "crec", "recd"),
                    default="libsvm",
                    help="headline lane: text parse, binary CSR row "
                         "blocks, CSR device planes, or zero-parse dense "
                         "row matrices")
    ap.add_argument("--dense-dtype", choices=("bf16", "f32"), default="bf16",
                    help="dense device dtype (bf16 halves host and "
                         "transfer bytes)")
    ap.add_argument("--no-scaling-table", action="store_true")
    ap.add_argument("--no-rec-lane", action="store_true",
                    help="skip the secondary binary-ingest lanes")
    ap.add_argument("--no-device", action="store_true",
                    help="host-only metrics: no device lane at all")
    ap.add_argument("--no-ledger", action="store_true",
                    help="do not append this run to the history "
                         "(DMLC_BENCH_HISTORY names the file, =0 none)")
    ap.add_argument("--kernel-probe", "--pallas-probe", action="store_true",
                    help=argparse.SUPPRESS)  # child modes
    ap.add_argument("--device-lane", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--mesh-lane", action="store_true",
                    help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def run_child(mode: str, args, timeout: int) -> dict:
    """Run a lane in a child process of this module (a fresh CUDA context
    and telemetry plane; a hang costs the lane's timeout); its last stdout
    line is the lane's JSON. A failed child fails the run."""
    cmd = [sys.executable, "-m", "dmlc_core_tpu_torch.bench", mode,
           "--device", args.device, f"--rows={args.rows}"]
    if args.smoke:
        cmd.append("--smoke")
    out = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=timeout, cwd=REPO_ROOT)
    if out.returncode != 0:
        raise RuntimeError(f"{mode} failed (exit {out.returncode}): "
                           f"{(out.stderr or '')[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    args.rows = args.rows or (20000 if args.smoke else 200000)
    device = torch.device(args.device)
    host_only = args.parse_only or args.no_device
    if not host_only and device.type == "cuda" and \
            not torch.cuda.is_available():
        log("bench: torch.cuda.is_available() is False; pass --device cpu "
            "to run on the CPU, or --parse-only / --no-device for host "
            "numbers alone")
        return 2
    if device.type == "cpu":
        # torch's own threads beside the native parse workers thrash
        torch.set_num_threads(1)
    if args.kernel_probe:
        from dmlc_core_tpu_torch.bench.kernel_probe import kernel_probe
        print(json.dumps(kernel_probe(device)))
        return 0
    if args.device_lane:
        from dmlc_core_tpu_torch.bench.device_lane import device_lane_probe
        print(json.dumps(device_lane_probe(args.rows, device)))
        return 0
    if args.mesh_lane:
        from dmlc_core_tpu_torch.bench.mesh_lane import mesh_lane_probe
        print(json.dumps(mesh_lane_probe(args.device, smoke=args.smoke)))
        return 0
    dense_dtype = "bfloat16" if args.dense_dtype == "bf16" else "float32"

    # provenance first: a number without it is not reproducible
    provenance = record.git_provenance()
    host = record.host_fingerprint()
    env_over = record.dmlc_env_overrides()
    sha12 = (provenance["git_sha"] or "unknown")[:12]
    log(f"# provenance: sha={sha12}"
        f"{'+dirty' if provenance['git_dirty'] else ''} "
        f"host={host['host']} cpus={host['cpus']} "
        f"(affinity {host['affinity']}) mem={host['mem_gb']}G "
        f"python={host['python']}")
    if env_over:
        log("# env overrides: " + " ".join(f"{k}={v}"
                                           for k, v in env_over.items()))
    sampler = telemetry.HostResourceSampler().start()

    rows = args.rows
    path = ensure_dataset(rows)
    lane_fmt = args.format
    lane_path = (path if lane_fmt == "libsvm"
                 else dict(BINARY_LANES)[lane_fmt](rows))
    size_mb = os.path.getsize(lane_path) / 1e6
    with NativeParser(path) as p:  # build and load the native core
        p.next_block()

    extras = {}
    if not args.no_scaling_table and lane_fmt not in ("recd", "crec"):
        # recd/crec have no parse stage to scale
        scaling, occupancy = host_lanes.thread_scaling(
            lane_path, rows, lane_fmt, sampler)
        extras["thread_scaling"] = scaling
        if occupancy:
            extras["parse_pipeline_occupancy"] = occupancy
    # zeroed once, after the scaling table: the stall attribution reads
    # the headline's spans alone
    telemetry.reset()
    if args.no_device:
        extras["device_skipped"] = True

    if host_only:
        stats = {}
        with sampler.section("headline"):
            rps, dt = host_lanes.parse_rows_per_sec(
                lane_path, rows, args.threads, fmt=lane_fmt,
                dense_dtype=dense_dtype, stats_out=stats)
        if stats:
            extras.setdefault("parse_pipeline_occupancy", {})[
                "headline"] = host_lanes.occupancy_row(stats)
            extras["parse_simd_lane"] = stats.get("simd_lane", "scalar")
        att = telemetry.stall_attribution()
        extras["stall_attribution"] = ingest.stall_extras(att)
        extras["bottleneck"] = ingest.bottleneck(att["verdict"],
                                                 os.cpu_count())
    else:
        extras["device"] = (record.card_line() if device.type == "cuda"
                            else "cpu")
        log(f"# device: {extras['device']}")
        with sampler.section("headline"):
            lane = ingest.run_lane(lane_path, rows, lane_fmt, device,
                                   args.batch_rows, args.threads,
                                   dense_dtype, args.reps)
        dt, rps = lane["dt"], lane["rows_per_sec"]
        extras.update({k: lane[k] for k in (
            "hbm_ingest_bw_util", "hbm_ingest_bw_util_best",
            "device_bytes_per_sec", "attainable_pytree_bytes_per_sec",
            "attainable_contiguous_bytes_per_sec")})
        extras.update({"e2e_spread_rows_per_sec":
                       lane["spread_rows_per_sec"], "reps": lane["reps"],
                       "ncores": os.cpu_count()})
        att = telemetry.stall_attribution()
        extras["stall_attribution"] = ingest.stall_extras(att)
        if lane["hbm_ingest_bw_util"] < 0.9:
            extras["bottleneck"] = ingest.bottleneck(att["verdict"],
                                                     os.cpu_count())
            log(f"# bw-util {lane['hbm_ingest_bw_util']:.1%}: landed "
                f"{lane['device_bytes_per_sec'] / 1e6:.0f} MB/s vs "
                f"pytree-attainable "
                f"{lane['attainable_pytree_bytes_per_sec'] / 1e6:.0f} MB/s "
                f"(contiguous "
                f"{lane['attainable_contiguous_bytes_per_sec'] / 1e6:.0f} "
                f"MB/s) -> {extras['bottleneck']}")
        if lane_fmt == "libsvm" and not args.no_rec_lane:
            for fmt2, ensure in BINARY_LANES:
                with sampler.section(f"{fmt2}_lane"):
                    sec = ingest.run_lane(ensure(rows), rows, fmt2, device,
                                          args.batch_rows, args.threads,
                                          dense_dtype, args.reps)
                extras[f"{fmt2}_lane"] = ingest.lane_summary(sec)
                log(f"# {fmt2} lane: {sec['rows_per_sec']:.0f} rows/s, "
                    f"bw-util {sec['hbm_ingest_bw_util']:.1%}")
        from dmlc_core_tpu_torch.bench.kernel_probe import kernel_probe
        with sampler.section("kernel_probe"):
            # off the card the probe has nothing to time: it says so
            extras["csr_to_dense_kernel"] = (
                run_child("--kernel-probe", args, 600)
                if device.type == "cuda" else kernel_probe(device))
        log(f"# csr->dense kernel: {extras['csr_to_dense_kernel']}")

    if lane_fmt == "libsvm" and not host_only:
        with sampler.section("device_lane"):
            dl = extras["device_lane"] = run_child(
                "--device-lane", args, 300 if args.smoke else 900)
        log(f"# device lane ({dl['backend']}): "
            f"{dl['hbm_ingest_rows_per_sec']:.0f} rows/s, transfer p50 "
            f"{dl['device_transfer_p50_us']:.0f}us p99 "
            f"{dl['device_transfer_p99_us']:.0f}us, overlap "
            f"{dl['overlap_ratio']:.0%} -> {dl['stall_verdict']}")
        with sampler.section("mesh_lane"):
            ml = extras["mesh_lane"] = run_child(
                "--mesh-lane", args, 300 if args.smoke else 600)
        log(f"# mesh lane: {ml['steps_per_sec']:.1f} collective steps/s "
            f"({ml['nworkers']} procs, {ml['steps']} steps), SIGKILL "
            f"recovery to the first resumed step {ml['recovery_s']:.2f}s")
        from dmlc_core_tpu_torch.bench.serving_lane import run_serving_lane
        with sampler.section("serving_lane"):
            sl = extras["serving_lane"] = run_serving_lane(
                args.device, smoke=args.smoke, sampler=sampler)
        log(f"# serving lane: {sl['sustained_qps']:.0f} sustained qps; "
            f"open-loop @{sl['open_loop_qps']:.0f} qps p50/p99/p999 "
            f"{sl['open_loop_p50_ms']:.1f}/{sl['open_loop_p99_ms']:.1f}/"
            f"{sl['open_loop_p999_ms']:.1f} ms, {sl['errors']} errors, "
            f"{sl['steady_new_shapes']} steady-state new shapes")

    baseline = record.load_baseline()
    if lane_fmt == "libsvm":
        # host lanes: no device stage, so they run on every kind of run
        if not args.no_rec_lane:
            extras["host_lane_rates"] = host_lanes.host_lane_rates(
                rows, args.threads, dense_dtype)
            log(f"# host lane rates: {extras['host_lane_rates']}")
        with sampler.section("cache_lane"):
            cl = extras["cache_lane"] = host_lanes.cache_lane_probe(
                path, rows, args.threads)
        recd = extras.get("host_lane_rates", {}).get("recd")
        if recd:
            cl["vs_recd_host"] = round(cl["epoch2_rows_per_sec"] / recd, 3)
        log(f"# cache lane: {cl}")
        from dmlc_core_tpu_torch.bench.remote_lane import remote_lane_probe
        with sampler.section("remote_lane"):
            rl = extras["remote_lane"] = remote_lane_probe(
                path, args.threads, latency_ms=20,
                cap_bytes=(2 << 20) if args.smoke else (8 << 20),
                concurrency=8 if args.smoke else 12, sampler=sampler)
        log(f"# remote lane: local {rl['local_rows_per_sec']:.0f} rows/s, "
            f"sequential {rl['sequential_rows_per_sec']:.0f}, ranged "
            f"{rl['ranged_rows_per_sec']:.0f} -> "
            f"{rl['origin']['cpu_attribution']}")
        with sampler.section("csv_lane"):
            extras["csv_lane"] = host_lanes.text_lane_probe(
                ensure_csv_dataset(rows), rows, args.threads, "csv",
                "?format=csv&label_column=0")
        with sampler.section("libfm_lane"):
            extras["libfm_lane"] = host_lanes.text_lane_probe(
                ensure_libfm_dataset(rows), rows, args.threads, "libfm")
        with sampler.section("recordio_roundtrip"):
            extras["recordio_roundtrip"] = \
                host_lanes.recordio_roundtrip_probe(
                    records=20000 if args.smoke else 200000,
                    native=not args.smoke)
        # parity ratios against the reference C++ build on the machine
        # bench_baseline.json names (not necessarily this one)
        pr = (baseline or {}).get("parity_rows") or {}
        if pr.get("reference_csv_mb_per_sec"):
            extras["csv_lane"]["vs_reference"] = round(
                extras["csv_lane"]["mb_per_sec"]
                / pr["reference_csv_mb_per_sec"], 3)
        if pr.get("reference_libfm_rows_per_sec"):
            extras["libfm_lane"]["vs_reference"] = round(
                extras["libfm_lane"]["rows_per_sec"]
                / pr["reference_libfm_rows_per_sec"], 3)
        ours_rt = extras["recordio_roundtrip"].get("native_records_per_sec")
        if pr.get("reference_recordio_rt_records_per_sec") and ours_rt:
            extras["recordio_roundtrip"]["vs_reference_native"] = round(
                ours_rt / pr["reference_recordio_rt_records_per_sec"], 3)
        log(f"# csv {extras['csv_lane']['mb_per_sec']} MB/s, libfm "
            f"{extras['libfm_lane']['rows_per_sec']:.0f} rows/s, recordio "
            f"rt {extras['recordio_roundtrip']['records_per_sec']:.0f} "
            f"rec/s")

    # the baseline is the reference C++ build's single-thread text
    # parse-to-host rate on the machine bench_baseline.json names, not
    # necessarily this one: only the text lane has a ratio against it
    vs = None
    if baseline is not None and lane_fmt == "libsvm":
        vs = round(rps / baseline["reference_rows_per_sec"], 3)
    extras.update(host_lanes.observability())
    extras["host_resources"] = {"overall": sampler.stop(),
                                "lanes": sampler.sections}
    extras["provenance"] = {**provenance, "host": host,
                            "env_overrides": env_over}
    log(f"# {rows} rows ({size_mb:.1f} MB {lane_fmt}) in {dt:.3f}s = "
        f"{size_mb / dt:.1f} MB/s (median of {extras.get('reps', 1)})")
    result = {"metric": f"higgs_{lane_fmt}_ingest_rows_per_sec",
              "value": round(rps, 1), "unit": "rows/s",
              "vs_baseline": vs, "extras": extras}
    print(json.dumps(result), flush=True)
    history = record.history_path()
    if not args.no_ledger and history is not None:
        record.append_ledger(result, provenance, host, env_over,
                             extras["host_resources"], args.smoke, history)
        log(f"# ledger: appended to {history}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
