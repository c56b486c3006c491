"""Provenance of a bench run and its regression record.

The port's copies of ``bench.py``'s ``git_provenance``,
``host_fingerprint``, ``dmlc_env_overrides`` and ``_load_baseline``
(:184-241), of ``scripts/benchdiff.py``'s ``lanes_from_extras``,
``make_record`` and ``append_record`` (:72-120, the record schema that
``benchdiff.py --history`` reads unchanged), and :func:`card_line`, the
card's ``name, power.limit`` as ``nvidia-smi`` reports them. Records go to
``bench_history_torch.jsonl`` at the checkout's root (never to the
reference's ``bench_history.jsonl``); ``DMLC_BENCH_HISTORY`` names
another file, ``0`` or ``off`` none.
"""

from __future__ import annotations

import json
import os
import platform
import socket
import subprocess
import sys
import time
from typing import Optional

from dmlc_core_tpu_torch.base import REPO_ROOT

DEFAULT_HISTORY = os.path.join(REPO_ROOT, "bench_history_torch.jsonl")
SCHEMA = 1  # benchdiff.py's record schema

# extras entries that are lanes worth carrying into the record
# (benchdiff.py's LANE_KEYS)
LANE_KEYS = ("cache_lane", "remote_lane", "csv_lane", "libfm_lane",
             "recordio_roundtrip", "rec_lane", "crec_lane", "recd_lane",
             "host_lane_rates", "thread_scaling", "serving_lane",
             "device_lane", "mesh_lane")


def card_line() -> str:
    """``name, power.limit`` of GPU 0 as nvidia-smi reports them."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    lines = proc.stdout.strip().splitlines()
    return lines[0].strip() if proc.returncode == 0 and lines else \
        f"nvidia-smi failed (exit {proc.returncode})"


def git_provenance() -> dict:
    """``{"git_sha", "git_dirty"}`` of the checkout this run measures
    (None/None outside a git checkout: provenance is evidence, never a
    blocker)."""
    try:
        sha = subprocess.run(["git", "rev-parse", "HEAD"], cwd=REPO_ROOT,
                             capture_output=True, text=True,
                             timeout=30).stdout.strip() or None
        st = subprocess.run(["git", "status", "--porcelain"],
                            cwd=REPO_ROOT, capture_output=True, text=True,
                            timeout=30)
        dirty = bool(st.stdout.strip()) if st.returncode == 0 else None
        return {"git_sha": sha, "git_dirty": dirty}
    except (OSError, subprocess.TimeoutExpired):
        return {"git_sha": None, "git_dirty": None}


def host_fingerprint() -> dict:
    """Host name, core count, schedulable affinity, memory, platform and
    python: whether two runs are comparable at all."""
    try:
        affinity = len(os.sched_getaffinity(0))
    except AttributeError:
        affinity = os.cpu_count()
    mem_gb = None
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    mem_gb = round(int(line.split()[1]) / 1e6, 1)
                    break
    except OSError:
        pass
    return {"host": socket.gethostname(), "cpus": os.cpu_count(),
            "affinity": affinity, "mem_gb": mem_gb,
            "platform": platform.platform(),
            "python": platform.python_version()}


def dmlc_env_overrides() -> dict:
    """Every ``DMLC_*``/``DCT_*`` variable set for this run: the knobs
    that change what the numbers mean."""
    return {k: v for k, v in sorted(os.environ.items())
            if k.startswith(("DMLC_", "DCT_"))}


def load_baseline() -> Optional[dict]:
    """``bench_baseline.json`` (the reference C++ build's single-thread
    rates on the machine its ``machine`` names, not necessarily this one)
    as a dict, or None when absent."""
    path = os.path.join(REPO_ROOT, "bench_baseline.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def lanes_from_extras(extras: dict) -> dict:
    """The comparable slice of a run's ``extras``: numbers only, error
    strings and nested diagnostics dropped."""
    lanes = {}
    for key in LANE_KEYS:
        v = extras.get(key)
        if not isinstance(v, dict):
            continue
        flat = {k: x for k, x in v.items()
                if isinstance(x, (int, float)) and not isinstance(x, bool)}
        if flat:
            lanes[key] = flat
    return lanes


def make_record(result: dict, *, git_sha=None, git_dirty=None, host=None,
                env_overrides=None, host_resources=None, smoke=False,
                argv=None, round_no=None, ts=None, source=None) -> dict:
    """One normalized record from a result line (``{"metric", "value",
    "unit", "vs_baseline", "extras"}``)."""
    extras = result.get("extras") or {}
    return {
        "schema": SCHEMA,
        "ts": ts if ts is not None else time.time(),
        "round": round_no,
        "git_sha": git_sha,
        "git_dirty": git_dirty,
        "host": host,
        "smoke": bool(smoke),
        "argv": argv,
        "env_overrides": env_overrides,
        "source": source,
        "metric": result.get("metric"),
        "value": result.get("value"),
        "unit": result.get("unit"),
        "vs_baseline": result.get("vs_baseline"),
        "stall_verdict": extras.get("bottleneck"),
        "device_unavailable": bool(extras.get("device_unavailable")),
        "lanes": lanes_from_extras(extras),
        "host_resources": host_resources,
    }


def append_record(record: dict, history: str) -> None:
    """Append one record (one JSON object a line)."""
    with open(history, "a") as f:
        f.write(json.dumps(record, sort_keys=True) + "\n")


def history_path() -> Optional[str]:
    """Where this run's record goes: ``DMLC_BENCH_HISTORY``, else
    :data:`DEFAULT_HISTORY`; None for ``0``/``off``."""
    path = os.environ.get("DMLC_BENCH_HISTORY") or DEFAULT_HISTORY
    return None if path in ("0", "off") else path


def append_ledger(result: dict, provenance: dict, host: dict,
                  env_overrides: dict, host_resources, smoke: bool,
                  history: str) -> None:
    """Append this run's record to ``history``. A failure is reported on
    stderr and does not fail the run: the result line is already out."""
    try:
        append_record(make_record(
            result, git_sha=provenance.get("git_sha"),
            git_dirty=provenance.get("git_dirty"), host=host,
            env_overrides=env_overrides, host_resources=host_resources,
            smoke=smoke, argv=sys.argv[1:]), history)
    except OSError as e:
        print(f"# ledger append failed: {e}", file=sys.stderr)
