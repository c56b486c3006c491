"""The traced run's readings: a ``torch.profiler`` capture of the window,
the card's busy time, the device time issued under the harness's own
``record_function`` ranges, the longest idle gaps named by what the host
was doing, and the program's telemetry histograms.

The timeline arithmetic (busy intervals merged, idle gaps between them,
the clock shift from the profiler's trace to ``perf_counter``) is a
frozen copy of ``chip_smoke.py``'s ``merge_intervals``,
``device_timeline`` and ``trace_clock_shift_us``.
"""

from __future__ import annotations

import bisect
import json
import os
import time
from typing import Dict, List, Optional

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# the host spans an idle gap is named by: the program's device-lane spans
# and the harness's own step
GAP_SPANS = ("bench.step", "device.wait", "device.stage", "device.put")
TOP = 10


def clock_anchor() -> Dict[str, float]:
    return {"wall_us": time.time() * 1e6,
            "perf_us": time.perf_counter() * 1e6}


def merge_intervals(iv: list) -> list:
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def clock_shift_us(trace: dict, anchors: dict) -> float:
    """Microseconds to add to a Chrome-trace ``ts`` to land on the
    ``perf_counter`` clock: the profiler writes wall-clock times on some
    builds (``ts`` + ``baseTimeNanoseconds``) and monotonic ones on
    others; the capture's anchors say which."""
    base = trace.get("baseTimeNanoseconds", 0) / 1e3
    times = [e["ts"] + base for e in trace["traceEvents"]
             if e.get("ph") == "X"]
    if not times:
        return base
    lo, hi = min(times), max(times)
    slack = 60e6
    a, b = anchors["start"], anchors["stop"]
    if a["wall_us"] - slack <= lo and hi <= b["wall_us"] + slack:
        return base - (a["wall_us"] - a["perf_us"])
    if a["perf_us"] - slack <= lo and hi <= b["perf_us"] + slack:
        return base
    raise ValueError(f"profiler trace on an unknown clock (first event "
                     f"{lo}, anchors {anchors})")


class Capture:
    """``torch.profiler`` (CPU activity unless ``cpu=False``, and CUDA
    activity on a card) around the window; :attr:`trace` is the exported
    Chrome trace, read back and its file deleted, and :attr:`anchors` the
    clock pairs at start and stop."""

    def __init__(self, out_dir: str, cuda: bool, cpu: bool = True):
        self.out_dir = out_dir
        self.cuda = cuda
        self.cpu = cpu
        self.trace: Optional[dict] = None
        self.anchors: Dict[str, dict] = {}

    def __enter__(self):
        import torch.profiler as tp
        acts = [tp.ProfilerActivity.CPU] if self.cpu else []
        if self.cuda:
            acts.append(tp.ProfilerActivity.CUDA)
        self._prof = tp.profile(activities=acts)
        self._prof.__enter__()
        self.anchors["start"] = clock_anchor()
        return self

    def __exit__(self, *exc) -> None:
        import torch
        if self.cuda:
            torch.cuda.synchronize()
        self.anchors["stop"] = clock_anchor()
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return
        path = os.path.join(self.out_dir, f"trace_{os.getpid()}.json")
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                self.trace = json.load(f)
        finally:
            if os.path.exists(path):
                os.unlink(path)


def device_time_us(trace: dict, cats=("kernel", "gpu_memset")) -> float:
    """Microseconds of the trace's device ops of ``cats``, summed: by
    default the card's compute, kernels and memsets, copies left out."""
    return sum(e.get("dur", 0) for e in trace["traceEvents"]
               if e.get("ph") == "X" and e.get("cat") in cats)


class TraceData:
    """What the per-layer readers of one traced run read.

    ``window_s``/``busy_s``: the traced window and the seconds in it in
    which a kernel, memcpy or memset ran (merged intervals);
    ``annotated_us[name]``: the device time of every op launched from
    inside a ``record_function(name)`` range, one sum per range;
    ``hist[name]``: (Δsum, Δcount) of a telemetry histogram over the
    window; ``extra``: what the driver adds (steps, rows, byte counts)."""

    def __init__(self, window_s: float, busy_s: float, top_ops: list,
                 idle_gaps: list, annotated_us: Dict[str, List[float]],
                 hist: Dict[str, tuple], extra: dict):
        self.window_s = window_s
        self.busy_s = busy_s
        self.top_ops = top_ops
        self.idle_gaps = idle_gaps
        self.annotated_us = annotated_us
        self.hist = hist
        self.extra = extra

    def hist_mean(self, name: str) -> Optional[float]:
        s, n = self.hist.get(name, (0.0, 0))
        return s / n if n > 0 else None

    def breakdown(self) -> dict:
        return {"device_ops": self.top_ops[:TOP],
                "idle_gaps": self.idle_gaps[:TOP]}


def analyze(trace: dict, anchors: dict, t0_us: float, t1_us: float,
            spans: List[dict], annotations=(), gap_spans=GAP_SPANS) -> dict:
    """The card's side of the window [t0_us, t1_us] (``perf_counter``
    microseconds) from a Chrome trace: busy seconds, the top device ops
    by time, the longest idle gaps each named by the host span of
    ``gap_spans`` that covers most of it ("none" where none does), and
    the device time launched under each of ``annotations``."""
    shift = clock_shift_us(trace, anchors)
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    ops: Dict[str, float] = {}
    busy = []
    by_corr: Dict[int, float] = {}
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a = e["ts"] + shift
        b = a + e.get("dur", 0)
        corr = e.get("args", {}).get("correlation")
        if corr is not None:
            by_corr[corr] = by_corr.get(corr, 0.0) + (b - a)
        lo, hi = max(a, t0_us), min(b, t1_us)
        if hi > lo:
            busy.append((lo, hi))
            ops[e["name"]] = ops.get(e["name"], 0.0) + (hi - lo)
    merged = merge_intervals(busy)
    busy_us = sum(b - a for a, b in merged)
    edges = [t0_us] + [x for iv in merged for x in iv] + [t1_us]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2)), reverse=True)[:TOP]
    named = []
    for dur, a in gaps:
        cover: Dict[str, float] = {}
        for sp in spans:
            if sp["name"] not in gap_spans:
                continue
            ov = min(a + dur, sp["ts"] + sp["dur"]) - max(a, sp["ts"])
            if ov > 0:
                cover[sp["name"]] = cover.get(sp["name"], 0.0) + ov
        name = max(cover, key=cover.get) if cover else "none"
        named.append([name, dur / 1e6])
    # device time under each annotation: the launches (by correlation id)
    # inside one of its ranges from the annotated thread and from every
    # thread that launches kernels (autograd runs a backward on a thread
    # of its own); the iterator's copy thread launches no kernel
    launches: Dict[object, list] = {}
    kernel_tids = set()
    for e in events:
        if e.get("cat") in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches.setdefault(e.get("tid"), []).append(
                    (e["ts"], corr))
                if "LaunchKernel" in e["name"]:
                    kernel_tids.add(e.get("tid"))
    compute = sorted(x for t in kernel_tids for x in launches[t])
    annotated: Dict[str, List[float]] = {}
    for e in events:
        if e.get("cat") != "user_annotation" or e["name"] not in annotations:
            continue
        a0 = e["ts"] + shift
        if a0 < t0_us or a0 > t1_us:
            continue
        ls = compute if e.get("tid") in kernel_tids else sorted(
            compute + launches.get(e.get("tid"), []))
        i = bisect.bisect_left(ls, (e["ts"], -1))
        total = 0.0
        while i < len(ls) and ls[i][0] <= e["ts"] + e.get("dur", 0):
            total += by_corr.get(ls[i][1], 0.0)
            i += 1
        annotated.setdefault(e["name"], []).append(total)
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]
    return {"window_s": (t1_us - t0_us) / 1e6, "busy_s": busy_us / 1e6,
            "top_ops": [[k[:160], v / 1e6] for k, v in top],
            "idle_gaps": named, "annotated_us": annotated}


def hist_totals() -> Dict[str, tuple]:
    """(sum, count) of every unlabeled telemetry histogram of the
    program, its native core's included."""
    from dmlc_core_tpu_torch import telemetry
    out: Dict[str, tuple] = {}
    for h in telemetry.snapshot().get("histograms", ()):
        if not h.get("labels"):
            s, n = out.get(h["name"], (0.0, 0))
            out[h["name"]] = (s + float(h["sum"]), n + int(h["count"]))
    return out


def hist_delta(before: Dict[str, tuple], after: Dict[str, tuple]
               ) -> Dict[str, tuple]:
    return {k: (v[0] - before.get(k, (0.0, 0))[0],
                v[1] - before.get(k, (0.0, 0))[1])
            for k, v in after.items()}


class SpanLog:
    """The program's telemetry spans over a window, gathered as it runs
    (its ring keeps the newest 8,192), plus the harness's own."""

    def __init__(self):
        self._seen: Dict[int, dict] = {}
        self.own: List[dict] = []

    def gather(self) -> None:
        from dmlc_core_tpu_torch import telemetry
        for sp in telemetry.spans():
            self._seen[sp["id"]] = sp

    def add(self, name: str, t0_s: float, t1_s: float) -> None:
        self.own.append({"name": name, "ts": t0_s * 1e6,
                         "dur": (t1_s - t0_s) * 1e6})

    def all(self) -> List[dict]:
        return list(self._seen.values()) + self.own
