"""The benchmark's core: look a cell up in ``BENCHMARK.json``, find its
files by name, run its driver, read its per-layer metrics, and print the
result line.

Everything that belongs to one configuration, traffic mix, driver kind or
per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives:

- ``benchmark/configs/<config>.json``: the sizes, the learner's settings,
  the data generator (``benchmark/datagen/<generator>.py``), the model
  kind (``benchmark/models/<kind>.py`` builds the program's side,
  ``benchmark/reference/<kind>.py`` is the plain reference) and the
  limits of the comparison that decides ``correct``;
- ``benchmark/traffic/<traffic>.json``: the mix's parameters and the
  driver kind that reads them (``benchmark/drivers/<driver>.py``);
- ``benchmark/metrics/<metric>.py``: one reader a per-layer metric, whose
  ``read(t)`` takes the traced run's :class:`~benchmark.trace.TraceData`
  and returns the value, or None when the run has nothing to read.

A later change adds a configuration, a mix, a driver kind or a metric by
adding files and entries; no file here names one.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# top-level module names that may not be loaded in the process that
# prints the result (compared whole: the port's name begins with the last)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "dmlc_core_tpu")


class RunError(Exception):
    """A run that cannot give a result; its message goes to stderr and
    the process exits with :attr:`code`."""

    def __init__(self, message: str, code: int = 2):
        super().__init__(message)
        self.code = code


# -- lookup -------------------------------------------------------------------
def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A module from its file (names may hold dots, so not by import)."""
    if not os.path.isfile(path):
        raise RunError(f"no such file: {os.path.relpath(path, ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def by_name(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise RunError(f"BENCHMARK.json has no {what} named {name!r}")


def cell_metrics(spec: dict, cell: str):
    """(end-to-end, per-layer) metric entries that ``cell`` reports."""
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (cell in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return e2e, per_layer


def resolve(workload: str, root: str = ROOT) -> dict:
    """Everything a run of ``workload`` needs, found by name."""
    spec = load_json(os.path.join(root, "BENCHMARK.json"))
    cell = by_name(spec["workloads"], workload, "workload")
    cfg_entry = by_name(spec["configs"], cell["config"], "config")
    config = load_json(os.path.join(root, cfg_entry["file"]))
    bench = os.path.join(root, "benchmark")
    traffic = load_json(os.path.join(bench, "traffic",
                                     cell["traffic"] + ".json"))
    e2e, per_layer = cell_metrics(spec, workload)
    return {"spec": spec, "cell": cell, "config": config,
            "traffic": traffic, "end_to_end": e2e, "per_layer": per_layer,
            "bench_dir": bench, "root": root}


def driver_of(found: dict):
    kind = found["traffic"]["driver"]
    return load_module(os.path.join(found["bench_dir"], "drivers",
                                    kind + ".py"), "bench_driver_" + kind)


def part(found: dict, folder: str, name: str):
    """``benchmark/<folder>/<name>.py`` of this run's checkout."""
    return load_module(os.path.join(found["bench_dir"], folder,
                                    name + ".py"),
                       f"bench_{folder}_{name}".replace(".", "_"))


# -- the run's clock ----------------------------------------------------------
def process_age_s(fallback_t0: float) -> float:
    """Seconds since this process started (``/proc`` start time against
    the boot clock), or since ``fallback_t0`` (``perf_counter``) where
    ``/proc`` cannot say."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start
    except (OSError, ValueError, IndexError, AttributeError):
        return time.perf_counter() - fallback_t0


def cache_dir(found: dict, *parts: str) -> str:
    """A fixed directory under ``benchmark/.cache`` of this checkout."""
    path = os.path.join(found["bench_dir"], ".cache", *parts)
    os.makedirs(path, exist_ok=True)
    return path


def program_env(found: dict) -> None:
    """Keep every build and kernel cache of the program inside the
    checkout, at fixed paths, and keep libraries from loading JAX."""
    os.environ["TORCH_EXTENSIONS_DIR"] = cache_dir(found, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = cache_dir(found, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for k, v in found["config"].get("env", {}).items():
        os.environ[k] = str(v)


def forbidden_loaded() -> List[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN_MODULES})


# -- one run ------------------------------------------------------------------
class Context:
    """What a driver gets: the cell's files, the run's arguments, and the
    clock that set-up is counted on."""

    def __init__(self, found: dict, seed: int, seconds: float, trace: bool,
                 device: str, t_import: float, overrides: Optional[dict]):
        self.found = found
        self.config = dict(found["config"])
        self.config.update((overrides or {}).get("config", {}))
        self.traffic = dict(found["traffic"])
        self.traffic.update((overrides or {}).get("traffic", {}))
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = device
        self._t_import = t_import
        self._marks = [("start", self.age_s())]

    def age_s(self) -> float:
        return process_age_s(self._t_import)

    def mark(self, phase: str) -> float:
        """End a phase of set-up; returns the seconds since the process
        started. ``report_setup`` prints the phases on stderr."""
        self._marks.append((phase, self.age_s()))
        return self._marks[-1][1]

    def report_setup(self) -> None:
        m = self._marks
        print("setup: " + ", ".join(f"{b[0]} {b[1] - a[1]:.3f} s"
                                    for a, b in zip(m, m[1:]))
              + f" (process start to harness {m[0][1]:.3f} s)",
              file=sys.stderr, flush=True)

    def cache(self, *parts: str) -> str:
        return cache_dir(self.found, *parts)

    def part(self, folder: str, name: str):
        return part(self.found, folder, name)

    def reports(self, metric: str) -> bool:
        """Whether this cell reports ``metric`` (end-to-end or per
        layer)."""
        return metric in [m["name"] for m in self.found["end_to_end"]
                          + self.found["per_layer"]]

    def limits(self) -> Dict[str, float]:
        return self.config["limits"][self.traffic["driver"]]


def device_info(device: str, chips: int, peak: int) -> dict:
    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": int(peak)}
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak)}


def read_per_layer(found: dict, t) -> Dict[str, dict]:
    """The cell's per-layer metrics from the traced run's data; a reader
    that finds nothing to read returns None and its metric is left out."""
    out = {}
    for m in found["per_layer"]:
        value = part(found, "metrics", m["name"]).read(t)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_import: Optional[float] = None,
             overrides: Optional[dict] = None, root: str = ROOT) -> dict:
    """One run of ``workload``: the result object (without printing it).
    ``device="cpu"`` and ``overrides`` (``{"config": {...}, "traffic":
    {...}}``: smaller sizes) serve the CPU tests; a measured run takes
    neither."""
    found = resolve(workload, root)
    program_env(found)
    ctx = Context(found, seed, seconds, trace, device,
                  time.perf_counter() if t_import is None else t_import,
                  overrides)
    out = driver_of(found).run(ctx)
    checks = out["checks"]
    correct = bool(out.get("ok", True)) and all(
        c["value"] <= c["limit"] for c in checks.values())
    # a CPU run (the tests') has no card to read a device metric from
    e2e_names = [m["name"] for m in found["end_to_end"]
                 if device != "cpu" or m["source"] != "device_trace"]
    units = {m["name"]: m["unit"] for m in found["end_to_end"]}
    if trace:
        metrics = read_per_layer(found, out["trace"])
    else:
        missing = [n for n in e2e_names if n not in out["metrics"]]
        if missing:
            raise RunError(f"driver gave no {missing}", 5)
        metrics = {n: {"value": float(out["metrics"][n]), "unit": units[n]}
                   for n in e2e_names}
    dev = device_info(device, found["cell"]["chips"],
                      out["memory_peak_bytes"])
    result = {"correct": correct, "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": dev}
    if trace:
        tr = out["trace"]
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    result["checks"] = checks
    return result


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main(argv, t_import: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        found = resolve(args.workload)
        chips = found["cell"]["chips"]
        import torch
        if not torch.cuda.is_available():
            raise RunError("no CUDA device: the benchmark measures the "
                           "card and never falls back to the CPU", 3)
        if torch.cuda.device_count() < chips:
            raise RunError(f"the cell needs {chips} cards, "
                           f"{torch.cuda.device_count()} are visible", 3)
        try:
            import dmlc_core_tpu_torch  # noqa: F401
        except ImportError as e:
            raise RunError(f"the program under test is missing: {e}", 2)
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), "cuda", t_import)
        print(f"bench: {args.workload} seed {args.seed} on "
              f"{card_line()}", file=sys.stderr, flush=True)
        loaded = forbidden_loaded()
        if loaded:
            raise RunError(f"JAX or the JAX package is loaded in the "
                           f"process that prints the result: {loaded}", 4)
    except RunError as e:
        print(f"bench: no result: {e}", file=sys.stderr, flush=True)
        return e.code
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
