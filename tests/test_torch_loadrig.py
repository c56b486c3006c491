"""The port's load rig (``python -m dmlc_core_tpu_torch.bench.loadrig``)
against the reference's ``scripts/loadrig.py``.

- ``origin``: both rigs serve the same file from one pre-forked worker
  (so the every-Nth fault counts do not depend on which worker takes a
  request) under the same fault knobs; each package's ``NativeStream``
  reads the bytes back through the retries, sequentially and with the
  backoff's jitter pinned, and the two packages' ``io_retry_stats()`` are
  equal.
- ``loadgen``: both rigs drive the port's scoring server with generated
  payloads, open and closed loop, and print the same JSON keys without
  errors.
"""

import hashlib
import json
import os
import select
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from dmlc_core_tpu.io import native as ref_native
from tests.torch_reference_native import reference_native  # noqa: F401

from dmlc_core_tpu_torch.io import native
from dmlc_core_tpu_torch.serving.model import save_model
from dmlc_core_tpu_torch.serving.server import ScoringServer, ServingConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_RIG = [sys.executable, "-m", "dmlc_core_tpu_torch.bench.loadrig"]
REF_RIG = [sys.executable, os.path.join(REPO, "scripts", "loadrig.py")]
FAULTS = ["--reset-every", "3", "--get-500-every", "5",
          "--get-truncate-every", "7"]
READS = 8


def ready_line(proc, timeout_s=60.0) -> str:
    """The origin's ``RIG_READY`` line (select-gated, so a wedged child
    fails the test instead of hanging it)."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        ready, _, _ = select.select([proc.stdout], [], [], 0.5)
        if ready:
            line = proc.stdout.readline()
            if line.startswith("RIG_READY"):
                return line
        assert proc.poll() is None, proc.stderr.read()[-3000:]
    raise AssertionError("origin did not print RIG_READY")


def origin_port(rig, line: str) -> int:
    if rig is PORT_RIG:  # RIG_READY {json}
        return json.loads(line.split(" ", 1)[1])["port"]
    return int(dict(kv.split("=", 1) for kv in line.split()[1:])["port"])


def test_origin_fault_knobs_match_the_reference(tmp_path, monkeypatch):
    # one sequential GET a read and a pinned backoff jitter: each fault
    # then lands on the same request in both runs
    monkeypatch.setenv("DMLC_IO_RANGE", "0")
    monkeypatch.setenv("DMLC_IO_JITTER_SEED", "7")
    monkeypatch.setenv("DMLC_IO_BACKOFF_BASE_MS", "5")
    blob = np.random.default_rng(11).integers(
        0, 256, 600_000, dtype=np.uint8).tobytes()
    (tmp_path / "blob.bin").write_bytes(blob)
    stats = {}
    for name, rig, pkg in (("port", PORT_RIG, native),
                           ("ref", REF_RIG, ref_native)):
        proc = subprocess.Popen(
            rig + ["origin", "--backend", "http", "--corpus",
                   f"/rig/blob.bin=@{tmp_path / 'blob.bin'}", "--workers",
                   "1", "--ttl", "120"] + FAULTS,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=REPO)
        try:
            port = origin_port(rig, ready_line(proc))
            pkg.reset_io_retry_stats()
            for _ in range(READS):  # enough requests for every fault
                with pkg.NativeStream(
                        f"http://127.0.0.1:{port}/rig/blob.bin", "r") as s:
                    got = s.read_all()
                assert hashlib.sha256(got).digest() == \
                    hashlib.sha256(blob).digest()
            stats[name] = pkg.io_retry_stats()
        finally:
            proc.terminate()
            proc.wait(timeout=30)
    assert stats["port"] == stats["ref"]
    assert stats["port"]["retries"] >= 3, stats


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    """The port's scoring server on the CPU with a 16-feature linear
    model."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(3)
    uri = str(tmp_path_factory.mktemp("model") / "m.ckpt")
    save_model(uri, "linear", {
        "w": rng.normal(size=16).astype(np.float32),
        "b": np.array(0.1, np.float32)}, 16)
    srv = ScoringServer(model_uri=uri, config=ServingConfig(),
                        device="cpu")
    srv.start()
    yield f"http://127.0.0.1:{srv.port}/score"
    srv.stop(drain=False, grace_s=3.0)


def key_tree(obj):
    """The nested key structure of a JSON object."""
    if isinstance(obj, dict):
        return {k: key_tree(v) for k, v in obj.items()}
    return None


@pytest.mark.parametrize("mode", [["--closed-loop"], ["--qps", "40"]],
                         ids=["closed", "open"])
def test_loadgen_prints_the_references_keys(server, mode):
    out = {}
    for name, rig in (("port", PORT_RIG), ("ref", REF_RIG)):
        proc = subprocess.run(
            rig + ["loadgen", "--url", server, "--duration-s", "1",
                   "--workers", "2", "--score-corpus",
                   "libsvm:rows=2,features=16,nnz=4,seed=1"] + mode,
            capture_output=True, text=True, timeout=120, cwd=REPO)
        assert proc.returncode == 0, proc.stderr[-3000:]
        out[name] = json.loads(proc.stdout.strip().splitlines()[-1])
    assert key_tree(out["port"]) == key_tree(out["ref"])
    for res in out.values():
        assert res["errors"] == 0 and res["completed"] > 0, res
