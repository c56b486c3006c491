"""Fixtures of the benchmark's CPU tests.

``serving_root``: a checkout whose ``BENCHMARK.json`` holds the
``criteo_fm.serve`` cell. Its driver, traffic file and metric readers are
in ``benchmark/``; the cell waits in PERF.md's open questions (its
latencies spread beyond any bound the contract allows), so the tests add
its entries the way a later change would.

``dlrm_small_root``: a checkout whose ``dlrm_dcnv2`` holds small tables
(each at most 97 rows; the generator reads them from the configuration)
and small widths, with the published 26 tables and multi-hot sizes: the
adapter refuses the configuration's 13.6 GB of tables on the CPU."""

from __future__ import annotations

import json
import os
import shutil

import pytest

from benchmark import harness

SERVING_CELL = {
    "workloads": [
        {"name": "criteo_fm.serve", "config": "criteo_fm",
         "traffic": "serve_open", "chips": 1,
         "why": "POST /score of 2-8 Criteo rows, open loop"}],
    "end_to_end": [
        {"name": "serve_p50_ms", "unit": "ms", "better": "lower",
         "bound": 0.25, "source": "host_clock",
         "workloads": ["criteo_fm.serve"]}],
    "per_layer": [
        {"name": n, "unit": u, "better": b, "source": "program_span",
         "layer": layer, "moves": "serve_p50_ms",
         "workloads": ["criteo_fm.serve"]}
        for n, u, b, layer in (
            ("serve_parse_ms", "ms", "lower", "frontend and parse"),
            ("serve_batch_rows", "rows", "higher", "micro-batcher"),
            ("serve_forward_ms", "ms", "lower", "model"))],
}


@pytest.fixture(scope="session")
def serving_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("serving_checkout")
    shutil.copytree(os.path.join(harness.ROOT, "benchmark"),
                    root / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    spec = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    for key, entries in SERVING_CELL.items():
        spec[key] = spec[key] + entries
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return str(root)


@pytest.fixture(scope="session")
def dlrm_small_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("dlrm_checkout")
    shutil.copytree(os.path.join(harness.ROOT, "benchmark"),
                    root / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), root)
    path = os.path.join(harness.ROOT, "benchmark", "configs",
                        "dlrm_dcnv2.json")
    cfg = harness.load_json(path)
    small = [min(n, 97)
             for n in cfg["published"]["num_embeddings_per_feature"]]
    cfg["model"].update({"num_embeddings_per_feature": small,
                         "embedding_dim": 16,
                         "dense_arch_layer_sizes": [24, 16],
                         "dcn_low_rank_dim": 8,
                         "over_arch_layer_sizes": [32, 16, 1]})
    (root / "benchmark/configs/dlrm_dcnv2.json").write_text(json.dumps(cfg))
    return str(root)


@pytest.fixture
def program_on_path(monkeypatch):
    """The server runs from the serving checkout, which holds no program:
    it imports the port from this repository."""
    monkeypatch.setenv("PYTHONPATH", harness.ROOT + os.pathsep +
                       os.environ.get("PYTHONPATH", ""))
