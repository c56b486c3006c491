"""The comparison that decides ``correct`` fails what it must: the
control (the plain reference in the program's place, in bfloat16) and
each fault a cell can have, planted in the timed path underneath a run
of the harness (on the CPU, at a size a test run holds: the harness's
look for a card is skipped).

The same readings at the cells' own sizes are taken on the card with
``benchmark/calibrate.py`` (``PERF.md`` gives them and the limits set
from them); ``test_control_fails_at_cell_size`` repeats the control
there."""

from __future__ import annotations

import contextlib

import pytest

from benchmark import calibrate, harness

SEED = 2 ** 31 + 777
SMALL = {"rows": 4096, "batch_rows": 1024}
TRAIN_CELLS = ["higgs_lr.text", "criteo_fm.crec"]


@pytest.fixture(autouse=True)
def _one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small(cell: str) -> dict:
    found = harness.resolve(cell)
    found["config"] = dict(found["config"], **SMALL)
    return found


def _fails(values: dict, limits: dict) -> bool:
    return any(values[k] > limits[k] for k in limits)


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_control_fails_training(cell):
    found = _small(cell)
    got = calibrate.control_train(found, SEED, "cpu")
    assert _fails(got, found["config"]["limits"]["train_epochs"]), got


def test_control_fails_serving(serving_root):
    found = harness.resolve("criteo_fm.serve", serving_root)
    got = calibrate.control_serve(found, SEED, 2.0)
    assert _fails(got, found["config"]["limits"]["serve_open"]), got


def _unchanged(monkeypatch):
    from dmlc_core_tpu_torch.models._dp import DataParallelModel
    orig = DataParallelModel.step

    def step(self, params, batch):
        _, loss = orig(self, params, batch)
        return params, loss

    monkeypatch.setattr(DataParallelModel, "step", step)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_training_fault_is_not_correct(cell, fault, monkeypatch):
    if fault == "state_unchanged":
        _unchanged(monkeypatch)
    with (calibrate.half_batch() if fault == "half_batch"
          else contextlib.nullcontext()):
        r = harness.run_cell(cell, SEED, 0.5, False, "cpu",
                             overrides={"config": SMALL})
    assert not r["correct"], r["checks"]


def test_altered_answer_is_not_correct(monkeypatch, serving_root,
                                      program_on_path):
    """The served model's bias moved by 0.05 where the server loads it:
    every answer it produces is altered."""
    from dmlc_core_tpu_torch.serving import model as serving_model
    orig = serving_model.save_model

    def save_model(uri, kind, params, *a, **k):
        params = dict(params, b=params["b"] + 0.05)
        return orig(uri, kind, params, *a, **k)

    monkeypatch.setattr(serving_model, "save_model", save_model)
    r = harness.run_cell("criteo_fm.serve", SEED, 1.0, False, "cpu",
                         overrides={"traffic": {"rate_qps": 40}},
                         root=serving_root)
    assert not r["correct"], r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_control_fails_at_cell_size(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells' own sizes run there")
    found = harness.resolve(cell)
    harness.program_env(found)
    limits = found["config"]["limits"][found["traffic"]["driver"]]
    for seed in (SEED, SEED + 1, SEED + 2):
        got = calibrate.control_train(found, seed, "cuda")
        assert _fails(got, limits), (seed, got)
