"""The comparison that decides ``correct`` fails what it must: the
control (the plain reference in the program's place, in bfloat16) and
each fault a cell can have, planted in the timed path underneath a run
of the harness (on the CPU, at a size a test run holds: the harness's
look for a card is skipped). ``dlrm_dcnv2.crec`` runs here with small
tables and widths (``conftest.py``'s ``dlrm_small_root``).

The readings themselves: SGD's (the linear and FM cells') are the same
bit for bit as they were before the adapters could name an optimizer,
and the Adagrad reading of the DLRM adapter sees a gradient error that
the update alone hides and compares the first step's loss and the
median leaf's change.

The same readings at the cells' own sizes are taken on the card with
``benchmark/calibrate.py`` (``PERF.md`` gives them and the limits set
from them); ``test_control_fails_at_cell_size`` repeats the control
there and ``test_tf32_is_not_correct_at_cell_size`` the DLRM cell's
TF32."""

from __future__ import annotations

import contextlib
import statistics

import numpy as np
import pytest

from benchmark import calibrate, correct, harness
from benchmark.models import dlrm, fm, linear

SEED = 2 ** 31 + 777
SMALL = {"rows": 4096, "batch_rows": 1024}
DLRM = "dlrm_dcnv2.crec"
TRAIN_CELLS = ["higgs_lr.text", "criteo_fm.crec", DLRM]


@pytest.fixture(autouse=True)
def _one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _root(cell: str, request) -> str:
    return (request.getfixturevalue("dlrm_small_root") if cell == DLRM
            else harness.ROOT)


def _small(cell: str, request) -> dict:
    found = harness.resolve(cell, _root(cell, request))
    found["config"] = dict(found["config"], **SMALL)
    return found


def _fails(values: dict, limits: dict) -> bool:
    return any(values[k] > limits[k] for k in limits)


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_control_fails_training(cell, request):
    found = _small(cell, request)
    got = {k: v["value"]
           for k, v in calibrate.control_train(found, SEED, "cpu").items()}
    assert _fails(got, found["config"]["limits"]["train_epochs"]), got


def test_control_fails_serving(serving_root):
    found = harness.resolve("criteo_fm.serve", serving_root)
    got = calibrate.control_serve(found, SEED, 2.0)
    assert _fails(got, found["config"]["limits"]["serve_open"]), got


def _unchanged(monkeypatch):
    """Every step hands back its parameters as they were before it, also
    where the learner updates them in place (the DLRM learner)."""
    import torch
    from dmlc_core_tpu_torch.models._dp import DataParallelModel
    orig = DataParallelModel.step

    def step(self, params, batch):
        before = [p.detach().clone() for p in params]
        _, loss = orig(self, params, batch)
        with torch.no_grad():
            for p, b in zip(params, before):
                p.copy_(b)
        return params, loss

    monkeypatch.setattr(DataParallelModel, "step", step)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_training_fault_is_not_correct(cell, fault, monkeypatch, request):
    if fault == "state_unchanged":
        _unchanged(monkeypatch)
    root = _root(cell, request)
    with (calibrate.half_batch() if fault == "half_batch"
          else contextlib.nullcontext()):
        r = harness.run_cell(cell, SEED, 0.5, False, "cpu",
                             overrides={"config": SMALL}, root=root)
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


# -- the readings -------------------------------------------------------------
def _before_adapters(prog: dict, ref: dict, lr: float) -> dict:
    """``correct.train_gaps`` as it read every cell before an adapter
    could name its optimizer (SGD over every leaf of one kind)."""
    def norms(leaves):
        return {k: float(np.linalg.norm(np.asarray(v, np.float64).ravel()))
                for k, v in leaves.items()}

    def worst(p, r, keep=None):
        pn, rn = norms(p), norms(r)
        med = statistics.median(rn.values())
        return max(abs(pn[k] - rn[k]) / max(rn[k], med, 1e-300)
                   for k in rn if keep is None or k in keep)

    def diff(a, b, scale=1.0):
        return {k: (np.asarray(a[k], np.float64)
                    - np.asarray(b[k], np.float64)) * scale for k in a}

    loss_gap = max(abs(float(p) - float(r)) / abs(float(r))
                   for p, r in zip(prog["loss"][:3], ref["loss"][:3]))
    g_ref = diff(ref["params"][0], ref["params"][1], 1.0 / lr)
    grad_gap = worst(diff(prog["params"][0], prog["params"][1], 1.0 / lr),
                     g_ref)
    gn = norms(g_ref)
    med = statistics.median(gn.values())
    keep = [k for k, v in gn.items() if v >= correct.NOUGHT * med]
    change_gap = worst(diff(prog["params"][2], prog["params"][0]),
                       diff(ref["params"][3], ref["params"][0]), keep)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap}


def _sgd_run(shapes: dict, seed: int, lr: float):
    """A program's and a reference's leaves over three SGD steps: the
    program's float32 and off by round-off and a little more, one leaf
    whose gradient is nought to rounding (so change_gap leaves it out)."""
    rng = np.random.default_rng(seed)
    p = [{k: rng.standard_normal(s) for k, s in shapes.items()}]
    for step in range(3):
        g = {k: rng.standard_normal(s) * (1e-9 if k == "b" else 1.0)
             for k, s in shapes.items()}
        p.append({k: p[-1][k] - lr * g[k] for k in shapes})
    ref = {"loss": list(rng.uniform(0.3, 0.7, 3)), "params": p}
    noise = [{k: (v * (1 + 1e-6 * rng.standard_normal(v.shape))).astype(
        np.float32) for k, v in q.items()} for q in (p[0], p[1], p[3])]
    prog = {"loss": [x * (1 + 1e-7 * rng.standard_normal())
                     for x in ref["loss"]], "params": noise}
    return prog, ref


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("adapter, shapes", [
    (linear, {"w": (28,), "b": ()}),
    (fm, {"b": (), "w": (512,), "v": (512, 8)})],
    ids=["higgs_lr", "criteo_fm"])
def test_sgd_readings_unchanged_bit_for_bit(adapter, shapes, seed):
    """The linear and FM cells' numbers are the ones they were before the
    adapters could name an optimizer, to the last bit."""
    lr = 0.05
    prog, ref = _sgd_run(shapes, seed, lr)
    got = correct.train_gaps(prog, ref, {"learning_rate": lr}, adapter)
    assert got == _before_adapters(prog, ref, lr)
    assert not hasattr(adapter, "gradient")
    assert not hasattr(adapter, "leaf_kind")
    assert not hasattr(adapter, "LOSS_STEPS")
    assert not hasattr(adapter, "CHANGE_MEDIAN_LEAF")


def _adagrad_leaves(grads: dict, p0: dict, lr: float, eps: float):
    """Leaves before and after one step from accumulators of 0: dense
    leaves elementwise, ``table*`` leaves row-wise."""
    before, after = dict(p0), {}
    for k, g in grads.items():
        acc = (g * g).mean(axis=1) if k.startswith("table") else g * g
        before["acc_" + k] = np.zeros_like(acc)
        after["acc_" + k] = acc
        s = np.sqrt(acc) + eps
        after[k] = p0[k] - lr * g / (s[:, None] if g.ndim > s.ndim else s)
    return before, after


def test_adagrad_reading_sees_a_gradient_error_the_update_hides():
    """A program whose every gradient is 10 % too large: Adagrad's first
    update is the gradient's sign whatever its size, so the old reading,
    (p0 − p1) / lr of every leaf against the median of all of them, reads
    under a fiftieth of it (only the accumulators move, and the weights'
    median swamps them), while the DLRM adapter's reading, the gradient worked
    out of the update and the accumulator, reads the 10 %."""
    rng = np.random.default_rng(5)
    model = {"learning_rate": 0.005, "adagrad_eps": 1e-8}
    shapes = {"top0_w": (64, 96), "top0_b": (64,), "table0": (300, 16)}
    p0 = {k: rng.uniform(-0.1, 0.1, s) for k, s in shapes.items()}
    g = {k: 1e-3 * rng.standard_normal(s) for k, s in shapes.items()}
    ref = _adagrad_leaves(g, p0, model["learning_rate"],
                          model["adagrad_eps"])
    prog = _adagrad_leaves({k: 1.1 * v for k, v in g.items()}, p0,
                           model["learning_rate"], model["adagrad_eps"])
    old = correct.worst_leaf(correct.sgd_gradient(*prog, model),
                             correct.sgd_gradient(*ref, model))["value"]
    new = correct.worst_leaf(dlrm.gradient(*prog, model),
                             dlrm.gradient(*ref, model),
                             kind=dlrm.leaf_kind)
    assert old < 2e-3, old
    assert abs(new["value"] - 0.1) < 1e-9, new
    # the reference's gradient comes back whole
    back = dlrm.gradient(*ref, model)
    assert set(back) == set(shapes)
    for k in shapes:
        np.testing.assert_allclose(back[k], g[k], rtol=1e-9, atol=0)


def test_dlrm_loss_gap_reads_the_first_step():
    """The DLRM cell compares the first step's loss alone: a later loss
    1e-3 off (Adagrad's whole steps on round-off gradients) is not read."""
    rng = np.random.default_rng(6)
    model = {"learning_rate": 0.005, "adagrad_eps": 1e-8}
    p0 = {"top0_w": rng.uniform(-0.1, 0.1, (8, 4))}
    before, after = _adagrad_leaves(
        {"top0_w": 1e-3 * rng.standard_normal((8, 4))}, p0, 0.005, 1e-8)
    ref = {"loss": [0.5, 0.4, 0.3], "params": [before, after, after, after]}
    prog = {"loss": [0.5 * (1 + 1e-7), 0.4 * (1 + 1e-3), 0.3 * (1 - 1e-3)],
            "params": [before, after, after]}
    got = correct.train_detail(prog, ref, model, dlrm)["loss_gap"]
    assert got["step"] == 1 and abs(got["value"] - 1e-7) < 1e-12, got
    sgd = correct.train_detail(prog, ref, model)["loss_gap"]
    assert abs(sgd["value"] - 1e-3) < 1e-9, sgd


def test_floors_are_taken_over_leaves_of_one_kind():
    """An accumulator's change is measured against the median of the
    accumulators', not against the weights', which are orders of
    magnitude larger: a 5 % error there reads 5 %."""
    ref = {"w0": np.ones(100), "w1": np.ones(400), "acc_w0": np.full(100,
           1e-6), "acc_w1": np.full(400, 1e-6)}
    prog = dict(ref, acc_w1=ref["acc_w1"] * 1.05)
    one = correct.worst_leaf(prog, ref)
    kinds = correct.worst_leaf(prog, ref, kind=dlrm.leaf_kind)
    assert one["value"] < 1e-4, one
    assert kinds["leaf"] == "acc_w1" and abs(kinds["value"] - 0.05) < 1e-9


def test_median_leaf_leaves_one_wandering_leaf_out():
    """The DLRM cell's change is its median leaf's, of each kind: one
    leaf 30 % off (an accumulator of a top bias after Adagrad's later
    steps) moves it by nothing, three of five leaves 5 % off do move it."""
    ref = {f"w{i}": np.full(50, 1.0 + i) for i in range(5)}
    ref.update({"acc_" + k: 1e-6 * v for k, v in ref.items()})
    one = dict(ref, acc_w3=1.3 * ref["acc_w3"])
    got = correct.worst_leaf(one, ref, kind=dlrm.leaf_kind, median=True)
    assert got["value"] == 0.0, got
    assert correct.worst_leaf(one, ref, kind=dlrm.leaf_kind)["value"] > 0.2
    half = dict(ref, **{k: 1.05 * ref[k] for k in ("w0", "w1", "w2")})
    got = correct.worst_leaf(half, ref, kind=dlrm.leaf_kind, median=True)
    assert got["leaf"] in ("w0", "w1", "w2")
    assert abs(got["value"] - 0.05 * np.linalg.norm(ref[got["leaf"]])
               / max(np.linalg.norm(ref[got["leaf"]]),
                     np.linalg.norm(ref["w2"]))) < 1e-12, got


def test_detail_names_where_each_number_was_read():
    prog, ref = _sgd_run({"w": (28,), "b": ()}, 3, 0.05)
    got = correct.train_detail(prog, ref, {"learning_rate": 0.05}, linear)
    assert got["loss_gap"]["step"] in (1, 2, 3)
    for name in ("grad_gap", "change_gap"):
        assert got[name]["leaf"] in ("w", "b")
        assert got[name]["program"] > 0 and got[name]["reference"] > 0
    # b's gradient is nought to rounding: left out of change_gap
    assert got["change_gap"]["leaf"] == "w"


def test_tf32_is_on_in_every_step_and_off_after():
    import torch
    from dmlc_core_tpu_torch.models._dp import DataParallelModel
    seen = []
    orig = DataParallelModel.step
    DataParallelModel.step = lambda self, params, batch: seen.append(
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32))
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    try:
        with calibrate.tf32():
            torch.backends.cuda.matmul.allow_tf32 = False  # as a learner
            DataParallelModel.step(None, None, None)
            DataParallelModel.step(None, None, None)
        assert DataParallelModel.step.__name__ == "<lambda>"
    finally:
        DataParallelModel.step = orig
    assert seen == [(True, True), (True, True)]
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == before


# -- on the card --------------------------------------------------------------
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
        got = {k: v["value"] for k, v in
               calibrate.control_train(found, seed, "cuda").items()}
        assert _fails(got, limits), (seed, got)


@pytest.mark.cuda
def test_tf32_is_not_correct_at_cell_size():
    """The DLRM cell's program with TF32 on, the precision below its
    float32, is refused at the cell's own size."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own size runs there")
    for seed in (SEED, SEED + 1, SEED + 2):
        with calibrate.tf32():
            r = harness.run_cell(DLRM, seed, 0.5, False, "cuda")
        assert not r["correct"], (seed, r["checks"])
