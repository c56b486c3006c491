"""``DLRMLearner`` (``models/dlrm.py``) against the plain reference
(``tests/reference_dlrm.py``) on the CPU, on seeded random weights.

Small tables (each published table cut to at most 97 rows), embedding
dim 16, cross rank 8, but the published 26 tables and multi-hot sizes
(214 ids a row), so bags hold duplicate ids within a row and across
rows. The rows go through the normal path: libfm text, ``.crec``,
``DeviceRowBlockIter(layout="csr")`` and ``DataParallelModel.step``; 150
rows in batches of 64 make the last batch partial (padding rows), and
every batch's nnz bucket holds padding nonzeros.

Tolerances: the learner computes in float32 and the reference in
float64 from the same float32 inputs and weights, so each gap is
float32 round-off through a model 3 cross layers and 5 MLP layers deep:
relative 1e-5 on margins and losses, and 1e-4 of each leaf's largest
gradient element (a gradient is a sum over 64 rows of products of
several factors, each rounded). After Adagrad steps every weight has
moved by about the learning rate (0.005) in a direction set by the
sign of its gradient, so the parameters are held to 1e-5 absolute: a
sign flipped by round-off would show as a gap near 1e-2.
"""

import numpy as np
import pytest
import torch

import reference_dlrm as ref
from dmlc_core_tpu_torch import telemetry
from dmlc_core_tpu_torch.device.device_iter import (DeviceRowBlockIter,
                                                    unpack_shard)
from dmlc_core_tpu_torch.device.sharding import DataMesh
from dmlc_core_tpu_torch.io.convert import rows_to_csr_recordio
from dmlc_core_tpu_torch.models import DLRMLearner
from dmlc_core_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                                  save_checkpoint)

PUBLISHED_ROWS = [40000000, 39060, 17295, 7424, 20265, 3, 7122, 1543, 63,
                  40000000, 3067956, 405282, 10, 2209, 11938, 155, 4, 976,
                  14, 40000000, 40000000, 40000000, 590152, 12973, 108, 36]
MULTI_HOT = [3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12,
             100, 27, 10, 3, 1, 1]
TABLES = [min(n, 97) for n in PUBLISHED_ROWS]
DENSE = 13
ROWS = 150
BATCH = 64  # batches of 64, 64 and 22 rows
LR, EPS = 0.005, 1e-8


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def telemetry_on():
    was = telemetry.enabled()
    telemetry.enable(True)
    yield
    telemetry.enable(was)


def make_rows(rows=ROWS, seed=3):
    """label [R], col [R, 227], val [R, 227] (float32 values as the file
    spells them, widened)."""
    rng = np.random.default_rng(seed)
    offsets = np.concatenate([[0], np.cumsum(TABLES)[:-1]])
    dense = np.round(rng.lognormal(0.0, 0.5, (rows, DENSE)), 4)
    ids = [DENSE + offsets[t] + rng.integers(0, TABLES[t], (rows, h))
           for t, h in enumerate(MULTI_HOT)]
    col = np.concatenate([np.broadcast_to(np.arange(DENSE), (rows, DENSE))]
                         + ids, axis=1)
    val = np.concatenate([dense, np.ones((rows, col.shape[1] - DENSE))],
                         axis=1)
    label = (rng.random(rows) < 0.3).astype(np.float64)
    return label, col, val


def write_libfm(path, label, col, val):
    field = np.concatenate([np.arange(DENSE)] + [
        np.full(h, DENSE + t) for t, h in enumerate(MULTI_HOT)])
    with open(path, "w") as f:
        for y, cs, vs in zip(label, col, val):
            f.write(f"{int(y)} " + " ".join(
                f"{fd}:{c}:{v:.4f}" if fd < DENSE else f"{fd}:{c}:1"
                for fd, c, v in zip(field, cs, vs)) + "\n")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("dlrm")
    label, col, val = make_rows()
    write_libfm(str(d / "rows.libfm"), label, col, val)
    rows_to_csr_recordio(str(d / "rows.libfm"), str(d / "rows.crec"),
                         fmt="libfm")
    with DeviceRowBlockIter(str(d / "rows.crec"), batch_rows=BATCH,
                            layout="csr", device="cpu") as it:
        batches = list(it)
    val32 = val.astype(np.float32).astype(np.float64)
    spans = [(lo, min(ROWS, lo + BATCH)) for lo in range(0, ROWS, BATCH)]
    plain = [(col[a:b], val32[a:b], label[a:b]) for a, b in spans]
    return {"batches": batches, "plain": plain, "dir": d}


def learner():
    return DLRMLearner(TABLES, MULTI_HOT, embed_dim=16, bottom=(24, 16),
                       cross_layers=3, cross_rank=8, top=(32, 16, 1),
                       learning_rate=LR, eps=EPS, device="cpu")


def as_dict(params):
    return {k: v.detach().clone() for k, v in params._asdict().items()}


def close(got, want, rtol=1e-5, atol=0.0, what=""):
    torch.testing.assert_close(got.double(), want.double(), rtol=rtol,
                               atol=atol, msg=what)


def test_data_has_duplicates_padding_and_a_partial_batch(data):
    col = data["plain"][0][0]
    # table 20 (100 ids into 97 rows) repeats ids within one bag
    bag = col[0, DENSE + sum(MULTI_HOT[:20]):DENSE + sum(MULTI_HOT[:21])]
    assert len(np.unique(bag)) < len(bag)
    shard = unpack_shard({k: v[0] for k, v in
                          data["batches"][2].tree().items()})
    assert int(shard["nrows"]) == ROWS - 2 * BATCH
    assert int((shard["row"] < BATCH).sum()) == (ROWS - 2 * BATCH) * 227
    assert shard["row"].numel() > (ROWS - 2 * BATCH) * 227


@pytest.mark.parametrize("b", range(3))
def test_margins_match_the_reference(data, b):
    lr = learner()
    params = lr.init(seed=11)
    col, val, _ = data["plain"][b]
    got = lr.predict(params, data["batches"][b])[0][:len(col)]
    want = ref.margins(as_dict(params), torch.as_tensor(col),
                       torch.as_tensor(val), TABLES, DENSE)
    close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("b", range(3))
def test_loss_and_gradients_match_the_reference(data, b):
    lr = learner()
    params = lr.init(seed=12)
    col, val, y = data["plain"][b]
    loss_sum, wsum, grads = lr._local(params, data["batches"][b])
    grads = type(params)(*grads)
    want_loss, want = ref.loss_and_grads(
        {k: v.double() for k, v in as_dict(params).items()},
        torch.as_tensor(col), torch.as_tensor(val), torch.as_tensor(y),
        TABLES, DENSE)
    assert float(wsum) == len(col)
    close(loss_sum / wsum, want_loss, rtol=1e-5)
    for name, g in grads._asdict().items():
        if name.startswith("acc_"):
            assert g is None, name  # state is not differentiated
            continue
        g = g.to_dense() if g.layout != torch.strided else g
        w = want[name] * len(col)  # the learner's is the sum's gradient
        close(g, w, rtol=1e-4, atol=1e-4 * float(w.abs().max()), what=name)


def test_table_gradient_holds_the_looked_up_rows_only(data):
    lr = learner()
    params = lr.init(seed=13)
    _, _, grads = lr._local(params, data["batches"][0])
    g = type(params)(*grads).table
    assert g.layout == torch.sparse_coo
    col = data["plain"][0][0]
    looked_up = np.unique(col[col >= DENSE] - DENSE)
    # coalesced: one gradient row a distinct row, duplicate ids summed
    assert g.is_coalesced()
    assert np.array_equal(g.indices()[0].numpy(), looked_up)
    assert g.values().shape == (len(looked_up), 16)


def test_three_adagrad_steps_match_the_reference(data):
    lr = learner()
    params = lr.init(seed=14)
    p0 = as_dict(params)
    want = ref.train(p0, data["plain"], TABLES, DENSE, LR, EPS)
    for s in range(3):
        params, loss = lr.step(params, data["batches"][s])
        close(loss, torch.tensor(want["loss"][s]), rtol=1e-5,
              what=f"loss {s}")
        for name, v in params._asdict().items():
            w = want["params"][s + 1][name]
            tol = 1e-5 if not name.startswith("acc_") else \
                1e-4 * float(w.abs().max())
            close(v, w, rtol=1e-4, atol=tol, what=f"step {s} {name}")


def test_rows_not_looked_up_stay_bit_identical(data):
    lr = learner()
    params = lr.init(seed=15)
    t0 = params.table.clone()
    for batch in data["batches"]:
        params, _ = lr.step(params, batch)
    col = np.concatenate([c for c, _, _ in data["plain"]])
    seen = np.zeros(sum(TABLES), bool)
    seen[col[col >= DENSE] - DENSE] = True
    untouched = torch.as_tensor(~seen)
    assert untouched.any() and seen.any()
    assert torch.equal(params.table[untouched], t0[untouched])
    assert torch.equal(params.acc_table[untouched],
                       torch.zeros(int(untouched.sum())))
    assert not torch.equal(params.table[~untouched], t0[~untouched])
    assert bool((params.acc_table[~untouched] > 0).all())


def test_padding_nonzeros_vanish(data):
    """Padding slots pointed at a real table row change nothing: they
    are dropped by their row id alone."""
    lr = learner()
    params = lr.init(seed=16)
    batch = data["batches"][2]
    tree = {k: v.clone() for k, v in batch.tree().items()}
    big = tree["big"][0]
    pad = big[0] == BATCH
    assert pad.any()
    big[1][pad] = DENSE + 5
    big[3][pad] = DENSE + 20
    big[2][pad] = torch.tensor(1.0).view(torch.int32)
    forged = type(batch)(total_rows=batch.total_rows, **tree)
    a, _, ga = lr._local(params, batch)
    b, _, gb = lr._local(params, forged)
    assert torch.equal(a, b)
    ta, tb = (type(params)(*g).table.coalesce() for g in (ga, gb))
    assert torch.equal(ta.indices(), tb.indices())


def test_a_batch_without_fields_is_refused(tmp_path):
    path = tmp_path / "rows.libsvm"
    path.write_text("1 0:0.5 20:1\n0 3:1.5 40:1\n")
    lr = learner()
    params = lr.init()
    with DeviceRowBlockIter(str(path), batch_rows=2, layout="csr",
                            device="cpu") as it:
        batch = next(iter(it))
        with pytest.raises(ValueError, match="field plane"):
            lr.step(params, batch)


def test_a_mesh_refuses_the_model(data):
    mesh = DataMesh(group=None, rank=0, size=1,
                    device=torch.device("cpu"))
    with pytest.raises(ValueError, match="runs on one device"):
        DLRMLearner(TABLES, MULTI_HOT, embed_dim=16, bottom=(24, 16),
                    cross_rank=8, top=(32, 16, 1), mesh=mesh, device="cpu")
    # the mesh step itself refuses row-sparse gradients and state leaves
    lr = learner()
    params = lr.init()
    lr.mesh = mesh
    with pytest.raises(ValueError, match="row-sparse table gradients"):
        lr.step(params, data["batches"][0])


def test_checkpoint_carries_the_optimizer_state(data, tmp_path):
    lr = learner()
    params, _ = lr.step(lr.init(seed=17), data["batches"][0])
    save_checkpoint(str(tmp_path / "ck.bin"), params, step=1)
    like = lr.init(seed=99)
    back, step, _ = restore_checkpoint(str(tmp_path / "ck.bin"), like)
    assert step == 1 and type(back) is type(params)
    for a, b in zip(params, back):
        assert torch.equal(a, b)
    assert float(back.acc_table.sum()) > 0
    p1, l1 = lr.step(params, data["batches"][1])
    p2, l2 = lr.step(back, data["batches"][1])
    assert torch.equal(l1, l2)
    for a, b in zip(p1, p2):
        assert torch.equal(a, b)


def test_instruments_once_a_step(data, telemetry_on):
    names = ("dlrm_embed_us", "dlrm_cross_us", "dlrm_embed_update_us",
             "dlrm_lookup_ids", "dlrm_unique_rows")
    c0 = {n: (telemetry.histogram(n).count, telemetry.histogram(n).sum)
          for n in names}
    lr = learner()
    params = lr.init()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for batch in data["batches"]:
            params, _ = lr.step(params, batch)
    for n in names:
        assert telemetry.histogram(n).count - c0[n][0] == 3, n
    ids = sum(int((c >= DENSE).sum()) for c, _, _ in data["plain"])
    rows = sum(len(np.unique(c[c >= DENSE])) for c, _, _ in data["plain"])
    assert telemetry.histogram("dlrm_lookup_ids").sum - \
        c0["dlrm_lookup_ids"][1] == ids
    assert telemetry.histogram("dlrm_unique_rows").sum - \
        c0["dlrm_unique_rows"][1] == rows
    ranges = {e.name for e in prof.events()}
    assert {"dlrm_embed", "dlrm_cross", "dlrm_embed_update"} <= ranges


def test_instruments_off_with_telemetry_off(data):
    was = telemetry.enabled()
    telemetry.enable(False)
    try:
        c0 = telemetry.histogram("dlrm_embed_us").count
        lr = learner()
        lr.step(lr.init(), data["batches"][0])
        assert telemetry.histogram("dlrm_embed_us").count == c0
    finally:
        telemetry.enable(was)
