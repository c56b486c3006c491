"""The per-layer readers of the program's step, host-batch and epoch-turn
instruments, on small CPU runs of each training cell: the padding share
exact from the generator's rows, the step's phases and the epoch turn
read, and nothing read (no error) from a run whose program lacks the
instruments.

Run with ``python -m pytest benchmark/tests``."""

from __future__ import annotations

import os

import pytest

from benchmark import harness, trace

SPEC = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
SEED = 2 ** 31 + 4242
ROWS, BATCH_ROWS = 4096, 1024
SMALL = {"config": {"rows": ROWS, "batch_rows": BATCH_ROWS}}
# the readers this file holds, by the cell that reports them
READERS = {
    "criteo_fm.crec": ("step_forward_ms", "step_backward_ms",
                       "step_update_ms", "step_host_ms", "pad_share",
                       "epoch_turn_share"),
    "higgs_lr.text": ("step_host_ms.text", "pad_share.text",
                      "epoch_turn_share.text"),
}


@pytest.fixture(autouse=True)
def _one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def want_pad_share(cell: str) -> float:
    """Every batch holds BATCH_ROWS rows of the generator's fixed
    nonzeros a row, in the smallest power-of-two bucket of at least the
    iterator's 4,096."""
    found = harness.resolve(cell)
    gen = harness.part(found, "datagen", found["config"]["data"]["generator"])
    nnz = BATCH_ROWS * gen.NNZ_PER_ROW
    bucket = 4096
    while bucket < nnz:
        bucket *= 2
    return 100.0 * (1.0 - nnz / bucket)


@pytest.mark.parametrize("cell", sorted(READERS))
def test_readers_on_a_small_traced_run(cell):
    names = READERS[cell]
    _, per_layer = harness.cell_metrics(SPEC, cell)
    assert set(names) <= {m["name"] for m in per_layer}
    r = harness.run_cell(cell, SEED, 1.0, True, "cpu", overrides=SMALL)
    assert r["correct"], r["checks"]
    got = {n: r["metrics"][n]["value"] for n in names}
    pad = next(n for n in names if n.startswith("pad_share"))
    assert got[pad] == pytest.approx(want_pad_share(cell), abs=1e-9)
    assert 0 < got[next(n for n in names
                        if n.startswith("epoch_turn_share"))] < 100
    assert all(got[n] > 0 for n in names if n.startswith("step_"))


def test_pad_shares_of_the_cells_at_their_sizes():
    # criteo_fm: 65,536 rows x 39 in a 4,194,304-entry bucket; higgs_lr:
    # 65,536 x 28 in 2,097,152
    assert 100.0 * (1 - 65536 * 39 / 4194304) == pytest.approx(39.0625)
    assert 100.0 * (1 - 65536 * 28 / 2097152) == pytest.approx(12.5)


def test_readers_find_nothing_without_the_instruments():
    """A program without the instruments (the parent of the change that
    adds them) leaves its histograms out: every reader returns None."""
    t = trace.TraceData(20.0, 18.0, [], [], {},
                        {"device_stage_us": (1e6, 50),
                         "device_wait_us": (2e5, 50)}, {})
    names = sorted({n for ns in READERS.values() for n in ns})
    for name in names:
        found = harness.resolve("criteo_fm.crec")
        assert harness.part(found, "metrics", name).read(t) is None, name
