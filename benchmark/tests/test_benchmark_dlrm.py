"""The ``dlrm_dcnv2`` configuration and its cell ``dlrm_dcnv2.crec`` on the
CPU.

- The configuration holds the published widths whole, and of each table
  the rows one chip of the stated eight holds: ceil(N/8) for the tables
  over 1,000,000 rows, N for the others; the generator draws from the
  same rows.
- The multi-hot ids after each table's first are a function of it.
- A small run of the cell through ``harness.run_cell`` is correct: the
  copy of the checkout with small tables and widths (``conftest.py``'s
  ``dlrm_small_root``), 4,096 rows in batches of 1,024.
- The step's roofline counts, worked by hand at the published widths.
"""

from __future__ import annotations

import math
import os

import numpy as np
import pytest

from benchmark import harness, roofline, roofline_dlrm
from benchmark.datagen import criteo_multihot

ROOT = harness.ROOT
CELL = "dlrm_dcnv2.crec"
SEED = 2 ** 31 + 4242
SMALL = {"config": {"rows": 4096, "batch_rows": 1024}}


def config():
    return harness.load_json(os.path.join(ROOT, "benchmark", "configs",
                                          "dlrm_dcnv2.json"))


def test_held_rows_are_one_chip_of_eight():
    cfg = config()
    published = cfg["published"]["num_embeddings_per_feature"]
    held = cfg["model"]["num_embeddings_per_feature"]
    assert len(published) == len(held) == 26
    assert held == [math.ceil(n / 8) if n > 1_000_000 else n
                    for n in published]
    assert sum(held) == 26500127
    # the generator draws from the configuration's rows
    assert criteo_multihot.HELD_ROWS == held
    assert criteo_multihot.MULTI_HOT == cfg["model"]["multi_hot_sizes"]
    assert cfg["deployment"]["chips"] == 8


def test_extra_ids_follow_the_first_id():
    """A table's bag is a function of its first id, as MLPerf's fixed
    multi-hot lookup makes it: rows sharing a first id share the bag."""
    arr = criteo_multihot.arrays(criteo_multihot.BLOCK + 100, SEED)
    col = arr["col"]
    lo = 13 + sum(criteo_multihot.MULTI_HOT[:20])
    bags = col[:, lo:lo + 100]  # table 20: 100 ids a row
    firsts, where = np.unique(bags[:, 0], return_inverse=True)
    assert len(firsts) < len(bags) // 2  # Zipf first ids recur
    for k in range(len(firsts)):
        rows = bags[where == k]
        assert (rows == rows[0]).all()
    held = criteo_multihot.HELD_ROWS[20]
    start = 13 + sum(criteo_multihot.HELD_ROWS[:20])
    assert ((bags >= start) & (bags < start + held)).all()
    # the other ids spread over the held rows
    assert np.unique(bags[:, 1:]).size > 0.9 * len(firsts) * 99


def test_widths_are_the_published_ones():
    cfg = config()
    m, pub = cfg["model"], cfg["published"]
    for key in ("dense_features", "multi_hot_sizes", "embedding_dim",
                "dense_arch_layer_sizes", "dcn_num_layers",
                "dcn_low_rank_dim", "over_arch_layer_sizes",
                "learning_rate", "adagrad_eps",
                "adagrad_initial_accumulator"):
        assert m[key] == pub[key], key
    assert (m["embedding_dim"], m["dcn_low_rank_dim"]) == (128, 512)
    assert m["dense_arch_layer_sizes"] == [512, 256, 128]
    assert m["over_arch_layer_sizes"] == [1024, 1024, 512, 256, 1]
    assert sum(m["multi_hot_sizes"]) == 214
    assert cfg["batch_rows"] * pub["gpus"] == pub["global_batch_size"]
    assert cfg["reduced"] == ["rows", "num_embeddings_per_feature"]


def test_step_roofline_worked_by_hand():
    m = config()["model"]
    assert roofline_dlrm.dense_params(m) == 16044545
    rows, ids, distinct = 8192, 8192 * 214, 1_000_000
    flops, nbytes = roofline_dlrm.step_cost(m, rows, rows * 227, ids,
                                            distinct)
    # multiply-adds a row: bottom 170,496, cross 3 x 3,538,944, top
    # 5,243,136; forward, weight and input gradients, less the first
    # layer's input gradient
    macs = 170496 + 3 * 3538944 + 5243136
    assert flops > 2 * rows * (3 * macs - 13 * 512)
    assert abs(flops / 0.79e12 - 1) < 0.01
    s, bound = roofline.bound_s(flops, nbytes)
    assert bound == "flops" and abs(s * 1e3 - 11.79) < 0.05
    assert nbytes == (rows * 227 * 16 + rows * 8 + distinct * 129 * 8
                      + 16044545 * 16)


@pytest.fixture
def small_root(dlrm_small_root):
    """A checkout whose ``dlrm_dcnv2`` holds small tables and widths."""
    return dlrm_small_root


@pytest.mark.parametrize("trace", [0, 1])
def test_small_run_of_the_cell_is_correct(small_root, trace):
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        r = harness.run_cell(CELL, SEED + trace, 1.0, bool(trace), "cpu",
                             overrides=SMALL, root=small_root)
    finally:
        torch.set_num_threads(n)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 3
    if trace:
        got = set(r["metrics"])
        # the CPU has no card: the device readers find nothing there
        assert {"embed_pool_ms", "embed_update_ms", "cross_ms",
                "unique_row_share", "step_backward_ms.dlrm",
                "data_wait_share.dlrm", "step_host_ms.dlrm",
                "stage_ms_per_batch.dlrm", "h2d_ms_per_batch.dlrm",
                "step_forward_ms.dlrm", "step_update_ms.dlrm",
                "pad_share.dlrm", "epoch_turn_share.dlrm"} <= got, got
        assert 0 < r["metrics"]["unique_row_share"]["value"] <= 100
    else:
        assert set(r["metrics"]) == {"setup_s", "train_rows_per_s"}


def test_full_tables_are_refused_on_the_cpu():
    from benchmark.models import dlrm
    with pytest.raises(ValueError, match="fewer rows"):
        dlrm.init(config(), SEED, "cpu")
