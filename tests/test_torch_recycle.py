"""Deferred recycling of the CPU's aliased staging buffers, against the
reference.

On the CPU ``DeviceRowBlockIter`` hands out tensors that alias its
staging buffers (``torch.from_numpy``). As the reference does on its
aliasing backends (``tpu/device_iter.py`` ``_recycle_or_defer`` /
``_sweep_deferred``), the buffers are parked behind weakrefs and go back
to the batcher's pool once the consumer has dropped the batch; a parking
lot past ``max(4, 2 x prefetch)`` drops its oldest entry, counted in the
``device_recycle_skipped`` gauge. Checked here on a 64-batch epoch: the
batches stay the reference's bit for bit while their buffers are reused;
a consumer that drops each batch costs no more fresh staging than the
pool and the parking lot hold; one that keeps every batch gets a fresh
buffer a batch, every kept batch intact, and the overflow counted.
``to_device=False`` batches are never recycled, as in the reference.
"""

import numpy as np
import pytest
import torch

from dmlc_core_tpu.tpu import device_iter as ref_di
from tests.torch_reference_native import reference_native  # noqa: F401

from dmlc_core_tpu_torch import telemetry
from dmlc_core_tpu_torch.device import device_iter as di
from dmlc_core_tpu_torch.io import convert

BATCH_ROWS = 32
BATCHES = 64


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_text(path, rows=BATCH_ROWS * BATCHES, features=12, seed=0):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(rows):
            keep = np.flatnonzero(rng.random(features) < 0.6)
            vals = rng.uniform(-2, 2, len(keep))
            feats = " ".join(f"{j}:{v:.5f}" for j, v in zip(keep, vals))
            f.write(f"{int(rng.random() < 0.5)} {feats}\n")
    return str(path)


def lane(tmp_path, kind):
    """(uri, iterator kwargs) of one lane: each batcher class recycles
    its own way."""
    src = write_text(tmp_path / "s.libsvm")
    if kind == "text_csr":
        return src, {"layout": "csr"}
    if kind == "text_dense_bf16":
        return src, {"layout": "dense", "dense_dtype": "bf16"}
    if kind == "crec":
        uri = str(tmp_path / "d.crec")
        convert.rows_to_csr_recordio(src, uri, rows_per_record=100)
        return uri, {}
    if kind == "drec":
        uri = str(tmp_path / "d.drec")
        convert.rows_to_dense_recordio(src, uri, rows_per_record=100)
        return uri, {}
    assert kind == "index64"
    return src, {"index64": True, "layout": "csr"}


def leaf_bytes(a) -> bytes:
    """A leaf's raw bytes (bf16 as its bits)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        return a.numpy().tobytes()
    return np.asarray(a).tobytes()


def reference_epoch(uri, **kw):
    with ref_di.DeviceRowBlockIter(uri, batch_rows=BATCH_ROWS, mesh=None,
                                   min_nnz_bucket=64, to_device=False,
                                   **kw) as it:
        return [{k: leaf_bytes(v) for k, v in b.tree().items()} for b in it]


def count_fresh_staging(it):
    """Count the batches the batcher had to stage in fresh buffers (its
    pool was empty)."""
    misses = [0]
    pop = it.batcher._pool.pop

    def counted(key):
        got = pop(key)
        misses[0] += got is None
        return got

    it.batcher._pool.pop = counted
    return misses


def skipped_gauge() -> float:
    return telemetry.gauge("device_recycle_skipped").value


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("kind", ["text_csr", "text_dense_bf16", "crec",
                                  "drec", "index64"])
def test_recycled_batches_are_the_references(tmp_path, kind, prefetch):
    uri, kw = lane(tmp_path, kind)
    want = reference_epoch(uri, **kw)
    with di.DeviceRowBlockIter(uri, batch_rows=BATCH_ROWS, device="cpu",
                               min_nnz_bucket=64, prefetch=prefetch,
                               **kw) as it:
        misses = count_fresh_staging(it)
        # each batch read and dropped, as a training loop does
        got = [{k: leaf_bytes(v) for k, v in b.tree().items()} for b in it]
    assert len(got) == len(want) == BATCHES
    assert got == want
    # the buffers really were reused (the nnz buckets vary, and each
    # bucket has buffers of its own)
    assert misses[0] < BATCHES // 2


@pytest.mark.parametrize("prefetch", [0, 2])
def test_dropped_batches_bound_the_staging(tmp_path, prefetch):
    """One nnz bucket (the default 4096 holds every batch), so one pool
    key: fresh staging stays within the pool's cap, the parking lot's
    cap and the batches in flight (one in the fill, the host queue, one
    in the transfer, one with the consumer), whatever the epoch's
    length."""
    uri, kw = lane(tmp_path, "text_csr")
    before = skipped_gauge()
    n = 0
    with di.DeviceRowBlockIter(uri, batch_rows=BATCH_ROWS, device="cpu",
                               prefetch=prefetch, **kw) as it:
        misses = count_fresh_staging(it)
        for batch in it:
            assert batch.big.shape[0] == 1
            n += 1
        assert it._deferred_cap == max(4, 2 * prefetch)
        in_flight = max(prefetch, 1) + 2
        assert misses[0] <= (di._HostBufferPool.CAP + it._deferred_cap
                             + in_flight)
        if prefetch == 0:
            # one batch alive at a time: the parking lot never overflows
            assert it._recycle_skipped == 0
            assert skipped_gauge() == before
    assert n == BATCHES


@pytest.mark.parametrize("prefetch", [0, 2])
def test_held_batches_are_never_reused_and_overflow_is_counted(tmp_path,
                                                               prefetch):
    uri, kw = lane(tmp_path, "text_csr")
    want = reference_epoch(uri, **kw)
    with di.DeviceRowBlockIter(uri, batch_rows=BATCH_ROWS, device="cpu",
                               min_nnz_bucket=64, prefetch=prefetch,
                               **kw) as it:
        misses = count_fresh_staging(it)
        # reshaped views only: the tensors handed out are dropped, their
        # storage (and the staging buffer it aliases) is not
        held = [{k: v.reshape(-1) for k, v in b.tree().items()}
                for b in it]
        assert misses[0] == BATCHES
        assert it._recycle_skipped == BATCHES - it._deferred_cap
        assert skipped_gauge() == it._recycle_skipped
    assert [{k: leaf_bytes(v) for k, v in b.items()} for b in held] == want


def test_host_batches_are_never_recycled(tmp_path):
    uri, kw = lane(tmp_path, "text_csr")
    with di.DeviceRowBlockIter(uri, batch_rows=BATCH_ROWS, device="cpu",
                               to_device=False, **kw) as it:
        misses = count_fresh_staging(it)
        n = sum(1 for _ in it)
        assert it._deferred == []
    assert misses[0] == n == BATCHES
