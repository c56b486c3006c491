"""Share of the host CSR batches' nonzero slots that hold padding: 1 less
Δ sum of the program's ``device_batch_nnz`` over Δ sum of its
``device_batch_slots`` (``device/device_iter.py::_stage``), in %."""


def read(t):
    nnz, _ = t.hist.get("device_batch_nnz", (0.0, 0))
    slots, n = t.hist.get("device_batch_slots", (0.0, 0))
    if n <= 0 or slots <= 0:
        return None
    return 100.0 * (1.0 - nnz / slots)
