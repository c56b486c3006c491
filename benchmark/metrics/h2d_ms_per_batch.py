"""Host-to-device copy a batch: Δ sum over Δ count of the iterator's
``device_transfer_us`` (``device_iter._device_put``)."""


def read(t):
    mean = t.hist_mean("device_transfer_us")
    return None if mean is None else mean / 1e3
