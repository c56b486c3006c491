"""Host batch assembly a batch: Δ sum over Δ count of the iterator's
``device_stage_us`` (``device/device_iter.py::_stage``)."""


def read(t):
    mean = t.hist_mean("device_stage_us")
    return None if mean is None else mean / 1e3
