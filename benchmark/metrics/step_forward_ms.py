"""The training step's forward a step: Δ sum over Δ count of the
program's ``step_forward_us`` (``models/_dp.py``, ``_shard_loss``), stream
time between two markers on the card."""


def read(t):
    mean = t.hist_mean("step_forward_us")
    return None if mean is None else mean / 1e3
