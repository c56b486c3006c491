"""The training step's parameter update a step: Δ sum over Δ count of the
program's ``step_update_us`` (``models/_dp.py``, ``_apply``), stream time
between two markers on the card."""


def read(t):
    mean = t.hist_mean("step_update_us")
    return None if mean is None else mean / 1e3
