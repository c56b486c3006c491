"""The training step's backward a step: Δ sum over Δ count of the
program's ``step_backward_us`` (``models/_dp.py``,
``torch.autograd.grad``), stream time between two markers on the card."""


def read(t):
    mean = t.hist_mean("step_backward_us")
    return None if mean is None else mean / 1e3
