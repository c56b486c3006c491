"""DLRM's cross network forward a step: Δ sum over Δ count of the
program's ``dlrm_cross_us`` (``models/dlrm.py``), stream time between
two markers on the card."""


def read(t):
    mean = t.hist_mean("dlrm_cross_us")
    return None if mean is None else mean / 1e3
