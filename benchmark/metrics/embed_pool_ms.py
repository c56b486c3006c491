"""DLRM's table lookup and bag pooling a step (with the sorts by bag and
by row and the step's one read of two counts): Δ sum over Δ count of the
program's ``dlrm_embed_us`` (``models/dlrm.py``), stream time between two
markers on the card."""


def read(t):
    mean = t.hist_mean("dlrm_embed_us")
    return None if mean is None else mean / 1e3
