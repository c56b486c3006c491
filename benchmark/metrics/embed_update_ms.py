"""DLRM's sum of each distinct table row's gradient and row-wise Adagrad
update a step: Δ sum over Δ count of the program's
``dlrm_embed_update_us`` (``models/dlrm.py``), stream time between two
markers on the card."""


def read(t):
    mean = t.hist_mean("dlrm_embed_update_us")
    return None if mean is None else mean / 1e3
