"""Rows a micro-batch (``serving/batching.py``): Δ sum over Δ count of
the server's ``serve_batch_rows``."""


def read(t):
    return t.hist_mean("serve_batch_rows")
