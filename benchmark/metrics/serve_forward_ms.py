"""The model's forward a micro-batch (``serving/model.py``): Δ sum over
Δ count of the server's ``serve_forward_us``."""


def read(t):
    mean = t.hist_mean("serve_forward_us")
    return None if mean is None else mean / 1e3
