"""The scoring server's frontend and parse a micro-batch: Δ sum over Δ
count of its ``serve_parse_us`` (``serving/server.py``), from a
``/metrics`` scrape before and after the window."""


def read(t):
    mean = t.hist_mean("serve_parse_us")
    return None if mean is None else mean / 1e3
