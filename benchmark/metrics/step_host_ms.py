"""The host's time to issue a training step: Δ sum over Δ count of the
program's ``step_host_us`` (``models/_dp.py``, ``perf_counter`` around
``step()`` on the caller's thread, no device wait)."""


def read(t):
    mean = t.hist_mean("step_host_us")
    return None if mean is None else mean / 1e3
