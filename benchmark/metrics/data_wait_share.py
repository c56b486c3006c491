"""Share of the window the training loop waited on the iterator: Δ of
``device_wait_us`` (``DeviceRowBlockIter.__iter__``) over the traced
window, in %."""


def read(t):
    s, n = t.hist.get("device_wait_us", (0.0, 0))
    if n <= 0 or t.window_s <= 0:
        return None
    return 100.0 * s / (t.window_s * 1e6)
