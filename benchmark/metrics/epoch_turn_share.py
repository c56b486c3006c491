"""Share of the window spent turning epochs: Δ sum of the program's
``device_epoch_turn_us`` (``DeviceRowBlockIter.before_first`` to the new
epoch's first batch handed over) over the traced window, in %."""


def read(t):
    s, n = t.hist.get("device_epoch_turn_us", (0.0, 0))
    if n <= 0 or t.window_s <= 0:
        return None
    return 100.0 * s / (t.window_s * 1e6)
