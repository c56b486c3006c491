"""Share of the DLRM-DCNv2 cell's traced window in which no kernel, copy
or memset ran on the card, in % (``device_idle_share.train``'s
reading)."""


def read(t):
    if t.window_s <= 0 or t.busy_s <= 0 or "steps" not in t.extra:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
