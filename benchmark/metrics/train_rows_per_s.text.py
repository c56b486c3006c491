"""Rows a second of the traced window, in a cell whose rate is set by
the host: the rows of every step completed in the window over the
window's seconds, as ``train_rows_per_s`` counts them (the profiler's
own cost on the host is in it)."""


def read(t):
    steps = t.extra.get("steps")
    if not steps or t.window_s <= 0:
        return None
    return sum(n for _, n in steps) / t.window_s
