"""``device_idle_share.train`` in the cells that report
``card_ms_per_step`` in the place of ``train_rows_per_s``: the share of
the traced window in which no kernel, copy or memset ran on the card,
in %."""


def read(t):
    if t.window_s <= 0 or t.busy_s <= 0 or "steps" not in t.extra:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
