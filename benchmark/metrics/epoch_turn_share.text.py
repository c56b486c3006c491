"""``epoch_turn_share`` in the cells that report ``card_ms_per_step`` in
the place of ``train_rows_per_s``: the same reading."""

from benchmark.metrics.epoch_turn_share import read  # noqa: F401
