"""``pad_share`` in the cells that report ``card_ms_per_step`` in the
place of ``train_rows_per_s``: the same reading."""

from benchmark.metrics.pad_share import read  # noqa: F401
