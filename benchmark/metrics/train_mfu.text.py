"""``train_mfu`` in the cells that report ``card_ms_per_step`` in the place
of ``train_rows_per_s``: the same reading."""

from benchmark.metrics.train_mfu import read  # noqa: F401
