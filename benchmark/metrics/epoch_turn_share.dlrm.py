"""``epoch_turn_share`` in the DLRM-DCNv2 cell: the same reading."""

from benchmark.metrics.epoch_turn_share import read  # noqa: F401
