"""``pad_share`` in the DLRM-DCNv2 cell: the same reading."""

from benchmark.metrics.pad_share import read  # noqa: F401
