"""``data_wait_share`` in the DLRM-DCNv2 cell: the same reading."""

from benchmark.metrics.data_wait_share import read  # noqa: F401
