"""``stage_ms_per_batch`` in the DLRM-DCNv2 cell: the same reading."""

from benchmark.metrics.stage_ms_per_batch import read  # noqa: F401
