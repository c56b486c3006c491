"""``step_update_ms`` in the DLRM-DCNv2 cell: the same reading."""

from benchmark.metrics.step_update_ms import read  # noqa: F401
