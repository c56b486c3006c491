"""``step_forward_ms`` in the DLRM-DCNv2 cell: the same reading."""

from benchmark.metrics.step_forward_ms import read  # noqa: F401
