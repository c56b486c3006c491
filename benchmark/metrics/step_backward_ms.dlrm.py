"""``step_backward_ms`` in the DLRM-DCNv2 cell: the same reading."""

from benchmark.metrics.step_backward_ms import read  # noqa: F401
