"""Timing and trace spans, checkpoints, and local-filesystem fault
injection."""

from dmlc_core_tpu_torch.utils.timer import (Timer, get_time,  # noqa: F401
                                             reset_span_totals, span_totals,
                                             trace_span)

__all__ = ["Timer", "get_time", "trace_span", "span_totals",
           "reset_span_totals"]
