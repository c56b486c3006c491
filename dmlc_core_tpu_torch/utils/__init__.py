"""Timing and trace spans, checkpoints, and local-filesystem fault
injection."""

from dmlc_core_tpu_torch.utils.timer import (Timer, get_time,  # noqa: F401
                                             reset_span_totals, span_totals,
                                             trace_span)

__all__ = ["CheckpointError", "save_checkpoint", "restore_checkpoint",
           "fast_forward", "job_part_uri", "job_commit_uri",
           "save_job_checkpoint", "commit_job_checkpoint",
           "restore_job_checkpoint", "Timer", "get_time", "trace_span",
           "span_totals", "reset_span_totals"]

_CHECKPOINT_NAMES = ("CheckpointError", "save_checkpoint",
                     "restore_checkpoint", "fast_forward",
                     "job_part_uri", "job_commit_uri",
                     "save_job_checkpoint", "commit_job_checkpoint",
                     "restore_job_checkpoint")


def __getattr__(name):
    # The checkpoint re-exports resolve lazily (PEP 562): checkpoint.py
    # imports torch, and the processes that need only the timer or
    # fs_fault (the tracker, the bench's parse clients) start without it.
    if name in _CHECKPOINT_NAMES:
        from dmlc_core_tpu_torch.utils import checkpoint
        return getattr(checkpoint, name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")
