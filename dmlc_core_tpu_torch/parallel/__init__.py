"""Multi-process initialization and Rabit-style collectives over
``torch.distributed``, and the elastic world's step watchdog."""

from dmlc_core_tpu_torch.parallel.distributed import (allgather_bytes,
                                                      allreduce,
                                                      allreduce_tree,
                                                      barrier, broadcast,
                                                      init_from_env, rank,
                                                      world_size)
from dmlc_core_tpu_torch.parallel.elastic import (STEP_ABORT_EXIT,
                                                  StepWatchdog,
                                                  structured_abort)

__all__ = ["allgather_bytes", "allreduce", "allreduce_tree", "barrier",
           "broadcast", "init_from_env", "rank", "world_size",
           "STEP_ABORT_EXIT", "StepWatchdog", "structured_abort"]
