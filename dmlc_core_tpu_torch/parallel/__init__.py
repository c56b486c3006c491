"""Multi-process initialization and Rabit-style collectives over
``torch.distributed``, the elastic world's step watchdog, and the LM
lane's axis collectives and GPipe schedule (the ring is
``parallel.ring``)."""

from dmlc_core_tpu_torch.parallel.axis import (copy_to_group, ppermute,
                                               psum, psum_bcast)
from dmlc_core_tpu_torch.parallel.distributed import (allgather_bytes,
                                                      allreduce,
                                                      allreduce_tree,
                                                      barrier, broadcast,
                                                      init_from_env, rank,
                                                      world_size)
from dmlc_core_tpu_torch.parallel.elastic import (STEP_ABORT_EXIT,
                                                  StepWatchdog,
                                                  structured_abort)
from dmlc_core_tpu_torch.parallel.pipeline_parallel import pipeline_apply

__all__ = ["allgather_bytes", "allreduce", "allreduce_tree", "barrier",
           "broadcast", "init_from_env", "rank", "world_size",
           "STEP_ABORT_EXIT", "StepWatchdog", "structured_abort",
           "pipeline_apply", "ppermute", "psum", "psum_bcast",
           "copy_to_group"]
