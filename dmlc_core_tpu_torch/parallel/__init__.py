"""Multi-process initialization and Rabit-style collectives over
``torch.distributed``."""

from dmlc_core_tpu_torch.parallel.distributed import (allgather_bytes,
                                                      allreduce,
                                                      allreduce_tree,
                                                      barrier, broadcast,
                                                      init_from_env, rank,
                                                      world_size)

__all__ = ["allgather_bytes", "allreduce", "allreduce_tree", "barrier",
           "broadcast", "init_from_env", "rank", "world_size"]
