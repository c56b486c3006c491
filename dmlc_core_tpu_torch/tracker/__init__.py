"""Distributed launch layer (reference tracker/dmlc_tracker), the port's
copy of ``dmlc_core_tpu/tracker``.

dmlc-submit CLI + cluster backends (local/ssh/mpi/sge/slurm/tpu-pod), the
rabit-compatible rendezvous tracker, and a worker-side client.
"""

from dmlc_core_tpu_torch.tracker.rendezvous import (PSTracker, RabitTracker,
                                                    run_job,
                                                    start_standalone_tracker)
from dmlc_core_tpu_torch.tracker.client import RendezvousClient

__all__ = ["RabitTracker", "PSTracker", "run_job",
           "start_standalone_tracker", "RendezvousClient"]
