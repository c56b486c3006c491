"""A rank of the bench's mesh lane, the port's counterpart of the
reference's ``tests/mesh_worker.py``.

    python -m dmlc_core_tpu_torch.bench.mesh_worker PROGRESS_DIR \\
        [STEPS] [STEP_SLEEP_S] [DEVICE]

It joins the ``torch.distributed`` world the tracker's mesh mode exports
(gloo, so ranks may share one card; ``DEVICE`` defaults to ``cuda``),
opens the heartbeat channel and the lease data plane, and every step:
acquires a shard lease, writes ``rankN.progress`` (``step pid``: the
lane's clock and kill trigger), sleeps, crosses a cross-process
allgather (``parallel.allgather_bytes``) and completes the lease, under a
``StepWatchdog``. A tracker abort or a failed collective (a dead peer)
ends in a structured abort and exit 41 (``STEP_ABORT_EXIT``); the
watchdog's own thread does the same for a rank stuck mid-collective.
"""

from __future__ import annotations

import os
import sys
import time

import torch.distributed as dist

from dmlc_core_tpu_torch.parallel import (STEP_ABORT_EXIT, StepWatchdog,
                                          allgather_bytes, distributed,
                                          structured_abort)
from dmlc_core_tpu_torch.tracker.client import (RendezvousClient,
                                                current_monitor)
from dmlc_core_tpu_torch.tracker.wire import TrackerAbortedError, env_int


def main(argv=None) -> int:
    """One rank of the mesh lane: ``PROGRESS_DIR [STEPS [STEP_SLEEP
    [DEVICE]]]``."""
    argv = sys.argv[1:] if argv is None else argv
    progress_dir = argv[0]
    steps = int(argv[1]) if len(argv) > 1 else 500
    step_sleep = float(argv[2]) if len(argv) > 2 else 0.05
    device = argv[3] if len(argv) > 3 else "cuda"

    distributed.init_from_env(device=device, backend="gloo")
    client = RendezvousClient(os.environ["DMLC_TRACKER_URI"],
                              env_int("DMLC_TRACKER_PORT", 9091))
    rank = client.start().rank
    mon = current_monitor()
    num_shards = env_int("DMLC_TRACKER_NUM_SHARDS", 0)
    nworkers = env_int("DMLC_NUM_WORKER", 0)
    if nworkers < 1:
        raise RuntimeError(f"DMLC_NUM_WORKER={nworkers}: the launcher "
                           f"exports the world's size, at least 1")

    wd = StepWatchdog(rank=rank).start()
    held = None  # (epoch, shard) while this rank holds a lease

    def release_held():
        # put the lease back so a survivor can take it (best effort: on a
        # tracker abort the pool is gone anyway)
        if held is not None and mon is not None:
            mon.release_lease(*held)

    wd.add_drain(release_held)
    step = None
    try:
        for step in range(steps):
            wd.step_begin(step)
            if mon is not None and num_shards > 0:
                # complete the previous step's lease only once the next is
                # granted: past the first acquire this rank holds a lease
                # at every instant, so a SIGKILL lands while one is held
                shard = mon.acquire_lease(step, timeout=30.0)
                if shard is not None:
                    if held is not None:
                        mon.complete_lease(*held)
                    held = (step, shard)
            with open(os.path.join(progress_dir, f"rank{rank}.progress"),
                      "w") as f:
                f.write(f"{step} {os.getpid()}\n")
            time.sleep(step_sleep)
            # the collective survivors wait in when a peer dies
            blobs = allgather_bytes(f"{rank}:{step}".encode(),
                                    name=f"step{step}")
            if len(blobs) != nworkers:
                raise RuntimeError(f"allgather returned {len(blobs)} "
                                   f"blobs in a world of {nworkers}")
            if held is not None:
                mon.complete_lease(*held)
                held = None
            wd.step_end()
    except (TrackerAbortedError, dist.DistError) as e:
        wd.drain()
        structured_abort(f"mesh_worker rank {rank} at step {step}: {e}",
                         rank=rank)
        return STEP_ABORT_EXIT
    finally:
        wd.stop()
    if held is not None:
        mon.complete_lease(*held)
    client.shutdown(rank)
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
