#!/usr/bin/env python3
"""A rank of the port's elastic mesh world, the port's counterpart of
``tests/mesh_worker.py``.

It is ``chip_smoke.py``'s run B worker (:func:`chip_smoke.job_mesh_worker`:
a gloo world, heartbeats, a ``StepWatchdog`` step loop with job
checkpoints, one structured abort with exit 41), so the CPU tests and the
card drive one implementation.

Usage: torch_mesh_worker.py SPEC, where SPEC is a JSON file with the keys
``uri``, ``device``, ``batch_rows``, ``scratch``, ``job``, ``steps``,
``kill_step`` and ``ckpt_steps`` (``chip_smoke.job_run_b`` writes one).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

if __name__ == "__main__":
    sys.exit(chip_smoke.job_mesh_worker(sys.argv[1]))
