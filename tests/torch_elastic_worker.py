#!/usr/bin/env python3
"""A worker of the port's elastic data plane, the port's counterpart of
``tests/elastic_worker.py``.

It is ``chip_smoke.py``'s run A worker
(:func:`chip_smoke.job_elastic_worker`: heartbeats, tracker-granted shard
leases through ``ElasticDeviceRowBlockIter``, a ``LinearLearner`` step a
batch, the victim SIGKILLed holding a lease), so a hand-run world and the
card drive one implementation. Run it under the port's submit, e.g.
``python -m dmlc_core_tpu_torch.tracker.submit --cluster local
--num-workers 2 --num-shards 16 -- python tests/torch_elastic_worker.py
SPEC``.

SPEC is a JSON file with the keys ``uri``, ``device``, ``batch_rows``,
``scratch`` and ``victim_task`` (``chip_smoke.job_run_a`` writes one).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

if __name__ == "__main__":
    sys.exit(chip_smoke.job_elastic_worker(sys.argv[1]))
