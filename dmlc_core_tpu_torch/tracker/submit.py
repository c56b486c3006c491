"""dmlc-submit entry point (reference tracker/dmlc_tracker/submit.py).

Usage::

    python -m dmlc_core_tpu_torch.tracker.submit --cluster=local \
        --num-workers=4 -- my_worker.py args...

The port's own copy of ``dmlc_core_tpu/tracker/submit.py`` (it imports nothing of
the JAX package): the same names, env variables, CLI flags and wire
bytes, so a worker of either package joins the other's tracker.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional

from dmlc_core_tpu_torch.tracker.launchers import BACKENDS
from dmlc_core_tpu_torch.tracker.opts import get_opts


def main(argv: Optional[List[str]] = None) -> None:
    """dmlc-submit CLI entry: parse options and dispatch to the cluster
    backend."""
    args = get_opts(argv)
    logging.basicConfig(
        format="%(asctime)s %(levelname)s %(message)s",
        level=getattr(logging, args.log_level))
    # liveness flags become the env knobs every backend (and the tracker
    # itself) reads — one export point covers local/ssh/k8s/yarn/... alike
    for flag, env in (("heartbeat_ms", "DMLC_TRACKER_HEARTBEAT_MS"),
                      ("dead_after_ms", "DMLC_TRACKER_DEAD_AFTER_MS"),
                      ("recover_grace_ms", "DMLC_TRACKER_RECOVER_GRACE_MS"),
                      ("num_shards", "DMLC_TRACKER_NUM_SHARDS"),
                      ("lease_ttl_ms", "DMLC_TRACKER_LEASE_TTL_MS"),
                      ("world_attempts", "DMLC_TRACKER_WORLD_ATTEMPTS")):
        v = getattr(args, flag, None)
        if v is not None:
            os.environ[env] = str(v)
    if getattr(args, "num_shards", None):
        # the worker-side data layer's elastic opt-in rides the env ABI
        os.environ["DMLC_ELASTIC_SHARDS"] = "1"
    backend = BACKENDS.get(args.cluster)
    if backend is None:
        raise SystemExit(f"unknown cluster backend {args.cluster!r}")
    backend(args)


if __name__ == "__main__":
    main()
