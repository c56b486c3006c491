"""Argument parsing for dmlc-submit (reference tracker/dmlc_tracker/opts.py).

Cluster choices mirror opts.py:71-143 with `tpu-pod` added; the
DMLC_SUBMIT_CLUSTER env default is preserved (opts.py:170-176).

The port's own copy of ``dmlc_core_tpu/tracker/opts.py`` (it imports nothing of
the JAX package): the same names, env variables, CLI flags and wire
bytes, so a worker of either package joins the other's tracker.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    """The dmlc-submit argparse parser (reference dmlc_tracker/opts.py
    surface)."""
    p = argparse.ArgumentParser(
        prog="dmlc-submit",
        description="Submit a distributed dmlc_core_tpu_torch job")
    default_cluster = os.getenv("DMLC_SUBMIT_CLUSTER")
    p.add_argument("--cluster", default=default_cluster,
                   choices=["local", "ssh", "mpi", "sge", "slurm", "tpu-pod",
                            "kubernetes", "yarn", "mesos"],
                   help="cluster backend (env default DMLC_SUBMIT_CLUSTER)")
    p.add_argument("--num-workers", required=True, type=int,
                   help="number of worker processes")
    p.add_argument("--num-servers", default=0, type=int,
                   help="number of parameter-server processes")
    p.add_argument("--host-ip", default=None, type=str,
                   help="tracker host IP override")
    p.add_argument("--host-file", default=None, type=str,
                   help="host list for ssh/mpi/tpu-pod backends")
    p.add_argument("--jobname", default=None, type=str)
    p.add_argument("--queue", default="default", type=str,
                   help="sge queue")
    p.add_argument("--vcores", default=1, type=int,
                   help="cores requested per task (sge)")
    p.add_argument("--log-dir", default="dmlc_logs", type=str)
    p.add_argument("--log-level", default="INFO",
                   choices=["INFO", "DEBUG"])
    p.add_argument("--sync-dst-dir", default=None, type=str,
                   help="remote working dir (ssh/tpu-pod rsync target)")
    p.add_argument("--num-attempt", default=0, type=int,
                   help="retry attempts per worker (local backend)")
    p.add_argument("--heartbeat-ms", default=None, type=int,
                   help="enable worker liveness: heartbeat interval in ms "
                        "(exported as DMLC_TRACKER_HEARTBEAT_MS; 0 keeps "
                        "the legacy wait-forever tracker)")
    p.add_argument("--dead-after-ms", default=None, type=int,
                   help="mark a rank dead after this many ms without a "
                        "heartbeat (DMLC_TRACKER_DEAD_AFTER_MS; default "
                        "4x --heartbeat-ms)")
    p.add_argument("--recover-grace-ms", default=None, type=int,
                   help="grace window for cmd=recover after a rank is "
                        "marked dead before the job aborts "
                        "(DMLC_TRACKER_RECOVER_GRACE_MS; default half of "
                        "--dead-after-ms)")
    p.add_argument("--num-shards", default=None, type=int,
                   help="enable the elastic data-plane: pre-split the "
                        "dataset into this many logical shard leases "
                        "(exported as DMLC_TRACKER_NUM_SHARDS + "
                        "DMLC_ELASTIC_SHARDS=1; pick S >> --num-workers; "
                        "unset keeps the static num_parts/part_index "
                        "contract)")
    p.add_argument("--lease-ttl-ms", default=None, type=int,
                   help="shard-lease time-to-live without a renewal "
                        "(DMLC_TRACKER_LEASE_TTL_MS; renewal piggybacks "
                        "on every heartbeat; default --dead-after-ms + "
                        "--recover-grace-ms)")
    p.add_argument("--mesh", action="store_true",
                   help="elastic-mesh world (local backend): workers get a "
                        "DMLC_COORDINATOR_ADDRESS for "
                        "torch.distributed (init_from_env), any rank death aborts "
                        "the world (no single-rank relaunch into a live "
                        "mesh), and the whole world is relaunched — fresh "
                        "tracker + coordinator ports — resuming from the "
                        "last committed job checkpoint")
    p.add_argument("--world-attempts", default=None, type=int,
                   help="whole-world relaunches after a mesh abort "
                        "(DMLC_TRACKER_WORLD_ATTEMPTS; default 2 with "
                        "--mesh, 0 otherwise)")
    p.add_argument("--archives", default=[], action="append",
                   help="archive (.zip/.tar*) the in-container bootstrap "
                        "unpacks before exec (reference opts.py archives); "
                        "repeatable")
    p.add_argument("--slurm-worker-nodes", default=None, type=int)
    p.add_argument("--slurm-server-nodes", default=None, type=int)
    p.add_argument("--worker-memory-mb", default=1024, type=int,
                   help="memory request per worker (yarn/mesos/kubernetes)")
    p.add_argument("--worker-cores", default=1, type=int,
                   help="cpu request per worker (yarn/mesos/kubernetes)")
    p.add_argument("--server-memory-mb", default=1024, type=int,
                   help="memory request per server (yarn/mesos/kubernetes)")
    p.add_argument("--server-cores", default=1, type=int,
                   help="cpu request per server (yarn/mesos/kubernetes)")
    p.add_argument("--kube-namespace", default="default", type=str,
                   help="kubernetes namespace for the job resources")
    p.add_argument("--kube-worker-image", default="dmlc/base", type=str,
                   help="container image for kubernetes workers")
    p.add_argument("--kube-server-image", default="dmlc/base", type=str,
                   help="container image for kubernetes servers")
    p.add_argument("--kube-tpu-type", default=None, type=str,
                   help="TPU accelerator selector (e.g. tpu-v5-lite-podslice);"
                        " adds google.com/tpu resources + nodeSelector")
    p.add_argument("--kube-tpu-topology", default=None, type=str,
                   help="TPU slice topology (e.g. 2x4) for the nodeSelector")
    p.add_argument("--kube-tpu-chips", default=None, type=int,
                   help="google.com/tpu chips per pod (defaults to the chip "
                        "count implied by --kube-tpu-topology, e.g. 2x4 -> 8)")
    p.add_argument("--kube-dry-run", action="store_true",
                   help="print the generated manifests instead of kubectl "
                        "apply")
    p.add_argument("--mesos-master", default=None, type=str,
                   help="mesos master address host:port")
    p.add_argument("--coordinator-port", default=8476, type=int,
                   help="JAX coordination service port (tpu-pod)")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="command to run on every worker")
    return p


def get_opts(argv: Optional[List[str]] = None) -> argparse.Namespace:
    """Parse dmlc-submit arguments; `--` splits launcher args from the user
    command."""
    args = build_parser().parse_args(argv)
    if args.cluster is None:
        raise SystemExit(
            "--cluster is required (or set DMLC_SUBMIT_CLUSTER)")
    if not args.command:
        raise SystemExit("no command given")
    while args.command and args.command[0] == "--":
        args.command = args.command[1:]
    return args
