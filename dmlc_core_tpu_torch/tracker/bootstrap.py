"""In-container bootstrap: set up the environment, then exec the user job.

Counterpart of reference tracker/dmlc_tracker/launcher.py:12-80 — the
script a cluster backend runs *inside* the allocated container before the
user command: derive the role on role-less schedulers (sge), extend
LD_LIBRARY_PATH/CLASSPATH for Hadoop-linked binaries, unzip shipped
archives, then exec. Extended for the TPU path: when the launcher exported
the JAX coordination trio (JAX_COORDINATOR_ADDRESS et al.) it is passed
through untouched so the job's `init_from_env` finds it.

Run as: python -m dmlc_core_tpu_torch.tracker.bootstrap <cmd> [args...]

The port's own copy of ``dmlc_core_tpu/tracker/bootstrap.py`` (it imports nothing of
the JAX package): the same names, env variables, CLI flags and wire
bytes, so a worker of either package joins the other's tracker.
"""

from __future__ import annotations

import glob
import os
import subprocess
import sys
from typing import Dict, List


def unzip_archives(archives: List[str], env: Dict[str, str],
                   runner=subprocess.call) -> None:
    """Unpack .zip/.tar* files shipped with the job (launcher.py:12-19)."""
    for fname in archives:
        if not os.path.exists(fname):
            continue
        if fname.endswith(".zip"):
            runner(["unzip", "-o", fname], env=env)
        elif ".tar" in fname:
            runner(["tar", "-xf", fname], env=env)


def build_env(base: Dict[str, str],
              classpath_runner=None) -> Dict[str, str]:
    """Compute the job environment from the launcher's exports.

    Mirrors launcher.py: sge role derivation (:44-49), hadoop/java
    library+class paths (:51-63), LIBHDFS_OPTS default (:67-71),
    LD_LIBRARY_PATH extension (:73-74).
    """
    env = dict(base)
    from dmlc_core_tpu_torch.tracker.wire import env_enum, env_int
    # a typo'd backend name must fail here too, not select nothing
    cluster = env_enum("DMLC_JOB_CLUSTER",
                       ("local", "ssh", "mpi", "sge", "slurm", "tpu-pod",
                        "kubernetes", "yarn", "mesos"), env=env)
    if cluster is None:
        raise RuntimeError("need DMLC_JOB_CLUSTER in the environment")

    # liveness + elastic data-plane knobs (doc/robustness.md) ride the
    # same env ABI; a typo'd value must fail HERE, in the container
    # bootstrap, not silently disable the heartbeat (or the lease TTL)
    # and let the job hang the old way
    for key in ("DMLC_TRACKER_HEARTBEAT_MS", "DMLC_TRACKER_DEAD_AFTER_MS",
                "DMLC_TRACKER_RECOVER_GRACE_MS", "DMLC_TRACKER_NUM_SHARDS",
                "DMLC_TRACKER_LEASE_TTL_MS", "DMLC_ELASTIC_SHARDS"):
        if env.get(key):
            env_int(key, 0, env=env)  # raises RuntimeError on garbage

    if cluster == "sge" and "DMLC_TASK_ID" in env:
        # array jobs carry no role: first num_worker tasks are workers
        num_worker = env_int("DMLC_NUM_WORKER", 0, env=env)
        task_id = env_int("DMLC_TASK_ID", 0, env=env)
        env["DMLC_ROLE"] = "worker" if task_id < num_worker else "server"

    hadoop_home = env.get("HADOOP_HOME") or env.get("HADOOP_PREFIX")
    hdfs_home = env.get("HADOOP_HDFS_HOME")
    java_home = env.get("JAVA_HOME")

    library_path = ["./"]
    class_path: List[str] = []
    if hdfs_home:
        library_path.append(f"{hdfs_home}/lib/native")
        library_path.append(f"{hdfs_home}/lib")
    if hadoop_home:
        # classpath expansion needs only the hadoop CLI (reference
        # launcher.py gates it on HADOOP_HOME alone)
        if classpath_runner is None:
            def classpath_runner(cmd):  # pragma: no cover - needs hadoop
                return subprocess.run(cmd, shell=True, capture_output=True,
                                      text=True).stdout
        raw = classpath_runner(f"{hadoop_home}/bin/hadoop classpath")
        for part in (raw or "").strip().split(":"):
            class_path += glob.glob(part) if part else []
    if java_home:
        library_path.append(f"{java_home}/jre/lib/amd64/server")

    if class_path:
        prev = env.get("CLASSPATH", "")
        env["CLASSPATH"] = (prev + ":" if prev else "") + ":".join(class_path)

    if "DMLC_HDFS_OPTS" in env:
        env["LIBHDFS_OPTS"] = env["DMLC_HDFS_OPTS"]
    elif "LIBHDFS_OPTS" not in env:
        env["LIBHDFS_OPTS"] = "--Xmx128m"

    prev_ld = env.get("LD_LIBRARY_PATH", "")
    env["LD_LIBRARY_PATH"] = ((prev_ld + ":") if prev_ld else "") + \
        ":".join(library_path)
    return env


def main(argv: List[str] = None) -> int:
    """CLI entry: prepare the container env (archives, lib paths) and exec the
    user command."""
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        # nonzero so a launcher that interpolated an empty user command
        # fails loudly instead of "succeeding" without running anything
        print("Usage: python -m dmlc_core_tpu_torch.tracker.bootstrap <cmd...>",
              file=sys.stderr)
        return 1
    env = build_env(dict(os.environ))
    if "DMLC_JOB_ARCHIVES" in env:
        unzip_archives(env["DMLC_JOB_ARCHIVES"].split(":"), env)
    return subprocess.call(argv, env=env)


if __name__ == "__main__":
    sys.exit(main())
