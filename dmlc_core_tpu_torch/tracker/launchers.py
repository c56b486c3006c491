"""Cluster launch backends for dmlc-submit.

Rebuild of reference tracker/dmlc_tracker/{local,ssh,mpi,sge,slurm}.py plus
the new TPU-native `tpu-pod` backend (SURVEY §7 step 6, BASELINE.md north
star). Every backend is split into a pure command-builder (unit-testable
without a cluster) and a `submit(args)` that wires it into the rendezvous
tracker via run_job.

Env-var protocol carried to every worker (the de-facto ABI, SURVEY §2.4):
DMLC_TRACKER_URI/PORT, DMLC_NUM_WORKER/SERVER, DMLC_ROLE, DMLC_TASK_ID,
DMLC_JOB_CLUSTER, DMLC_NUM_ATTEMPT, DMLC_PS_ROOT_URI/PORT, DMLC_NODE_HOST,
DMLC_INTERFACE. The tpu-pod backend adds the JAX distributed trio
(JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID) so workers
can `jax.distributed.initialize()` with no arguments.

The port's own copy of ``dmlc_core_tpu/tracker/launchers.py`` (it imports nothing of
the JAX package): the same names, env variables, CLI flags and wire
bytes, so a worker of either package joins the other's tracker.
"""

from __future__ import annotations

import logging
import os
import subprocess
import sys
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from dmlc_core_tpu_torch.tracker import rendezvous

logger = logging.getLogger("dmlc_core_tpu_torch.tracker")

PASSTHROUGH_ENV_KEYS = [
    # reference ssh.py get_env keys
    "OMP_NUM_THREADS", "KMP_AFFINITY", "LD_LIBRARY_PATH",
    "AWS_ACCESS_KEY_ID", "AWS_SECRET_ACCESS_KEY", "DMLC_INTERFACE",
    # TPU additions
    "JAX_PLATFORMS", "TPU_WORKER_ID", "PYTHONPATH",
    # liveness knobs (doc/robustness.md): workers read these to open the
    # heartbeat channel; the tracker's worker_envs() also exports them,
    # but env-launched trackers (standalone/ssh) rely on pass-through
    "DMLC_TRACKER_HEARTBEAT_MS", "DMLC_TRACKER_DEAD_AFTER_MS",
    "DMLC_TRACKER_RECOVER_GRACE_MS", "DMLC_TRACKER_CLIENT_TIMEOUT",
]


def parse_host_file(path: str) -> List[Tuple[str, str]]:
    """Parse a host file into (host, ssh_port) pairs. Accepts `ip`,
    `ip:port`, and mpi-style `ip slots=N` lines (reference ssh.py:38-60)."""
    hosts: List[Tuple[str, str]] = []
    with open(path) as f:
        for raw in f:
            h = raw.strip()
            if not h or h.startswith("#"):
                continue
            i = h.find("slots=")
            if i != -1:
                h = h[:i].strip()
            port = "22"
            if ":" in h:
                h, port = h.rsplit(":", 1)
            hosts.append((h, port))
    if not hosts:
        raise ValueError(f"host file {path} contains no hosts")
    return hosts


def export_prefix(envs: Dict[str, object],
                  passthrough: Sequence[str] = PASSTHROUGH_ENV_KEYS) -> str:
    """`export K=V; ...` shell prefix (reference ssh.py get_env)."""
    parts = []
    for k in passthrough:
        v = os.getenv(k)
        if v is not None:
            parts.append(f"export {k}={v};")
    for k, v in envs.items():
        parts.append(f"export {k}={v};")
    return " ".join(parts)


def inline_env(envs: Dict[str, object]) -> str:
    """`K=V K=V` command prefix (reference slurm.py get_mpi_env)."""
    return " ".join(f"{k}={v}" for k, v in envs.items())


# -- local -------------------------------------------------------------------
def submit_local(args) -> None:
    """Local backend under WorkerSupervisor: worker exit is detected and
    the task relaunched under its old id (the restarted worker rejoins the
    tracker with cmd=recover) — AppMaster-style supervision instead of the
    reference's in-line retry loop (local.py:12-49). With liveness enabled
    the supervisor is wired to the tracker both ways: dead ranks trigger a
    proactive relaunch, exhausted attempts abort the job.

    ``--mesh`` switches supervision from per-task to per-WORLD
    (doc/robustness.md "Elastic mesh training"): a torch.distributed world
    cannot admit a single relaunched rank mid-flight, so any worker death
    aborts the tracker (max_attempts=0, no proactive relaunch) and
    run_job relaunches the whole world — fresh tracker + coordinator
    ports, every rank restarted together — resuming from the last
    committed job checkpoint."""
    from dmlc_core_tpu_torch.tracker.supervisor import (WorkerSupervisor,
                                                  popen_start_fn)
    mesh = bool(getattr(args, "mesh", False))

    def launch(nworker: int, nserver: int, envs: Dict[str, object],
               tracker=None):
        sup = WorkerSupervisor(
            max_attempts=0 if mesh else args.num_attempt)
        for i in range(nworker + nserver):
            role = "worker" if i < nworker else "server"
            sup.add(i, role, popen_start_fn(args.command, role, i,
                                            dict(envs)))
        if tracker is not None:
            # mesh worlds never relaunch a single rank in place — the
            # supervisor's only job is fail-fast world teardown
            sup.attach_tracker(tracker,
                               proactive_relaunch=False if mesh else None)
        sup.launch()  # spawn errors raise here, in the submitting caller
        sup.watch_in_thread()
        # run_job invokes this stopper before a world relaunch so the old
        # attempt's surviving processes die before the new world binds
        return sup.stop

    rendezvous.run_job(args.num_workers, args.num_servers, launch,
                       host_ip=args.host_ip or "auto",
                       ps_cmd=" ".join(args.command),
                       mesh=mesh,
                       world_attempts=getattr(args, "world_attempts", None))


# -- ssh ---------------------------------------------------------------------
def build_ssh_commands(hosts: List[Tuple[str, str]], command: Sequence[str],
                       nworker: int, nserver: int, envs: Dict[str, object],
                       working_dir: str) -> List[str]:
    """One ssh command per host exporting the DMLC env before the worker
    command."""
    cmds = []
    for i in range(nworker + nserver):
        e = dict(envs)
        e["DMLC_ROLE"] = "server" if i < nserver else "worker"
        node, port = hosts[i % len(hosts)]
        e["DMLC_NODE_HOST"] = node
        inner = (export_prefix(e) + f" cd {working_dir}; " +
                 " ".join(command))
        cmds.append("ssh -o StrictHostKeyChecking=no " + node +
                    " -p " + port + " '" + inner + "'")
    return cmds


def submit_ssh(args) -> None:
    """cluster=ssh backend: spawn one ssh-launched worker per host-file entry."""
    hosts = parse_host_file(args.host_file)

    def launch(nworker: int, nserver: int, envs: Dict[str, object]) -> None:
        local_dir = os.getcwd() + "/"
        working_dir = local_dir
        if args.sync_dst_dir not in (None, "None"):
            working_dir = args.sync_dst_dir
            for node, port in hosts:  # rsync workdir (reference sync_dir)
                subprocess.check_call(
                    f'rsync -az --rsh="ssh -o StrictHostKeyChecking=no '
                    f'-p {port}" {local_dir} {node}:{working_dir}',
                    shell=True)
        for prog in build_ssh_commands(hosts, args.command, nworker, nserver,
                                       envs, working_dir):
            threading.Thread(
                target=lambda p=prog: subprocess.check_call(p, shell=True),
                daemon=True).start()

    rendezvous.run_job(args.num_workers, args.num_servers, launch,
                       host_ip=args.host_ip or "auto",
                       ps_cmd=" ".join(args.command))


# -- mpi ---------------------------------------------------------------------
def mpi_env_flags(envs: Dict[str, object], mpi_version_text: str) -> str:
    """-x K=V (OpenMPI) or -env K V (MPICH) flags (reference mpi.py:12-37)."""
    if "Open MPI" in mpi_version_text:
        return " ".join(f"-x {k}={v}" for k, v in envs.items())
    if "mpich" in mpi_version_text.lower():
        return " ".join(f"-env {k} {v}" for k, v in envs.items())
    raise RuntimeError("Unknown MPI version: " + mpi_version_text[:80])


def build_mpi_command(command: Sequence[str], n: int,
                      envs: Dict[str, object], mpi_version_text: str,
                      host_file: Optional[str] = None) -> str:
    """mpirun/mpiexec invocation carrying the DMLC env (OpenMPI -x / MPICH
    -env dialects)."""
    cmd = f"--hostfile {host_file} " if host_file else ""
    return (f"mpirun -n {n} {mpi_env_flags(envs, mpi_version_text)} "
            f"{cmd}{' '.join(command)}")


def submit_mpi(args) -> None:
    """cluster=mpi backend: run the job under mpirun against the rendezvous
    tracker."""
    out, _ = subprocess.Popen(["mpirun", "--version"],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE).communicate()
    version = out.decode(errors="replace")

    def launch(nworker: int, nserver: int, envs: Dict[str, object]) -> None:
        envs = dict(envs, DMLC_JOB_CLUSTER="mpi")
        for role, n in (("worker", nworker), ("server", nserver)):
            if n == 0:
                continue
            prog = build_mpi_command(args.command, n,
                                     dict(envs, DMLC_ROLE=role), version,
                                     args.host_file)
            threading.Thread(
                target=lambda p=prog: subprocess.check_call(p, shell=True),
                daemon=True).start()

    rendezvous.run_job(args.num_workers, args.num_servers, launch,
                       host_ip=args.host_ip or "auto",
                       ps_cmd=" ".join(args.command))


# -- sge ---------------------------------------------------------------------
def build_sge_script() -> str:
    # the in-container bootstrap derives DMLC_ROLE from DMLC_TASK_ID for
    # array jobs (reference launcher.py:44-49) before exec'ing the command.
    # SGE_TASK_ID is 1-based (qsub -t 1-N); DMLC_TASK_ID is 0-based
    # everywhere else in this tracker, so shift here.
    """SGE array-job script body; $SGE_TASK_ID maps to DMLC_TASK_ID."""
    return ("source ~/.bashrc\n"
            "export DMLC_TASK_ID=$((SGE_TASK_ID - 1))\n"
            "export DMLC_JOB_CLUSTER=sge\n"
            'python3 -m dmlc_core_tpu_torch.tracker.bootstrap "$@"\n')


def build_sge_command(args, ntask: int, envs: Dict[str, object],
                      runscript: str) -> str:
    """qsub invocation submitting the generated SGE array-job script."""
    env_arg = ",".join(f'{k}="{v}"' for k, v in envs.items())
    cmd = f"qsub -cwd -t 1-{ntask} -S /bin/bash"
    if args.queue != "default":
        cmd += f" -q {args.queue}"
    cmd += f" -N {args.jobname}"
    cmd += f" -e {args.log_dir} -o {args.log_dir}"
    cmd += f" -pe orte {args.vcores}"
    cmd += f" -v {env_arg},PATH=${{PATH}}:."
    cmd += f" {runscript} {' '.join(args.command)}"
    return cmd


def submit_sge(args) -> None:
    """cluster=sge backend: submit an array job per role via qsub."""
    if args.jobname is None:
        args.jobname = (f"dmlc{args.num_workers}." +
                        args.command[0].split("/")[-1])
    os.makedirs(args.log_dir, exist_ok=True)
    runscript = os.path.join(args.log_dir, "rundmlc.sh")
    with open(runscript, "w") as f:
        f.write(build_sge_script())

    def launch(nworker: int, nserver: int, envs: Dict[str, object]) -> None:
        cmd = build_sge_command(args, nworker + nserver, envs, runscript)
        logger.info("%s", cmd)
        subprocess.check_call(cmd, shell=True)

    rendezvous.run_job(args.num_workers, args.num_servers, launch,
                       host_ip=args.host_ip or "auto",
                       ps_cmd=" ".join(args.command))


# -- slurm -------------------------------------------------------------------
def build_slurm_command(command: Sequence[str], n: int, nodes: int,
                        envs: Dict[str, object]) -> str:
    """srun invocation carrying the DMLC env (one task per worker)."""
    return (f"{inline_env(envs)} srun --share --exclusive=user -N {nodes} "
            f"-n {n} {' '.join(command)}")


def submit_slurm(args) -> None:
    """cluster=slurm backend: srun workers against the rendezvous tracker."""
    def launch(nworker: int, nserver: int, envs: Dict[str, object]) -> None:
        envs = dict(envs, DMLC_JOB_CLUSTER="slurm")
        for role, n, nodes in (
                ("worker", nworker, args.slurm_worker_nodes or nworker),
                ("server", nserver, args.slurm_server_nodes or nserver)):
            if n == 0:
                continue
            prog = build_slurm_command(args.command, n, nodes,
                                       dict(envs, DMLC_ROLE=role))
            threading.Thread(
                target=lambda p=prog: subprocess.check_call(p, shell=True),
                daemon=True).start()

    rendezvous.run_job(args.num_workers, args.num_servers, launch,
                       host_ip=args.host_ip or "auto",
                       ps_cmd=" ".join(args.command))


# -- tpu-pod -----------------------------------------------------------------
def build_tpu_pod_env(host_index: int, hosts: List[Tuple[str, str]],
                      coordinator_port: int, envs: Dict[str, object]
                      ) -> Dict[str, object]:
    """Per-host env for a TPU pod slice: process_id = host index, coordinator
    = host 0. Workers call jax.distributed.initialize() with no args (or
    dmlc_core_tpu_torch.parallel.init_from_env) and shard input with
    InputSplit(part=JAX_PROCESS_ID, nsplit=JAX_NUM_PROCESSES) — the
    TPU-native replacement for the Rabit socket rendezvous (SURVEY §5)."""
    e = dict(envs)
    e["DMLC_ROLE"] = "worker"
    e["DMLC_TASK_ID"] = host_index
    e["DMLC_JOB_CLUSTER"] = "tpu-pod"
    e["DMLC_NODE_HOST"] = hosts[host_index][0]
    e["JAX_COORDINATOR_ADDRESS"] = f"{hosts[0][0]}:{coordinator_port}"
    e["JAX_NUM_PROCESSES"] = len(hosts)
    e["JAX_PROCESS_ID"] = host_index
    return e


def build_tpu_pod_commands(hosts: List[Tuple[str, str]],
                           command: Sequence[str],
                           envs: Dict[str, object],
                           coordinator_port: int = 8476,
                           working_dir: str = ".") -> List[str]:
    """Per-host launch commands for a TPU pod slice (local exec or ssh), env
    from build_tpu_pod_env."""
    cmds = []
    for i, (node, port) in enumerate(hosts):
        e = build_tpu_pod_env(i, hosts, coordinator_port, envs)
        inner = (export_prefix(e) + f" cd {working_dir}; " +
                 " ".join(command))
        if node in ("localhost", "127.0.0.1") and port == "local":
            cmds.append(inner)
        else:
            cmds.append("ssh -o StrictHostKeyChecking=no " + node +
                        " -p " + port + " '" + inner + "'")
    return cmds


def submit_tpu_pod(args) -> None:
    """Launch one process per pod-slice host; no socket tracker is needed —
    JAX's coordination service (host 0) is the rendezvous."""
    if args.host_file:
        hosts = parse_host_file(args.host_file)
        if args.num_workers and args.num_workers != len(hosts):
            raise SystemExit(
                f"tpu-pod: --num-workers={args.num_workers} does not match "
                f"{len(hosts)} hosts in {args.host_file} (one process per "
                f"pod-slice host)")
    else:
        # single-host slice (or local simulation): spawn workers locally
        hosts = [("localhost", "local")] * args.num_workers
    working_dir = args.sync_dst_dir or os.getcwd()
    if args.sync_dst_dir not in (None, "None") and args.host_file:
        local_dir = os.getcwd() + "/"
        for node, port in hosts:  # ship the workdir like submit_ssh
            subprocess.check_call(
                f'rsync -az --rsh="ssh -o StrictHostKeyChecking=no '
                f'-p {port}" {local_dir} {node}:{working_dir}',
                shell=True)
    envs = {"DMLC_NUM_WORKER": len(hosts), "DMLC_NUM_SERVER": 0}
    cmds = build_tpu_pod_commands(hosts, args.command, envs,
                                  args.coordinator_port, working_dir)
    threads = []
    for i, prog in enumerate(cmds):
        # localhost simulation needs per-process env rather than ssh export
        t = threading.Thread(
            target=lambda p=prog: subprocess.check_call(
                p, shell=True, executable="/bin/bash"),
            daemon=True)
        t.start()
        threads.append(t)
    for t in threads:
        t.join()


# -- kubernetes --------------------------------------------------------------
def build_kube_manifest(args, role: str, count: int,
                        envs: Dict[str, object]) -> Dict[str, object]:
    """One indexed Job per role (reference kubernetes.py submits a
    manifest-template job per role). Emitted as a JSON-compatible dict —
    kubectl accepts JSON manifests, so no yaml dependency is needed. The
    DMLC_TASK_ID comes from the pod's completion index; TPU pods add
    google.com/tpu resources + the GKE tpu nodeSelector pair."""
    image = (args.kube_worker_image if role == "worker"
             else args.kube_server_image)
    mem = (args.worker_memory_mb if role == "worker"
           else args.server_memory_mb)
    cores = args.worker_cores if role == "worker" else args.server_cores
    env_list = [{"name": k, "value": str(v)} for k, v in envs.items()]
    env_list += [
        {"name": "DMLC_ROLE", "value": role},
        {"name": "DMLC_JOB_CLUSTER", "value": "kubernetes"},
        {"name": "DMLC_TASK_ID",
         "valueFrom": {"fieldRef": {
             "fieldPath":
                 "metadata.annotations['batch.kubernetes.io/job-completion-index']"}}},
    ]
    resources: Dict[str, object] = {
        "requests": {"memory": f"{mem}Mi", "cpu": str(cores)},
        "limits": {"memory": f"{mem}Mi"},
    }
    spec: Dict[str, object] = {
        "containers": [{
            "name": f"dmlc-{role}",
            "image": image,
            "command": list(args.command),
            "env": env_list,
            "resources": resources,
        }],
        "restartPolicy": "Never",
    }
    if args.kube_tpu_type:
        # chip count is independent of the cpu request: explicit flag, else
        # the product of the topology dims (2x4 -> 8)
        chips = args.kube_tpu_chips
        if chips is None and args.kube_tpu_topology:
            dims = args.kube_tpu_topology.lower().split("x")
            chips = 1
            for d in dims:
                chips *= int(d)
        if chips is None:
            raise SystemExit(
                "kubernetes: pass --kube-tpu-chips or --kube-tpu-topology "
                "with --kube-tpu-type")
        resources["limits"] = dict(resources["limits"],
                                   **{"google.com/tpu": str(chips)})
        resources["requests"] = dict(resources["requests"],
                                     **{"google.com/tpu": str(chips)})
        selector = {"cloud.google.com/gke-tpu-accelerator": args.kube_tpu_type}
        if args.kube_tpu_topology:
            selector["cloud.google.com/gke-tpu-topology"] = \
                args.kube_tpu_topology
        spec["nodeSelector"] = selector
    return {
        "apiVersion": "batch/v1",
        "kind": "Job",
        "metadata": {
            "name": f"{args.jobname}-{role}",
            "namespace": args.kube_namespace,
            "labels": {"app": "dmlc", "dmlc-job": args.jobname},
        },
        "spec": {
            "completions": count,
            "parallelism": count,
            "completionMode": "Indexed",
            "backoffLimit": max(int(args.num_attempt), 0) * count,
            "template": {
                "metadata": {"labels": {"app": "dmlc",
                                        "dmlc-job": args.jobname,
                                        "dmlc-role": role}},
                "spec": spec,
            },
        },
    }


def submit_kubernetes(args) -> None:
    """Reference tracker/dmlc_tracker/kubernetes.py: template a Job per role
    and submit; the rendezvous tracker runs here and pods dial back via
    DMLC_TRACKER_URI (which must be reachable from the cluster — pass
    --host-ip)."""
    import json

    if args.jobname is None:
        args.jobname = f"dmlc-{args.command[0].split('/')[-1]}"
    args.jobname = args.jobname.replace("_", "-").replace(".", "-").lower()

    def launch(nworker: int, nserver: int, envs: Dict[str, object]) -> None:
        manifests = []
        if nserver:
            manifests.append(build_kube_manifest(args, "server", nserver,
                                                 envs))
        if nworker:
            manifests.append(build_kube_manifest(args, "worker", nworker,
                                                 envs))
        payload = json.dumps({"apiVersion": "v1", "kind": "List",
                              "items": manifests}, indent=2)
        if args.kube_dry_run:
            print(payload)
            return
        # supervised submission (AppMaster parity): each role Job is a
        # CommandTask — failed Jobs are deleted + re-applied up to
        # --num-attempt times; restarted pods rejoin via cmd=recover
        from dmlc_core_tpu_torch.tracker.supervisor import (CommandTask,
                                                      WorkerSupervisor)
        kubectl = getattr(args, "kubectl", None) or "kubectl"
        # CLI-polled supervision: each poll execs `kubectl get` against the
        # API server, and Job state changes on minute timescales — poll
        # seconds apart, not the local-Popen default
        sup = WorkerSupervisor(max_attempts=args.num_attempt,
                               poll_interval=5.0)
        for i, m in enumerate(manifests):
            name = m["metadata"]["name"]
            one = json.dumps(m, indent=2)
            # emit every condition as "Type=Status" — Complete/Failed may
            # not be conditions[0] (k8s appends SuccessCriteriaMet /
            # FailureTarget first on recent versions)
            status_path = ("jsonpath={range .status.conditions[*]}"
                           "{.type}={.status} {end}")

            def start(attempt, one=one, name=name):
                if attempt > 0:  # tear down the failed incarnation first
                    subprocess.run([kubectl, "delete", "job", name,
                                    "--ignore-not-found=true"],
                                   capture_output=True)
                return CommandTask(
                    submit_cmd=[kubectl, "apply", "-f", "-"],
                    submit_input=one,
                    status_cmd=[kubectl, "get", "job", name, "-o",
                                status_path],
                    succeeded_text="Complete=True",
                    failed_text="Failed=True",
                    delete_cmd=[kubectl, "delete", "job", name,
                                "--ignore-not-found=true"])

            role = m["spec"]["template"]["metadata"]["labels"]["dmlc-role"]
            sup.add(i, role, start)
        sup.launch()  # submission errors (RBAC, kubeconfig) raise here
        sup.watch_in_thread()

    if args.kube_dry_run:
        # no tracker: render manifests with placeholder rendezvous env and
        # return immediately (nothing listens, nothing leaks)
        launch(args.num_workers, args.num_servers, {
            "DMLC_TRACKER_URI": args.host_ip or "<tracker-host>",
            "DMLC_TRACKER_PORT": 9091,
            "DMLC_NUM_WORKER": args.num_workers,
            "DMLC_NUM_SERVER": args.num_servers,
        })
        return

    rendezvous.run_job(args.num_workers, args.num_servers, launch,
                       host_ip=args.host_ip or "auto",
                       ps_cmd=" ".join(args.command))


# -- yarn --------------------------------------------------------------------
def build_yarn_command(args, role: str, n: int,
                       envs: Dict[str, object],
                       attempt: int = 0) -> List[str]:
    """Reference yarn.py ships a Java AppMaster jar (tracker/yarn/) that
    allocates one container per task and restarts failed tasks. This build
    has no Java component; the same contract is expressed as one `yarn jar
    <distributed-shell>` submission *per role* (like the mpi/slurm backends)
    carrying the DMLC_* env protocol, with container count/memory/cores
    mapped onto -num_containers/-container_*. The attempt number is baked
    into -appname so supervision status for a relaunch never reads the
    previous incarnation's retained FINISHED/FAILED record (YARN keeps
    completed apps in `-list -appStates ALL`)."""
    e = dict(envs)
    e["DMLC_ROLE"] = role
    e["DMLC_JOB_CLUSTER"] = "yarn"
    e["DMLC_NUM_ATTEMPT"] = attempt
    if getattr(args, "archives", None):
        e["DMLC_JOB_ARCHIVES"] = ":".join(args.archives)
    shell_env = []
    for k, v in e.items():
        shell_env += ["-shell_env", f"{k}={v}"]
    mem = args.worker_memory_mb if role == "worker" else args.server_memory_mb
    cores = args.worker_cores if role == "worker" else args.server_cores
    jar = os.getenv("DMLC_YARN_SHELL_JAR",
                    "hadoop-yarn-applications-distributedshell.jar")
    cmd = [os.getenv("DMLC_YARN_BIN", "yarn"), "jar", jar,
           "-jar", jar,
           "-appname", f"{args.jobname or 'dmlc-job'}-{role}-a{attempt}",
           "-num_containers", str(n),
           "-container_memory", str(mem),
           "-container_vcores", str(cores)]
    cmd += shell_env
    # bootstrap extends LD_LIBRARY_PATH/CLASSPATH from HADOOP_HOME and
    # unpacks DMLC_JOB_ARCHIVES inside the container (reference launcher.py)
    cmd += ["-shell_command",
            "python3 -m dmlc_core_tpu_torch.tracker.bootstrap " +
            " ".join(args.command)]
    return cmd


def submit_yarn(args) -> None:
    """Supervised submission (AppMaster parity, mirroring the kubernetes
    path): each role is a CommandTask — the distributedshell client runs
    async in the foreground, application state is polled from
    `yarn application -list` filtered to this app's name, and a FAILED
    final state kills + resubmits up to --num-attempt times."""
    from dmlc_core_tpu_torch.tracker.supervisor import CommandTask, WorkerSupervisor

    ybin = os.getenv("DMLC_YARN_BIN", "yarn")

    def kill_cmd_for(name: str) -> List[str]:
        # real YARN kills by application id; resolve it from the list
        # output by app name (column 2) at kill time
        return ["bash", "-lc",
                f"id=$({ybin} application -list -appStates ALL 2>/dev/null"
                f" | awk -v n='{name}' '$2==n {{print $1; exit}}');"
                f" [ -n \"$id\" ] && {ybin} application -kill \"$id\""
                f" || true"]

    def launch(nworker: int, nserver: int, envs: Dict[str, object]) -> None:
        sup = WorkerSupervisor(max_attempts=args.num_attempt,
                               poll_interval=5.0)
        roles = [(r, n) for r, n in (("server", nserver),
                                     ("worker", nworker)) if n]
        base = args.jobname or "dmlc-job"
        for i, (role, n) in enumerate(roles):

            def start(attempt, role=role, n=n):
                # the per-attempt -appname means a relaunch polls ONLY its
                # own application; the failed incarnation was already torn
                # down by the supervisor's terminate() (delete_cmd below)
                name = f"{base}-{role}-a{attempt}"
                cmd = build_yarn_command(args, role, n, envs, attempt)
                logger.info("%s", " ".join(cmd))
                return CommandTask(
                    submit_cmd=cmd,
                    status_cmd=[ybin, "application", "-list",
                                "-appStates", "ALL"],
                    status_filter=name,
                    succeeded_text="SUCCEEDED", failed_text="FAILED",
                    delete_cmd=kill_cmd_for(name),
                    submit_async=True)

            sup.add(i, role, start)
        sup.launch()
        sup.watch_in_thread()

    rendezvous.run_job(args.num_workers, args.num_servers, launch,
                       host_ip=args.host_ip or "auto",
                       ps_cmd=" ".join(args.command))


# -- mesos -------------------------------------------------------------------
def build_mesos_command(args, role: str, n: int,
                        envs: Dict[str, object],
                        attempt: int = 0) -> List[str]:
    """Reference mesos.py registers a framework that launches one task per
    worker/server; expressed here as `mesos-execute` task groups against
    --mesos-master with the env protocol inlined. The attempt number is
    baked into the task name so each incarnation's status is observable
    independently in the master's /tasks feed (mesos task names are not
    unique; a relaunch must not read its predecessor's FAILED record)."""
    e = dict(envs)
    e["DMLC_ROLE"] = role
    e["DMLC_JOB_CLUSTER"] = "mesos"
    e["DMLC_NUM_ATTEMPT"] = attempt
    mem = args.worker_memory_mb if role == "worker" else args.server_memory_mb
    cores = args.worker_cores if role == "worker" else args.server_cores
    master = args.mesos_master or os.getenv("MESOS_MASTER")
    if not master:
        raise SystemExit("mesos: pass --mesos-master or set MESOS_MASTER")
    return [os.getenv("DMLC_MESOS_EXECUTE", "mesos-execute"),
            f"--master={master}",
            f"--name=dmlc-{role}-a{attempt}",
            f"--instances={n}",
            f"--resources=cpus:{cores};mem:{mem}",
            "--command=" + inline_env(e) + " " + " ".join(args.command)]


def submit_mesos(args) -> None:
    """Supervised submission: mesos-execute owns the framework and stays in
    the foreground, so it runs async under a CommandTask whose status is
    the master's /tasks REST feed (tracker/mesos_status.py), normalized to
    SUCCEEDED/FAILED; a failed incarnation's client is torn down and the
    group resubmitted under the next attempt's task name."""
    from dmlc_core_tpu_torch.tracker.supervisor import CommandTask, WorkerSupervisor

    master = args.mesos_master or os.getenv("MESOS_MASTER")

    def launch(nworker: int, nserver: int, envs: Dict[str, object]) -> None:
        sup = WorkerSupervisor(max_attempts=args.num_attempt,
                               poll_interval=5.0)
        roles = [(r, n) for r, n in (("server", nserver),
                                     ("worker", nworker)) if n]
        for i, (role, n) in enumerate(roles):

            def start(attempt, role=role, n=n):
                cmd = build_mesos_command(args, role, n, envs, attempt)
                logger.info("%s", " ".join(cmd))
                return CommandTask(
                    submit_cmd=cmd,
                    status_cmd=[sys.executable, "-m",
                                "dmlc_core_tpu_torch.tracker.mesos_status",
                                str(master), f"dmlc-{role}-a{attempt}"],
                    succeeded_text="SUCCEEDED", failed_text="FAILED",
                    submit_async=True)

            sup.add(i, role, start)
        sup.launch()
        sup.watch_in_thread()

    rendezvous.run_job(args.num_workers, args.num_servers, launch,
                       host_ip=args.host_ip or "auto",
                       ps_cmd=" ".join(args.command))


BACKENDS = {
    "local": submit_local,
    "ssh": submit_ssh,
    "mpi": submit_mpi,
    "sge": submit_sge,
    "slurm": submit_slurm,
    "tpu-pod": submit_tpu_pod,
    "kubernetes": submit_kubernetes,
    "yarn": submit_yarn,
    "mesos": submit_mesos,
}
