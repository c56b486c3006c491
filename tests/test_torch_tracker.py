"""The port's job tracker against the reference's.

Both packages' ``tracker`` modules on the same inputs: topology maps for
1-64 workers; the wire helpers; workers of each package joining the other
package's ``RabitTracker`` (the same ranks, parents, rings and links, the
same lease grants for a ``(num_shards, epoch)``, recovery of a dropped
worker under its old rank); ``opts.get_opts`` over a table of argv; every
backend's command builder and the kube manifest (the bootstrap command
names each package's own module, the rest is equal byte for byte);
``bootstrap.build_env`` and ``mesos_status.group_state``;
``WorkerSupervisor`` relaunch and abort with short ``sys.executable -c``
tasks; ``PSTracker`` and ``start_standalone_tracker``.
"""

import argparse
import os
import shlex
import socket
import subprocess
import sys
import threading
import time

import pytest

from dmlc_core_tpu.tracker import bootstrap as ref_bootstrap
from dmlc_core_tpu.tracker import launchers as ref_launchers
from dmlc_core_tpu.tracker import mesos_status as ref_mesos
from dmlc_core_tpu.tracker import opts as ref_opts
from dmlc_core_tpu.tracker import rendezvous as ref_rdv
from dmlc_core_tpu.tracker import supervisor as ref_sup
from dmlc_core_tpu.tracker import topology as ref_topology
from dmlc_core_tpu.tracker import wire as ref_wire
from dmlc_core_tpu.tracker.client import RendezvousClient as RefClient

from dmlc_core_tpu_torch import tracker
from dmlc_core_tpu_torch.tracker import (bootstrap, launchers, mesos_status,
                                         opts, rendezvous, supervisor,
                                         topology, wire)
from dmlc_core_tpu_torch.tracker.client import RendezvousClient

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_PKG, REF_PKG = "dmlc_core_tpu_torch", "dmlc_core_tpu"


def test_tracker_metrics_render_as_the_references():
    """The tracker's, the leases' and the elastic world's metrics carry
    the reference's HELP lines, so a scrape of the port's tracker is the
    reference's exposition."""
    from dmlc_core_tpu import telemetry as ref_tel
    from dmlc_core_tpu_torch import telemetry as tel
    names = [n for n in ref_tel.METRIC_HELP if n.startswith(
        ("tracker_", "lease_", "mesh_")) or n == "device_abort_drains_total"]
    assert len(names) == 19
    for n in names:
        assert tel.METRIC_HELP[n] == ref_tel.METRIC_HELP[n], n


def test_package_exports_are_the_references():
    import dmlc_core_tpu.tracker as ref_tracker
    assert tracker.__all__ == ref_tracker.__all__
    assert tracker.RabitTracker is rendezvous.RabitTracker


@pytest.mark.parametrize("n", range(1, 65))
def test_topology_maps_equal(n):
    assert topology.build_link_maps(n) == ref_topology.build_link_maps(n)
    assert topology.build_tree(n) == ref_topology.build_tree(n)


def test_wire_constants_and_helpers_equal(monkeypatch):
    for name in ("MAGIC", "CMD_HEARTBEAT", "HEARTBEAT_PING", "HEARTBEAT_BYE",
                 "HEARTBEAT_ABORT", "LEASE_ACQUIRE", "LEASE_RELEASE",
                 "LEASE_COMPLETE", "LEASE_GRANT", "LEASE_EMPTY",
                 "LEASE_DRAINED", "TELEMETRY_PULL", "TELEMETRY_PUSH",
                 "TELEMETRY_PUSH_MAX", "CHANNEL_COMMAND_WORDS",
                 "CHANNEL_SENTINELS"):
        assert getattr(wire, name) == getattr(ref_wire, name), name
    for host in ("127.0.0.1", "localhost", "::1"):
        assert wire.resolve_ip(host) == ref_wire.resolve_ip(host)
        assert wire.addr_family(wire.resolve_ip(host)) == \
            ref_wire.addr_family(ref_wire.resolve_ip(host))
    for arg in (None, "127.0.0.1", "auto"):
        assert wire.guess_host_ip(arg) == ref_wire.guess_host_ip(arg)
    monkeypatch.setenv("DMLC_X", "b")
    assert wire.env_enum("DMLC_X", ("a", "b")) == \
        ref_wire.env_enum("DMLC_X", ("a", "b")) == "b"
    monkeypatch.setenv("DMLC_X", "zz")
    with pytest.raises(RuntimeError) as p:
        wire.env_enum("DMLC_X", ("a", "b"))
    with pytest.raises(RuntimeError) as r:
        ref_wire.env_enum("DMLC_X", ("a", "b"))
    assert str(p.value) == str(r.value)
    e = wire.TrackerAbortedError("gone", [3, 1])
    f = ref_wire.TrackerAbortedError("gone", [3, 1])
    assert (str(e), e.reason, e.dead_ranks) == (str(f), f.reason,
                                                 f.dead_ranks)


def test_wire_socket_and_bind_free_port_talk_to_the_reference():
    s = wire.bind_free_port("127.0.0.1", 9091, 9999)
    s.listen(1)
    port = s.getsockname()[1]
    c = socket.create_connection(("127.0.0.1", port))
    a, _ = s.accept()
    mine, theirs = wire.WireSocket(a), ref_wire.WireSocket(c)
    mine.send_int(-86)
    mine.send_str("héllo")
    assert theirs.recv_int() == -86 and theirs.recv_str() == "héllo"
    theirs.send_str("back")
    assert mine.recv_str() == "back"
    for x in (mine, theirs):
        x.close()
    s.close()


# -- workers of one package against the other's tracker ----------------------
def _world(tracker_cls, client_cls, n, num_shards=0, epoch=0):
    """n client threads of ``client_cls`` against a ``tracker_cls``; each
    takes its assignment and, on an elastic tracker, drains the epoch's
    leases. Returns ({rank: (parent, world, tree, prev, next, links)},
    {rank: [shards granted]})."""
    trk = tracker_cls("127.0.0.1", n, heartbeat_ms=100, dead_after_ms=3000,
                      num_shards=num_shards)
    trk.start()
    out, grants, errors = {}, {}, []
    go = threading.Barrier(n)

    def worker():
        try:
            c = client_cls("127.0.0.1", trk.port)
            a = c.start(heartbeat=num_shards > 0)
            out[a.rank] = (a.parent, a.world_size, sorted(a.tree_neighbors),
                           a.ring_prev, a.ring_next, sorted(a.links))
            got = []
            if num_shards:
                go.wait(timeout=30)
                # one shard at a time, in rank order, so the grant
                # sequence does not depend on thread timing
                for _ in range(num_shards):
                    while len(sum(grants.values(), [])) % n != a.rank:
                        time.sleep(0.001)
                        if len(sum(grants.values(), [])) >= num_shards:
                            break
                    shard = c.heartbeat.acquire_lease(epoch, timeout=30)
                    if shard is None:
                        break
                    got.append(shard)
                    grants[a.rank] = got
                    c.heartbeat.complete_lease(epoch, shard)
            for ws in a.links.values():
                ws.close()
            c.shutdown(a.rank)
        except Exception as e:  # surfaced below
            errors.append(e)

    ths = [threading.Thread(target=worker) for _ in range(n)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=60)
    trk.join(timeout=30)
    assert not errors, errors
    return out, grants


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_cross_package_rendezvous_assignments(n):
    want, _ = _world(ref_rdv.RabitTracker, RefClient, n)
    assert sorted(want) == list(range(n))
    assert _world(ref_rdv.RabitTracker, RendezvousClient, n)[0] == want
    assert _world(rendezvous.RabitTracker, RefClient, n)[0] == want
    assert _world(rendezvous.RabitTracker, RendezvousClient, n)[0] == want


@pytest.mark.parametrize("num_shards,epoch", [(6, 0), (9, 2)])
def test_cross_package_lease_grants(num_shards, epoch):
    want = _world(ref_rdv.RabitTracker, RefClient, 2, num_shards, epoch)[1]
    assert sorted(sum(want.values(), [])) == list(range(num_shards))
    for trk, cl in ((ref_rdv.RabitTracker, RendezvousClient),
                    (rendezvous.RabitTracker, RefClient),
                    (rendezvous.RabitTracker, RendezvousClient)):
        assert _world(trk, cl, 2, num_shards, epoch)[1] == want


@pytest.mark.parametrize("tracker_cls,client_cls", [
    (rendezvous.RabitTracker, RefClient),
    (ref_rdv.RabitTracker, RendezvousClient)])
def test_cross_package_recover_after_a_dropped_worker(tracker_cls,
                                                      client_cls):
    """A worker drops and a new one recovers under its old rank; the
    survivor re-requests its links (the two-sided recovery of the
    reference's protocol)."""
    trk = tracker_cls("127.0.0.1", 2)
    trk.start()
    first = {}

    def initial():
        a = client_cls("127.0.0.1", trk.port).start()
        first[a.rank] = a

    ths = [threading.Thread(target=initial) for _ in range(2)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=20)
    for ws in first[1].links.values():
        ws.close()  # rank 1 is gone
    recovered = {}

    def recover(rank):
        recovered[rank] = client_cls("127.0.0.1", trk.port).start(
            rank=rank, recover=True)

    th1 = threading.Thread(target=recover, args=(1,))
    th1.start()
    time.sleep(0.2)
    th0 = threading.Thread(target=recover, args=(0,))
    th0.start()
    th1.join(timeout=20)
    th0.join(timeout=20)
    assert sorted(recovered[1].links) == [0]
    assert sorted(recovered[0].links) == [1]
    for r in (0, 1):
        client_cls("127.0.0.1", trk.port).shutdown(r)
    trk.join(timeout=20)
    assert [e["event"] for e in trk.events].count("recover") == 2


def test_worker_envs_and_state_match():
    got = rendezvous.RabitTracker("127.0.0.1", 3, heartbeat_ms=100,
                                  num_shards=4)
    want = ref_rdv.RabitTracker("127.0.0.1", 3, heartbeat_ms=100,
                                num_shards=4)
    try:
        g, w = got.worker_envs(), want.worker_envs()
        assert g.pop("DMLC_TRACKER_PORT") != w.pop("DMLC_TRACKER_PORT")
        assert g == w
        gs, ws = got.state(), want.state()
        assert gs.pop("port") != ws.pop("port")
        assert gs == ws
    finally:
        got.stop()
        want.stop()


# -- opts, launchers, bootstrap, mesos ----------------------------------------
ARGV = [
    ["--cluster", "local", "--num-workers", "2", "--", "python", "w.py"],
    ["--cluster=local", "--num-workers=3", "--num-shards=8", "--mesh",
     "--world-attempts=1", "--heartbeat-ms=200", "--dead-after-ms=2000",
     "--", "./w", "a b"],
    ["--cluster", "ssh", "--num-workers", "4", "--num-servers", "1",
     "--host-file", "hosts.txt", "--sync-dst-dir", "/tmp/x", "--", "w"],
    ["--cluster", "kubernetes", "--num-workers", "2", "--jobname", "j",
     "--kube-tpu-type", "tpu-v5", "--kube-tpu-topology", "2x2",
     "--kube-dry-run", "--", "python", "t.py"],
    ["--cluster", "yarn", "--num-workers", "2", "--worker-memory-mb",
     "512", "--archives", "a.zip", "--", "t"],
    ["--cluster", "mesos", "--num-workers", "1", "--mesos-master",
     "m:5050", "--", "t"],
    ["--cluster", "tpu-pod", "--num-workers", "4", "--host-file", "h",
     "--coordinator-port", "8476", "--", "t"],
]


@pytest.mark.parametrize("argv", ARGV)
def test_get_opts_namespaces_equal(argv):
    assert vars(opts.get_opts(argv)) == vars(ref_opts.get_opts(argv))


def test_get_opts_refusals_equal(monkeypatch, capsys):
    monkeypatch.delenv("DMLC_SUBMIT_CLUSTER", raising=False)
    for mod in (opts, ref_opts):
        with pytest.raises(SystemExit):
            mod.get_opts(["--num-workers", "2", "--", "x"])
    monkeypatch.setenv("DMLC_SUBMIT_CLUSTER", "slurm")
    assert vars(opts.get_opts(["--num-workers", "2", "--", "x"])) == \
        vars(ref_opts.get_opts(["--num-workers", "2", "--", "x"]))


def _same(a, b):
    """Equal once the bootstrap module names its own package."""
    return repr(a).replace(PORT_PKG, REF_PKG) == repr(b)


ENVS = {"DMLC_TRACKER_URI": "10.0.0.1", "DMLC_TRACKER_PORT": 9091,
        "DMLC_NUM_WORKER": 2, "DMLC_NUM_SERVER": 1}


def test_host_env_and_shell_builders_equal(tmp_path, monkeypatch):
    hf = tmp_path / "hosts"
    hf.write_text("# c\n10.0.0.2\n10.0.0.3:2222\n10.0.0.4 slots=4\n")
    hosts = launchers.parse_host_file(str(hf))
    assert hosts == ref_launchers.parse_host_file(str(hf))
    monkeypatch.setenv("OMP_NUM_THREADS", "3")
    assert launchers.PASSTHROUGH_ENV_KEYS == \
        ref_launchers.PASSTHROUGH_ENV_KEYS
    for fn, a in (("export_prefix", (ENVS,)), ("inline_env", (ENVS,)),
                  ("build_ssh_commands", (hosts, ["w", "x"], 2, 1, ENVS,
                                          "/wd")),
                  ("mpi_env_flags", (ENVS, "mpirun (Open MPI) 4.1")),
                  ("mpi_env_flags", (ENVS, "HYDRA build details: mpich 4")),
                  ("build_mpi_command", (["w"], 3, ENVS, "Open MPI", "hf")),
                  ("build_sge_script", ()),
                  ("build_slurm_command", (["w"], 3, 2, ENVS)),
                  ("build_tpu_pod_env", (1, hosts, 8476, ENVS)),
                  ("build_tpu_pod_commands", (hosts, ["w"], ENVS, 8476,
                                              "/wd"))):
        assert _same(getattr(launchers, fn)(*a),
                     getattr(ref_launchers, fn)(*a)), fn
    assert sorted(launchers.BACKENDS) == sorted(ref_launchers.BACKENDS)


@pytest.mark.parametrize("argv", [a for a in ARGV if a[1] in (
    "kubernetes", "yarn", "mesos")] + [
    ["--cluster", "sge", "--num-workers", "2", "--jobname", "s",
     "--queue", "q", "--", "w"]])
@pytest.mark.parametrize("role", ["worker", "server"])
def test_cluster_manager_builders_equal(argv, role):
    args, ref_args = opts.get_opts(argv), ref_opts.get_opts(argv)
    cluster = args.cluster
    if cluster == "kubernetes":
        got = launchers.build_kube_manifest(args, role, 2, ENVS)
        want = ref_launchers.build_kube_manifest(ref_args, role, 2, ENVS)
    elif cluster == "yarn":
        got = launchers.build_yarn_command(args, role, 2, ENVS, 1)
        want = ref_launchers.build_yarn_command(ref_args, role, 2, ENVS, 1)
    elif cluster == "mesos":
        got = launchers.build_mesos_command(args, role, 2, ENVS, 1)
        want = ref_launchers.build_mesos_command(ref_args, role, 2, ENVS, 1)
    else:
        got = launchers.build_sge_command(args, 2, ENVS, "/r/rundmlc.sh")
        want = ref_launchers.build_sge_command(ref_args, 2, ENVS,
                                               "/r/rundmlc.sh")
    assert _same(got, want)


@pytest.mark.parametrize("base", [
    {"DMLC_JOB_CLUSTER": "local", "DMLC_ROLE": "worker"},
    {"DMLC_JOB_CLUSTER": "sge", "SGE_TASK_ID": "3", "DMLC_NUM_WORKER": "2"},
    {"DMLC_JOB_CLUSTER": "kubernetes", "LD_LIBRARY_PATH": "/a",
     "DMLC_TRACKER_HEARTBEAT_MS": "100"},
])
def test_bootstrap_build_env_equal(base):
    assert bootstrap.build_env(dict(base), lambda: "") == \
        ref_bootstrap.build_env(dict(base), lambda: "")


def test_bootstrap_refusals_equal():
    for env in ({}, {"DMLC_JOB_CLUSTER": "nope"}):
        with pytest.raises(RuntimeError) as p:
            bootstrap.build_env(dict(env))
        with pytest.raises(RuntimeError) as r:
            ref_bootstrap.build_env(dict(env))
        assert str(p.value) == str(r.value)


@pytest.mark.parametrize("states", [
    [], ["TASK_RUNNING"], ["TASK_FINISHED", "TASK_FINISHED"],
    ["TASK_FINISHED", "TASK_FAILED"], ["TASK_LOST"],
    ["TASK_FINISHED", "TASK_STAGING"]])
def test_mesos_group_state_equal(states):
    tasks = [{"name": "g", "state": s} for s in states] + \
        [{"name": "other", "state": "TASK_FAILED"}]
    assert mesos_status.group_state(tasks, "g") == \
        ref_mesos.group_state(tasks, "g")


# -- the supervisor ------------------------------------------------------------
def _task(code: str):
    """A command for ``popen_start_fn`` (it runs the words through bash)."""
    return [sys.executable, "-c", shlex.quote(code)]


@pytest.mark.parametrize("sup_mod", [supervisor, ref_sup])
def test_supervisor_relaunches_then_succeeds(tmp_path, sup_mod):
    """A task failing on its first attempt is relaunched under the same id
    with DMLC_NUM_ATTEMPT=1 and then succeeds."""
    code = ("import os, sys; a = int(os.environ['DMLC_NUM_ATTEMPT']); "
            f"open(r'{tmp_path}/t' + os.environ['DMLC_TASK_ID'] + '_' "
            "+ str(a), 'w').close(); sys.exit(3 if a == 0 else 0)")
    sup = sup_mod.WorkerSupervisor(max_attempts=1, poll_interval=0.01)
    for i in range(2):
        sup.add(i, "worker", sup_mod.popen_start_fn(_task(code), "worker",
                                                    i, {"X": 1}))
    sup.run()
    assert sorted(os.listdir(tmp_path)) == ["t0_0", "t0_1", "t1_0", "t1_1"]
    assert sorted(sup.failures) == [(0, 0, 3), (1, 0, 3)]


def test_supervisor_gives_up_and_aborts_the_tracker():
    got = {}
    for name, mod in (("port", supervisor), ("ref", ref_sup)):
        aborted = []

        class Tracker:
            elastic = False

            def abort(self, reason):
                aborted.append(reason)

            def on_rank_dead(self, cb):
                pass

        sup = mod.WorkerSupervisor(max_attempts=0, poll_interval=0.01)
        sup.add(0, "worker", mod.popen_start_fn(
            _task("import sys; sys.exit(5)"), "worker", 0, {}))
        sup.attach_tracker(Tracker())
        with pytest.raises(RuntimeError) as e:
            sup.run()
        got[name] = (str(e.value), aborted, sup.failures)
    assert got["port"] == got["ref"]
    assert got["port"][1] == ["task 0 (worker) exhausted 1 attempts "
                              "(exited with code 5)"]


def test_command_task_polls_like_the_reference(tmp_path):
    marker = tmp_path / "ran"
    got = {}
    for name, mod in (("port", supervisor), ("ref", ref_sup)):
        t = mod.CommandTask(
            [sys.executable, "-c", f"open(r'{marker}', 'w').close()"],
            [sys.executable, "-c", f"import os; print('Succeeded' if "
             f"os.path.exists(r'{marker}') else 'Running')"])
        deadline = time.monotonic() + 30
        while (rc := t.poll()) is None and time.monotonic() < deadline:
            time.sleep(0.05)
        got[name] = rc
        marker.unlink()
    assert got == {"port": 0, "ref": 0}


# -- PS tracker and the standalone tracker ------------------------------------
def test_ps_tracker_exports_scheduler_env(tmp_path):
    """The port's PSTracker starts the scheduler with the reference's
    env. The reference's probes the port on "" and cannot start one (a
    reference fault, repaired in the port: ROADMAP.md section 3)."""
    with pytest.raises(socket.gaierror):
        ref_rdv.PSTracker("127.0.0.1", "true")
    out = tmp_path / "env"
    ps = rendezvous.PSTracker(
        "127.0.0.1", f"env | grep ^DMLC_ > {out}", envs={"DMLC_X": 7})
    ps.join()
    env = dict(line.split("=", 1) for line in out.read_text().split())
    assert env["DMLC_ROLE"] == "scheduler" and env["DMLC_X"] == "7"
    assert env["DMLC_PS_ROOT_PORT"] == str(ps.port)
    assert ps.worker_envs() == {"DMLC_PS_ROOT_URI": "127.0.0.1",
                                "DMLC_PS_ROOT_PORT": ps.port}
    assert rendezvous.PSTracker("127.0.0.1", None).worker_envs() == {}


def test_standalone_tracker_prints_the_env_block():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from dmlc_core_tpu_torch.tracker import "
            "start_standalone_tracker; "
            "start_standalone_tracker(1, host_ip='127.0.0.1')")
    proc = subprocess.Popen([sys.executable, "-c", code, REPO],
                            stdout=subprocess.PIPE, text=True)
    try:
        lines = [proc.stdout.readline().strip() for _ in range(6)]
        env = dict(ln.split("=", 1) for ln in lines[1:-1])
        assert lines[0] == "DMLC_TRACKER_ENV_START"
        assert lines[-1] == "DMLC_TRACKER_ENV_END"
        c = RefClient(env["DMLC_TRACKER_URI"], int(env["DMLC_TRACKER_PORT"]))
        a = c.start()
        c.shutdown(a.rank)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_submit_local_runs_workers_of_either_package(tmp_path):
    """``python -m dmlc_core_tpu_torch.tracker.submit --cluster local``:
    two workers, one of each package's client, join the port's tracker."""
    worker = tmp_path / "w.py"
    worker.write_text(
        "import os, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "pkg = 'dmlc_core_tpu' if os.environ['DMLC_TASK_ID'] == '1' "
        "else 'dmlc_core_tpu_torch'\n"
        "mod = __import__(pkg + '.tracker.client', fromlist=['x'])\n"
        "c = mod.RendezvousClient(os.environ['DMLC_TRACKER_URI'],\n"
        "                         int(os.environ['DMLC_TRACKER_PORT']))\n"
        "a = c.start(heartbeat=True)\n"
        f"open({str(tmp_path)!r} + '/r' + os.environ['DMLC_TASK_ID'], "
        "'w').write(f'{a.rank} {a.world_size} {pkg}')\n"
        "c.shutdown(a.rank)\n")
    proc = subprocess.run(
        [sys.executable, "-m", "dmlc_core_tpu_torch.tracker.submit",
         "--cluster", "local", "--num-workers", "2", "--heartbeat-ms",
         "200", "--", sys.executable, str(worker)], cwd=REPO,
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = sorted((tmp_path / f"r{t}").read_text() for t in (0, 1))
    assert [g.split()[1] for g in got] == ["2", "2"]
    assert sorted(g.split()[0] for g in got) == ["0", "1"]
    assert sorted(g.split()[2] for g in got) == [REF_PKG, PORT_PKG]


def test_opts_are_an_argparse_namespace():
    assert isinstance(opts.get_opts(ARGV[0]), argparse.Namespace)
