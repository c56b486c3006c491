"""The port's diagnostics layer against the reference's ``base.py``.

Log output: each scenario runs twice in a fresh interpreter, once per
package (the reference under ``JAX_PLATFORMS=cpu``), and the two stderr
streams must be equal line for line once the time stamps, ports and
measured numbers are masked; the reference's stream must also be the
lines pinned here, so two empty streams do not pass. Subprocesses,
because the package handler binds the ``sys.stderr`` of its first import.

Helpers: the CHECK family, ``get_env`` and ``set_env`` of both packages on
the same operands give the same value, or the same exception type and
text.
"""

import os
import re
import subprocess
import sys

import pytest

from dmlc_core_tpu import base as ref_base

from dmlc_core_tpu_torch import base

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ("dmlc_core_tpu", "dmlc_core_tpu_torch")

PRELUDE = """\
import importlib, os, sys
sys.path.insert(0, {repo!r})
pkg = {pkg!r}


def mod(name):
    return importlib.import_module(pkg + name)


"""

SCENARIOS = {
    "helpers": (
        "base = mod('.base')\n"
        "base.log_info('parity %d of %s', 1, 'two')\n"
        "base.log_warning('careful: %.2f%%', 12.5)\n"
        "base.logger().info('through logger() %s', ['x'])\n"
        "base.logger().debug('not shown at INFO')\n",
        ["[T] INFO parity 1 of two",
         "[T] WARNING careful: F%",
         "[T] INFO through logger() ['x']"]),
    "module_logger": (
        "rz = mod('.tracker.rendezvous')\n"
        "rz.logger.info('tracker logger INFO line')\n"
        "rz.logger.warning('tracker logger WARNING line')\n",
        ["[T] INFO tracker logger INFO line",
         "[T] WARNING tracker logger WARNING line"]),
    "tracker": (
        "rz = mod('.tracker.rendezvous')\n"
        "t = rz.RabitTracker('127.0.0.1', 1)\n"
        "t.start()\n"
        "t.stop()\n"
        "t.join(timeout=30)\n",
        ["[T] INFO tracker listening on F.F:P",
         "[T] INFO tracker stopped by request"]),
    "init_from_env": (
        "mod('.parallel.distributed').init_from_env()\n",
        ["[T] INFO init_from_env: no launcher env found; single-process "
         "mode (use cluster=tpu-pod or export DMLC_COORDINATOR_ADDRESS)"]),
    "eager_load": (
        "it = mod('.data').RowBlockIter.create(sys.argv[1], fmt='libsvm')\n"
        "print(sum(b.size for b in it))\n",
        ["[T] INFO N MB read, F MB/sec"]),
}

# what the reference's launcher env protocol reads; none may leak in
LAUNCHER_ENV = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                "JAX_PROCESS_ID", "DMLC_COORDINATOR_ADDRESS",
                "DMLC_NUM_WORKER", "DMLC_TASK_ID", "DMLC_TRACKER_URI",
                "DMLC_TRACKER_PORT", "DMLC_ROLE")

MASKS = (
    (re.compile(r"^\[\d\d:\d\d:\d\d\] "), "[T] "),  # the package handler
    (re.compile(r"^\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d{3} "), "T "),  # root
    (re.compile(r":\d+\b"), ":P"),
    (re.compile(r"\d+\.\d+"), "F"),
    (re.compile(r"\d+ MB read"), "N MB read"),
)


def masked(stderr: str) -> "list[str]":
    out = []
    for line in stderr.splitlines():
        for pattern, repl in MASKS:
            line = pattern.sub(repl, line)
        out.append(line)
    return out


def child_env() -> dict:
    env = {k: v for k, v in os.environ.items() if k not in LAUNCHER_ENV}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    return env


def run_both(argv_of, cwd) -> "dict[str, subprocess.CompletedProcess]":
    out = {}
    for pkg in PKGS:
        proc = subprocess.run(argv_of(pkg), capture_output=True, text=True,
                              timeout=180, cwd=cwd, env=child_env())
        out[pkg] = proc
    return out


@pytest.fixture(scope="module")
def libsvm_13mb(tmp_path_factory):
    """A 13 MB libsvm file: the eager load logs once every 10 MB."""
    line = "1 " + " ".join(f"{j}:{(j * 37 % 101) / 101:.6f}"
                           for j in range(28)) + "\n"
    path = tmp_path_factory.mktemp("diag") / "rows.libsvm"
    path.write_text(line * (13_000_000 // len(line) + 1))
    return str(path)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_log_lines_are_the_references(scenario, libsvm_13mb, tmp_path):
    code, want = SCENARIOS[scenario]
    procs = run_both(lambda pkg: [
        sys.executable, "-c", PRELUDE.format(repo=REPO, pkg=pkg) + code,
        libsvm_13mb], str(tmp_path))
    for pkg, proc in procs.items():
        assert proc.returncode == 0, (pkg, proc.stderr[-3000:])
    ref, port = (masked(procs[p].stderr) for p in PKGS)
    assert ref == want, procs[PKGS[0]].stderr
    assert port == ref, procs[PKGS[1]].stderr
    assert procs[PKGS[1]].stdout == procs[PKGS[0]].stdout


SUBMIT_WORKER = """\
import importlib, os
client = importlib.import_module(os.environ["PARITY_PKG"] + ".tracker.client")
c = client.RendezvousClient(os.environ["DMLC_TRACKER_URI"],
                            int(os.environ["DMLC_TRACKER_PORT"]))
a = c.start()
c.log("hello from rank %d" % a.rank)
c.shutdown(a.rank)
"""

# under dmlc-submit every package line prints twice: the package handler's
# line, then basicConfig's root handler's (ROADMAP.md §3, mirrored)
SUBMIT_LINES = [
    "[T] INFO tracker listening on F.F:P",
    "T INFO tracker listening on F.F:P",
    "[T] INFO @tracker all 1 workers started",
    "T INFO @tracker all 1 workers started",
    "[T] INFO hello from rank 0",
    "T INFO hello from rank 0",
    "[T] INFO @tracker all workers finished",
    "T INFO @tracker all workers finished",
    "[T] INFO @tracker F secs between start and finish",
    "T INFO @tracker F secs between start and finish",
]


@pytest.mark.parametrize("level", [[], ["--log-level", "DEBUG"]],
                         ids=["default", "debug"])
def test_submit_doubles_each_line_as_the_reference_does(level, tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(SUBMIT_WORKER)

    def argv(pkg):
        return [sys.executable, "-c",
                f"import os, runpy; os.environ['PARITY_PKG'] = {pkg!r};"
                f" runpy.run_module({pkg + '.tracker.submit'!r},"
                f" run_name='__main__')",
                "--cluster", "local", "--num-workers", "1", *level, "--",
                sys.executable, str(worker)]

    procs = run_both(argv, REPO)
    for pkg, proc in procs.items():
        assert proc.returncode == 0, (pkg, proc.stderr[-3000:])
    ref, port = (masked(procs[p].stderr) for p in PKGS)
    assert ref == SUBMIT_LINES, procs[PKGS[0]].stderr
    assert port == ref, procs[PKGS[1]].stderr


def test_submit_refuses_a_quieter_log_level_as_the_reference_does():
    """``--log-level`` offers INFO and DEBUG only, so WARNING cannot quiet
    the tracker's lines in either package: both refuse it with the same
    usage error."""
    procs = run_both(lambda pkg: [
        sys.executable, "-m", pkg + ".tracker.submit", "--cluster", "local",
        "--num-workers", "1", "--log-level", "WARNING", "--", "true"], REPO)
    for proc in procs.values():
        assert proc.returncode == 2
        assert "invalid choice: 'WARNING'" in proc.stderr
    assert procs[PKGS[1]].stderr == procs[PKGS[0]].stderr


# -- the helpers, in this process --------------------------------------------
def outcome(fn, *args):
    try:
        value = fn(*args)
    except Exception as e:  # the exception is what is compared
        return type(e).__name__, str(e)
    return "value", type(value).__name__, value


CHECKS = ("check_eq", "check_ne", "check_lt", "check_le", "check_gt",
          "check_ge")
OPERANDS = ((1, 1), (1, 2), (2, 1), (1.0, 1), ("a", "b"), ([1], [1]),
            (None, 0))


@pytest.mark.parametrize("msg", ["", "while parsing"])
@pytest.mark.parametrize("a,b", OPERANDS)
@pytest.mark.parametrize("name", CHECKS)
def test_check_family_matches_reference(name, a, b, msg):
    want = outcome(getattr(ref_base, name), a, b, msg)
    assert outcome(getattr(base, name), a, b, msg) == want
    if want[0] == "DMLCError":
        with pytest.raises(base.DMLCError):
            getattr(base, name)(a, b, msg)


@pytest.mark.parametrize("msg", ["", "need rows"])
@pytest.mark.parametrize("cond", [0, 1, "", "x", None, [], [0]])
def test_check_matches_reference(cond, msg):
    assert outcome(base.check, cond, msg) == outcome(ref_base.check, cond,
                                                     msg)


GET_ENV_CASES = [
    (None, 5, None), (None, "d", None), (None, False, None),
    ("0", True, None), ("1", False, None), ("true", False, None),
    ("Yes", False, None), ("on", False, None), ("off", True, None),
    (" TRUE ", False, None), ("2", False, None),
    ("42", 0, None), ("-7", 0, None), ("3.5", 0, None),
    ("3.5", 0.0, None), ("1e3", 0.0, None), ("abc", "", None),
    ("abc", 0, None), ("12", None, int), ("2.5", None, float),
    ("yes", 0, bool), ("0", "x", bool), ("7", "x", int), ("7", 0, str),
]


@pytest.mark.parametrize("raw,default,dtype", GET_ENV_CASES)
def test_get_env_matches_reference(raw, default, dtype, monkeypatch):
    key = "DMLC_DIAGNOSTICS_PARITY"
    if raw is None:
        monkeypatch.delenv(key, raising=False)
    else:
        monkeypatch.setenv(key, raw)
    assert outcome(base.get_env, key, default, dtype) == outcome(
        ref_base.get_env, key, default, dtype)


@pytest.mark.parametrize("value", [True, False, 0, 17, -3, "abc", "", 2.5,
                                   None])
def test_set_env_matches_reference(value, monkeypatch):
    key = "DMLC_DIAGNOSTICS_PARITY"
    monkeypatch.delenv(key, raising=False)
    ref_base.set_env(key, value)
    want = os.environ.pop(key)
    base.set_env(key, value)
    assert os.environ[key] == want
