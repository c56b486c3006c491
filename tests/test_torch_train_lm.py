"""``python -m dmlc_core_tpu_torch.train_lm`` against ``examples/train_lm.py``.

- ``byte_windows`` is the reference's bit for bit;
- on ``--mesh data=1,seq=1`` (and ``--model tp --mesh data=1,model=1``)
  the two CLIs print the same lines, losses to the four decimals printed;
- LM checkpoints cross between the packages: the port's plain checkpoint
  resumes in the reference and the reference's in the port, and a
  2-rank tensor-parallel world's job checkpoint (its shards gathered to
  whole matrices) resumes in the reference on a 2-device mesh, and back;
- a 2-rank world equals one process on the same global batch;
- the abort path: a 2-worker ``tracker.submit --mesh`` in which one
  worker is SIGKILLed; the survivor writes one abort record and exits 41,
  while an error of the step's own (out of memory, a ValueError) in a
  world propagates instead of taking that path.

Every run is a real process on the CPU with its own timeout.
"""

import json
import os
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from examples.train_lm import byte_windows as ref_windows
from tests.torch_world_worker import run_world

from dmlc_core_tpu_torch import train_lm
from dmlc_core_tpu_torch.utils.checkpoint import (commit_job_checkpoint,
                                                  job_commit_uri,
                                                  job_part_uri)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_CLI = os.path.join(REPO, "examples", "train_lm.py")
SMALL = ["--seq", "64", "--embed", "16", "--heads", "2", "--layers", "1",
         "--batch", "2"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = tmp_path_factory.mktemp("lm_corpus") / "c.txt"
    path.write_bytes(b"the quick brown fox jumps over the lazy dog. " * 300)
    return str(path)


def _env(devices=1):
    return dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
                OMP_NUM_THREADS="1",
                XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")


def ref_cli(args, devices=1, cwd=None):
    r = subprocess.run([sys.executable, REF_CLI, *args], env=_env(devices),
                       capture_output=True, text=True, timeout=240, cwd=cwd)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def port_cli(args, cwd=None):
    r = subprocess.run([sys.executable, "-m", "dmlc_core_tpu_torch.train_lm",
                        *args, "--device", "cpu"], env=_env(),
                       capture_output=True, text=True, timeout=240, cwd=cwd)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def port_world(args, size=2):
    outs = run_world(lambda r: [sys.executable, "-m",
                                "dmlc_core_tpu_torch.train_lm", *args,
                                "--device", "cpu"], size=size, timeout=120,
                     env={"JAX_PLATFORMS": "cpu"})
    return [o for o, _ in outs]


def loss_lines(text):
    """{step: loss string} of the printed ``step N: loss X.XXXX`` lines."""
    return {int(s): v for s, v in re.findall(r"step (\d+): loss (\d+\.\d{4})",
                                              text)}


def test_byte_windows_are_the_references_bit_for_bit():
    data = np.frombuffer(b"".join(bytes([i % 251]) for i in range(5000)),
                         np.uint8)
    for seed, step, part, npart, seq, batch in ((0, 0, 0, 1, 64, 2),
                                                (3, 17, 1, 4, 128, 3),
                                                (9, 2, 3, 4, 7, 5)):
        got = train_lm.byte_windows(data, seq, batch, seed, step, part,
                                    npart)
        want = ref_windows(data, seq, batch, seed, step, part, npart)
        assert got.dtype == want.dtype == np.int32
        assert np.array_equal(got, want)


@pytest.mark.parametrize("extra", [
    [], ["--model", "tp", "--mesh", "data=1,model=1"],
    ["--model", "tp", "--mesh", "data=1,model=1", "--heads", "3",
     "--embed", "24", "--experts", "3"]], ids=["lm", "tp", "tp_moe3"])
def test_cli_prints_the_references_lines(corpus, extra):
    args = [corpus, *SMALL, "--steps", "4", *extra]
    got, want = port_cli(args), ref_cli(args)
    assert sorted(loss_lines(got)) == [0, 1, 2, 3]
    assert got.splitlines() == want.splitlines()


def test_checkpoints_cross_between_packages(corpus, tmp_path):
    args = [corpus, *SMALL, "--ckpt-every", "2"]
    whole = loss_lines(ref_cli(args + ["--steps", "4"]))
    # the port's step-2 checkpoint resumed by the reference, and back
    port_ck, ref_ck = str(tmp_path / "port.ck"), str(tmp_path / "ref.ck")
    port_cli(args + ["--steps", "2", "--checkpoint", port_ck])
    ref_cli(args + ["--steps", "2", "--checkpoint", ref_ck])
    by_ref = ref_cli(args + ["--steps", "4", "--resume", port_ck])
    by_port = port_cli(args + ["--steps", "4", "--resume", ref_ck])
    for out in (by_ref, by_port):
        assert "at step 2" in out
        assert loss_lines(out) == {2: whole[2], 3: whole[3]}


def test_tensor_parallel_job_checkpoint_crosses_packages(corpus, tmp_path):
    """A 2-rank ``data=1,model=2`` world's job checkpoint holds WHOLE
    matrices (the shards gathered by head): the reference resumes it on a
    2-device mesh; the reference's checkpoint, committed as a job step,
    resumes in the port's world, each rank taking its heads."""
    args = [corpus, *SMALL, "--model", "tp", "--mesh", "data=1,model=2",
            "--ckpt-every", "2"]
    whole = loss_lines(ref_cli(args + ["--steps", "4"], devices=2))
    base = str(tmp_path / "tp.job")
    outs = port_world(args + ["--steps", "2", "--checkpoint", base])
    assert all(loss_lines(o) == {0: whole[0], 1: whole[1]} for o in outs)
    resumed = ref_cli(args + ["--steps", "4", "--resume",
                              job_part_uri(base, 2, 0, 1)], devices=2)
    assert loss_lines(resumed) == {2: whole[2], 3: whole[3]}

    ref_base = str(tmp_path / "ref.job")
    ref_cli(args + ["--steps", "2", "--checkpoint",
                    job_part_uri(ref_base, 2, 0, 1)], devices=2)
    commit_job_checkpoint(ref_base, 2, 1)
    outs = port_world(args + ["--steps", "4", "--resume", ref_base])
    for o in outs:
        assert "resumed from committed job checkpoint" in o
        assert loss_lines(o) == {2: whole[2], 3: whole[3]}


def test_two_rank_world_equals_one_process(corpus):
    """``--mesh data=1,seq=2`` on 2 ranks (the ring) and ``data=1,seq=1``
    on 2 ranks (two parts, meaned each step) against one process on the
    same global batch."""
    one = loss_lines(port_cli([corpus, *SMALL[:-1], "4", "--steps", "3"]))
    ring = port_world([corpus, *SMALL[:-1], "4", "--steps", "3", "--mesh",
                       "data=1,seq=2"])
    parts = port_world([corpus, *SMALL[:-1], "2", "--steps", "3"])
    for out in ring + parts:
        got = loss_lines(out)
        assert sorted(got) == [0, 1, 2]
        np.testing.assert_allclose([float(got[s]) for s in range(3)],
                                   [float(one[s]) for s in range(3)],
                                   atol=1.5e-4)


def _train_lm_pids(corpus, expect):
    deadline = time.monotonic() + 90
    pids = []
    while time.monotonic() < deadline:
        pids = []
        for pid in os.listdir("/proc"):
            if not pid.isdigit():
                continue
            try:
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    argv = f.read().decode(errors="replace").split("\0")
            except OSError:
                continue
            if argv[1:3] == ["-m", "dmlc_core_tpu_torch.train_lm"] \
                    and corpus in argv:
                pids.append(int(pid))
        if len(pids) == expect:
            return pids
        time.sleep(0.05)
    raise AssertionError(f"never saw {expect} train_lm workers ({pids})")


def test_sigkilled_worker_survivor_exits_41_with_one_record(corpus,
                                                            tmp_path):
    ck = str(tmp_path / "ck")
    records = tmp_path / "abort.jsonl"
    # each worker's exit code lands in exit_<task id>; the wrapper waits
    # out the supervisor's SIGTERM (sent to it, not to train_lm) so the
    # survivor's own exit code is what it records
    worker = (f"trap : TERM; "
              f"{sys.executable} -m dmlc_core_tpu_torch.train_lm {corpus} "
              f"{' '.join(SMALL)} --steps 100000 --device cpu "
              f"--checkpoint {ck} --ckpt-every 2; rc=$?; "
              f"echo $rc > {tmp_path}/exit_$DMLC_TASK_ID; exit $rc")
    cmd = [sys.executable, "-m", "dmlc_core_tpu_torch.tracker.submit",
           "--cluster", "local", "--num-workers", "2", "--mesh",
           "--world-attempts", "0", "--heartbeat-ms", "200",
           "--dead-after-ms", "1500", "--", worker]  # run by bash
    env = dict(_env(), DMLC_ABORT_RECORD=str(records))
    log = open(tmp_path / "submit.log", "w")
    proc = subprocess.Popen(cmd, env=env, stdout=log,
                            stderr=subprocess.STDOUT, cwd=str(tmp_path),
                            start_new_session=True)
    try:
        pids = _train_lm_pids(corpus, 2)
        deadline = time.monotonic() + 90
        while not os.path.exists(job_commit_uri(ck)):
            assert time.monotonic() < deadline and proc.poll() is None, \
                (tmp_path / "submit.log").read_text()[-3000:]
            time.sleep(0.02)
        victim = pids[1]
        os.kill(victim, signal.SIGKILL)
        deadline = time.monotonic() + 60
        while len(list(tmp_path.glob("exit_*"))) < 2:
            assert time.monotonic() < deadline, \
                (tmp_path / "submit.log").read_text()[-3000:]
            time.sleep(0.05)
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
        log.close()
    codes = sorted(int((tmp_path / f"exit_{t}").read_text())
                   for t in (0, 1))
    assert codes == [41, 137], codes
    recs = [json.loads(line) for line in records.read_text().splitlines()]
    assert len(recs) == 1, recs
    assert recs[0]["pid"] != victim and "train_lm at step" in \
        recs[0]["reason"] and "CollectiveError" in recs[0]["reason"]


# each rank of a 2-rank ring world runs the CLI with the model's second
# step raising ``sys.argv[1]``'s error, and prints what main did with it
FAILING_STEP = """
import sys, torch
from dmlc_core_tpu_torch import train_lm
from dmlc_core_tpu_torch.models.transformer import TransformerLM
from dmlc_core_tpu_torch.parallel.distributed import CollectiveError
errors = {"oom": torch.cuda.OutOfMemoryError("CUDA out of memory"),
          "value": ValueError("operands could not be broadcast"),
          "collective": CollectiveError("Connection reset by peer")}
step, calls = TransformerLM.step, []
def failing(self, *a):
    calls.append(1)
    if len(calls) == 2:
        raise errors[sys.argv[1]]
    return step(self, *a)
TransformerLM.step = failing
try:
    rc = train_lm.main(sys.argv[2:])
except Exception as e:
    rc = "raised " + type(e).__name__
print("RESULT", rc)
"""


@pytest.mark.parametrize("error,result", [
    ("oom", "raised OutOfMemoryError"), ("value", "raised ValueError"),
    ("collective", "41")])
def test_world_aborts_with_41_only_for_a_collectives_error(corpus, tmp_path,
                                                           error, result):
    """Exit 41 tells the supervisor to relaunch the world, so only a
    failed collective (``torch.distributed.DistError``) takes that path;
    a deterministic error would only recur on every relaunch."""
    records = tmp_path / "abort.jsonl"
    outs = run_world(lambda r: [sys.executable, "-c", FAILING_STEP, error,
                                corpus, *SMALL, "--steps", "3", "--mesh",
                                "data=1,seq=2", "--device", "cpu"],
                     size=2, timeout=120,
                     env={"JAX_PLATFORMS": "cpu",
                          "DMLC_ABORT_RECORD": str(records)})
    for out, _ in outs:
        assert re.findall(r"RESULT (.*)", out) == [result], out
        assert sorted(loss_lines(out)) == [0]
    recs = ([json.loads(line) for line in records.read_text().splitlines()]
            if records.exists() else [])
    assert len(recs) == (2 if error == "collective" else 0), recs
    assert all("train_lm at step 1: CollectiveError" in r["reason"]
               for r in recs)


def test_cli_refuses_without_cuda_and_bad_flags(corpus, monkeypatch):
    from dmlc_core_tpu_torch.base import DMLCError
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DMLCError, match="no CUDA device"):
        train_lm.main([corpus, *SMALL, "--steps", "1"])
    with pytest.raises(SystemExit, match="ckpt-every"):
        train_lm.main([corpus, "--checkpoint", "x", "--ckpt-every", "0"])
    with pytest.raises(DMLCError, match="does not divide a world of 1"):
        train_lm.main([corpus, *SMALL, "--mesh", "data=2,seq=1",
                       "--device", "cpu"])
