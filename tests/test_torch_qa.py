"""The port's QA lane (``dmlc_core_tpu_torch/qa/``).

- Parity: every test of the reference's analyzer suite
  (``tests/test_analyze.py``) but ``test_repo_is_clean`` runs against the
  port's ``qa/analyze.py``, loaded under a private name with its
  ``ANALYZE`` pointed at the port's file. The reference's bug-class
  fixtures must pass against the port's tool.
- Port-only fixtures: an ``extern "C"`` function of a ``.cu`` file
  against a binding row of the wrong arity, width or restype, and its
  clean twin; the ``NO_COUNTERPART`` table's rules.
- Repo mode: the analyzer reports 0 findings, both lints exit 0, and
  ``qa.gendoc`` regenerates ``doc/torch/`` byte for byte.
- Proven red: on a copy of the port, the native core's sources and the
  docs, a broken argtype of the kernel's row gives exactly one ``[abi]``
  finding, and each of this lane's fault repairs reverted gives exactly
  its findings back.
"""

import importlib.util
import inspect
import json
import os
import re
import shutil
import subprocess
import sys
import textwrap

import pytest

from dmlc_core_tpu_torch.qa import contracts, lint, srcwalk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QA = os.path.join(REPO, "dmlc_core_tpu_torch", "qa")
ANALYZE = os.path.join(QA, "analyze.py")


def _load_reference_suite():
    spec = importlib.util.spec_from_file_location(
        "_reference_test_analyze",
        os.path.join(REPO, "tests", "test_analyze.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.ANALYZE = ANALYZE  # run_analyze() and the probe-skip test read it
    return mod


REF = _load_reference_suite()
REF_CASES = sorted(
    (name for name, fn in vars(REF).items()
     if name.startswith("test_") and inspect.isfunction(fn)
     and name != "test_repo_is_clean"),
    key=lambda name: getattr(REF, name).__code__.co_firstlineno)


def test_reference_suite_is_whole():
    # every bug class of the reference's suite, so none drops out
    assert len(REF_CASES) >= 47


@pytest.mark.parametrize("name", REF_CASES)
def test_reference_fixture_against_port(name, tmp_path):
    fn = getattr(REF, name)
    for mark in getattr(fn, "pytestmark", []):
        if mark.name == "skipif" and mark.args and mark.args[0]:
            pytest.skip(mark.kwargs.get("reason", "skipif"))
    if "tmp_path" in inspect.signature(fn).parameters:
        fn(tmp_path)
    else:
        fn()


def run_analyze(*args, cwd=REPO):
    return subprocess.run([sys.executable, ANALYZE, *args],
                          capture_output=True, text=True, cwd=cwd,
                          timeout=300)


def write_fixture(tmp_path, name, body):
    path = tmp_path / name
    path.write_text(textwrap.dedent(body))
    return path


def findings(stdout):
    return [ln for ln in stdout.splitlines() if re.search(r":\d+: \[", ln)]


# ---------------------------------------------------------------------------
# port-only fixtures: the .cu boundary
# ---------------------------------------------------------------------------

KERNEL_CU = """\
    #include <cuda_runtime.h>

    namespace {
    __global__ void scale_kernel(const float* x, long long n, float a,
                                 float* out) {}
    }  // namespace

    // "extern" in a comment, and a string: "dct_fake(int x) {"
    extern "C" int dct_scale_f32(const void* x, long long n, float a,
                                 void* out, void* stream) {
      return 0;
    }
    """

KERNEL_ROW = ("ctypes.c_int", "[_vp, ctypes.c_longlong, ctypes.c_float, "
              "_vp, _vp]")


def kernel_binding(restype, argtypes):
    return f"""\
        import ctypes

        _vp = ctypes.c_void_p
        _SIGNATURES = {{
            "dct_scale_f32": ({restype}, {argtypes}),
        }}
        """


@pytest.mark.parametrize("restype,argtypes,want", [
    (KERNEL_ROW[0], KERNEL_ROW[1], None),
    (KERNEL_ROW[0], "[_vp, ctypes.c_longlong, ctypes.c_float, _vp]",
     "argtypes but the C ABI takes 5"),
    (KERNEL_ROW[0], "[_vp, ctypes.c_int, ctypes.c_float, _vp, _vp]",
     "needs c_longlong"),
    ("ctypes.c_void_p", KERNEL_ROW[1], "restype is c_void_p"),
], ids=["clean", "arity", "width", "restype"])
def test_cu_extern_c_against_its_row(tmp_path, restype, argtypes, want):
    write_fixture(tmp_path, "kernel.cu", KERNEL_CU)
    write_fixture(tmp_path, "kernels.py", kernel_binding(restype, argtypes))
    out = run_analyze("--root", str(tmp_path))
    if want is None:
        assert out.returncode == 0, out.stdout + out.stderr
    else:
        assert out.returncode == 1, out.stdout + out.stderr
        assert want in out.stdout and "[abi]" in out.stdout


def test_cu_extern_c_without_a_row_is_flagged(tmp_path):
    write_fixture(tmp_path, "kernel.cu", KERNEL_CU)
    write_fixture(tmp_path, "kernels.py", """\
        import ctypes

        _SIGNATURES = {"dct_other": (ctypes.c_int, [])}
        """)
    out = run_analyze("--root", str(tmp_path))
    # the export without a row, and the row without an export
    assert out.returncode == 2, out.stdout + out.stderr
    assert "`dct_scale_f32` is exported but has no ctypes binding" \
        in out.stdout
    assert "exports no such function" in out.stdout


# ---------------------------------------------------------------------------
# port-only fixtures: NO_COUNTERPART
# ---------------------------------------------------------------------------

CATALOG_MD = """\
    | metric | type | meaning |
    |---|---|---|
    | `good_total` | counter | ported |
    | `tpu_only_total` | counter | a plane the port does not have |
    """


def metric_fixture(tmp_path, no_counterpart, catalog=CATALOG_MD):
    write_fixture(tmp_path, "obs.md", catalog)
    write_fixture(tmp_path, "help.py", """\
        METRIC_HELP = {
            "good_total": "ported",
        }
        """)
    write_fixture(tmp_path, "code.py", """\
        def run():
            telemetry.counter("good_total").inc()
        """)
    write_fixture(tmp_path, "contracts.py", no_counterpart)


def test_no_counterpart_row_with_reason_is_clean(tmp_path):
    metric_fixture(tmp_path, """\
        NO_COUNTERPART = {
            "tpu_only_total": "the TPU's own plane",
        }
        """)
    out = run_analyze("--root", str(tmp_path))
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("reason", ['""', '"   "', "None"])
def test_no_counterpart_row_without_reason_is_flagged(tmp_path, reason):
    metric_fixture(tmp_path, f"""\
        NO_COUNTERPART = {{
            "tpu_only_total": {reason},
        }}
        """)
    out = run_analyze("--root", str(tmp_path))
    assert out.returncode == 1, out.stdout + out.stderr
    assert "NO_COUNTERPART row `tpu_only_total` gives no reason" \
        in out.stdout


def test_no_counterpart_reason_may_name_a_module_constant(tmp_path):
    metric_fixture(tmp_path, """\
        _WHY = ("the TPU's "
                "own plane")
        NO_COUNTERPART = {
            "tpu_only_total": _WHY,
        }
        """)
    out = run_analyze("--root", str(tmp_path))
    assert out.returncode == 0, out.stdout + out.stderr


def test_catalog_name_in_neither_help_nor_table_is_flagged(tmp_path):
    metric_fixture(tmp_path, """\
        NO_COUNTERPART = {
            "tpu_only_total": "the TPU's own plane",
        }
        """, catalog=CATALOG_MD + "    | `lost_total` | gauge | x |\n")
    out = run_analyze("--root", str(tmp_path))
    assert out.returncode == 1, out.stdout + out.stderr
    line = findings(out.stdout)[0]
    assert "`lost_total`" in line and "documented-but-gone" in line
    assert "NO_COUNTERPART" in line


def test_no_counterpart_row_the_port_registers_is_flagged(tmp_path):
    metric_fixture(tmp_path, """\
        NO_COUNTERPART = {
            "tpu_only_total": "the TPU's own plane",
            "good_total": "claimed missing, but registered",
        }
        """)
    out = run_analyze("--root", str(tmp_path))
    assert out.returncode == 1, out.stdout + out.stderr
    assert "lists `good_total`, but the port registers it" in out.stdout


def test_no_counterpart_row_naming_no_catalog_metric_is_flagged(tmp_path):
    metric_fixture(tmp_path, """\
        NO_COUNTERPART = {
            "tpu_only_total": "the TPU's own plane",
            "typo_totl": "a misspelt row",
        }
        """)
    out = run_analyze("--root", str(tmp_path))
    assert out.returncode == 1, out.stdout + out.stderr
    assert "`typo_totl` names no metric of the catalog" in out.stdout


def test_port_table_marker_parses_beside_the_references(tmp_path):
    # the reference's fixtures name scripts/contracts.py in the marker;
    # the port's generated table names its own module
    table = contracts.render_knob_table(
        {"DMLC_A": [contracts.KnobSite("a.py", 1, "5")]})
    assert "dmlc_core_tpu_torch/qa/contracts.py" in table
    (tmp_path / "params.md").write_text("# Parameters\n\n" + table + "\n")
    write_fixture(tmp_path, "knobs.py", """\
        def read():
            return env_int("DMLC_A", 5)
        """)
    out = run_analyze("--root", str(tmp_path))
    assert out.returncode == 0, out.stdout + out.stderr


# ---------------------------------------------------------------------------
# repo mode
# ---------------------------------------------------------------------------

def test_port_analyzer_is_clean_on_the_repo():
    out = subprocess.run(
        [sys.executable, "-m", "dmlc_core_tpu_torch.qa.analyze"],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "analyze: repo: 0 finding(s)" in out.stdout
    # the struct layouts of capi.cc were compiled and compared
    assert "layout probe ran over 3 struct(s)" in out.stdout


def test_port_lint_is_clean():
    out = subprocess.run(
        [sys.executable, "-m", "dmlc_core_tpu_torch.qa.lint"],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert re.search(r"lint: \d+ files checked, 0 with problems",
                     out.stdout)


def test_port_lint_checks_cu_files_by_the_cpp_rules(tmp_path):
    files = {os.path.relpath(p, REPO)
             for p in srcwalk.iter_sources()}
    assert "dmlc_core_tpu_torch/csrc/csr_to_dense.cu" in files
    assert "chip_smoke.py" in files
    assert "tests/test_torch_qa.py" in files
    assert "tests/torch_reference_native.py" in files
    assert not any(f.startswith(("dmlc_core_tpu/", "scripts/", "cpp/"))
                   or "/_build/" in f for f in files)
    cu = tmp_path / "k.cu"
    cu.write_text("int x;\t// " + "y" * 90 + "\nint z;")
    errs = lint.lint_file(str(cu))
    assert any("tab character" in e for e in errs)
    assert any("line too long" in e and "> 90" in e for e in errs)
    assert any("missing newline at EOF" in e for e in errs)


def test_reference_lint_is_clean():
    out = subprocess.run([sys.executable, "scripts/lint.py"],
                         capture_output=True, text=True, cwd=REPO,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_gendoc_regenerates_the_committed_pages(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "dmlc_core_tpu_torch.qa.gendoc", "--out",
         str(tmp_path)], capture_output=True, text=True, cwd=REPO,
        timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "doc: OK" in out.stdout
    for page in ("api.md", "parameters.md", "index.md"):
        want = open(os.path.join(REPO, "doc", "torch", page)).read()
        got = (tmp_path / page).read_text()
        assert got == want, f"doc/torch/{page} is stale: run make torch-doc"


# ---------------------------------------------------------------------------
# proven red: a copy of the tree, broken one way at a time
# ---------------------------------------------------------------------------

HOPPER = "dmlc_core_tpu_torch/ops/hopper_kernels.py"
NATIVE = "dmlc_core_tpu_torch/io/native.py"
TELEMETRY = "dmlc_core_tpu_torch/telemetry.py"
MESH_WORKER = "dmlc_core_tpu_torch/bench/mesh_worker.py"


def copy_tree(dst):
    """What the repo-mode analyzer reads: the port, the native core's
    sources, the port's and the reference's docs, the reference's HELP
    table and chip_smoke.py."""
    ignore = shutil.ignore_patterns("_build", "__pycache__")
    shutil.copytree(os.path.join(REPO, "dmlc_core_tpu_torch"),
                    dst / "dmlc_core_tpu_torch", ignore=ignore)
    shutil.copytree(os.path.join(REPO, "cpp", "src"), dst / "cpp" / "src")
    shutil.copytree(os.path.join(REPO, "doc"), dst / "doc")
    (dst / "dmlc_core_tpu").mkdir()
    shutil.copy(os.path.join(REPO, "dmlc_core_tpu", "telemetry.py"),
                dst / "dmlc_core_tpu")
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), dst)


def edit(path, old, new):
    text = path.read_text()
    assert text.count(old) == 1, old
    path.write_text(text.replace(old, new))


def break_kernel_argtype(root):
    edit(root / HOPPER, "[_vp, _vp, _vp, ctypes.c_longlong,",
         "[_vp, _vp, _vp, ctypes.c_int,")


def drop_parser_create_row(root):
    text = (root / NATIVE).read_text()
    start = text.index('        "dct_parser_create": (')
    end = text.index('        "dct_parser_create_ex": (')
    (root / NATIVE).write_text(text[:start] + text[end:])


def drop_rig_help(root):
    text = (root / TELEMETRY).read_text()
    start = text.index("    # measurement rig (bench/loadrig.py")
    end = text.index('    "host_cpu_busy_frac"')
    (root / TELEMETRY).write_text(text[:start] + text[end:])


def raw_num_worker_parse(root):
    edit(root / MESH_WORKER, 'nworkers = env_int("DMLC_NUM_WORKER", 0)',
         'nworkers = int(os.environ["DMLC_NUM_WORKER"])')


def reword_help_line(root):
    edit(root / TELEMETRY, '"rig_errors_total": "load-generator requests '
         'that failed"', '"rig_errors_total": "requests that failed"')


def test_unbroken_copy_is_clean(tmp_path):
    copy_tree(tmp_path)
    out = run_analyze("--repo", str(tmp_path))
    assert out.returncode == 0, out.stdout + out.stderr
    assert f"analyze: {tmp_path}: 0 finding(s)" in out.stdout


@pytest.mark.parametrize("breakage,want", [
    (break_kernel_argtype,
     [(HOPPER, "abi", "`dct_csr_to_dense_f32` argument 4: C `long long` "
       "needs c_longlong, binding declares c_int")]),
    (drop_parser_create_row,
     [("cpp/src/capi.cc", "abi", "`dct_parser_create` is exported but has "
       "no ctypes binding row")]),
    (drop_rig_help,
     [("dmlc_core_tpu_torch/bench/loadrig.py", "metric",
       f"metric `{name}` has no METRIC_HELP entry")
      for name in ("rig_requests_total", "rig_errors_total",
                   "rig_shed_total", "rig_intended_us", "rig_service_us")]),
    (raw_num_worker_parse,
     [(MESH_WORKER, "env", "raw int() over an os.environ value")]),
    (reword_help_line,
     [(TELEMETRY, "metric", "METRIC_HELP `rig_errors_total` is "
       "'requests that failed' but the reference's")]),
], ids=["kernel-argtype", "A4-parser-create", "A2-rig-help",
        "A3-raw-env", "help-text"])
def test_broken_copy_is_red(tmp_path, breakage, want):
    copy_tree(tmp_path)
    breakage(tmp_path)
    out = run_analyze("--repo", str(tmp_path))
    got = findings(out.stdout)
    assert out.returncode == len(want) == len(got), out.stdout
    for rel, pass_name, text in want:
        hits = [line for line in got if line.startswith(rel + ":")
                and f"[{pass_name}] {text}" in line]
        assert len(hits) == 1, (rel, text, out.stdout)


# ---------------------------------------------------------------------------
# chip_smoke.py's qa phase, rehearsed on the CPU
# ---------------------------------------------------------------------------

def test_chip_smoke_qa_phase_passes_on_the_repo():
    import chip_smoke as cs
    res = cs.qa_phase()
    assert res["findings"] == 0 and res["layout_probe"] == "ran"
    assert res["probe_structs"] == 3
    assert res["lint_files"] > 100 and res["lint_files_with_problems"] == 0
    assert res["seconds"] == res["analyze_s"] + res["lint_s"] > 0


def test_chip_smoke_qa_phase_fails_on_a_finding(tmp_path):
    copy_tree(tmp_path)
    break_kernel_argtype(tmp_path)
    proc = subprocess.run(
        [sys.executable, "-c", "import chip_smoke as cs; cs.qa_phase()"],
        capture_output=True, text=True, cwd=str(tmp_path), timeout=300)
    assert proc.returncode != 0
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["phase"] == "qa" and line["findings"] == 1
    assert "qa: the port's analyzer has findings" in proc.stderr
