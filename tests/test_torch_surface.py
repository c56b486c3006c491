"""The completeness gate: the port answers for every public name, CLI flag
and TPU kernel of the JAX package.

The JAX package's sources are read with ``ast``, never imported. A module
``dmlc_core_tpu/<path>.py`` has its counterpart in
``dmlc_core_tpu_torch/<path>.py``, with ``tpu/`` read as ``device/`` and
``pallas_kernels`` as ``hopper_kernels``. The gate fails when

- a public top-level function or class of a reference module, a public
  method of such a class, or a name of an ``__init__.py`` re-export or an
  ``__all__`` has no attribute of that name in the port's counterpart
  module, unless it stands in ``RENAMED`` (the port's name must exist
  then) or in ``NO_COUNTERPART`` (ROADMAP.md §1 says why);
- a CLI flag, positional or subcommand of a reference entry point is
  missing from its counterpart in the port (``CLI_PAIRS``), or the port
  adds a flag other than ``PORT_EXTRA_FLAGS``;
- a ``pl.pallas_call`` site of the JAX package (a call node, not a
  comment) has no row in PERF.md §6's kernel table, or a row names no
  existing CUDA source under ``dmlc_core_tpu_torch/csrc/``.
"""

import ast
import importlib
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(REPO, "dmlc_core_tpu")
PORT = os.path.join(REPO, "dmlc_core_tpu_torch")

# "<reference file>::<name>" -> (the port's name, why it differs)
RENAMED = {
    "ops/pallas_kernels.py::csr_to_dense_pallas": (
        "csr_to_dense_kernel",
        "the Pallas kernel's wrapper; the port's kernel is CUDA C++"),
    "tpu/device_iter.py::jax_profiler_capture": (
        "torch_profiler_capture",
        "the same capture through torch.profiler (DMLC_TORCH_PROFILE)"),
    "bench.py::--pallas-probe": (
        "--kernel-probe",
        "the probe times the CUDA kernel; --pallas-probe stays an alias"),
}

# "<reference file>::<name>" -> why the port has none (ROADMAP.md §1)
NO_COUNTERPART = {
    "parallel/varying.py::mark_varying":
        "JAX's shard_map varying-type shim; torch has no varying types",
    "parallel/varying.py::shard_map_compat_kwargs":
        "JAX's shard_map keyword shim across JAX versions",
    "tpu/sharding.py::batch_sharding":
        "a NamedSharding; the port places one device a rank",
    "tpu/sharding.py::packed_batch_sharding":
        "a NamedSharding; the port places one device a rank",
    "tpu/sharding.py::replicated_sharding":
        "a NamedSharding; the port places one device a rank",
    "tpu/device_iter.py::match_placement_rules":
        "matches NamedSharding placement rules; one device a rank",
    "scripts/loadrig.py::origin":
        "the bench's origin is bench/remote_lane.py origin, with the "
        "shaping knobs it uses and none of the fault knobs",
    "scripts/loadrig.py::loadgen":
        "an HTTP load generator the bench does not use",
}

# reference entry point -> the port's counterpart
CLI_PAIRS = [
    ("examples/train.py", "dmlc_core_tpu_torch/train.py"),
    ("examples/train_lm.py", "dmlc_core_tpu_torch/train_lm.py"),
    ("bench.py", "dmlc_core_tpu_torch/bench/__main__.py"),
    ("dmlc_core_tpu/serving/__main__.py",
     "dmlc_core_tpu_torch/serving/__main__.py"),
    ("dmlc_core_tpu/tracker/opts.py", "dmlc_core_tpu_torch/tracker/opts.py"),
    ("dmlc_core_tpu/io/convert.py", "dmlc_core_tpu_torch/io/convert.py"),
    ("scripts/loadrig.py", "dmlc_core_tpu_torch/bench/loadrig.py"),
]
# the card and the process-group backend: choices the reference leaves to
# JAX's platform
PORT_EXTRA_FLAGS = {"--device", "--backend"}


def ref_modules():
    out = []
    for root, dirs, files in os.walk(REF):
        dirs[:] = sorted(d for d in dirs if not d.startswith(("_", ".")))
        out += [os.path.relpath(os.path.join(root, f), REF)
                for f in sorted(files) if f.endswith(".py")]
    return sorted(out)


def port_module_name(rel: str) -> str:
    parts = rel[:-len(".py")].split(os.sep)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    parts = [{"tpu": "device", "pallas_kernels": "hopper_kernels"}.get(p, p)
             for p in parts]
    return ".".join(["dmlc_core_tpu_torch"] + parts)


def ref_rel_of_module(module: str) -> str:
    """``dmlc_core_tpu.tpu.sharding`` -> ``tpu/sharding.py`` (or the
    package's ``__init__.py``)."""
    parts = module.split(".")[1:]
    path = os.path.join(*parts) if parts else ""
    if os.path.isdir(os.path.join(REF, path)):
        return os.path.join(path, "__init__.py") if path else "__init__.py"
    return path + ".py"


def public_names(rel: str) -> "dict[str, str]":
    """Every public name of a reference module -> the table key that
    excuses it (its defining module's for a re-export)."""
    tree = ast.parse(open(os.path.join(REF, rel)).read())
    names = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)) and not node.name.startswith("_"):
            names[node.name] = f"{rel}::{node.name}"
            if isinstance(node, ast.ClassDef):
                for m in node.body:
                    if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                            and not m.name.startswith("_"):
                        q = f"{node.name}.{m.name}"
                        names[q] = f"{rel}::{q}"
        elif (os.path.basename(rel) == "__init__.py"
              and isinstance(node, ast.ImportFrom) and node.module
              and node.module.split(".")[0] == "dmlc_core_tpu"):
            src = ref_rel_of_module(node.module)
            for a in node.names:
                names[a.asname or a.name] = f"{src}::{a.name}"
        elif isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            for e in node.value.elts:
                names.setdefault(e.value, f"{rel}::{e.value}")
    return names


def has_path(obj, dotted: str) -> bool:
    for part in dotted.split("."):
        if not hasattr(obj, part):
            return False
        obj = getattr(obj, part)
    return True


@pytest.mark.parametrize("rel", ref_modules())
def test_every_public_name_has_a_counterpart(rel):
    names = public_names(rel)
    wanted = {n: key for n, key in names.items()
              if key not in NO_COUNTERPART}
    if not wanted:
        return  # the whole module stands in NO_COUNTERPART
    module = importlib.import_module(port_module_name(rel))
    missing = []
    for name, key in sorted(wanted.items()):
        port_name = RENAMED[key][0] if key in RENAMED else name
        if not has_path(module, port_name):
            missing.append(f"{name} (as {port_name})"
                           if port_name != name else name)
    assert not missing, (
        f"{port_module_name(rel)} lacks the reference's {missing}; port "
        "them, or give a reason in RENAMED / NO_COUNTERPART and ROADMAP.md "
        "§1")


def cli_surface(path: str) -> "dict[str, set]":
    """{subcommand ('' for the main parser): the option strings and
    positional names its ``add_argument`` calls declare}."""
    tree = ast.parse(open(os.path.join(REPO, path)).read())
    sub_of = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Call)
                and isinstance(node.value.func, ast.Attribute)
                and node.value.func.attr == "add_parser"):
            sub_of[node.targets[0].id] = node.value.args[0].value
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            owner = getattr(node.func.value, "id", "")
            out.setdefault(sub_of.get(owner, ""), set()).update(
                a.value for a in node.args if isinstance(a, ast.Constant)
                and isinstance(a.value, str))
    return out


@pytest.mark.parametrize("ref_path,port_path", CLI_PAIRS,
                         ids=[p[0] for p in CLI_PAIRS])
def test_every_cli_flag_has_a_counterpart(ref_path, port_path):
    ref, port = cli_surface(ref_path), cli_surface(port_path)
    assert ref, f"{ref_path}: no add_argument call found"
    renamed_to = {v[0] for k, v in RENAMED.items()
                  if k.startswith(ref_path + "::")}
    missing, extra = [], []
    for sub, flags in sorted(ref.items()):
        if f"{ref_path}::{sub}" in NO_COUNTERPART:
            continue
        got = port.get(sub)
        if got is None:
            missing.append(f"subcommand {sub!r}")
            continue
        for flag in sorted(flags):
            key = f"{ref_path}::{flag}"
            want = RENAMED[key][0] if key in RENAMED else flag
            if want not in got:
                missing.append(f"{sub} {want}".strip())
        extra += [f"{sub} {f}".strip() for f in sorted(
            got - flags - PORT_EXTRA_FLAGS - renamed_to)]
    for sub in sorted(set(port) - set(ref)):
        extra.append(f"subcommand {sub!r}")
    assert not missing, f"{port_path} lacks {ref_path}'s {missing}"
    assert not extra, f"{port_path} adds {extra} beyond {ref_path}"


def pallas_sites() -> "list[tuple[str, str, int]]":
    """(file, innermost enclosing function, line) of each
    ``*.pallas_call(...)`` call node under ``dmlc_core_tpu/``."""
    sites = []

    def visit(node, rel, fn):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                visit(child, rel, child.name)
                continue
            if (isinstance(child, ast.Call)
                    and isinstance(child.func, ast.Attribute)
                    and child.func.attr == "pallas_call"):
                sites.append((f"dmlc_core_tpu/{rel}", fn, child.lineno))
            visit(child, rel, fn)

    for rel in ref_modules():
        visit(ast.parse(open(os.path.join(REF, rel)).read()), rel,
              "<module>")
    return sorted(sites)


def kernel_table_rows() -> "list[str]":
    """The body rows of PERF.md §6's table of TPU kernels."""
    text = open(os.path.join(REPO, "PERF.md")).read()
    section = text.split("\n## 6.")[1].split("\n## ")[0]
    lines = section.splitlines()
    head = next(i for i, ln in enumerate(lines)
                if ln.startswith("| TPU kernel |"))
    rows = []
    for ln in lines[head + 2:]:
        if not ln.startswith("|"):
            break
        rows.append(ln)
    return rows


def test_every_pallas_call_site_has_a_ported_kernel():
    sites = pallas_sites()
    assert sites, "no pl.pallas_call site found in the JAX package"
    rows = kernel_table_rows()
    unported = [s for s in sites if not any(
        f"`{s[0]}" in row and f"`{s[1]}`" in row and f":{s[2]}" in row
        for row in rows)]
    assert not unported, (
        f"pl.pallas_call sites {unported} have no row (file, function and "
        "line) in PERF.md §6's kernel table")
    for row in rows:
        assert any(f"`{s[0]}" in row for s in sites), (
            f"PERF.md §6 row names no pallas_call site: {row[:120]}")
        sources = re.findall(r"`(?:dmlc_core_tpu_torch/)?(csrc/[\w./-]+)`",
                             row)
        assert sources, f"PERF.md §6 row names no csrc/ source: {row[:120]}"
        for src in sources:
            assert os.path.isfile(os.path.join(PORT, src)), src


def test_the_tables_name_real_reference_names_with_reasons():
    cli = {ref: cli_surface(ref) for ref, _ in CLI_PAIRS}
    roadmap = open(os.path.join(REPO, "ROADMAP.md")).read()
    section1 = roadmap.split("### 1.")[1].split("\n### 2.")[0]
    for table in (RENAMED, NO_COUNTERPART):
        for key, entry in table.items():
            reason = entry[1] if table is RENAMED else entry
            assert len(reason.split()) >= 4, key
            path, name = key.split("::")
            if path in cli:
                assert name in cli[path] or name in set().union(
                    *cli[path].values()), key
            else:
                assert public_names(path).get(name) == key, key
            if table is NO_COUNTERPART:
                assert path in section1 and name in section1, (
                    f"ROADMAP.md §1 gives no reason for {key}")
