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
  existing CUDA source under ``dmlc_core_tpu_torch/csrc/``;
- a public function or method (``__init__`` included) takes its
  parameters otherwise than the reference's (the signature gate, both
  sides read with ``ast``): a reference parameter is missing or
  keyword-only in the port, a default differs, a parameter positional in
  both sits at another index, or a parameter only the port has
  (``device``, ``pin``, ``group``, ...) is positional before one of the
  reference's. ``SIGNATURE_EXCEPTIONS`` maps a reference parameter to the
  port's name for it, or to None where the port has none (ROADMAP.md §1
  says why);
- a script under ``bin/`` has no ``-torch`` counterpart that imports the
  port's module where the script imports the reference's.
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
}

# "<reference file>::<function or Class.method>" ->
#     ({reference parameter: the port's parameter, or None}, why)
SIGNATURE_EXCEPTIONS = {
    "ops/pallas_kernels.py::csr_to_dense_pallas": (
        {"chunk": None, "interpret": None},
        "the Pallas grid's tile and interpret mode; the CUDA kernel runs "
        "a thread a nonzero and the CPU path is the plain version"),
    "parallel/ring.py::ring_allreduce": (
        {"axis_name": "group"},
        "a named shard_map axis; the port's ring runs over a process "
        "group"),
    "parallel/ring.py::ring_attention": (
        {"axis_name": "group"},
        "a named shard_map axis; the port's ring runs over a process "
        "group"),
    "parallel/ring.py::ring_attention_zigzag": (
        {"axis_name": "group"},
        "a named shard_map axis; the port's ring runs over a process "
        "group"),
    "parallel/ring.py::sequence_parallel_attention": (
        {"mesh": None, "axis_name": "group"},
        "a JAX mesh and its axis name; the port takes the axis's process "
        "group, so causal and layout move up one place"),
    "parallel/pipeline_parallel.py::pipeline_apply": (
        {"axis_name": "group"},
        "a named shard_map axis; the port's stages are the ranks of a "
        "process group"),
    "models/linear.py::LinearLearner.__init__": (
        {"axis_name": None},
        "the mesh axis the reference's psum names; the port reduces over "
        "the DataMesh's process group"),
    "models/fm.py::FMLearner.__init__": (
        {"axis_name": None},
        "the mesh axis the reference's psum names; the port reduces over "
        "the DataMesh's process group"),
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


# -- the signature gate -------------------------------------------------
def port_source(rel: str) -> str:
    """The port's source file for reference module ``rel``."""
    path = os.path.join(PORT, *port_module_name(rel).split(".")[1:])
    return path + ".py" if os.path.isfile(path + ".py") else \
        os.path.join(path, "__init__.py")


def module_defs(path: str, depth: int = 0) -> dict:
    """Top-level functions and classes of a module -> (node, the defs of
    its module), following ``from dmlc_core_tpu_torch... import`` lines
    for the names the module imports rather than defines."""
    tree = ast.parse(open(path).read())
    defs = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            defs[node.name] = (node, defs)
    for node in tree.body:
        if (depth < 4 and isinstance(node, ast.ImportFrom) and node.module
                and node.module.split(".")[0] == "dmlc_core_tpu_torch"):
            base = os.path.join(REPO, *node.module.split("."))
            src = base + ".py" if os.path.isfile(base + ".py") else \
                os.path.join(base, "__init__.py")
            if not os.path.isfile(src):
                continue
            theirs = module_defs(src, depth + 1)
            for a in node.names:
                if a.name in theirs:
                    defs.setdefault(a.asname or a.name, theirs[a.name])
    return defs


def find_method(cls: ast.ClassDef, defs: dict, name: str):
    """The def of method ``name`` of ``cls``, through bases defined in
    its module; None if neither has one."""
    for m in cls.body:
        if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                m.name == name:
            return m
    for b in cls.bases:
        if isinstance(b, ast.Name) and isinstance(
                defs.get(b.id, (None,))[0], ast.ClassDef):
            base, base_defs = defs[b.id]
            found = find_method(base, base_defs, name)
            if found is not None:
                return found
    return None


def parameters(fn) -> list:
    """[(name, kind, default node or None)]; kind is ``pos`` (positional
    or keyword, or positional only), ``var``, ``kw`` or ``varkw``."""
    a = fn.args
    pos = a.posonlyargs + a.args
    defaults = [None] * (len(pos) - len(a.defaults)) + list(a.defaults)
    out = [(p.arg, "pos", d) for p, d in zip(pos, defaults)]
    if a.vararg:
        out.append((a.vararg.arg, "var", None))
    out += [(p.arg, "kw", d) for p, d in zip(a.kwonlyargs, a.kw_defaults)]
    if a.kwarg:
        out.append((a.kwarg.arg, "varkw", None))
    return out


def default_value(node):
    """A default's value where it is a constant expression, else its
    source."""
    if node is None:
        return None
    try:
        return ("value", eval(compile(ast.Expression(node), "<default>",
                                      "eval"), {"__builtins__": {}}, {}))
    except Exception:  # a name (np.float32, ...): compare the source
        return ("source", ast.unparse(node))


def signature_faults(key: str, ref_fn, port_fn) -> list:
    """Where ``port_fn`` takes its parameters otherwise than ``ref_fn``
    (see the module docstring)."""
    mapping = SIGNATURE_EXCEPTIONS.get(key, ({}, ""))[0]
    ref = []  # (name in the port, kind, default, renamed)
    for name, kind, default in parameters(ref_fn):
        if name not in mapping:
            ref.append((name, kind, default, False))
        elif mapping[name] is not None:
            ref.append((mapping[name], kind, default, True))
    port = {n: (k, d) for n, k, d in parameters(port_fn)}
    ref_pos = [r[0] for r in ref if r[1] == "pos"]
    port_pos = [n for n, k, _ in parameters(port_fn) if k == "pos"]
    faults = []
    for name, kind, default, renamed in ref:
        if name not in port:
            faults.append(f"{name} is missing")
            continue
        pkind, pdefault = port[name]
        if kind == "pos" and pkind != "pos":
            faults.append(f"{name} is keyword-only")
        if not renamed and default_value(default) != default_value(
                pdefault):
            faults.append(
                f"{name}'s default is "
                f"{ast.unparse(pdefault) if pdefault else 'none'}, not "
                f"{ast.unparse(default) if default else 'none'}")
        if kind == "pos" == pkind and \
                ref_pos.index(name) != port_pos.index(name):
            faults.append(f"{name} sits at {port_pos.index(name)}, not "
                          f"{ref_pos.index(name)}")
    ours = set(r[0] for r in ref)
    for i, name in enumerate(port_pos):
        later = [n for n in port_pos[i + 1:] if n in ours]
        if name not in ours and later:
            faults.append(f"port-only {name} is positional before "
                          f"{later[-1]}")
    return faults


def signature_pairs(rel: str) -> list:
    """(table key, reference def, port def or None) of every public
    function and of every public method or ``__init__`` of every public
    class defined in reference module ``rel``."""
    tree = ast.parse(open(os.path.join(REF, rel)).read())
    port = module_defs(port_source(rel))
    pairs = []
    for node in tree.body:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)) or node.name.startswith("_"):
            continue
        key = f"{rel}::{node.name}"
        if key in NO_COUNTERPART:
            continue
        name = RENAMED[key][0] if key in RENAMED else node.name
        theirs, defs = port.get(name, (None, {}))
        if not isinstance(node, ast.ClassDef):
            pairs.append((key, node, theirs if not isinstance(
                theirs, ast.ClassDef) else None))
            continue
        for m in node.body:
            if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                    (m.name == "__init__" or not m.name.startswith("_")):
                pairs.append((f"{key}.{m.name}", m,
                              find_method(theirs, defs, m.name)
                              if isinstance(theirs, ast.ClassDef)
                              else None))
    return pairs


@pytest.mark.parametrize("rel", ref_modules())
def test_every_signature_matches_the_reference(rel):
    if not os.path.isfile(port_source(rel)):
        assert all(k in NO_COUNTERPART for k in public_names(rel).values())
        return
    faults = []
    for key, ref_fn, port_fn in signature_pairs(rel):
        if port_fn is None:
            faults.append(f"{key}: no def found in the port")
            continue
        faults += [f"{key}: {f}"
                   for f in signature_faults(key, ref_fn, port_fn)]
    assert not faults, (
        f"{port_module_name(rel)} takes parameters otherwise than the "
        f"reference: {faults}; match them, or give a reason in "
        "SIGNATURE_EXCEPTIONS and ROADMAP.md §1")


def test_signature_exceptions_name_real_parameters_with_reasons():
    roadmap = open(os.path.join(REPO, "ROADMAP.md")).read()
    section1 = roadmap.split("### 1.")[1].split("\n### 2.")[0]
    pairs = {}
    for rel in {k.split("::")[0] for k in SIGNATURE_EXCEPTIONS}:
        pairs.update({k: (r, p) for k, r, p in signature_pairs(rel)})
    for key, (mapping, reason) in SIGNATURE_EXCEPTIONS.items():
        assert len(reason.split()) >= 4, key
        assert key in pairs, f"{key} is no public def of the reference"
        ref_fn, port_fn = pairs[key]
        ref_names = [n for n, _, _ in parameters(ref_fn)]
        port_names = [n for n, _, _ in parameters(port_fn)]
        path, name = key.split("::")
        assert path in section1 and name.split(".")[0] in section1, (
            f"ROADMAP.md §1 gives no reason for {key}")
        for ref_name, port_name in mapping.items():
            assert ref_name in ref_names, f"{key}: no parameter {ref_name}"
            assert port_name is None or port_name in port_names, (key,
                                                                   port_name)
            assert ref_name in section1, (
                f"ROADMAP.md §1 gives no reason for {key}'s {ref_name}")


def bin_imports(path: str) -> list:
    """The modules a script's ``import`` and ``from`` lines name."""
    out = []
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.ImportFrom) and node.module:
            out.append(node.module)
        elif isinstance(node, ast.Import):
            out += [a.name for a in node.names]
    return out


BIN = os.path.join(REPO, "bin")


@pytest.mark.parametrize("script", sorted(
    f for f in os.listdir(BIN) if not f.endswith("-torch")))
def test_every_bin_script_has_a_torch_counterpart(script):
    ref = bin_imports(os.path.join(BIN, script))
    path = os.path.join(BIN, script + "-torch")
    assert os.path.isfile(path) and os.access(path, os.X_OK), (
        f"bin/{script} has no executable bin/{script}-torch")
    ours = bin_imports(path)
    for mod in ref:
        if mod.split(".")[0] == "dmlc_core_tpu":
            assert "dmlc_core_tpu_torch" + mod[len("dmlc_core_tpu"):] in ours
    assert not [m for m in ours if m.split(".")[0] in (
        "dmlc_core_tpu", "jax", "jaxlib", "ml_dtypes")], ours
