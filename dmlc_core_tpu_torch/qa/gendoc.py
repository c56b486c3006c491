#!/usr/bin/env python3
"""The port's doc lane: render ``doc/torch/`` from the live port,
warnings-as-errors (``scripts/gendoc.py``'s counterpart).

The pages are generated: the Python API page by introspecting the port's
modules, the parameters page from the port's own build of the native
format registry and from the env-knob extraction that the analyzer holds
the page to (:mod:`.contracts`). Any public symbol without a docstring, or
a relative link that resolves to no file, fails the run::

    python -m dmlc_core_tpu_torch.qa.gendoc [--out DIR]

``--out`` writes the pages elsewhere (the tests compare them with the
committed ones); the default is ``doc/torch/`` of this checkout.
"""

import argparse
import importlib
import inspect
import os
import re
import sys

if not __package__:  # run as a file path: make the package importable
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
from dmlc_core_tpu_torch.qa import contracts  # noqa: E402
from dmlc_core_tpu_torch.qa.srcwalk import REPO  # noqa: E402

DOC_DIR = os.path.join(REPO, "doc", "torch")
PKG = "dmlc_core_tpu_torch"

# the port's public Python surface, grouped as the index presents it
MODULE_GROUPS = [
    ("Foundation", [
        "base", "params", "registry", "config", "serializer", "telemetry",
    ]),
    ("Data & I/O", [
        "data", "io.native", "io.convert", "io.tls_proxy",
    ]),
    ("CUDA device bridge", [
        "device.device_iter", "device.sharding",
    ]),
    ("Ops, kernels & models", [
        "ops.sparse", "ops.attention", "ops.ranking", "ops.hopper_kernels",
        "models.linear", "models.fm", "models.transformer",
        "models.tp_transformer", "models.convert",
    ]),
    ("Parallelism & communication", [
        "parallel.axis", "parallel.ring", "parallel.pipeline_parallel",
        "parallel.distributed", "parallel.elastic",
    ]),
    ("Distributed launch", [
        "tracker.submit", "tracker.opts", "tracker.rendezvous",
        "tracker.topology", "tracker.wire", "tracker.launchers",
        "tracker.bootstrap", "tracker.supervisor", "tracker.client",
        "tracker.mesos_status", "tracker.minihttp", "tracker.event_log",
    ]),
    ("Online scoring", [
        "serving.server", "serving.model", "serving.batching",
        "serving.frontend",
    ]),
    ("Training entry points", [
        "train", "train_lm",
    ]),
    ("Benchmark", [
        "bench", "bench.datasets", "bench.record", "bench.host_lanes",
        "bench.ingest", "bench.kernel_probe", "bench.device_lane",
        "bench.serving_lane", "bench.remote_lane", "bench.loadrig",
        "bench.mesh_lane", "bench.mesh_worker",
    ]),
    ("Utilities", [
        "utils.checkpoint", "utils.fs_fault", "utils.timer",
    ]),
    ("QA lane", [
        "qa.srcwalk", "qa.lint", "qa.contracts", "qa.analyze", "qa.gendoc",
    ]),
]

warnings = []


def warn(msg: str) -> None:
    """Record a doc-lane warning (each one fails the run)."""
    warnings.append(msg)
    print(f"doc warning: {msg}", file=sys.stderr)


def first_paragraph(doc) -> str:
    """The first paragraph of a docstring, on one line."""
    if not doc:
        return ""
    return inspect.cleandoc(doc).split("\n\n")[0].replace("\n", " ")


def signature_of(obj) -> str:
    """``obj``'s signature with machine-dependent defaults masked, so the
    page regenerates byte for byte on any checkout."""
    try:
        sig = str(inspect.signature(obj))
    except (TypeError, ValueError):
        return "(...)"
    # non-literal defaults repr with memory addresses
    # ("<function f at 0x7f...>"), and path defaults name the checkout
    sig = re.sub(r"<([\w.]+)[^<>]* at 0x[0-9a-f]+>", r"<\1>", sig)
    return sig.replace(REPO, "<repo>")


def public_names(mod):
    """``__all__``, or the module's own public classes and functions."""
    if hasattr(mod, "__all__"):
        return list(mod.__all__)
    return [n for n, v in vars(mod).items()
            if not n.startswith("_")
            and (inspect.isclass(v) or inspect.isfunction(v))
            and getattr(v, "__module__", None) == mod.__name__]


def render_module(modname: str) -> str:
    """One module's section of the API page."""
    mod = importlib.import_module(modname)
    out = [f"## `{modname}`", ""]
    if not mod.__doc__:
        warn(f"{modname}: module has no docstring")
    else:
        out += [first_paragraph(mod.__doc__), ""]
    for name in public_names(mod):
        obj = getattr(mod, name, None)
        if obj is None:
            warn(f"{modname}.{name}: listed in __all__ but missing")
            continue
        if inspect.isclass(obj):
            out.append(f"### class `{name}{signature_of(obj)}`")
            out.append("")
            if not obj.__doc__:
                warn(f"{modname}.{name}: class has no docstring")
            else:
                out += [first_paragraph(obj.__doc__), ""]
            # inherited public API of the port's own bases documents on
            # every subclass (never object's or a library's)
            members = {}
            for klass in reversed(obj.__mro__):
                if klass.__module__.startswith(PKG):
                    members.update(vars(klass))
            for mname, meth in sorted(members.items()):
                if mname.startswith("_"):
                    continue
                # unwrap BEFORE the callable test: classmethod objects are
                # not callable themselves (pre-3.10 semantics kept)
                if isinstance(meth, (staticmethod, classmethod)):
                    meth = meth.__func__
                if not callable(meth):
                    continue
                doc = first_paragraph(getattr(meth, "__doc__", ""))
                if not doc:
                    warn(f"{modname}.{name}.{mname}: method has no "
                         f"docstring")
                out.append(f"- `{mname}{signature_of(meth)}` — {doc}")
            out.append("")
        elif inspect.isfunction(obj):
            out.append(f"### `{name}{signature_of(obj)}`")
            out.append("")
            if not obj.__doc__:
                warn(f"{modname}.{name}: function has no docstring")
            else:
                out += [first_paragraph(obj.__doc__), ""]
        # plain constants need no entry
    return "\n".join(out)


def gen_api() -> str:
    """The Python API page."""
    parts = ["# dmlc_core_tpu_torch Python API",
             "",
             "Generated by `python -m dmlc_core_tpu_torch.qa.gendoc` — do "
             "not edit by hand; `make torch-doc` regenerates it and fails "
             "on undocumented public symbols.",
             ""]
    for group, mods in MODULE_GROUPS:
        parts += [f"# {group}", ""]
        for m in mods:
            parts.append(render_module(f"{PKG}.{m}"))
            parts.append("")
    return "\n".join(parts)


def gen_parameters() -> str:
    """The parameters page: the Parameter machinery, the native format
    registry and the generated env-knob table."""
    from dmlc_core_tpu_torch.io.native import parser_formats_doc
    from dmlc_core_tpu_torch.params import Parameter, field

    class _Example(Parameter):
        """doc example"""
        learning_rate = field(float, default=0.01,
                              desc="step size", lower_bound=0.0)
        num_hidden = field(int, default=128, desc="hidden units")

    return "\n".join([
        "# Parameters",
        "",
        "Generated by `python -m dmlc_core_tpu_torch.qa.gendoc` from the "
        "live port.",
        "",
        "The port carries the reference's reflection machinery: its own "
        "build of the native core's C++ `Parameter<T>` structs "
        "(`cpp/src/parameter.h`) drives the native parsers, and "
        "`dmlc_core_tpu_torch.params.Parameter` serves configs, with typed "
        "fields, defaults, ranges, enums and generated docstrings.",
        "",
        "## Declaring parameters (Python)",
        "",
        "```python",
        "from dmlc_core_tpu_torch.params import Parameter, field",
        "",
        "class Example(Parameter):",
        "    learning_rate = field(float, default=0.01, desc='step size',",
        "                          lower_bound=0.0)",
        "    num_hidden = field(int, default=128, desc='hidden units')",
        "```",
        "",
        "`Example().init({...})` validates and coerces; unknown or "
        "out-of-range keys raise with the generated docstring:",
        "",
        "```",
        _Example.docstring(),
        "```",
        "",
        "# Native data formats",
        "",
        "Formats resolve by name through the native registry "
        "(`cpp/src/registry.h`), as in the reference "
        "([../parameters.md](../parameters.md)); `?format=` URI arguments "
        "or the `fmt` argument select one; `.rec`/`.drec` files are "
        "auto-detected by suffix.",
        "",
        parser_formats_doc().rstrip(),
        "",
        "# Environment knobs",
        "",
        "Every `DMLC_*`/`DCT_*` environment variable the port reads "
        "(`dmlc_core_tpu_torch/`, the native core's `cpp/src/` and "
        "`chip_smoke.py`), extracted by "
        "`dmlc_core_tpu_torch/qa/contracts.py` — the same extraction "
        "`make torch-analyze` diffs this table against, so a knob added, "
        "removed or re-defaulted without regenerating this page fails the "
        "lane. The analyzer also holds each knob of the reference's table "
        "([../parameters.md](../parameters.md)) to the same default here, "
        "unless `NO_COUNTERPART` gives the reason the port does not read "
        "it. Defaults: a literal is the in-code fallback; `unset` means "
        "the raw value is read with behavior-defined fallback; `computed` "
        "means the default derives from other knobs at run time; "
        "`required` means the process exports it before the read.",
        "",
        contracts.render_knob_table(contracts.collect_repo_knobs(REPO)),
    ])


def gen_index() -> str:
    """The index page of ``doc/torch/``."""
    return "\n".join([
        "# dmlc_core_tpu_torch documentation",
        "",
        "The PyTorch/CUDA port of `dmlc_core_tpu` for one NVIDIA Hopper "
        "GPU. The reference's pages ([../index.md](../index.md)) describe "
        "the semantics both packages share; these are generated from the "
        "port.",
        "",
        "| page | contents |",
        "|---|---|",
        "| [api.md](api.md) | generated Python API reference of "
        "`dmlc_core_tpu_torch` |",
        "| [parameters.md](parameters.md) | parameter system, the native "
        "data-format registry and the generated DMLC_*/DCT_* env-knob "
        "table of the port |",
        "| [../observability.md](../observability.md) | the metric "
        "catalog the port's METRIC_HELP is held to (less the rows "
        "`qa/contracts.py` NO_COUNTERPART gives a reason for) |",
        "| [../analysis.md](../analysis.md) | the analyzer's passes; the "
        "port's `qa/analyze.py` runs them over the port |",
        "",
        "Build: `make torch-doc` (part of `make ci`) regenerates these "
        "pages and fails on any undocumented public symbol or broken "
        "relative link; `make torch-lint` and `make torch-analyze` are the "
        "rest of the port's QA lane.",
    ])


_LINK_RE = re.compile(r"\]\(([^)#\s]+)(?:#[^)\s]*)?\)")


def check_doc_links(pages, out_dir) -> None:
    """Every relative link of the generated pages resolves to a file
    (links into the reference's doc/ resolve against this checkout)."""
    for fname, text in sorted(pages.items()):
        for i, line in enumerate(text.splitlines(), 1):
            for m in _LINK_RE.finditer(line):
                target = m.group(1)
                if "://" in target or target.startswith("mailto:"):
                    continue
                resolved = os.path.normpath(os.path.join(DOC_DIR, target))
                local = os.path.normpath(os.path.join(out_dir, target))
                if not (os.path.exists(resolved) or os.path.exists(local)):
                    warn(f"doc/torch/{fname}:{i}: broken relative link "
                         f"({target})")


def main(argv=None) -> int:
    """Write the pages; exit 1 when any warning was raised."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=DOC_DIR,
                    help="directory to write the pages into "
                         "(default: doc/torch/ of this checkout)")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    pages = {
        "api.md": gen_api(),
        "parameters.md": gen_parameters(),
        "index.md": gen_index(),
    }
    for name, text in pages.items():
        with open(os.path.join(args.out, name), "w") as f:
            f.write(text.rstrip() + "\n")
        print(f"doc: wrote {os.path.join(args.out, name)} "
              f"({len(text)} bytes)")
    check_doc_links(pages, args.out)
    if warnings:
        print(f"doc: {len(warnings)} warning(s) — failing (warnings are "
              f"errors in the doc lane)", file=sys.stderr)
        return 1
    print("doc: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
