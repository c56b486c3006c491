#!/usr/bin/env python3
"""The port's lint lane: ``scripts/lint.py``'s rules over the port's tree
(:mod:`.srcwalk`: ``dmlc_core_tpu_torch/``, the port's tests and
``chip_smoke.py``).

Checks, per file class:
  all sources   no tabs, no trailing whitespace, newline at EOF,
                no CRLF line endings
  *.py          parses (ast.parse), line length <= 88, unused imports,
                undefined bare names (NameError-lite: loads of names never
                bound anywhere in the module, imported, or built in),
                mutable default arguments, bare `except:`
  *.cu / *.cc / *.h
                line length <= 90; headers carry an include guard

    python -m dmlc_core_tpu_torch.qa.lint

Exit status 0 when clean, 1 when any file has a problem.
"""

import ast
import builtins
import os
import re
import sys

if not __package__:  # run as a file path: make the package importable
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
from dmlc_core_tpu_torch.qa.srcwalk import (REPO,  # noqa: E402
                                            iter_sources)

PY_MAX = 88
CC_MAX = 90


def lint_file(path: str) -> list:
    """Every problem of one file, as `rel:line: message` strings."""
    errs = []
    rel = os.path.relpath(path, REPO)
    with open(path, "rb") as fh:
        raw = fh.read()
    if b"\r\n" in raw:
        errs.append(f"{rel}: CRLF line endings")
    if raw and not raw.endswith(b"\n"):
        errs.append(f"{rel}: missing newline at EOF")
    text = raw.decode("utf-8", errors="replace")
    limit = PY_MAX if path.endswith(".py") else CC_MAX
    for i, line in enumerate(text.split("\n")):
        if "\t" in line:
            errs.append(f"{rel}:{i + 1}: tab character")
        if line != line.rstrip():
            errs.append(f"{rel}:{i + 1}: trailing whitespace")
        if len(line) > limit:
            errs.append(f"{rel}:{i + 1}: line too long "
                        f"({len(line)} > {limit})")
    if path.endswith(".py"):
        try:
            tree = ast.parse(text, filename=rel)
        except SyntaxError as e:
            errs.append(f"{rel}:{e.lineno}: syntax error: {e.msg}")
        else:
            errs += lint_python_ast(rel, tree, text.split("\n"))
    elif path.endswith(".h"):
        if not re.search(r"#ifndef \w+_H_\n#define \w+_H_", text):
            errs.append(f"{rel}: missing DCT-style include guard")
    return errs


def _iter_args(args: ast.arguments):
    return (args.posonlyargs + args.args + args.kwonlyargs
            + ([args.vararg] if args.vararg else [])
            + ([args.kwarg] if args.kwarg else []))


def _string_annotation_names(tree: ast.AST) -> set:
    """Names referenced inside QUOTED (forward-reference) annotations —
    they live in ast.Constant strings, invisible to the Name walk."""
    out = set()
    anns = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.AnnAssign, ast.arg)):
            anns.append(node.annotation)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            anns.append(node.returns)
    for ann in anns:
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            try:
                sub = ast.parse(ann.value, mode="eval")
            except SyntaxError:
                continue
            for n in ast.walk(sub):
                if isinstance(n, ast.Name):
                    out.add(n.id)
    return out


def lint_python_ast(rel: str, tree: ast.AST, lines: list) -> list:
    """AST-level checks (the pyflakes-lite slice of the reference's pylint
    lane): unused imports, names loaded but never bound anywhere in the
    module, mutable default arguments (defs AND lambdas), bare excepts.
    Scope handling is deliberately module-coarse — a name bound ANYWHERE
    (any def/class/comprehension/assignment/match capture) counts as
    defined, so closures and late-binding patterns cannot false-positive;
    what remains caught is the genuine typo class."""
    errs = []
    imported = {}   # alias name -> lineno
    bound = set()
    loaded = {}     # name -> first lineno
    export_names = set()
    star_import = False

    def noqa(node) -> bool:
        # a noqa anywhere in the statement's physical span suppresses it
        # (multi-line parenthesized imports carry it on any line)
        last = getattr(node, "end_lineno", node.lineno) or node.lineno
        return any("noqa" in lines[i - 1]
                   for i in range(node.lineno, last + 1)
                   if 0 < i <= len(lines))

    def check_defaults(node, label: str):
        args = node.args
        for dflt in args.defaults + [d for d in args.kw_defaults
                                     if d is not None]:
            if isinstance(dflt, (ast.List, ast.Dict, ast.Set)):
                errs.append(f"{rel}:{node.lineno}: mutable default "
                            f"argument in {label}")

    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                name = (a.asname or a.name).split(".")[0]
                if not noqa(node):
                    imported[name] = node.lineno
                bound.add(name)
        elif isinstance(node, ast.ImportFrom):
            if node.module == "__future__":
                continue  # compiler directive, not a binding to "use"
            for a in node.names:
                if a.name == "*":
                    star_import = True
                    continue
                name = a.asname or a.name
                if not noqa(node):
                    imported[name] = node.lineno
                bound.add(name)
        elif isinstance(node, ast.Lambda):
            bound.update(arg.arg for arg in _iter_args(node.args))
            check_defaults(node, "lambda")
        elif isinstance(node, ast.Name):
            if isinstance(node.ctx, ast.Load):
                loaded.setdefault(node.id, node.lineno)
            else:
                bound.add(node.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            bound.add(node.name)
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                bound.update(arg.arg for arg in _iter_args(node.args))
                check_defaults(node, f"{node.name}()")
        elif isinstance(node, ast.ExceptHandler):
            if node.type is None:
                errs.append(f"{rel}:{node.lineno}: bare `except:` "
                            f"(catch Exception or narrower)")
            if node.name:
                bound.add(node.name)
        elif isinstance(node, (ast.Global, ast.Nonlocal)):
            bound.update(node.names)
        elif isinstance(node, ast.MatchAs) and node.name:
            bound.add(node.name)
        elif isinstance(node, ast.MatchStar) and node.name:
            bound.add(node.name)
        elif isinstance(node, ast.MatchMapping) and node.rest:
            bound.add(node.rest)
        elif isinstance(node, (ast.Assign, ast.AugAssign)):
            # __all__ construction (plain or incremental): its string
            # elements are exports, which count as "uses" of an import
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if isinstance(t, ast.Name) and t.id == "__all__":
                    for elt in getattr(node.value, "elts", []):
                        if isinstance(elt, ast.Constant):
                            export_names.add(str(elt.value))

    for name in _string_annotation_names(tree):
        loaded.setdefault(name, 0)

    dunder_ok = {"__doc__", "__name__", "__file__", "__all__",
                 "__builtins__", "__class__", "__debug__", "__spec__"}
    known = bound | set(imported) | set(dir(builtins)) | dunder_ok
    for name, lineno in sorted(loaded.items(), key=lambda kv: kv[1]):
        # star imports make holes in the namespace model: disable the
        # undefined check for such modules
        if star_import:
            break
        if name not in known:
            errs.append(f"{rel}:{lineno}: undefined name `{name}`")
    for name, lineno in sorted(imported.items(), key=lambda kv: kv[1]):
        if name not in loaded and name not in export_names and \
                name != "_":
            errs.append(f"{rel}:{lineno}: unused import `{name}`")
    return errs


def main() -> int:
    """Lint the port's tree; prints every problem and a summary line."""
    bad_files = total = 0
    for path in iter_sources():
        total += 1
        errs = lint_file(path)
        if errs:
            bad_files += 1
            for e in errs:
                print(e)
    print(f"lint: {total} files checked, {bad_files} with problems")
    return 1 if bad_files else 0  # exit status wraps mod 256 — keep it 0/1


if __name__ == "__main__":
    sys.exit(main())
