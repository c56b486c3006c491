#!/usr/bin/env python3
"""The port's concurrency and invariant analyzer (``scripts/analyze.py``
re-scoped to ``dmlc_core_tpu_torch/``).

The same passes as the reference's, over the port's copies of the code
they were written to guard:

1. **Python lock discipline** (``dmlc_core_tpu_torch/{tracker,data,
   serving}/``): a cross-module call graph over ``with <lock>:`` regions
   and ``.acquire()``/``.release()`` pairs flags any call that can
   re-acquire a non-reentrant lock already held, and any blocking call
   (socket, subprocess, sleep, file I/O, joins and waits) reachable while
   a lock is held. Escape: ``# lock-ok: <reason>``.

2. **C++ capability check** (``dmlc_core_tpu_torch/csrc/``; ``cpp/`` is
   the reference lane's): a member declared ``DMLC_GUARDED_BY(m)`` is
   touched only under a lock of ``m`` or in a ``DMLC_REQUIRES(m)``
   function.

3. **Invariant lints**: no raw ``int()``/``float()`` over ``os.environ``
   in ``dmlc_core_tpu_torch/`` outside its ``tracker/wire.py`` (use
   ``wire.env_int``/``env_float``/``env_enum``; ``# env-ok: <reason>``),
   no ``atoi``-family or ``getenv``-fed parses and no raw ``rename`` or
   unchecked ``fsync`` in the port's C++ (``// env-ok:``,
   ``// fs-ok:``), and no runtime ``assert`` in ``tracker``, ``data``,
   ``io`` and ``serving`` (``# assert-ok: <reason>``).

4. **Cross-boundary contracts** (:mod:`.contracts`): the port's two C
   boundaries (``cpp/src/capi.cc`` against ``io/native.py``, and
   ``csrc/*.cu``'s ``extern "C"`` functions against
   ``ops/hopper_kernels.py``), with the compile-time struct layout probe;
   the metric catalog (the reference's ``doc/observability.md`` less
   ``NO_COUNTERPART``) against the port's registrations and its
   ``METRIC_HELP``, whose lines must equal the reference's; the env knobs
   against ``doc/torch/parameters.md``, and the reference's knobs against
   what the port reads; the tracker's wire words. Escapes:
   ``# abi-ok: <reason>``, ``# contract-ok: <reason>``.

    python -m dmlc_core_tpu_torch.qa.analyze            # this checkout
    python -m dmlc_core_tpu_torch.qa.analyze --repo DIR # another checkout
    python dmlc_core_tpu_torch/qa/analyze.py --root DIR # a fixture tree

Exit code is the finding count (capped at 125 so it never wraps mod 256;
0 = clean). ``--root DIR`` analyzes a fixture tree with every file in
scope for every pass, as the reference's ``--root`` does.
"""

import argparse
import ast
import os
import re
import sys
import time

if not __package__:  # run as a file path: make the package importable
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
from dmlc_core_tpu_torch.qa import contracts  # noqa: E402
from dmlc_core_tpu_torch.qa.srcwalk import (REPO,  # noqa: E402
                                            iter_sources)

LOCK_OK_RE = re.compile(r"(?:#|//)\s*lock-ok\s*:?\s*(.*\S)?")
ENV_OK_RE = re.compile(r"(?:#|//)\s*env-ok\s*:?\s*(.*\S)?")
ASSERT_OK_RE = re.compile(r"(?:#|//)\s*assert-ok\s*:?\s*(.*\S)?")
FS_OK_RE = re.compile(r"(?:#|//)\s*fs-ok\s*:?\s*(.*\S)?")
ABI_OK_RE = re.compile(r"(?:#|//)\s*abi-ok\s*:?\s*(.*\S)?")
CONTRACT_OK_RE = re.compile(r"(?:#|//)\s*contract-ok\s*:?\s*(.*\S)?")

# scopes when walking the real repo (relative-path prefixes)
PKG = "dmlc_core_tpu_torch/"
LOCK_SCOPE = (PKG + "tracker/", PKG + "data/", PKG + "serving/")
PY_ENV_SCOPE = (PKG,)
PY_ENV_ALLOW = (PKG + "tracker/wire.py",)
ASSERT_SCOPE = (PKG + "tracker/", PKG + "data/", PKG + "io/",
                PKG + "serving/")
# the port's own C++, which has no checked-parse or fs helpers to allow;
# cpp/ is read only by the contract pass (the reference's analyzer checks
# its locks, parses and fs discipline)
CPP_SCOPE = (PKG + "csrc/",)

# calls considered blocking when reachable with a lock held. Attribute
# names are matched on ANY receiver (conservative: only sites under lock
# regions are ever checked, and audited sites annotate) except string
# literals (" ".join). `close` is deliberately absent: closes are bounded
# teardown and flagging them would bury the real findings.
BLOCKING_ATTRS = {
    "send": "socket send", "sendall": "socket send", "sendto": "socket send",
    "recv": "socket recv", "recv_into": "socket recv",
    "recvfrom": "socket recv", "accept": "socket accept",
    "connect": "socket connect", "connect_ex": "socket connect",
    "recv_all": "wire recv", "recv_int": "wire recv",
    "recv_str": "wire recv", "send_int": "wire send",
    "send_str": "wire send", "makefile": "socket I/O",
    "sleep": "sleep", "poll": "status poll (may exec a CLI)",
    "wait": "blocking wait", "join": "thread join",
    "write": "file/stream write", "read": "file/stream read",
    "readline": "file/stream read", "flush": "stream flush",
    "fsync": "fsync", "communicate": "subprocess I/O",
    "urlopen": "network I/O", "getaddrinfo": "DNS resolution",
    "gethostbyname": "DNS resolution",
    "create_connection": "socket connect",
}
BLOCKING_MODULE_CALLS = {"subprocess": "subprocess call",
                         "select": "select wait"}
BLOCKING_NAME_CALLS = {"open": "open() file I/O", "sleep": "sleep"}


def dotted(node):
    """`a.b.c` -> "a.b.c" for Name/Attribute chains, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def comment_marker(lines, lineno, rx):
    """The marker's reason if `rx` matches on `lineno` (1-based) or in
    the contiguous block of pure-comment lines directly above it (so an
    audited site can carry a multi-line rationale); (found, reason)."""
    def probe(ln):
        if 1 <= ln <= len(lines):
            return rx.search(lines[ln - 1])
        return None

    m = probe(lineno)
    ln = lineno - 1
    while m is None and 1 <= ln <= len(lines) and \
            lines[ln - 1].lstrip().startswith(("#", "//")):
        m = probe(ln)
        ln -= 1
    if m:
        return True, (m.group(1) or "").strip()
    return False, ""


class Findings:
    """The set of (file, line, pass, message) findings of one run."""
    def __init__(self):
        self.items = set()

    def add(self, rel, lineno, pass_name, msg):
        """Record one finding (duplicates collapse)."""
        self.items.add((rel, lineno, pass_name, msg))

    def report(self):
        """Print the findings in order; returns their count."""
        for rel, lineno, pass_name, msg in sorted(self.items):
            print(f"{rel}:{lineno}: [{pass_name}] {msg}")
        return len(self.items)


# ===========================================================================
# Pass 1: Python lock discipline
# ===========================================================================

class _Func:
    """One analyzed function/method: its lock regions and call sites."""

    def __init__(self, module, classname, name, node):
        self.module = module          # module key (relative path)
        self.classname = classname    # enclosing class or None
        self.name = name
        self.node = node
        self.acquires = set()         # lock ids taken anywhere in the body
        # (call_node, held_tuple, region_with_lineno) for every call
        self.calls = []
        self.reacquires = []          # (lock_id, lineno): taken while held
        self.qual = f"{classname}.{name}" if classname else name


def _lock_id(expr, module, classname):
    """Stable identity for a lock expression. `self._x` is class-scoped
    (the same attribute on another instance of the same class IS the same
    lock for deadlock purposes — conservative), bare names module-scoped."""
    if isinstance(expr, ast.Attribute) and \
            isinstance(expr.value, ast.Name) and expr.value.id == "self":
        return f"{module}::{classname}.{expr.attr}"
    d = dotted(expr)
    if d is not None:
        return f"{module}::{d}"
    return f"{module}::<expr>"


def _is_lockish(expr) -> bool:
    """Heuristic: the expression names a lock (its final component ends
    with "lock" — the repo convention: _lock, _send_lock, _lease_lock)."""
    name = None
    if isinstance(expr, ast.Attribute):
        name = expr.attr
    elif isinstance(expr, ast.Name):
        name = expr.id
    return name is not None and name.lower().endswith(("lock", "mutex"))


def _blocking_reason(call):
    """A direct-blocking description for this Call node, or None."""
    f = call.func
    if isinstance(f, ast.Name):
        return BLOCKING_NAME_CALLS.get(f.id)
    if isinstance(f, ast.Attribute):
        if isinstance(f.value, ast.Constant):
            return None  # " ".join(...) and friends
        root = f.value
        while isinstance(root, ast.Attribute):
            root = root.value
        if isinstance(root, ast.Name) and \
                root.id in BLOCKING_MODULE_CALLS and \
                isinstance(f.value, ast.Name):
            return f"{BLOCKING_MODULE_CALLS[root.id]} ({root.id}.{f.attr})"
        if f.attr in BLOCKING_ATTRS:
            return f"{BLOCKING_ATTRS[f.attr]} (.{f.attr}())"
    return None


class _FuncWalker:
    """Walks one function body tracking held locks statement-by-statement
    (with-blocks and acquire/release pairs). Nested defs/lambdas run
    later, NOT under the current locks — they reset the held set."""

    def __init__(self, func: _Func):
        self.f = func

    def walk(self):
        self._suite(self.f.node.body, held=())

    def _suite(self, stmts, held):
        manual = list(held)  # acquire()/release() adjust within this suite
        for st in stmts:
            self._stmt(st, tuple(manual))
            self._apply_manual(st, manual)
            if isinstance(st, ast.Try):
                # the canonical `acquire(); try: ... finally: release()`
                # idiom: the finally suite ALWAYS runs, so its
                # acquire/release effects carry into this suite (else
                # everything after the try would be a false positive)
                for fst in st.finalbody:
                    self._apply_manual(fst, manual)

    def _apply_manual(self, st, manual):
        got = self._manual_acquire(st)
        if got is not None:
            if any(h[0] == got[0] for h in manual):
                self.f.reacquires.append(got)
            manual.append(got)
            self.f.acquires.add(got[0])
        rel = self._manual_release(st)
        if rel is not None:
            for i in range(len(manual) - 1, -1, -1):
                if manual[i][0] == rel:
                    del manual[i]
                    break

    def _manual_acquire(self, st):
        call = self._lock_method_call(st)
        if call and call[1] == "acquire":
            return (call[0], getattr(call[2], "lineno", 0))
        return None

    def _manual_release(self, st):
        call = self._lock_method_call(st)
        if call and call[1] == "release":
            return call[0]
        return None

    def _lock_method_call(self, st):
        if isinstance(st, ast.Expr) and isinstance(st.value, ast.Call):
            fn = st.value.func
            if isinstance(fn, ast.Attribute) and \
                    fn.attr in ("acquire", "release") and \
                    _is_lockish(fn.value):
                lid = _lock_id(fn.value, self.f.module, self.f.classname)
                return (lid, fn.attr, st)
        return None

    def _stmt(self, st, held):
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # a nested def runs LATER (often on another thread): neither
            # its calls nor its locks belong to this function's footprint
            return
        if isinstance(st, (ast.With, ast.AsyncWith)):
            inner = list(held)
            for item in st.items:
                if _is_lockish(item.context_expr):
                    lid = _lock_id(item.context_expr, self.f.module,
                                   self.f.classname)
                    self.f.acquires.add(lid)
                    if any(h[0] == lid for h in inner):
                        # nested `with` on a lock already held HERE — the
                        # simplest self-deadlock, no call graph needed
                        self.f.reacquires.append((lid, st.lineno))
                    inner.append((lid, st.lineno))
                else:
                    self._expr(item.context_expr, held)
            self._suite(st.body, tuple(inner))
            return
        # generic: visit child expressions under `held`, child suites too
        for field in st._fields:
            val = getattr(st, field, None)
            if isinstance(val, list):
                if val and isinstance(val[0], ast.stmt):
                    self._suite(val, held)
                else:
                    for v in val:
                        if isinstance(v, ast.expr):
                            self._expr(v, held)
                        elif isinstance(v, ast.stmt):
                            self._suite([v], held)
                        elif isinstance(v, ast.excepthandler):
                            self._suite(v.body, held)
            elif isinstance(val, ast.expr):
                self._expr(val, held)
            elif isinstance(val, ast.stmt):
                self._suite([val], held)

    def _expr(self, expr, held):
        # walk without descending into lambdas (their bodies run later,
        # not under the current locks)
        stack = [expr]
        while stack:
            node = stack.pop()
            if isinstance(node, ast.Lambda):
                continue
            if isinstance(node, ast.Call):
                self.f.calls.append((node, held))
            stack.extend(ast.iter_child_nodes(node))


class LockPass:
    """Cross-module lock-discipline analysis over the scoped .py files."""

    # attribute names never resolved through the name-based call graph:
    # `close` is ubiquitous teardown (sockets, files, monitors) and
    # resolving `sock.close()` to an unrelated `Foo.close` method would
    # drown the pass in cross-class false positives
    NO_RESOLVE = {"close"}

    def __init__(self, findings: Findings):
        self.findings = findings
        self.funcs = []           # every _Func
        self.by_name = {}         # bare name -> [funcs]
        self.lines = {}           # module -> source lines
        self.imports = {}         # module -> imported top-level names

    def add_module(self, path, rel, tree, lines):
        """Register one module's functions, lock regions and imports."""
        self.lines[rel] = lines
        imported = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    imported.add((a.asname or a.name).split(".")[0])
            elif isinstance(node, ast.ImportFrom):
                for a in node.names:
                    imported.add(a.asname or a.name)
        self.imports[rel] = imported
        self._collect(rel, None, tree.body)

    def _collect(self, module, classname, body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                f = _Func(module, classname, node.name, node)
                self.funcs.append(f)
                self.by_name.setdefault(node.name, []).append(f)
                _FuncWalker(f).walk()
                # nested defs inside are walked as reset-held suites but
                # not registered as call targets (rare; keeps graph small)
            elif isinstance(node, ast.ClassDef):
                self._collect(module, node.name, node.body)

    # -- call graph -----------------------------------------------------------
    def _resolve(self, caller: _Func, call: ast.Call):
        """Candidate _Funcs this call may land in (name-based, preferring
        the caller's own class for self.X())."""
        fn = call.func
        if isinstance(fn, ast.Name):
            return [g for g in self.by_name.get(fn.id, ())
                    if g.classname is None and g.module == caller.module]
        if isinstance(fn, ast.Attribute):
            if fn.attr in self.NO_RESOLVE:
                return []
            if isinstance(fn.value, ast.Name) and \
                    fn.value.id in self.imports.get(caller.module, ()):
                # `subprocess.run(...)` / `telemetry.gauge(...)`: a module
                # attribute, never one of our methods — the blocking-module
                # rule already classifies these
                return []
            cands = self.by_name.get(fn.attr, ())
            if isinstance(fn.value, ast.Name) and fn.value.id == "self":
                same = [g for g in cands
                        if g.classname == caller.classname
                        and g.module == caller.module]
                if same:
                    return same
            return list(cands)
        return []

    # Both transitive walks memoize ONLY cycle-free results: a set
    # computed while a recursion-cycle member was on the stack is missing
    # that member's contributions, and caching it would silently clear
    # every later query through the cycle (order-dependent false
    # negatives). Cycle members are recomputed per top-level query —
    # fine at this codebase's size.

    def _trans_acquires(self, func: _Func, memo, stack):
        out, _complete = self._trans_acquires_rec(func, memo, stack)
        return out

    def _trans_acquires_rec(self, func, memo, stack):
        if func in memo:
            return memo[func], True
        if func in stack:
            return set(), False
        stack.add(func)
        out = set(func.acquires)
        complete = True
        for call, _held in func.calls:
            for g in self._resolve(func, call):
                sub, ok = self._trans_acquires_rec(g, memo, stack)
                out |= sub
                complete = complete and ok
        stack.discard(func)
        if complete:
            memo[func] = out
        return out, complete

    def _trans_blocking(self, func: _Func, memo, stack):
        """{description: via-path} of blocking ops reachable from func."""
        out, _complete = self._trans_blocking_rec(func, memo, stack)
        return out

    def _trans_blocking_rec(self, func, memo, stack):
        if func in memo:
            return memo[func], True
        if func in stack:
            return {}, False
        stack.add(func)
        out = {}
        complete = True
        for call, _held in func.calls:
            reason = _blocking_reason(call)
            if reason is not None:
                out.setdefault(reason, func.qual)
            for g in self._resolve(func, call):
                sub, ok = self._trans_blocking_rec(g, memo, stack)
                for desc, via in sub.items():
                    out.setdefault(desc, f"{func.qual} -> {via}")
                complete = complete and ok
        stack.discard(func)
        if complete:
            memo[func] = out
        return out, complete

    def run(self):
        """Check every call made while a lock is held."""
        acq_memo, blk_memo = {}, {}
        for f in self.funcs:
            lines = self.lines[f.module]
            for lid, ln in f.reacquires:
                found, reason = comment_marker(lines, ln, LOCK_OK_RE)
                if found:
                    if not reason:
                        self.findings.add(f.module, ln, "lock",
                                          "lock-ok annotation without a "
                                          "reason")
                    continue
                self.findings.add(
                    f.module, ln, "lock",
                    f"{f.qual}() re-acquires non-reentrant lock "
                    f"`{lid.split('::')[-1]}` already held "
                    f"(self-deadlock)")
            for call, held in f.calls:
                if not held:
                    continue
                self._check_site(f, call, held, lines, acq_memo, blk_memo)

    def _suppressed(self, lines, call, held):
        """lock-ok on the call line / line above, or on the `with` line
        that opened any held region / its line above."""
        check = [call.lineno] + [ln for _lid, ln in held if ln]
        for ln in check:
            found, reason = comment_marker(lines, ln, LOCK_OK_RE)
            if found:
                return True, reason, ln
        return False, "", 0

    def _check_site(self, f, call, held, lines, acq_memo, blk_memo):
        held_ids = {lid for lid, _ln in held}
        msgs = []
        # (a) re-acquisition self-deadlock
        for g in self._resolve(f, call):
            re_acq = self._trans_acquires(g, acq_memo, set()) & held_ids
            for lid in sorted(re_acq):
                msgs.append(
                    f"call to {g.qual}() re-acquires non-reentrant lock "
                    f"`{lid.split('::')[-1]}` already held (self-deadlock)")
        # (b) blocking work under the lock
        direct = _blocking_reason(call)
        if direct is not None:
            msgs.append(f"blocking call under lock: {direct}")
        else:
            for g in self._resolve(f, call):
                blk = self._trans_blocking(g, blk_memo, set())
                for desc, via in sorted(blk.items())[:2]:
                    msgs.append(f"blocking call under lock: {desc} "
                                f"via {via}")
                if blk:
                    break
        if not msgs:
            return
        ok, reason, ln = self._suppressed(lines, call, held)
        if ok:
            if not reason:
                self.findings.add(f.module, ln, "lock",
                                  "lock-ok annotation without a reason")
            return
        locks = ", ".join(sorted(lid.split("::")[-1] for lid in held_ids))
        for msg in msgs[:2]:  # at most 2 findings per site: stay readable
            self.findings.add(f.module, call.lineno, "lock",
                              f"{f.qual}() holding `{locks}`: {msg}")


# ===========================================================================
# Pass 2: C++ DMLC_GUARDED_BY structural checker
# ===========================================================================

def strip_cpp(text: str) -> str:
    """Blank out comments and string/char literals, preserving offsets
    and newlines, so structural regexes never match inside them."""
    out = list(text)
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        nxt = text[i + 1] if i + 1 < n else ""
        if c == "/" and nxt == "/":
            while i < n and text[i] != "\n":
                out[i] = " "
                i += 1
        elif c == "/" and nxt == "*":
            out[i] = out[i + 1] = " "
            i += 2
            while i < n and not (text[i] == "*" and i + 1 < n
                                 and text[i + 1] == "/"):
                if text[i] != "\n":
                    out[i] = " "
                i += 1
            if i < n:
                out[i] = " "
            if i + 1 < n:
                out[i + 1] = " "
            i += 2
        elif c in "\"'":
            quote = c
            out[i] = " "
            i += 1
            while i < n and text[i] != quote:
                if text[i] == "\\":
                    out[i] = " "
                    i += 1
                    if i < n and text[i] != "\n":
                        out[i] = " "
                    i += 1
                    continue
                if text[i] != "\n":
                    out[i] = " "
                i += 1
            if i < n:
                out[i] = " "
            i += 1
        else:
            i += 1
    return "".join(out)


_GUARDED_RE = re.compile(r"\b(\w+)\s+DMLC_GUARDED_BY\(\s*([\w.:*&>-]+)\s*\)")
_REQUIRES_RE = re.compile(r"DMLC_REQUIRES\(\s*([\w.:*&>-]+)\s*\)")
_LOCKDECL_RE = re.compile(
    r"\b(?:lock_guard|unique_lock|scoped_lock)\s*(?:<[^<>;(]*>)?\s+"
    r"(\w+)\s*(?:\(|\{)\s*([^,(){};]+?)\s*[,)}]")


def _mutex_name(expr: str) -> str:
    """Normalize `*mu`, `r.mu`, `plan->rng_mu` to the bare mutex name."""
    idents = re.findall(r"\w+", expr)
    return idents[-1] if idents else expr.strip()


def _brace_pairs(stripped: str):
    pairs = []
    stack = []
    for i, c in enumerate(stripped):
        if c == "{":
            stack.append(i)
        elif c == "}" and stack:
            pairs.append((stack.pop(), i))
    return pairs


def _enclosing_scope_end(pairs, pos: int) -> int:
    """End offset of the innermost brace block containing `pos`."""
    best_open, best_close = -1, None
    for o, cl in pairs:
        if o < pos < cl and o > best_open:
            best_open, best_close = o, cl
    return best_close if best_close is not None else 10 ** 12


class CppGuardPass:
    """Per header/source pair: collect DMLC_GUARDED_BY annotations, then
    verify every touch of a guarded member happens inside a lock scope of
    the named mutex or a DMLC_REQUIRES function."""

    def __init__(self, findings: Findings):
        self.findings = findings

    def run_unit(self, paths_rels):
        """`paths_rels`: [(abspath, relpath)] of one stem's .h/.cc pair.
        Returns the loaded [(rel, text, stripped, lines)] so analyze()
        can feed the other C++ passes without re-reading/re-stripping."""
        files = []
        members = {}  # member -> (mutex, decl_file, decl_line_span)
        for path, rel in paths_rels:
            with open(path, encoding="utf-8", errors="replace") as fh:
                text = fh.read()
            stripped = strip_cpp(text)
            lines = text.split("\n")
            files.append((rel, text, stripped, lines))
            for m in _GUARDED_RE.finditer(stripped):
                # skip the macro machinery itself (#define DMLC_GUARDED_BY
                # and friends in base.h)
                bol = stripped.rfind("\n", 0, m.start()) + 1
                if stripped[bol:m.start()].lstrip().startswith("#"):
                    continue
                member, mutex = m.group(1), _mutex_name(m.group(2))
                semi = stripped.find(";", m.end())
                end_line = stripped.count("\n", 0, semi if semi >= 0
                                          else m.end()) + 1
                start_line = stripped.count("\n", 0, m.start()) + 1
                members.setdefault(member, (mutex, rel,
                                            (start_line, end_line)))
        if members:
            for rel, _text, stripped, lines in files:
                self._check_file(rel, stripped, lines, members)
        return files

    def _check_file(self, rel, stripped, lines, members):
        pairs = _brace_pairs(stripped)
        # active-lock spans: (start, end, mutex)
        spans = []
        for m in _LOCKDECL_RE.finditer(stripped):
            scope_end = _enclosing_scope_end(pairs, m.end())
            # a unique_lock releases at `<var>.unlock()` and re-arms at
            # `<var>.lock()`: the guarded region is the union of those
            # intervals, not the whole lexical scope — touches after an
            # early unlock are exactly the race this pass exists for
            # (the parse/lock/bookkeep worker-loop shape re-locks)
            var = re.escape(m.group(1))
            unlock_rx = re.compile(rf"\b{var}\s*\.\s*unlock\s*\(")
            relock_rx = re.compile(rf"\b{var}\s*\.\s*lock\s*\(")
            mx = _mutex_name(m.group(2))
            start = m.start()
            pos = m.end()
            while True:
                unl = unlock_rx.search(stripped, pos, scope_end)
                if unl is None:
                    spans.append((start, scope_end, mx))
                    break
                spans.append((start, unl.start(), mx))
                relk = relock_rx.search(stripped, unl.end(), scope_end)
                if relk is None:
                    break
                start = relk.end()
                pos = relk.end()
        for m in _REQUIRES_RE.finditer(stripped):
            # a REQUIRES on a definition guards its body; on a pure
            # declaration (`;` before `{`) there is no body here
            brace = stripped.find("{", m.end())
            semi = stripped.find(";", m.end())
            if brace < 0 or (0 <= semi < brace):
                continue
            close = _enclosing_scope_end(pairs, brace + 1)
            spans.append((brace, close, _mutex_name(m.group(1))))
        decl_lines = {}
        for member, (_mx, decl_rel, (a, b)) in members.items():
            if decl_rel == rel:
                decl_lines[member] = set(range(a, b + 1))
        for member, (mutex, _decl_rel, _span) in members.items():
            rx = re.compile(rf"\b{re.escape(member)}\b")
            for m in rx.finditer(stripped):
                line = stripped.count("\n", 0, m.start()) + 1
                if line in decl_lines.get(member, ()):
                    continue
                active = {mx for s, e, mx in spans if s <= m.start() < e}
                if mutex in active:
                    continue
                found, reason = comment_marker(lines, line, LOCK_OK_RE)
                if found:
                    if not reason:
                        self.findings.add(rel, line, "guard",
                                          "lock-ok annotation without a "
                                          "reason")
                    continue
                self.findings.add(
                    rel, line, "guard",
                    f"`{member}` is DMLC_GUARDED_BY({mutex}) but touched "
                    f"outside a lock scope of `{mutex}` (and not in a "
                    f"DMLC_REQUIRES({mutex}) function)")


# ===========================================================================
# Pass 3: invariant lints
# ===========================================================================

_CPP_ATOI_RE = re.compile(r"\b(?:atoi|atol|atoll)\s*\(")
_CPP_NUMPARSE_RE = re.compile(
    r"\b(?:atoi|atol|atoll|strtol|strtoll|strtoul|strtoull|strtod|"
    r"stoi|stol|stoll|stoul|stoull|stod|stof)\b")


def _env_access(node) -> bool:
    """True when the expression subtree reads the process environment."""
    for n in ast.walk(node):
        d = dotted(n)
        if d in ("os.environ", "os.getenv"):
            return True
    return False


class PyEnvAssertPass:
    """Python halves of the invariant lints: raw env numeric casts and
    runtime asserts."""

    def __init__(self, findings: Findings):
        self.findings = findings

    def run(self, rel, tree, lines, check_env: bool, check_assert: bool):
        """Lint one module: raw env parses and/or runtime asserts."""
        if check_env:
            self._env(rel, tree, lines)
        if check_assert:
            self._asserts(rel, tree, lines)

    @staticmethod
    def _scope_nodes(body):
        """Document-order nodes of one scope, NOT descending into nested
        functions/lambdas (each function body is its own taint scope)."""
        queue = list(body)
        while queue:
            node = queue.pop(0)
            yield node
            kids = [c for c in ast.iter_child_nodes(node)
                    if not isinstance(c, (ast.FunctionDef,
                                          ast.AsyncFunctionDef,
                                          ast.Lambda))]
            queue[:0] = kids

    def _env(self, rel, tree, lines):
        scopes = [tree.body]
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scopes.append(node.body)
        for body in scopes:
            self._env_scope(rel, body, lines, set())

    def _env_scope(self, rel, body, lines, tainted):
        for node in self._scope_nodes(body):
            if isinstance(node, ast.Assign) and _env_access(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        tainted.add(t.id)
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Name) and \
                    node.func.id in ("int", "float") and node.args:
                arg = node.args[0]
                bad = _env_access(arg) or (
                    isinstance(arg, ast.Name) and arg.id in tainted)
                if not bad:
                    continue
                found, reason = comment_marker(lines, node.lineno,
                                               ENV_OK_RE)
                if found:
                    if not reason:
                        self.findings.add(rel, node.lineno, "env",
                                          "env-ok annotation without "
                                          "a reason")
                    continue
                self.findings.add(
                    rel, node.lineno, "env",
                    f"raw {node.func.id}() over an os.environ value — "
                    f"use wire.env_int/env_float/env_enum (checked "
                    f"parse: garbage must raise, naming the variable)")

    def _asserts(self, rel, tree, lines):
        for node in ast.walk(tree):
            if not isinstance(node, ast.Assert):
                continue
            found, reason = comment_marker(lines, node.lineno,
                                           ASSERT_OK_RE)
            if found:
                if not reason:
                    self.findings.add(rel, node.lineno, "assert",
                                      "assert-ok annotation without a "
                                      "reason")
                continue
            self.findings.add(
                rel, node.lineno, "assert",
                "assert used for a runtime check in tracker/client code — "
                "raise a real error (`python -O` strips asserts)")


class CppEnvPass:
    """C++ half of the checked-env-parse rule."""

    def __init__(self, findings: Findings):
        self.findings = findings

    def run(self, rel, text, stripped, lines):
        """Flag raw atoi-family and getenv-fed parses in one file."""
        for m in _CPP_ATOI_RE.finditer(stripped):
            line = stripped.count("\n", 0, m.start()) + 1
            found, reason = comment_marker(lines, line, ENV_OK_RE)
            if found:
                if not reason:
                    self.findings.add(rel, line, "env",
                                      "env-ok annotation without a reason")
                continue
            self.findings.add(
                rel, line, "env",
                "raw atoi-family parse — use io::CheckedEnvInt/CheckedInt "
                "(retry.h) or a strtol with end-pointer validation")
        # getenv feeding a numeric parse within one statement
        for m in re.finditer(r"\bgetenv\b", stripped):
            start = max(stripped.rfind(";", 0, m.start()),
                        stripped.rfind("{", 0, m.start()),
                        stripped.rfind("}", 0, m.start()))
            end = stripped.find(";", m.end())
            stmt = stripped[start + 1:end if end >= 0 else len(stripped)]
            if not _CPP_NUMPARSE_RE.search(stmt.replace("getenv", "")):
                continue
            line = stripped.count("\n", 0, m.start()) + 1
            found, reason = comment_marker(lines, line, ENV_OK_RE)
            if found:
                if not reason:
                    self.findings.add(rel, line, "env",
                                      "env-ok annotation without a reason")
                continue
            self.findings.add(
                rel, line, "env",
                "getenv value numerically parsed in place — use "
                "io::CheckedEnvInt (typo'd env knobs must raise, not "
                "silently become 0)")


class CppFsPass:
    """Local-durability discipline (doc/robustness.md "Local durability"):
    outside the fs_fault.cc/shard_cache.cc/filesys.cc helpers, C++ code
    must not call raw ``std::rename``/``rename`` (use ``fsio::Rename`` —
    injectable, and the caller must handle the failure) and must not
    discard ``fsync``'s return (an unchecked fsync is how a 'durable'
    write silently isn't). ``// fs-ok: <reason>`` escapes audited sites;
    the reason is mandatory."""

    _RENAME_RE = re.compile(r"\b(?:std::)?rename\s*\(")
    _FSYNC_RE = re.compile(r"\bfsync\s*\(")

    def __init__(self, findings: Findings):
        self.findings = findings

    def _escaped(self, rel, lines, line) -> bool:
        found, reason = comment_marker(lines, line, FS_OK_RE)
        if found and not reason:
            self.findings.add(rel, line, "fs",
                              "fs-ok annotation without a reason")
        return found

    def run(self, rel, text, stripped, lines):
        """Flag raw renames and discarded fsync results in one file."""
        for m in self._RENAME_RE.finditer(stripped):
            line = stripped.count("\n", 0, m.start()) + 1
            if self._escaped(rel, lines, line):
                continue
            self.findings.add(
                rel, line, "fs",
                "raw rename() outside the fs_fault.cc helpers — use "
                "fsio::Rename (injectable; the caller must handle a "
                "failed/torn publish)")
        for m in self._FSYNC_RE.finditer(stripped):
            # statement position = result discarded: walk back over
            # whitespace (and a leading ::) to the previous code char.
            # ')' is statement position too — an unbraced `if (ok)
            # fsync(fd);` body and the `(void)fsync(fd)` cast both
            # discard the result (the cast spelling should carry an
            # fs-ok reason like any other audited discard).
            i = m.start() - 1
            while i >= 0 and (stripped[i] in " \t\n\r" or
                              stripped[i] == ':'):
                i -= 1
            if i >= 0 and stripped[i] not in ";{})":
                continue  # checked/assigned/compared — fine
            line = stripped.count("\n", 0, m.start()) + 1
            if self._escaped(rel, lines, line):
                continue
            self.findings.add(
                rel, line, "fs",
                "fsync() return value discarded — a failed fsync means "
                "the bytes are NOT durable; check it (or use fsio::Fsync "
                "and handle the failure)")


# ===========================================================================
# Pass 4: cross-boundary contracts (ABI / metrics / env knobs / wire words)
# ===========================================================================

class ContractPass:
    """Diffs the port's hand-kept contracts against their extracted ground
    truth (:mod:`.contracts`): its two C ABIs against their ctypes tables,
    metric registrations against the reference's catalog, the port's
    METRIC_HELP and the reference's HELP lines, env-knob reads against
    ``doc/torch/parameters.md`` and the reference's knob table, and the
    tracker wire words. In repo mode the participating files are pinned;
    in fixture mode roles are detected (a C++ file exporting `dct_*`, a
    .py with a dct signature table / mirrors / METRIC_HELP /
    NO_COUNTERPART / a wire registry, .md pages with metric tables or the
    knob-table markers)."""

    CODE_SCOPE = contracts.CODE_SCOPE

    def __init__(self, findings: Findings, base: str, fixture: bool):
        self.findings = findings
        self.base = base
        self.fixture = fixture
        self.py = {}       # rel -> (tree, lines)
        self.cpp = {}      # rel -> (stripped, lines)
        self.cpp_code = {}  # rel -> comments-only-stripped text
        self.md = {}       # rel -> text
        self.ref_help = None  # the reference's METRIC_HELP (repo mode)
        self.probe_notes = []
        self.probed = []   # struct names the layout probe compiled

    # -- loading ------------------------------------------------------------
    def load(self, cpp_files):
        """`cpp_files`: {rel: (text, stripped, lines)} already loaded by
        analyze() — re-used so each C++ file is read and stripped once.
        The metric/knob extractors need string literals, so they run on a
        comments-only strip of the raw text."""
        for rel, (text, stripped, lines) in cpp_files.items():
            if self.fixture or _in_scope(rel, self.CODE_SCOPE):
                self.cpp[rel] = (stripped, lines)
                self.cpp_code[rel] = contracts.strip_cpp_comments(text)
        if self.fixture:
            paths = [(p, os.path.relpath(p, self.base).replace(os.sep, "/"))
                     for p in iter_sources(self.base, suffixes=(".py",))]
        else:
            paths = [(p, rel) for p, rel in
                     contracts.iter_code_scope(self.base)
                     if p.endswith(".py")]
        for path, rel in paths:
            tree, lines = _parse(path, rel)
            if tree is not None:
                self.py[rel] = (tree, lines)
        if self.fixture:
            for dirpath, dirs, files in os.walk(self.base):
                dirs[:] = sorted(d for d in dirs if not d.startswith("."))
                for f in sorted(files):
                    if f.endswith(".md"):
                        p = os.path.join(dirpath, f)
                        rel = os.path.relpath(p, self.base).replace(
                            os.sep, "/")
                        self.md[rel] = _read(p)
            return
        for rel in (contracts.REFERENCE_CATALOG, contracts.REFERENCE_KNOBS,
                    contracts.PORT_KNOBS):
            p = os.path.join(self.base, rel)
            if os.path.exists(p):
                self.md[rel] = _read(p)
        tree, _lines = _parse(os.path.join(self.base,
                                           contracts.REFERENCE_HELP),
                              contracts.REFERENCE_HELP)
        if tree is not None:
            self.ref_help = contracts.extract_metric_help_text(tree)
        if not self.ref_help:
            self.findings.add(
                contracts.REFERENCE_HELP, 1, "metric",
                "the reference's METRIC_HELP cannot be read — the port's "
                "HELP lines have nothing to be held against")

    # -- shared escape handling ---------------------------------------------
    def _escaped(self, rel, lineno, rx, label) -> bool:
        lines = None
        if rel in self.py:
            lines = self.py[rel][1]
        elif rel in self.cpp:
            lines = self.cpp[rel][1]
        if lines is None:
            return False
        found, reason = comment_marker(lines, lineno, rx)
        if found and not reason:
            self.findings.add(rel, lineno, label,
                              f"{label}-ok annotation without a reason")
        return found

    def run(self):
        """Run the ABI, metric, knob and wire-word checks."""
        self._abi()
        no_cp = self._no_counterpart()
        self._metrics(no_cp)
        self._knobs(no_cp)
        self._wire()

    # -- 4a: ABI parity + layout probe ---------------------------------------
    def _abi(self):
        if self.fixture:
            self._abi_boundary(sorted(self.cpp), sorted(self.py))
            return
        for c_src, py_rel in contracts.ABI_BOUNDARIES:
            c_rels = sorted(r for r in self.cpp
                            if r == c_src or (c_src.endswith("/")
                                              and r.startswith(c_src)))
            if not c_rels or py_rel not in self.py:
                self.findings.add(
                    py_rel if not c_rels else c_src, 1, "abi",
                    f"C boundary {c_src} <-> {py_rel}: "
                    f"{'no C source' if not c_rels else 'no binding module'}"
                    f" found")
                continue
            self._abi_boundary(c_rels, [py_rel])

    def _abi_boundary(self, c_rels, py_rels):
        funcs, structs, abi_rels = {}, {}, {}
        for rel in c_rels:
            stripped, lines = self.cpp[rel]
            f, s, _h = contracts.parse_c_abi("\n".join(lines), stripped)
            for name, fn in f.items():
                funcs[name] = fn
                abi_rels[name] = rel
            for name, st in s.items():
                structs[name] = st
                abi_rels[name] = rel
        bindings, mirrors, bind_rel = {}, {}, None
        for rel in py_rels:
            tree, _lines = self.py[rel]
            b = contracts.extract_bindings(tree)
            m = contracts.extract_mirrors(tree)
            if b or m:
                bind_rel = rel
                bindings.update(b)
                mirrors.update(m)
        if not funcs and not bindings and not structs:
            return
        for name, fn in sorted(funcs.items()):
            rel = abi_rels[name]
            if name not in bindings:
                if not self._escaped(rel, fn.lineno, ABI_OK_RE, "abi"):
                    self.findings.add(
                        rel, fn.lineno, "abi",
                        f"`{name}` is exported but has no ctypes binding "
                        f"row — an undeclared call defaults restype to "
                        f"c_int (64-bit returns truncate) with unchecked "
                        f"argtypes")
                continue
            b = bindings[name]
            if self._escaped(bind_rel, b.lineno, ABI_OK_RE, "abi"):
                continue
            want_ret = contracts.expected_restype(fn.ret)
            if b.restype is None:
                self.findings.add(
                    bind_rel, b.lineno, "abi",
                    f"`{name}` binding declares argtypes only — restype "
                    f"silently defaults to c_int; declare "
                    f"({want_ret or fn.ret}, [argtypes])")
            elif want_ret is not None and b.restype != want_ret:
                self.findings.add(
                    bind_rel, b.lineno, "abi",
                    f"`{name}` restype is {b.restype} but the C ABI "
                    f"returns `{fn.ret}` ({want_ret})")
            if len(b.argtypes) != len(fn.params):
                self.findings.add(
                    bind_rel, b.lineno, "abi",
                    f"`{name}` binding declares {len(b.argtypes)} "
                    f"argtypes but the C ABI takes {len(fn.params)} "
                    f"parameters")
                continue
            for i, (ct, pt) in enumerate(zip(fn.params, b.argtypes)):
                err = contracts.ctype_mismatch(ct, pt, mirrors)
                if err is not None:
                    self.findings.add(
                        bind_rel, b.lineno, "abi",
                        f"`{name}` argument {i + 1}: {err}")
        for name, b in sorted(bindings.items()):
            if funcs and name not in funcs and \
                    not self._escaped(bind_rel, b.lineno, ABI_OK_RE,
                                      "abi"):
                self.findings.add(
                    bind_rel, b.lineno, "abi",
                    f"binding declares `{name}` but the C ABI exports no "
                    f"such function")
        self._abi_structs(structs, mirrors, abi_rels, bind_rel)

    def _abi_structs(self, structs, mirrors, abi_rels, bind_rel):
        probe_structs = {}
        for name, st in sorted(structs.items()):
            rel = abi_rels[name]
            if name not in mirrors:
                if not self._escaped(rel, st.lineno, ABI_OK_RE, "abi"):
                    self.findings.add(
                        rel, st.lineno, "abi",
                        f"ABI struct `{name}` has no ctypes Structure "
                        f"mirror (docstring convention: 'Mirror of "
                        f"{name}')")
                continue
            m = mirrors[name]
            clean = True
            if len(m.fields) != len(st.fields):
                self.findings.add(
                    bind_rel, m.lineno, "abi",
                    f"`{m.pyname}` mirrors `{name}` with "
                    f"{len(m.fields)} fields, C declares "
                    f"{len(st.fields)} — struct drift corrupts memory")
                clean = False
            for (ct, cn, _cl), (pn, pt, pl) in zip(st.fields, m.fields):
                if cn != pn:
                    self.findings.add(
                        bind_rel, pl, "abi",
                        f"`{m.pyname}` field `{pn}` vs C `{name}.{cn}` "
                        f"— field order/name drift")
                    clean = False
                    continue
                err = contracts.ctype_mismatch(ct, pt, mirrors)
                if err is not None:
                    self.findings.add(bind_rel, pl, "abi",
                                      f"`{m.pyname}.{pn}`: {err}")
                    clean = False
            if clean:
                probe_structs[name] = st
        for cname, m in sorted(mirrors.items()):
            if structs and cname not in structs:
                self.findings.add(
                    bind_rel, m.lineno, "abi",
                    f"`{m.pyname}` claims to mirror `{cname}` but the C "
                    f"ABI declares no such struct")
        if probe_structs:
            self._layout_probe(probe_structs, mirrors, abi_rels, bind_rel)

    def _layout_probe(self, structs, mirrors, abi_rels, bind_rel):
        layout, note = contracts.run_layout_probe(structs)
        if layout is None:
            self.probe_notes.append(note)
            return
        self.probed += sorted(structs)
        for name, st in sorted(structs.items()):
            m = mirrors[name]
            cls = contracts.build_mirror_class(m)
            got = layout.get(name)
            if cls is None or got is None:
                continue
            import ctypes as _ct
            if _ct.sizeof(cls) != got["size"]:
                self.findings.add(
                    bind_rel, m.lineno, "abi",
                    f"layout probe: sizeof({name}) is {got['size']} in C "
                    f"but ctypes.sizeof({m.pyname}) is "
                    f"{_ct.sizeof(cls)} — byte layout diverged")
                continue
            for fname, _canon, pl in m.fields:
                coff = got["fields"].get(fname)
                poff = getattr(cls, fname).offset
                if coff is not None and coff != poff:
                    self.findings.add(
                        bind_rel, pl, "abi",
                        f"layout probe: offsetof({name}, {fname}) is "
                        f"{coff} in C but {poff} in {m.pyname}")

    # -- 4b: metric contract -------------------------------------------------
    def _no_counterpart(self):
        """(table, rel) of the NO_COUNTERPART table ({name: (reason,
        line)}), or ({}, None) when no module in scope defines one; rows
        without a reason are findings."""
        table, rel = {}, None
        for r, (tree, _lines) in sorted(self.py.items()):
            n = contracts.extract_no_counterpart(tree)
            if n is not None:
                table, rel = n, r
        for name, (reason, line) in sorted(table.items()):
            if not (reason or "").strip():
                self.findings.add(
                    rel, line, "contract",
                    f"NO_COUNTERPART row `{name}` gives no reason — say "
                    f"why the port has no counterpart, or port it")
        return table, rel

    def _metrics(self, no_cp):
        skipped, skip_rel = no_cp
        registry = {}
        for rel, code in sorted(self.cpp_code.items()):
            contracts.extract_metrics_cpp(rel, code, registry)
        help_text, help_rel = None, None
        for rel, (tree, _lines) in sorted(self.py.items()):
            contracts.extract_metrics_py(rel, tree, registry)
            h = contracts.extract_metric_help_text(tree)
            if h is not None:
                help_text, help_rel = h, rel
        help_map = (None if help_text is None
                    else {k: ln for k, (_t, ln) in help_text.items()})
        catalog, cat_rel = {}, None
        for rel, text in sorted(self.md.items()):
            if not self.fixture and rel != contracts.REFERENCE_CATALOG:
                continue
            c = contracts.extract_doc_catalog(text)
            if c:
                cat_rel = rel
                catalog.update(c)
        if not self.fixture and not catalog:
            self.findings.add(
                contracts.REFERENCE_CATALOG, 1, "metric",
                "the reference's metric catalog cannot be read — the "
                "port's registrations have nothing to be held against")
        if not registry:
            return
        for name, reg in sorted(registry.items()):
            rel, line = reg.sites[0]
            # an audited annotation on ANY registration site of the
            # metric suppresses every code-side finding for it (the
            # doc-side documented-but-gone check below is unaffected —
            # an escaped metric is still registered)
            esc = any(self._escaped(r, ln, CONTRACT_OK_RE, "contract")
                      for r, ln in reg.sites)
            if esc:
                continue
            if name in skipped:
                self.findings.add(
                    skip_rel, skipped[name][1], "contract",
                    f"NO_COUNTERPART lists `{name}`, but the port "
                    f"registers it ({rel}:{line}) — drop the row")
            if catalog and name not in catalog:
                self.findings.add(
                    rel, line, "metric",
                    f"metric `{name}` is registered but missing from the "
                    f"{cat_rel} catalog (undocumented metric)")
            if help_map is not None and name not in help_map:
                self.findings.add(
                    rel, line, "metric",
                    f"metric `{name}` has no METRIC_HELP entry "
                    f"({help_rel}) — /metrics serves it without # HELP")
            if len(reg.kinds) > 1:
                self.findings.add(
                    rel, line, "metric",
                    f"metric `{name}` is registered with conflicting "
                    f"kinds: {', '.join(sorted(reg.kinds))}")
            if len(reg.halves) == 2:
                cu = set().union(*reg.labels.get("cpp", [frozenset()]))
                pu = set().union(*reg.labels.get("py", [frozenset()]))
                if reg.labels.get("cpp") and reg.labels.get("py") and \
                        cu != pu:
                    self.findings.add(
                        rel, line, "metric",
                        f"metric `{name}` label keys diverge across "
                        f"halves: C++ {{{','.join(sorted(cu)) or ''}}} "
                        f"vs Python {{{','.join(sorted(pu)) or ''}}}")
            if name in catalog:
                doc = catalog[name]
                known = [ks for ks in
                         (k for half in reg.labels.values()
                          for k in half)]
                if known:
                    union = set().union(*known)
                    if union != doc["labels"]:
                        self.findings.add(
                            rel, line, "metric",
                            f"metric `{name}` label keys "
                            f"{{{','.join(sorted(union))}}} disagree "
                            f"with the {cat_rel} catalog "
                            f"{{{','.join(sorted(doc['labels']))}}}")
                if doc["kind"] and doc["kind"] not in reg.kinds:
                    self.findings.add(
                        rel, line, "metric",
                        f"metric `{name}` is documented as "
                        f"{doc['kind']} but registered as "
                        f"{', '.join(sorted(reg.kinds))}")
        for name, doc in sorted(catalog.items()):
            if name not in registry and name not in skipped:
                why = (f"; port it, or give it a NO_COUNTERPART row with "
                       f"its reason ({skip_rel})" if skip_rel else "")
                self.findings.add(
                    cat_rel, doc["line"], "metric",
                    f"`{name}` is documented in the catalog but no code "
                    f"registers it (documented-but-gone){why}")
        if help_map is not None:
            for name, line in sorted(help_map.items()):
                if name not in registry:
                    self.findings.add(
                        help_rel, line, "metric",
                        f"METRIC_HELP entry `{name}` matches no "
                        f"registered metric (stale help)")
        for name, (reason, line) in sorted(skipped.items()):
            if name not in catalog and not \
                    contracts._KNOB_NAME_RE.match(name):
                self.findings.add(
                    skip_rel, line, "contract",
                    f"NO_COUNTERPART row `{name}` names no metric of the "
                    f"catalog (stale row)")
        if self.ref_help and help_text:
            self._help_text(help_text, help_rel)

    def _help_text(self, help_text, help_rel):
        """Every port HELP line is the reference's, word for word, but for
        the listed exceptions (and those must really differ)."""
        for name, (text, line) in sorted(help_text.items()):
            ref = self.ref_help.get(name)
            if ref is None:
                continue
            if name in contracts.HELP_TEXT_EXCEPTIONS:
                if text == ref[0]:
                    self.findings.add(
                        help_rel, line, "metric",
                        f"HELP_TEXT_EXCEPTIONS lists `{name}`, but its "
                        f"line equals the reference's — drop the "
                        f"exception")
                continue
            if text != ref[0]:
                self.findings.add(
                    help_rel, line, "metric",
                    f"METRIC_HELP `{name}` is {text!r} but the "
                    f"reference's ({contracts.REFERENCE_HELP}:{ref[1]}) "
                    f"is {ref[0]!r}")

    # -- 4c: env-knob registry ----------------------------------------------
    def _knobs(self, no_cp):
        skipped, skip_rel = no_cp
        registry = {}
        for rel, (tree, _lines) in sorted(self.py.items()):
            contracts.extract_knobs_py(rel, tree, registry)
        for rel, code in sorted(self.cpp_code.items()):
            contracts.extract_knobs_cpp(rel, code, registry)
        if not registry:
            return
        for name, sites in sorted(registry.items()):
            lits = contracts.knob_conflicts(sites)
            if len(lits) > 1:
                by_default = {}
                for s in sites:
                    by_default.setdefault(s.default, s)
                keep = [by_default[d] for d in lits]
                first = keep[0]
                for s in keep[1:]:
                    if not self._escaped(s.rel, s.lineno, CONTRACT_OK_RE,
                                         "contract"):
                        self.findings.add(
                            s.rel, s.lineno, "knob",
                            f"`{name}` read with default "
                            f"`{s.default}` here but `{first.default}` "
                            f"at {first.rel}:{first.lineno} (knob-"
                            f"default drift)")
        if not self.fixture:
            self._reference_knobs(registry, skipped, skip_rel)
        doc_rel, rows, found = None, {}, False
        for rel, text in sorted(self.md.items()):
            if not self.fixture and rel != contracts.PORT_KNOBS:
                continue
            r, ok = contracts.parse_knob_table(text)
            if ok:
                doc_rel, rows, found = rel, r, True
        if not found:
            if not self.fixture:
                self.findings.add(
                    contracts.PORT_KNOBS, 1, "knob",
                    "no generated env-knob table (markers missing) — "
                    "run `make torch-doc` to render it from the code")
            return
        for name, sites in sorted(registry.items()):
            s = sites[0]
            if name not in rows:
                if not self._escaped(s.rel, s.lineno, CONTRACT_OK_RE,
                                     "contract"):
                    self.findings.add(
                        s.rel, s.lineno, "knob",
                        f"env knob `{name}` is read here but absent "
                        f"from the {doc_rel} table (run `make torch-doc`)")
            elif rows[name] != contracts.knob_display_default(sites):
                self.findings.add(
                    s.rel, s.lineno, "knob",
                    f"env knob `{name}` default drift: {doc_rel} says "
                    f"`{rows[name]}`, code says "
                    f"`{contracts.knob_display_default(sites)}` (run "
                    f"`make torch-doc`)")
        for name in sorted(rows):
            if name not in registry:
                self.findings.add(
                    doc_rel, 1, "knob",
                    f"documented env knob `{name}` is read nowhere in "
                    f"the code (stale row — run `make torch-doc`)")

    def _reference_knobs(self, registry, skipped, skip_rel):
        """Every knob of the reference's generated table is read by the
        port too, with the same default, or has a NO_COUNTERPART row."""
        ref_rows, found = contracts.parse_knob_table(
            self.md.get(contracts.REFERENCE_KNOBS, ""))
        if not found:
            self.findings.add(
                contracts.REFERENCE_KNOBS, 1, "knob",
                "the reference's env-knob table cannot be read — the "
                "port's knobs have nothing to be held against")
            return
        for name, ref_default in sorted(ref_rows.items()):
            if name in skipped:
                if name in registry:
                    s = registry[name][0]
                    self.findings.add(
                        skip_rel, skipped[name][1], "contract",
                        f"NO_COUNTERPART lists `{name}`, but the port "
                        f"reads it ({s.rel}:{s.lineno}) — drop the row")
                continue
            if name not in registry:
                self.findings.add(
                    contracts.REFERENCE_KNOBS, 1, "knob",
                    f"reference knob `{name}` is read nowhere in the "
                    f"port — port it, or give it a NO_COUNTERPART row "
                    f"with its reason ({skip_rel})")
                continue
            ours = contracts.knob_display_default(registry[name])
            if ours != ref_default and "computed" not in (ours,
                                                          ref_default):
                s = registry[name][0]
                self.findings.add(
                    s.rel, s.lineno, "knob",
                    f"env knob `{name}` defaults to `{ours}` in the port "
                    f"but `{ref_default}` in the reference "
                    f"({contracts.REFERENCE_KNOBS})")
        for name, (_reason, line) in sorted(skipped.items()):
            if contracts._KNOB_NAME_RE.match(name) and name not in ref_rows:
                self.findings.add(
                    skip_rel, line, "contract",
                    f"NO_COUNTERPART row `{name}` names no knob of the "
                    f"reference's table (stale row)")

    # -- 4d: wire-protocol words ---------------------------------------------
    def _wire(self):
        target = None
        for rel, (tree, lines) in sorted(self.py.items()):
            if self.fixture:
                ww = contracts.extract_wire_words(tree)
                if ww.has_registry or os.path.basename(rel) == "wire.py":
                    target = (rel, ww)
                    break
            elif rel == contracts.PORT_WIRE:
                target = (rel, contracts.extract_wire_words(tree))
        if target is None:
            if not self.fixture:
                self.findings.add(contracts.PORT_WIRE, 1, "wire",
                                  "the port's wire module is missing")
            return
        rel, ww = target
        if not ww.has_registry:
            self.findings.add(
                rel, 1, "wire",
                "no CHANNEL_COMMAND_WORDS/CHANNEL_SENTINELS registry — "
                "the channel word contract is unenforceable")
            return
        resolved = {}
        for kind, table in (("command", ww.commands),
                            ("sentinel", ww.sentinels)):
            for key, (val, line) in sorted(table.items()):
                if isinstance(val, str):
                    if val != key:
                        self.findings.add(
                            rel, line, "wire",
                            f"registry entry \"{key}\" binds constant "
                            f"`{val}` — the key must name the constant "
                            f"it registers")
                    if val not in ww.constants:
                        self.findings.add(
                            rel, line, "wire",
                            f"registry entry \"{key}\" references "
                            f"`{val}` which is not a module int "
                            f"constant")
                        continue
                    value = ww.constants[val][0]
                elif val is None:
                    self.findings.add(
                        rel, line, "wire",
                        f"registry entry \"{key}\" has a non-constant "
                        f"value")
                    continue
                else:
                    value = val
                if value >= 0:
                    self.findings.add(
                        rel, line, "wire",
                        f"{kind} word {key} = {value} is non-negative — "
                        f"it collides with the ping space (any "
                        f"non-negative int32 is a ping / shard id)")
                if value in resolved:
                    self.findings.add(
                        rel, line, "wire",
                        f"{kind} word {key} = {value} collides with "
                        f"{resolved[value]} — two frames become "
                        f"indistinguishable on the wire")
                else:
                    resolved[value] = key
        registered = set(ww.commands) | set(ww.sentinels)
        for name, (value, line) in sorted(ww.constants.items()):
            if value < 0 and name not in registered:
                self.findings.add(
                    rel, line, "wire",
                    f"negative channel word {name} = {value} is not in "
                    f"CHANNEL_COMMAND_WORDS/CHANNEL_SENTINELS — "
                    f"unregistered words dodge the collision check")


# ===========================================================================
# entry point
# ===========================================================================

def _in_scope(rel: str, prefixes) -> bool:
    return any(rel.startswith(p) for p in prefixes)


def _read(path: str) -> str:
    with open(path, encoding="utf-8", errors="replace") as fh:
        return fh.read()


def _parse(path: str, rel: str):
    """(ast tree, lines) of a Python file; (None, None) when it is missing
    or does not parse (lint.py owns syntax errors)."""
    if not os.path.exists(path):
        return None, None
    text = _read(path)
    try:
        return ast.parse(text, filename=rel), text.split("\n")
    except SyntaxError:
        return None, None


def analyze(root=None, repo=None) -> int:
    """Run every pass; returns the finding count. `root=None` analyzes a
    checkout (`repo`, default this one) with per-pass scopes; an explicit
    fixture root puts every file in scope for every pass."""
    findings = Findings()
    lock_pass = LockPass(findings)
    guard_pass = CppGuardPass(findings)
    py_pass = PyEnvAssertPass(findings)
    cppenv_pass = CppEnvPass(findings)
    cppfs_pass = CppFsPass(findings)
    fixture = root is not None
    base = os.path.abspath(root if fixture else (repo or REPO))
    if fixture:
        files = [(p, os.path.relpath(p, base).replace(os.sep, "/"))
                 for p in iter_sources(base)]
    else:
        files = list(contracts.iter_code_scope(base))

    cpp_units = {}  # stem -> [(path, rel)]
    cpp_loaded = {}
    for path, rel in files:
        if path.endswith(".py"):
            in_lock = fixture or _in_scope(rel, LOCK_SCOPE)
            in_env = (fixture or _in_scope(rel, PY_ENV_SCOPE)) and \
                rel not in PY_ENV_ALLOW
            in_assert = fixture or _in_scope(rel, ASSERT_SCOPE)
            if not (in_lock or in_env or in_assert):
                continue
            tree, lines = _parse(path, rel)
            if tree is None:
                continue
            if in_lock:
                lock_pass.add_module(path, rel, tree, lines)
            py_pass.run(rel, tree, lines, in_env, in_assert)
        elif fixture or _in_scope(rel, CPP_SCOPE):
            stem = os.path.splitext(path)[0]
            cpp_units.setdefault(stem, []).append((path, rel))
        else:
            # the native core: read by the contract pass alone
            text = _read(path)
            cpp_loaded[rel] = (text, strip_cpp(text), text.split("\n"))

    lock_pass.run()
    for stem in sorted(cpp_units):
        for rel, text, stripped, lines in guard_pass.run_unit(
                cpp_units[stem]):
            cpp_loaded[rel] = (text, stripped, lines)
            cppfs_pass.run(rel, text, stripped, lines)
            cppenv_pass.run(rel, text, stripped, lines)

    contract_pass = ContractPass(findings, base, fixture)
    contract_pass.load(cpp_loaded)
    contract_pass.run()
    for note in contract_pass.probe_notes:
        print(f"analyze: NOTE: {note}")
    if contract_pass.probed:
        print(f"analyze: layout probe ran over "
              f"{len(contract_pass.probed)} struct(s)")

    count = findings.report()
    return count


def main(argv=None) -> int:
    """Command line: analyze this checkout, another (``--repo``) or a
    fixture tree (``--root``); exit code = finding count."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    where = ap.add_mutually_exclusive_group()
    where.add_argument("--root", default=None,
                       help="analyze this tree instead of the repo (every "
                            "file in scope for every pass; fixture mode)")
    where.add_argument("--repo", default=None,
                       help="analyze this checkout with the repo-mode "
                            "scopes (default: the one holding this file)")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    count = analyze(args.root, args.repo)
    scope = args.root or args.repo or "repo"
    print(f"analyze: {scope}: {count} finding(s) in "
          f"{time.perf_counter() - t0:.2f} s")
    return min(count, 125)  # exit code = finding count, never wraps


if __name__ == "__main__":
    sys.exit(main())
