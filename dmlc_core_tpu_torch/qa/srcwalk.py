"""The port's source tree: the one definition of which files the QA lane
checks, shared by :mod:`.lint` and :mod:`.analyze` so the two can never
disagree about it.

In repo mode the tree is ``dmlc_core_tpu_torch/`` (its ``.py``, ``.cu``,
``.cc`` and ``.h`` files, build outputs skipped), the port's tests
(``tests/test_torch_*.py`` and ``tests/torch_*.py``) and ``chip_smoke.py``.
A fixture root is walked whole.
"""

import fnmatch
import os

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# build outputs, caches and generated docs are never linted or analyzed
SKIP_DIRS = {".git", ".bench_cache", "_native", "_build", "__pycache__",
             ".pytest_cache", "doc"}

SOURCE_SUFFIXES = (".py", ".cu", ".cc", ".h")

PACKAGE = "dmlc_core_tpu_torch"
TEST_PATTERNS = ("test_torch_*.py", "torch_*.py")
TOP_FILES = ("chip_smoke.py",)


def walk_tree(base: str, suffixes=SOURCE_SUFFIXES):
    """Every source file under ``base``, sorted within each directory for
    deterministic reports."""
    for dirpath, dirs, files in os.walk(base):
        dirs[:] = sorted(d for d in dirs if d not in SKIP_DIRS)
        for f in sorted(files):
            if f.endswith(tuple(suffixes)):
                yield os.path.join(dirpath, f)


def iter_sources(root: str = None, suffixes=SOURCE_SUFFIXES,
                 repo: str = None):
    """The port's checked files under ``repo`` (default: this checkout),
    or every source file under a fixture ``root``."""
    if root is not None:
        yield from walk_tree(root, suffixes)
        return
    base = REPO if repo is None else repo
    yield from walk_tree(os.path.join(base, PACKAGE), suffixes)
    tests = os.path.join(base, "tests")
    if ".py" in suffixes and os.path.isdir(tests):
        for f in sorted(os.listdir(tests)):
            if any(fnmatch.fnmatch(f, p) for p in TEST_PATTERNS):
                yield os.path.join(tests, f)
    for f in TOP_FILES:
        path = os.path.join(base, f)
        if f.endswith(tuple(suffixes)) and os.path.isfile(path):
            yield path
