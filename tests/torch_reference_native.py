"""The JAX package's native core for the port's parity tests, built once
under a lock.

``dmlc_core_tpu/io/native.py`` builds its library with ``make -C cpp``,
which links ``dmlc_core_tpu/_native/libdmlc_core_tpu.so`` in place and
holds no lock. A test worker that arrives while another process's linker
is writing that file finds it present and newer than the sources, skips
its own build and loads the half-written file: ``OSError: ... file too
short`` or ``invalid ELF header``. The port's parity tests call into that
library, so they take it from here instead: the same ``make`` target
writes a temporary file under the port's build lock (``_build/build.lock``)
that is moved into ``_build/reference/`` with ``os.replace``, and the
reference's loader is pointed at it before its first load. A complete copy
also replaces the in-place library when that one is missing or stale, so
that reference runs in subprocesses (``examples/train.py``) find a whole
file there. The JAX package itself is not changed.
"""

import os
import shutil

import pytest

from dmlc_core_tpu.io import native as ref_native
from dmlc_core_tpu_torch.base import BUILD_DIR, REPO_ROOT, build_if_stale

REF_LIB = os.path.join(BUILD_DIR, "reference", "libdmlc_core_tpu.so")
_CPP_DIR = os.path.join(REPO_ROOT, "cpp")


def _sources():
    src = os.path.join(_CPP_DIR, "src")
    return [os.path.join(src, f) for f in os.listdir(src)]


def use_locked_reference_build() -> str:
    """Build the reference's library into ``REF_LIB`` when it is missing
    or stale, point ``dmlc_core_tpu.io.native`` at it, and return its
    path."""
    sources = _sources()
    build_if_stale(REF_LIB, sources,
                   lambda tmp: ["make", "-C", _CPP_DIR, f"OUT={tmp}"])
    if ref_native._lib is None:
        ref_native._LIB_PATH = REF_LIB
    in_place = os.path.join(ref_native._NATIVE_DIR, "libdmlc_core_tpu.so")
    try:
        stale = any(os.path.getmtime(s) > os.path.getmtime(in_place)
                    for s in sources)
    except OSError:  # missing, or unlinked by a linker just now
        stale = True
    if stale:
        os.makedirs(ref_native._NATIVE_DIR, exist_ok=True)
        tmp = f"{in_place}.tmp{os.getpid()}"
        shutil.copy2(REF_LIB, tmp)
        os.replace(tmp, in_place)
    return REF_LIB


@pytest.fixture(scope="session", autouse=True)
def reference_native():
    """Autouse in every test module that imports it: the reference's
    native core comes from the locked build."""
    return use_locked_reference_build()
