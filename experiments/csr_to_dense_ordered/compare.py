#!/usr/bin/env python3
"""Time the one-pass CSR -> dense design in ordered.cu beside the
package's kernel and its previous version, on the same inputs, on one
CUDA GPU:

    python3 experiments/csr_to_dense_ordered/compare.py

Run from the root of a checkout with nvcc on the PATH (or under
CUDA_HOME). Builds ordered.cu for sm_90a into the package's build
directory, then for each of chip_smoke.py's kernel cases, and four that
sit on either side of the one-pass design's limits, prints one JSON line:
the device time (chip_smoke.time_ms: median of 30 runs, L2 flushed) of
the package kernel (``kernel_us``), of the kernel's previous version
(``previous_kernel_us``), of the one-pass design (``ordered_us``) and of
its general path forced (``ordered_general_us``), the path the one-pass
design took, and whether every result matched the plain version at the
case's tolerance. Then the card's ``name, power.limit`` line. Exits
non-zero if any result disagrees or a case takes the wrong path.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

import chip_smoke as cs  # noqa: E402
from dmlc_core_tpu_torch.ops import hopper_kernels as hk  # noqa: E402

MAX_GAP = 1 << 15  # ordered.cu's kMaxGap
MAX_RUN = 32       # ordered.cu's kMaxRun


def ordered_path(row, col, R: int, F: int) -> bool:
    """Whether ordered.cu takes its one-pass path: each nonzero's key (its
    cell, or where a dropped one sorts) never goes back, each is a new cell
    at most MAX_GAP cells past the first one it may own or a duplicate of
    the cell before, and no cell takes more than MAX_RUN adds."""
    r, c = torch.from_numpy(row).long(), torch.from_numpy(col).long()
    kept = (r >= 0) & (r < R) & (c >= 0) & (c < F)
    at = torch.where(r < 0, 0, torch.where(r >= R, R * F,
                                           r * F + c.clamp(0, F)))
    at = torch.cat([torch.tensor([0]), at, torch.tensor([R * F])])
    kept = torch.cat([torch.tensor([False]), kept, torch.tensor([False])])
    dup = kept[1:] & kept[:-1] & (at[1:] == at[:-1])
    gap = at[1:] - (at[:-1] + kept[:-1].long())
    if not bool((dup | ((gap >= 0) & (gap <= MAX_GAP))).all()):
        return False
    return int(torch.bincount(torch.cumsum((~dup).long(), 0)).max()) \
        <= MAX_RUN


def limit_cases(rng):
    """Cases on either side of the one-pass design's limits."""
    F = cs.FEATURES
    cases = []
    n = 1 << 20  # about 9 adds per cell, in the order of the cells
    row = np.sort(rng.integers(0, 4096, n)).astype(np.int32)
    col = rng.integers(0, F, n).astype(np.int32)
    val = rng.standard_normal(n).astype(np.float32)
    order = np.lexsort((col, row))
    cases.append(("cell_order_9_per_cell_4096x28", row[order], col[order],
                  val[order], 4096, F, "bound", True))
    for adds in (MAX_RUN, MAX_RUN + 1):  # one cell's run of adds
        row, col, val = cs.padded_batch_csr(rng, 1024, 1024 * F + 64)
        at = 500 * F + 7
        row = np.insert(row, at, np.full(adds - 1, 500, np.int32))
        col = np.insert(col, at, np.full(adds - 1, 7, np.int32))
        val = np.insert(val, at,
                        rng.standard_normal(adds - 1).astype(np.float32))
        cases.append((f"run_of_{adds}_1024x28", row, col, val, 1024, F,
                      "bound", True))
    lengths = np.full(4096, F)  # 33,600 zero cells owned by one nonzero
    lengths[1000:2200] = 0
    row, col, val = cs.uneven_csr(rng, lengths, F)
    cases.append(("gap_past_limit_4096x28", row, col, val, 4096, F,
                  "exact", True))
    return cases


def main() -> int:
    if not torch.cuda.is_available():
        print("compare.py needs a CUDA GPU", file=sys.stderr)
        return 2
    os.makedirs(hk.BUILD_DIR, exist_ok=True)
    so = os.path.join(hk.BUILD_DIR, "libordered_csr_to_dense.so")
    previous = cs.start_previous_kernel_build()
    build = subprocess.run(
        [hk._nvcc(), *hk.NVCC_ARCH, "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", so,
         os.path.join(HERE, "ordered.cu")], capture_output=True, text=True)
    if build.returncode:
        print(build.stdout + build.stderr, file=sys.stderr)
        return 1
    print(json.dumps({"ptxas": [ln for ln in build.stderr.splitlines()
                                if "registers" in ln]}), flush=True)
    cs.load_previous_kernel(*previous)
    hk.build()
    lib = ctypes.CDLL(so)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ordered_csr_to_dense_f32.argtypes = [
        vp, vp, vp, ctypes.c_longlong, i32, i32, vp, vp, vp, i32, i32, vp]
    lib.ordered_csr_to_dense_f32.restype = i32
    lib.ordered_max_blocks.restype = i32
    max_blocks = lib.ordered_max_blocks()
    counts = torch.zeros(2, dtype=torch.int64, device="cuda")

    failed = False
    rng = np.random.default_rng(0)
    for name, row, col, val, R, F, tol, _ in (cs.kernel_cases(rng)
                                              + limit_cases(rng)):
        if not len(row):
            continue
        r, c, v = (torch.from_numpy(a).cuda() for a in (row, col, val))
        want = hk.csr_to_dense_reference(r, c, v, R, F)
        # enough blocks for one 4,096-entry step each and 65,536 cells each
        # of zeroing, at most what the card holds at once
        grid = max(1, min(max_blocks, max(-(-(len(row) + 1) // 4096),
                                          -(-R * F // 65536))))
        flags = torch.empty(grid, dtype=torch.int32, device="cuda")
        out = torch.empty((R, F), device="cuda")

        def ordered(force=0):
            err = lib.ordered_csr_to_dense_f32(
                r.data_ptr(), c.data_ptr(), v.data_ptr(), len(row), R, F,
                out.data_ptr(), flags.data_ptr(), counts.data_ptr(), force,
                grid, torch.cuda.current_stream().cuda_stream)
            assert err == 0, err
            return out
        before = counts.tolist()
        ordered()
        torch.cuda.synchronize()
        took = "ordered" if counts[0] > before[0] else "general"
        expect = "ordered" if ordered_path(row, col, R, F) else "general"
        rec = {"case": name, "nnz": len(row), "path": took,
               "expected_path": expect}
        ok = {"kernel": cs.check_case(hk.csr_to_dense_kernel(r, c, v, R, F),
                                      want, tol, r, c, v, R, F, {}),
              "previous_kernel": cs.check_case(
                  cs.previous_kernel(r, c, v, R, F), want, tol, r, c, v, R,
                  F, {}),
              "ordered": cs.check_case(out.clone(), want, tol, r, c, v, R,
                                       F, {}),
              "ordered_general": cs.check_case(ordered(1).clone(), want,
                                               tol, r, c, v, R, F, {})}
        rec["match"] = ok
        if took == "ordered":
            again = ordered().clone()
            rec["bit_stable"] = bool(torch.equal(ordered(), again))
        rec["kernel_us"] = 1e3 * cs.time_ms(
            lambda: hk.csr_to_dense_kernel(r, c, v, R, F))
        rec["previous_kernel_us"] = 1e3 * cs.time_ms(
            lambda: cs.previous_kernel(r, c, v, R, F))
        rec["ordered_us"] = 1e3 * cs.time_ms(ordered)
        rec["ordered_general_us"] = 1e3 * cs.time_ms(lambda: ordered(1))
        rec["bound_us"] = 1e3 * cs.bound_ms(r, c, R, F)[0]
        print(json.dumps(rec), flush=True)
        failed |= (not all(ok.values()) or took != expect
                   or not rec.get("bit_stable", True))
    print(cs.card_line(), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
