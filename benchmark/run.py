"""The benchmark's one command:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

run from the root of a checkout. The cell is looked up in
``BENCHMARK.json``; its configuration, traffic mix, driver and per-layer
metric readers are files under ``benchmark/`` found by name
(``benchmark/harness.py``). The last line of standard output is the
result: one JSON object. A run that cannot measure (no CUDA card, fewer
cards than the cell asks for, the program missing, JAX loaded) prints no
result and exits non-zero.
"""

import os
import sys
import time

# set-up is counted from here (the process's own start where /proc has it)
_T_IMPORT = time.perf_counter()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], t_import=_T_IMPORT))
