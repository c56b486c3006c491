"""The port's scoring server (``python -m dmlc_core_tpu_torch.serving``'s
own ``main``) with a ``torch.profiler`` window the benchmark opens and
closes by signal, for the traced run of a serving cell:

    python benchmark/serve_child.py <summary.json> <server arguments>

SIGUSR1 opens the capture (CUDA activity only: the server's host work is
what the cell measures, so its ops are not recorded) and writes
``<summary.json>.started``; SIGUSR2 closes it and writes the window's
summary (busy seconds, top device ops, idle gaps named by the server's
spans) to ``<summary.json>``. The server itself is not changed.
"""

import json
import os
import signal
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main() -> int:
    out, argv = sys.argv[1], sys.argv[2:]
    from benchmark import trace as tr
    from benchmark.drivers.serve_open import SERVE_SPANS
    from dmlc_core_tpu_torch import telemetry
    from dmlc_core_tpu_torch.serving.__main__ import main as serve
    cuda = "cpu" not in argv
    state = {}

    def start(signum, frame):
        state["cap"] = tr.Capture(os.path.dirname(out), cuda,
                                  cpu=not cuda).__enter__()
        with open(out + ".started", "w"):
            pass

    def stop(signum, frame):
        cap = state.pop("cap")
        cap.__exit__(None, None, None)
        got = tr.analyze(cap.trace, cap.anchors,
                         cap.anchors["start"]["perf_us"],
                         cap.anchors["stop"]["perf_us"], telemetry.spans(),
                         gap_spans=SERVE_SPANS)
        with open(out + ".part", "w") as f:
            json.dump(got, f)
        os.replace(out + ".part", out)

    signal.signal(signal.SIGUSR1, start)
    signal.signal(signal.SIGUSR2, stop)
    return serve(argv)


if __name__ == "__main__":
    sys.exit(main())
