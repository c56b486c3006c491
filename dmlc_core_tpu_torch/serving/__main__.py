"""Standalone scoring server: ``python -m dmlc_core_tpu_torch.serving``.

Binds the port, prints one ``SERVE_READY port=<p> pid=<p>`` line on
stdout, and serves until SIGTERM/SIGINT, which starts the draining
shutdown (answer every admitted request, shed the rest, finish every
write) and exits 0. The model runs on ``--device`` (default ``cuda``;
without CUDA the server refuses to start). Every response carries
Content-Length, so a client of a killed server sees only clean errors or
complete responses.
"""

import argparse
import os
import signal
import sys
import threading

from dmlc_core_tpu_torch.serving.server import ScoringServer, ServingConfig


def main(argv=None) -> int:
    """CLI entry; returns the process exit code."""
    ap = argparse.ArgumentParser(
        description="batched online scoring server (doc/serving.md)")
    ap.add_argument("--model-uri", required=True,
                    help="serving model artifact (save_model checkpoint)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 binds an ephemeral port (printed on stdout)")
    ap.add_argument("--rows-buckets", default="16,64,256,1024",
                    help="comma-separated row-bucket ladder")
    ap.add_argument("--batch-delay-ms", type=float, default=None)
    ap.add_argument("--batch-max-rows", type=int, default=None)
    ap.add_argument("--queue-max", type=int, default=None)
    ap.add_argument("--shed-lateness-ms", type=float, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device of the model (default: cuda; "
                         "raises without CUDA)")
    args = ap.parse_args(argv)

    config = ServingConfig(rows_buckets=args.rows_buckets,
                           batch_delay_ms=args.batch_delay_ms,
                           batch_max_rows=args.batch_max_rows,
                           queue_max=args.queue_max,
                           shed_lateness_ms=args.shed_lateness_ms)
    server = ScoringServer(model_uri=args.model_uri, host=args.host,
                           port=args.port, config=config,
                           device=args.device)
    server.start()
    done = threading.Event()

    def _drain(signum, frame):
        done.set()

    signal.signal(signal.SIGTERM, _drain)
    signal.signal(signal.SIGINT, _drain)
    print(f"SERVE_READY port={server.port} pid={os.getpid()}",
          flush=True)
    done.wait()
    server.stop(drain=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
