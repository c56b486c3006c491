"""Driver ``train_epochs``: epoch after epoch of the port's training loop
over one file, the loop ``train.train_epoch`` runs.

Set-up writes the configuration's rows with its generator (and, for
``"input": "crec"``, converts them once with the port's
``io/convert.py::rows_to_csr_recordio`` and deletes the text), builds the
learner, draws its parameters from the seed, opens
``DeviceRowBlockIter(uri, batch_rows, layout="csr")`` on the card, and
drives the first three steps through the window's own call and feed:
those steps warm every shape the window uses and are the ones the
reference follows. The window then goes on with the same learner,
parameters and iterator for ``--seconds``: every batch goes to
``learner.step``, its loss is read back, and ``before_first()`` starts
the next epoch. ``train_rows_per_s`` is the rows of every step completed
in the window over the window's seconds; ``card_ms_per_step``, for a cell
that reports it, the card's compute in the window (every kernel and
memset of a ``torch.profiler`` trace of the device alone; copies left
out) over the window's steps.
"""

from __future__ import annotations

import contextlib
import math
import os
import sys
import time

import numpy as np

CHECK_STEPS = 3
SPAN_GATHER_EVERY = 256
# milliseconds of kernels and memsets the card ran in the window, a step
CARD_METRIC = "card_ms_per_step"


def process_cpu_s() -> float:
    """This process's CPU seconds so far, all its threads', user and
    system."""
    t = os.times()
    return t.user + t.system


def prepare_data(ctx) -> str:
    """The cell's input file, made (or found) under the checkout's cache:
    one entry a configuration, by seed and rows; other entries of the
    configuration are deleted first, so the cache stays one data set. A
    file made here is written back to the disk before the window opens,
    so the disk's writeback does not run beside the measured epochs."""
    cfg = ctx.config
    gen = ctx.part("datagen", cfg["data"]["generator"])
    fmt = cfg["data"]["format"]
    rows = cfg["rows"]
    d = ctx.cache("data", cfg["name"])
    stem = f"{ctx.seed}-{rows}"
    text = os.path.join(d, f"{stem}.{fmt}")
    crec = ctx.traffic["input"] == "crec"
    want = os.path.join(d, f"{stem}.crec") if crec else text
    if not os.path.exists(want):
        for f in os.listdir(d):
            if not f.startswith(stem + "."):
                os.unlink(os.path.join(d, f))
        if not os.path.exists(text):
            gen.write(text + ".part", rows, ctx.seed, fmt)
            os.replace(text + ".part", text)
        if crec:
            from dmlc_core_tpu_torch.io.convert import rows_to_csr_recordio
            rows_to_csr_recordio(text, want + ".part", fmt=fmt)
            os.replace(want + ".part", want)
            os.unlink(text)
        # write the file back now, not while the window reads it
        os.sync()
    return want if crec else f"{want}?format={fmt}"


class Feed:
    """Batches of the iterator, epoch after epoch: at the end of one,
    ``before_first()`` and on. ``pos`` is the batch's place in its
    epoch."""

    def __init__(self, it):
        self.it = it
        self.epochs = 0
        self._gen = iter(it)
        self._pos = 0

    def next(self):
        try:
            batch = next(self._gen)
        except StopIteration:
            self.it.before_first()
            self.epochs += 1
            self._gen = iter(self.it)
            self._pos = 0
            batch = next(self._gen)
        self._pos += 1
        return self._pos - 1, batch


class Trainer:
    """The one training object: learner, parameters and feed. Set-up's
    steps and the window's go through :meth:`step`."""

    def __init__(self, learner, params, feed, annotate: bool):
        self.learner = learner
        self.params = params
        self.feed = feed
        self._annotate = annotate

    def _range(self, name: str):
        if not self._annotate:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(name)

    def step(self):
        """(pos, rows, loss, t0, t1) of one step, the loss read back."""
        pos, batch = self.feed.next()
        t0 = time.perf_counter()
        with self._range("bench.step"):
            self.params, loss = self.learner.step(self.params, batch)
            loss = float(loss)
        return pos, batch.total_rows, loss, t0, time.perf_counter()


@contextlib.contextmanager
def annotated_csr_to_dense(calls: list):
    """Wrap the port's ``csr_to_dense`` as the linear learner calls it in
    ``record_function("bench.csr_to_dense")``, noting each call's row
    plane length, rows and features; whatever implements it, the range
    holds its work."""
    import torch
    from dmlc_core_tpu_torch.models import linear as lin
    orig = lin.csr_to_dense

    def wrapped(row, col, val, num_rows, num_features, *a, **k):
        calls.append((int(row.numel()), int(num_rows), int(num_features)))
        with torch.profiler.record_function("bench.csr_to_dense"):
            return orig(row, col, val, num_rows, num_features, *a, **k)

    lin.csr_to_dense = wrapped
    try:
        yield
    finally:
        lin.csr_to_dense = orig


def run(ctx) -> dict:
    import torch
    from dmlc_core_tpu_torch.device.device_iter import DeviceRowBlockIter
    from benchmark import correct, trace as tr

    cfg = ctx.config
    kind = cfg["model"]["kind"]
    model = ctx.part("models", kind)
    cuda = ctx.device == "cuda"
    uri = prepare_data(ctx)
    ctx.mark("data")
    learner = model.learner(cfg, ctx.device)
    params = model.init(cfg, ctx.seed, ctx.device)
    p0 = model.leaves(params)
    it = DeviceRowBlockIter(uri, batch_rows=cfg["batch_rows"], layout="csr",
                            device=ctx.device)
    ctx.mark("learner")
    trainer = Trainer(learner, params, Feed(it), ctx.trace)
    first = {"loss": [], "params": [p0]}
    try:
        for s in range(CHECK_STEPS):
            pos, _, loss, _, _ = trainer.step()
            if pos != s:
                raise RuntimeError(f"set-up step {s} read batch {pos}")
            first["loss"].append(loss)
            if s == 0 or s == CHECK_STEPS - 1:
                first["params"].append(model.leaves(trainer.params))
        if cuda:
            torch.cuda.synchronize()
        setup_s = ctx.mark("first_steps")
        ctx.report_setup()

        steps, calls, spans = [], [], tr.SpanLog()
        capture = hist0 = None
        # the card's compute time is read from a trace of the device's
        # activity alone, in the untraced run of a cell that reports it
        card = cuda and not ctx.trace and ctx.reports(CARD_METRIC)
        if ctx.trace:
            hist0 = tr.hist_totals()
            capture = tr.Capture(ctx.cache("trace"), cuda)
        elif card:
            capture = tr.Capture(ctx.cache("trace"), cuda, cpu=False)
        with (capture or contextlib.nullcontext()), \
                (annotated_csr_to_dense(calls) if ctx.trace
                 else contextlib.nullcontext()):
            cpu0 = process_cpu_s()
            t0 = time.perf_counter()
            deadline = t0 + ctx.seconds
            rows = 0
            losses_bad = 0
            while True:
                pos, n, loss, a, b = trainer.step()
                rows += n
                losses_bad += not math.isfinite(loss)
                steps.append((pos, n, a, b))
                if ctx.trace and len(steps) % SPAN_GATHER_EVERY == 0:
                    spans.gather()
                if b >= deadline:
                    break
            t1 = b
            cpu1 = process_cpu_s()
            hist = tr.hist_delta(hist0, tr.hist_totals()) if ctx.trace \
                else None
        peak = torch.cuda.max_memory_allocated() if cuda else 0
    finally:
        it.close()
    epochs = trainer.feed.epochs
    del trainer, learner, params, it
    _report_window(steps, t0, t1)
    print(f"host: process {cpu1 - cpu0:.3f} cpu-s in {t1 - t0:.3f} s",
          file=sys.stderr, flush=True)
    if cuda:
        torch.cuda.empty_cache()

    metrics = {"setup_s": setup_s, "train_rows_per_s": rows / (t1 - t0)}
    if card:
        metrics[CARD_METRIC] = tr.device_time_us(capture.trace) / 1e3 / len(
            steps)
    out = {"metrics": metrics,
           "attempted": len(steps), "failed": losses_bad,
           "memory_peak_bytes": peak, "ok": losses_bad == 0}
    gen = ctx.part("datagen", cfg["data"]["generator"])
    arr = gen.arrays(cfg["rows"], ctx.seed)
    if ctx.trace:
        spans.gather()
        for pos, n, a, b in steps:
            spans.add("bench.step", a, b)
        out["trace"] = _trace_data(ctx, capture, hist, spans, steps, calls,
                                   arr, t0, t1, epochs)
    ref = ctx.part("reference", kind).train(
        arr, p0, cfg["batch_rows"], CHECK_STEPS, cfg["model"])
    gaps = correct.train_gaps(first, ref, cfg["model"], model)
    out["checks"] = correct.checks(gaps, ctx.limits())
    return out


def _report_window(steps, t0, t1) -> None:
    """Steps, epochs and the spread of whole epochs' rates, on stderr."""
    rates, a, rows = [], t0, 0
    for i, (pos, n, _, b) in enumerate(steps):
        rows += n
        if i + 1 < len(steps) and steps[i + 1][0] == 0:
            rates.append(rows / (b - a))
            a, rows = b, 0
    line = f"window: {len(steps)} steps in {t1 - t0:.3f} s"
    if len(rates) > 2:
        rates = sorted(rates[1:])  # the first epoch began in set-up
        line += (f", {len(rates)} whole epochs at {rates[0]:.0f} / "
                 f"{rates[len(rates) // 2]:.0f} / {rates[-1]:.0f} rows/s "
                 f"(min / median / max)")
    print(line, file=sys.stderr, flush=True)


def _trace_data(ctx, capture, hist, spans, steps, calls, arr, t0, t1,
                epochs):
    from benchmark import trace as tr
    cfg = ctx.config
    got = tr.analyze(capture.trace, capture.anchors, t0 * 1e6, t1 * 1e6,
                     spans.all(), ("bench.step", "bench.csr_to_dense"))
    R = cfg["batch_rows"]
    per_row = arr["col"].shape[1]
    positions = sorted({pos for pos, _, _, _ in steps})
    distinct = {p: int(np.unique(arr["col"][p * R:(p + 1) * R]).size)
                for p in positions}
    extra = {"config": cfg, "epochs": epochs,
             "steps": [(pos, n) for pos, n, _, _ in steps],
             "nnz_per_row": per_row, "distinct_cols": distinct,
             "csr_to_dense_calls": calls}
    return tr.TraceData(got["window_s"], got["busy_s"], got["top_ops"],
                        got["idle_gaps"], got["annotated_us"],
                        hist, extra)
