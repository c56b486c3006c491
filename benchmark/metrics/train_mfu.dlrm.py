"""The whole DLRM-DCNv2 training step's share of the card's peak: each
window step's least time by ``benchmark/roofline_dlrm.py`` (its float32
operations or bytes, from the widths, the batch's rows and nonzeros and
its distinct table rows), summed over the steps, over the window's
seconds, in %."""

from benchmark import roofline, roofline_dlrm


def read(t):
    ex = t.extra
    if "steps" not in ex or t.window_s <= 0 or t.busy_s <= 0:
        return None
    model = ex["config"]["model"]
    if model["kind"] != "dlrm":
        return None
    per_row = ex["nnz_per_row"]
    ids_per_row = per_row - model["dense_features"]
    total = 0.0
    for pos, rows in ex["steps"]:
        # every row holds each dense column once: the rest are table rows
        distinct = ex["distinct_cols"][pos] - model["dense_features"]
        total += roofline.bound_s(*roofline_dlrm.step_cost(
            model, rows, rows * per_row, rows * ids_per_row, distinct))[0]
    return 100.0 * total / t.window_s
