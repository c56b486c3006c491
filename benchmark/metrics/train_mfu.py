"""The whole training step's share of the card's peak: each window
step's least time by ``benchmark/roofline.py`` (its flops or bytes, from
the batch's rows, nonzeros and distinct columns), summed over the steps,
over the window's seconds, in %."""

from benchmark import roofline


def step_cost(cfg, rows, nnz, distinct):
    kind = cfg["model"]["kind"]
    if kind == "linear":
        return roofline.linear_step_cost(rows, nnz, cfg["features"])
    if kind == "fm":
        return roofline.fm_step_cost(rows, nnz, distinct, cfg["model"]["k"])
    return None


def read(t):
    ex = t.extra
    if "steps" not in ex or t.window_s <= 0 or t.busy_s <= 0:
        return None
    total = 0.0
    for pos, rows in ex["steps"]:
        cost = step_cost(ex["config"], rows, rows * ex["nnz_per_row"],
                         ex["distinct_cols"][pos])
        if cost is None:
            return None
        total += roofline.bound_s(*cost)[0]
    return 100.0 * total / t.window_s
