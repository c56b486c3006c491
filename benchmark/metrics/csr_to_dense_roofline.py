"""``csr_to_dense``'s share of its roofline: the least time of each call
in the window (``roofline.csr_to_dense_cost``: the whole row plane, the
kept nonzeros' columns and values, the dense f32 output) over the device
time of every op launched inside the harness's
``record_function("bench.csr_to_dense")`` around the port's
``models.linear.csr_to_dense``, in %. Never capped."""

from benchmark import roofline


def read(t):
    calls = t.extra.get("csr_to_dense_calls")
    spent = t.annotated_us.get("bench.csr_to_dense")
    if not calls or not spent or sum(spent) <= 0:
        return None
    steps = t.extra["steps"]
    # the calls whose device time was read (one a window step)
    n = min(len(calls), len(spent), len(steps))
    bound = 0.0
    for (plane, rows, feats), (_, real_rows) in zip(calls[:n], steps[:n]):
        cost = roofline.csr_to_dense_cost(
            plane, real_rows * t.extra["nnz_per_row"], rows, feats)
        bound += roofline.bound_s(*cost)[0]
    return 100.0 * bound / (sum(spent[:n]) / 1e6)
