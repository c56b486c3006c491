"""Device time of a training step: the kernels, copies and memsets
launched inside the harness's ``record_function("bench.step")`` around
``learner.step`` (and its loss read back), a step."""


def read(t):
    per = t.annotated_us.get("bench.step")
    if not per or sum(per) <= 0:
        return None
    return sum(per) / len(per) / 1e3
