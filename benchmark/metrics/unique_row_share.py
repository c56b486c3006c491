"""Share of the table ids looked up that are distinct rows, the rows the
sparse update touches: Δ sum of the program's ``dlrm_unique_rows`` over Δ
sum of its ``dlrm_lookup_ids`` (``models/dlrm.py``), in %."""


def read(t):
    rows, _ = t.hist.get("dlrm_unique_rows", (0.0, 0))
    ids, n = t.hist.get("dlrm_lookup_ids", (0.0, 0))
    if n <= 0 or ids <= 0:
        return None
    return 100.0 * rows / ids
