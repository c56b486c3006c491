"""Native parse work a thousand rows: the Δ of the native core's
``parse_stage_parse_us`` and ``parse_stage_scan_us`` sums (its workers'
decode and pre-tiling time) over the rows the iterator staged in the
window. Nothing to read where the lane parses no text."""


def read(t):
    parse = sum(t.hist.get(n, (0.0, 0))[0]
                for n in ("parse_stage_parse_us", "parse_stage_scan_us"))
    batches = t.hist.get("device_stage_us", (0.0, 0))[1]
    if parse <= 0 or batches <= 0:
        return None
    return parse / (batches * t.extra["config"]["batch_rows"] / 1e3)
