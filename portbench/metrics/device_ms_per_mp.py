"""device_ms_per_mp (ms/MP): the summed time of every device operation of
the program (kernels, copies, sets; not the harness's answer check) inside
the traced window, which closes at the last completion counted, over the
megapixels completed there."""

from portbench.tracing import clip


def read(record):
    trace = record["trace"]
    if not trace or not record["mp"] or not trace["device_ops"]:
        return None
    lo, hi = trace["window"]
    ops = clip([(t, t + d) for _, t, d in trace["device_ops"]], lo, hi)
    return sum(b - a for a, b in ops) / 1e3 / record["mp"]
