"""device_idle_share (%): 100 x (1 - the union of the intervals of the
program's device operations (not the harness's answer check) over the
length of the traced window, which closes at the last completion
counted)."""

from portbench.tracing import clip, merge


def read(record):
    trace = record["trace"]
    if not trace or not trace["device_ops"]:
        return None
    lo, hi = trace["window"]
    if hi <= lo:
        return None
    busy = merge(clip([(t, t + d) for _, t, d in trace["device_ops"]], lo, hi))
    return 100.0 * (1.0 - sum(b - a for a, b in busy) / (hi - lo))
