"""idle_unspanned_share (%): the share of the card's idle time in the
traced window during which the request the card was waiting for had no
span open but its root (`Decode batch`): host work of that request that
no span names yet.

Each idle gap ends where a device operation starts, and the request the
card waited for is the one that launched it: a request with a launch span
(`Upload`, `Stacked program`, `Colour tail`, `Fused program`) open within
LAUNCH_SLACK_NS of the gap's end, which allows for the launch's latency
and for the two clocks' disagreement. Over the gap, the spans of that
request, on any thread (a pool thread's spans carry the request of the
call that caused them), cover what they were open over; what they leave
is unspanned. Where several requests were launching, their spans cover
together. A gap that no launch span explains, as the window's last one,
which no operation ends, counts whole as unspanned; its share goes to
standard error.

The device operations are placed on the recorder's clock by the window's
own range: the trace's window opens at the harness's `portbench window`
range, which opens at the run's window opening (its `window_ns`)."""

import bisect
import sys

from portbench.recorder import LAUNCH, ROOT, program
from portbench.tracing import clip, merge

LAUNCH_SLACK_NS = 200_000


def _covered(intervals, ends, a, b) -> list:
    """The parts of sorted disjoint `intervals` (their ends `ends`) inside
    (a, b)."""
    out = []
    for x, y in intervals[bisect.bisect_right(ends, a):]:
        if x >= b:
            break
        out.append((max(x, a), min(y, b)))
    return out


def read(record):
    got = program(record)
    trace = record["trace"]
    if got is None or not trace or not trace["device_ops"]:
        return None
    prog, (w0, w1) = got
    n = w1 - w0
    lo = trace["window"][0]
    # in ns from the window's opening (a float of the clock itself would
    # round to 256 ns)
    busy = merge(clip([((t - lo) * 1e3, (t + d - lo) * 1e3)
                       for _, t, d in trace["device_ops"]], 0, n))
    gaps, at = [], 0.0
    for a, b in busy:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    idle = sum(b - a for a, b in gaps) + max(n - at, 0)
    if idle <= 0:
        return None

    spans: dict = {}
    launches = []
    for s in prog["spans"]:
        a, b = s["start_ns"] - w0, s["end_ns"] - w0
        if s["name"] != ROOT:
            spans.setdefault(s["request"], []).append((a, b))
        if s["name"] in LAUNCH:
            launches.append((a - LAUNCH_SLACK_NS, b + LAUNCH_SLACK_NS,
                             s["request"]))
    spans = {r: merge(iv) for r, iv in spans.items()}
    ends = {r: [y for _, y in iv] for r, iv in spans.items()}
    launches.sort()

    unspanned = max(n - at, 0)  # after the last operation
    unexplained = unspanned
    active: list = []
    k = 0
    for a, b in gaps:  # by end, so a launch that closed stays closed
        while k < len(launches) and launches[k][0] <= b:
            active.append(launches[k])
            k += 1
        active = [x for x in active if x[1] >= b]
        requests = {r for _, _, r in active}
        if not requests:
            unexplained += b - a
        covered = merge(c for r in requests
                        for c in _covered(spans.get(r, ()), ends.get(r, ()),
                                          a, b))
        unspanned += (b - a) - sum(y - x for x, y in covered)
    print(f"[portbench] idle_unspanned_share: {unspanned / 1e9:.4f} s of "
          f"{idle / 1e9:.4f} s idle in {len(gaps)} gaps; "
          f"{unexplained / 1e9:.4f} s in gaps no launch span explains",
          file=sys.stderr)
    return 100.0 * unspanned / idle
