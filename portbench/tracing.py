"""What the harness reads around the program: the port's spans, the
profiler's device trace, the answers it checks, and the table of peaks.

- `SpanLog`: the port's spans (`utils/trace.py` logs one DEBUG record,
  "<name>: <ms> ms", as each span closes), kept in memory with their end
  on the harness's clock, only while the window is open.
- `Profiler`: torch.profiler over the window; its Chrome trace is read
  once into device operations (kernels, copies, sets) and the host's
  annotations (the port's spans with JXL_TPU_TRACE_ANNOTATE=1, and the
  harness's own "portbench window" range, which opens the traced window).
  The window is then closed where the run's rate closes it, at the last
  completion counted, and the device operations are those inside it. The
  harness's own answer check runs on a stream of its own, marked in the
  trace by a spin kernel; its operations are kept apart and counted as no
  work of the program's.
- `AnswerCheck`: keeps the first answer of each checked slot and the
  largest difference of every later answer of that slot from it, on the
  check's own stream, so every answer of those slots is judged.
- `peaks`: the card's entry in peaks.json."""

from __future__ import annotations

import contextlib
import json
import logging
import math
import os
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
WINDOW = "portbench window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "spin_kernel"  # torch.cuda._sleep's kernel, launched by nothing else


def peaks(kind: str) -> dict:
    with open(os.path.join(HERE, "peaks.json")) as f:
        return json.load(f).get(kind, {})


class SpanLog(logging.Handler):
    """Span records (name, start, end) on time.perf_counter's clock."""

    def __init__(self, logger_name: str):
        super().__init__(logging.DEBUG)
        self._logger = logging.getLogger(logger_name)
        self._spans: list = []
        self._lock = threading.Lock()

    def emit(self, record):
        end = time.perf_counter()
        args = record.args
        if (isinstance(args, tuple) and len(args) >= 2
                and record.msg.startswith("%s: %.2f ms")):
            with self._lock:
                self._spans.append((args[0], end - args[1] / 1e3, end))

    def start(self):
        self._logger.addHandler(self)
        self._logger.setLevel(logging.DEBUG)
        self._logger.propagate = False

    def stop(self):
        self._logger.setLevel(logging.WARNING)
        self._logger.removeHandler(self)
        self._logger.propagate = True

    def records(self, t_open: float, t_close: float) -> list:
        """The spans that ended inside [t_open, t_close]."""
        return [s for s in self._spans if t_open <= s[2] <= t_close]


def merge(intervals) -> list:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def clip(intervals, lo: float, hi: float) -> list:
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if b > lo and a < hi]


class Profiler:
    """torch.profiler over the window, read into `events`: {"device_ops":
    [(name, ts_us, dur_us)], "check_ops": the same for the answer check's
    stream, "annotations": [(name, ts_us, dur_us)], "window": (t0_us,
    t1_us)}."""

    def __init__(self, cuda: bool):
        import torch.profiler as tp

        acts = [tp.ProfilerActivity.CPU]
        if cuda:
            acts.append(tp.ProfilerActivity.CUDA)
        self._prof = tp.profile(activities=acts)
        self.events: dict = {}

    def start(self):
        self._prof.start()

    @contextlib.contextmanager
    def window(self):
        import torch.profiler as tp

        with tp.record_function(WINDOW):
            yield

    def stop(self, seconds: float):
        """Stop and read the trace; the window is the `seconds` from the
        opening of the harness's range."""
        self._prof.stop()
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                raw = json.load(f)
        self.events = read_trace(raw, seconds)

    def busy_and_window(self) -> tuple:
        """Seconds in which a device operation ran inside the window, and
        the window's length."""
        lo, hi = self.events["window"]
        busy = merge(clip([(t, t + d) for _, t, d in
                           self.events["device_ops"]], lo, hi))
        return sum(b - a for a, b in busy) / 1e6, (hi - lo) / 1e6

    def breakdown(self, spans=(), t_open: float = 0.0, n: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps of the device, each named by the innermost host span open at
        the gap's middle: the trace's annotations, and `spans` (name,
        start, end on the harness's clock, the window opening at `t_open`)
        placed on the trace's clock by the window's own range."""
        lo, hi = self.events["window"]
        by_name: dict = {}
        for name, t, d in self.events["device_ops"]:
            by_name[name] = by_name.get(name, 0.0) + d / 1e6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        busy = merge(clip([(t, t + d) for _, t, d in
                           self.events["device_ops"]], lo, hi))
        edges = [lo] + [x for ab in busy for x in ab] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        notes = list(self.events["annotations"]) + [
            (name, lo + (a - t_open) * 1e6, (b - a) * 1e6)
            for name, a, b in spans]
        named = []
        for a, b in gaps[:n]:
            mid = (a + b) / 2
            open_ = [x for x in notes if x[1] <= mid <= x[1] + x[2]]
            name = max(open_, key=lambda x: x[1])[0] if open_ else "no span"
            named.append([name, (b - a) / 1e6])
        return {"device_ops": [[k, v] for k, v in top], "idle_gaps": named}


def read_trace(raw: dict, seconds: float) -> dict:
    """A Chrome trace's device operations and annotations, the window
    opened by the WINDOW range and `seconds` long; the operations on the
    stream that carries the MARKER kernel go to "check_ops"."""
    ops, notes, start = [], [], None
    for e in raw.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        item = (e.get("name", ""), float(e["ts"]), float(e.get("dur", 0)))
        if cat in DEVICE_CATS:
            ops.append((item, (e.get("args") or {}).get("stream")))
        elif cat == "user_annotation":
            if item[0] == WINDOW:
                start = item[1]
            else:
                notes.append(item)
    if start is None:
        start = min((o[1] for o, _ in ops), default=0.0)
    lo, hi = start, start + seconds * 1e6
    check = {st for o, st in ops if MARKER in o[0] and st is not None}
    inside = [(o, st) for o, st in ops if o[1] < hi and o[1] + o[2] > lo]
    return {"device_ops": [o for o, st in inside if st not in check],
            "check_ops": [o for o, st in inside
                          if st in check and MARKER not in o[0]],
            "annotations": notes, "window": (lo, hi)}


class AnswerCheck:
    """Every answer of the checked slots, against the first answer of its
    slot; `gap` then judges each first answer against the reference. On
    the card its work runs on a stream of its own (`stream`), after the
    answers are ready on the client's stream."""

    def __init__(self, slots, cuda: bool = False):
        import torch

        self.slots = list(slots)
        self.answers = 0
        self.stream = torch.cuda.Stream() if cuda else None
        self._first: dict = {}
        self._diffs: dict = {s: [] for s in self.slots}
        self._lock = threading.Lock()

    def reset(self) -> None:
        """Forget every answer (after the warm-up)."""
        if self.stream is not None:
            self.stream.synchronize()
        with self._lock:
            self.answers = 0
            self._first.clear()
            self._diffs = {s: [] for s in self.slots}

    def mark(self) -> None:
        """The MARKER kernel on the check's stream, which names the stream
        in a trace."""
        import torch

        with torch.cuda.stream(self.stream):
            torch.cuda._sleep(1000)

    def add(self, outs, slots) -> None:
        """Answers `outs` of the pool's `slots`, ready on the current
        stream."""
        import torch

        ctx = contextlib.nullcontext()
        if self.stream is not None:
            self.stream.wait_stream(torch.cuda.current_stream())
            ctx = torch.cuda.stream(self.stream)
        with ctx, self._lock:
            for o, s in zip(outs, slots):
                if s not in self._diffs:
                    continue
                if self.stream is not None:
                    o.record_stream(self.stream)
                self.answers += 1
                if s not in self._first:
                    self._first[s] = o.clone()
                else:
                    self._diffs[s].append((o - self._first[s]).abs().amax())

    def gap(self, reference) -> float:
        """The largest gap of any checked answer from `reference(slot)`:
        its slot's first answer's largest absolute difference from the
        reference, plus the largest difference of the slot's other answers
        from the first (inf if a slot has no answer; NaN reads as inf)."""
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        worst = 0.0
        for s in self.slots:
            if s not in self._first:
                return math.inf
            ref = reference(s)
            g = float((self._first.pop(s).double() - ref).abs().max())
            del ref
            if self._diffs[s]:
                g += float(torch.stack(self._diffs[s]).amax())
            worst = max(worst, math.inf if math.isnan(g) else g)
        return worst
