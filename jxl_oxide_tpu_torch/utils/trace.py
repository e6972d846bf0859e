"""Span tracing for the decode pipeline.

Behavioral parity: the reference instruments every pipeline stage with
`tracing` spans (e.g. lf_global.rs:63 "Decode Patches", vardct/mod.rs:55
"Render VarDCT", render/lib.rs:944 "Transform to requested color
encoding") and the CLI installs a fmt subscriber with -v/-vv verbosity
(cli/main.rs:31-45). Here spans emit DEBUG logs with wall-time on exit,
"<name>: <ms> ms" and the span's attributes (the CLI's -v).

While a recorder runs (`start_recording` to `stop_recording`), each span
also keeps one record in memory, in a list of its thread's, with no lock:
its id, its parent (the span open in the caller's context), its request
(the id of its root span), name, start and end on `now_ns`'s clock, the
thread's CPU time inside it, and its attributes (the keyword arguments of
`span`, and what `count` adds to them). The current span lives in a
context variable; `bind` carries it to pool threads, so a span on a
worker names the request and the span that caused it. `device_span` adds
the stream time of the work launched inside it, from two CUDA events.
With the recorder off, a span costs what it always did plus one check of
`_recording`.

JXL_TPU_TRACE_ANNOTATE=1 in the environment starts the recorder when this
module loads, for a harness that cannot call `start_recording` before the
port runs (portbench/run.py sets it in traced runs; its readers call
`stop_recording` after the window). Nothing stops that recorder but
`stop_recording`: it keeps every span of the process until then, without
bound, so the variable is for benchmark runs only, never for a
long-lived process.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import itertools
import logging
import os
import threading
import time

__all__ = ["logger", "set_verbosity", "span", "traced", "bind", "count",
           "device_span", "now_ns", "start_recording", "stop_recording"]

logger = logging.getLogger("jxl_oxide_tpu_torch")
_configured = False


def set_verbosity(level: int) -> None:
    """The CLI's -v: 0 = warnings, 1 or more = the DEBUG span records on
    stderr (jxl_oxide_tpu/utils/trace.py set_verbosity)."""
    global _configured
    if not _configured:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"))
        logger.addHandler(handler)
        _configured = True
    logger.setLevel(logging.WARNING if level <= 0 else logging.DEBUG)


# the recorder: on or off, and the record lists of every thread that
# recorded since start_recording, each (spans, device spans)
_recording = False
_session: list | None = None
_local = threading.local()
# the innermost open span of this context: (id, request, attrs)
_current: contextvars.ContextVar = contextvars.ContextVar(
    "jxl_oxide_tpu_torch_span", default=None)
_ids = itertools.count(1)


def now_ns() -> int:
    """The recorder's clock: time.time_ns(), the clock of torch.profiler's
    trace (an event's ts x 1e3 + the trace's baseTimeNanoseconds)."""
    return time.time_ns()


def start_recording() -> None:
    """Start recording spans (a new session: earlier records are gone)."""
    global _recording, _session
    _session = []
    _recording = True


def stop_recording() -> dict:
    """Stop recording and gather every thread's records: {"spans": [{id,
    parent, request, name, start_ns, end_ns, cpu_ns, attrs}, ...] by
    start, "device": [{request, name, start_ns, end_ns, ms}, ...]}. A device span's `ms` is its events' elapsed time, so the caller
    synchronises the card first; None where an event has not completed."""
    global _recording, _session
    _recording = False
    session, _session = _session or [], None
    spans, device = [], []
    for recs, devs in session:
        for sid, parent, request, name, t0, t1, cpu, attrs in recs:
            spans.append({"id": sid, "parent": parent, "request": request,
                          "name": name, "start_ns": t0, "end_ns": t1,
                          "cpu_ns": cpu, "attrs": attrs})
        for request, name, t0, t1, begin, end in devs:
            try:
                ms = begin.elapsed_time(end)
            except RuntimeError:  # not recorded or not completed
                ms = None
            device.append({"request": request, "name": name,
                           "start_ns": t0, "end_ns": t1, "ms": ms})
    spans.sort(key=lambda s: s["start_ns"])
    device.sort(key=lambda s: s["start_ns"])
    return {"spans": spans, "device": device}


def _buffers():
    """This thread's (spans, device spans) lists in the running session,
    or None when the recorder stopped meanwhile."""
    session = _session
    if session is None:
        return None
    loc = _local
    if getattr(loc, "session", None) is not session:
        loc.session = session
        loc.buffers = ([], [])
        session.append(loc.buffers)
    return loc.buffers


def bind(fn):
    """`fn` to run under a copy of the caller's context while recording,
    so that the spans it opens on a pool thread carry the caller's request
    and parent; `fn` itself otherwise. Bind once a task: one context runs
    on one thread at a time."""
    if not _recording:
        return fn
    return functools.partial(contextvars.copy_context().run, fn)


def count(**amounts) -> None:
    """Add `amounts` to the attributes of the innermost open span, while
    recording (the counts of the work a span does, such as bytes)."""
    if not _recording:
        return
    node = _current.get()
    if node is not None:
        attrs = node[2]
        for k, v in amounts.items():
            attrs[k] = attrs.get(k, 0) + v


def _log(name: str, ms: float, attrs: dict) -> None:
    extra = "".join(f" {k}={v}" for k, v in attrs.items())
    logger.debug("%s: %.2f ms%s", name, ms, extra)


def traced(name: str):
    """Decorator form of span() for whole pipeline stages."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return wrapper

    return deco


@contextlib.contextmanager
def span(name: str, **attrs):
    """Trace one pipeline stage; `attrs` are its attributes. Cheap when
    logging is disabled and the recorder is off."""
    if not _recording:
        if not logger.isEnabledFor(logging.DEBUG):
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _log(name, (time.perf_counter() - t0) * 1e3, attrs)
        return
    parent = _current.get()
    sid = next(_ids)
    request = parent[1] if parent is not None else sid
    _current.set((sid, request, attrs))
    # the DEBUG line keeps its own clock, so the record and the line are
    # two readings of one span
    p0 = time.perf_counter()
    t0 = now_ns()
    c0 = time.thread_time_ns()
    try:
        yield
    finally:
        c1 = time.thread_time_ns()
        t1 = now_ns()
        ms = (time.perf_counter() - p0) * 1e3
        _current.set(parent)
        bufs = _buffers()
        if bufs is not None:
            bufs[0].append((sid, None if parent is None else parent[0],
                            request, name, t0, t1, c1 - c0, attrs))
        if logger.isEnabledFor(logging.DEBUG):
            _log(name, ms, attrs)


@contextlib.contextmanager
def device_span(name: str, device):
    """The stream time of the work the body launches on `device`'s current
    stream, while recording on a CUDA device: an event recorded before
    the body and one after, resolved by stop_recording. Nothing otherwise;
    it never synchronises."""
    if not _recording:
        yield
        return
    import torch

    if torch.device(device).type != "cuda":
        yield
        return
    node = _current.get()
    stream = torch.cuda.current_stream(device)
    begin = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = now_ns()
    begin.record(stream)
    try:
        yield
    finally:
        end.record(stream)
        t1 = now_ns()
        bufs = _buffers()
        if bufs is not None:
            bufs[1].append((None if node is None else node[1], name, t0, t1,
                            begin, end))


if os.environ.get("JXL_TPU_TRACE_ANNOTATE", "") == "1":
    start_recording()
