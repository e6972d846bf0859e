"""The port's own span records, for the readers of the program's spans.

The port's recorder (`jxl_oxide_tpu_torch/utils/trace.py`) keeps, for each
span, its id, parent, request (its root span's id), name, start and end
on time.time_ns's clock, the thread's CPU time inside it and its
attributes; and, for each device span, its request and the stream time
between two CUDA events. A traced run sets JXL_TPU_TRACE_ANNOTATE=1
before it imports the port, which starts the recorder; the first reader
that asks stops it, after the window's closing synchronize, and keeps
what it gathered in the run's record under "program", with the window on
the recorder's clock under "window_ns". A port without the recorder gives
nothing, and the readers then return None."""

from __future__ import annotations

import sys
import time

PORT = "jxl_oxide_tpu_torch"
# the host stages of host_entropy_ms_per_mp and program_inputs_ms_per_mp
HOST = ("Host entropy stage", "Fused program inputs",
        "Stacked program inputs")
NATIVE = "Native"
ROOT = "Decode batch"
# the spans inside which a request launches work on the card
LAUNCH = ("Upload", "Stacked program", "Colour tail", "Fused program")


def clock_offset_ns() -> int:
    """time.time_ns() less time.perf_counter_ns(), from the closest of a
    few paired readings."""
    best = None
    for _ in range(8):
        a = time.perf_counter_ns()
        w = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, w - (a + b) // 2)
    return best[1]


def _stop_port_recorder():
    trace = sys.modules.get(f"{PORT}.utils.trace")
    stop = getattr(trace, "stop_recording", None)
    return stop() if stop is not None else None


def program(record: dict):
    """(the recorder's {"spans", "device"}, (open, close) in ns) of the
    run, or None where nothing was recorded."""
    if "program" not in record:
        record["program"] = _stop_port_recorder()
        off = clock_offset_ns()
        t_open, t_close = record["window"]
        record["window_ns"] = (round(t_open * 1e9) + off,
                               round(t_close * 1e9) + off)
        prog = record["program"]
        if prog and record.get("images"):
            n = len(closed_in(prog["spans"], record["window_ns"]))
            d = len(closed_in(prog["device"], record["window_ns"]))
            print(f"[portbench] recorder: {n} spans and {d} device spans "
                  f"closed in the window, {n / record['images']:.2f} spans "
                  f"an image", file=sys.stderr)
    prog = record["program"]
    if not prog or not prog["spans"] or not record["mp"]:
        return None
    return prog, record["window_ns"]


def closed_in(items, window) -> list:
    """The spans (or device spans) that closed inside the window."""
    lo, hi = window
    return [s for s in items if lo <= s["end_ns"] <= hi]


def wall_ns(s: dict) -> int:
    return s["end_ns"] - s["start_ns"]


def host_split(record: dict):
    """{host_wall, host_cpu, native_wall, native_cpu} in ns over the
    host stages (HOST) that closed in the window, and the Native spans
    under them that closed there; None where nothing was recorded."""
    got = program(record)
    if got is None:
        return None
    prog, window = got
    by_id = {s["id"]: s for s in prog["spans"]}

    def under_host(s):
        p = by_id.get(s["parent"])
        while p is not None:
            if p["name"] in HOST:
                return True
            p = by_id.get(p["parent"])
        return False

    inside = closed_in(prog["spans"], window)
    host = [s for s in inside if s["name"] in HOST]
    native = [s for s in inside if s["name"] == NATIVE and under_host(s)]
    if not host:
        return None
    return {"host_wall": sum(wall_ns(s) for s in host),
            "host_cpu": sum(s["cpu_ns"] for s in host),
            "native_wall": sum(wall_ns(s) for s in native),
            "native_cpu": sum(s["cpu_ns"] for s in native)}


def stream_ms_per_mp(record: dict, stage: str):
    """The summed stream time of the device spans named `stage` that
    closed in the window, over the megapixels completed there."""
    got = program(record)
    if got is None:
        return None
    prog, window = got
    ms = [d["ms"] for d in closed_in(prog["device"], window)
          if d["name"] == stage and d["ms"] is not None]
    if not ms:
        return None
    return sum(ms) / record["mp"]
