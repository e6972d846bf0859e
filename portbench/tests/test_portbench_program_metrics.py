"""The readers of the port's own span records (portbench/recorder.py and
the metrics that use it) on synthetic records: the host split, the bytes
uploaded, the stream time by stage, and the share of the card's idle
time that no span covers."""

import importlib.util
import os
import sys
import time

import pytest

from portbench import recorder

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MS = 1_000_000  # ns
W0 = 10**18  # the window's opening on the recorder's clock


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), os.path.join(PB, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def span(sid, name, parent, start_ms, wall_ms, cpu_ms, request=1, **attrs):
    return {"id": sid, "parent": parent, "request": request, "name": name,
            "start_ns": W0 + start_ms * MS,
            "end_ns": W0 + (start_ms + wall_ms) * MS, "cpu_ns": cpu_ms * MS,
            "attrs": attrs}


def dev(name, end_ms, ms):
    return {"request": 1, "name": name,
            "start_ns": W0 + (end_ms - 1) * MS, "end_ns": W0 + end_ms * MS,
            "ms": ms}


def record(spans=(), device=(), mp=2.0, window_ms=100, logged=(),
           trace=None):
    return {"program": {"spans": list(spans), "device": list(device)},
            "window_ns": (W0, W0 + window_ms * MS), "window": (50.0, 50.1),
            "mp": mp, "spans": list(logged), "trace": trace}


def host_spans():
    """Decode batch (1) over: Host entropy stage (2) 10 ms wall, 6 CPU,
    with a Native (3) 4 wall, 1 CPU; Fused program inputs (4) 5 / 4 with a
    Native (5) 1 / 1; Stacked program inputs (6) 2 / 2; a Native (8)
    under Parse headers (7), outside the host stages; a Host entropy
    stage (9) that closes after the window."""
    return [span(1, "Decode batch", None, 0, 99, 30),
            span(2, "Host entropy stage", 1, 1, 10, 6),
            span(3, "Native", 2, 2, 4, 1, fn="decode_lf_groups_batch"),
            span(4, "Fused program inputs", 1, 12, 5, 4),
            span(5, "Native", 4, 13, 1, 1, fn="sparse_extract"),
            span(6, "Stacked program inputs", 1, 20, 2, 2, images=2),
            span(7, "Parse headers", 1, 30, 3, 3),
            span(8, "Native", 7, 31, 1, 0, fn="parse_decoder_native"),
            span(9, "Host entropy stage", 1, 95, 10, 10)]


def test_host_split_per_megapixel():
    r = record(host_spans())
    cpu = reader("host_cpu_ms_per_mp")(r)
    native = reader("native_ms_per_mp")(r)
    wait = reader("host_wait_ms_per_mp")(r)
    assert cpu == pytest.approx((6 + 4 + 2) / 2)
    assert native == pytest.approx((4 + 1) / 2)
    # off the CPU: (4 + 1 + 0) in the stages, less (3 + 0) in their natives
    assert wait == pytest.approx((5 - 3) / 2)
    # the stages' wall time is cpu + wait + the natives' time off the CPU
    assert cpu + wait + (3 + 0) / 2 == pytest.approx((10 + 5 + 2) / 2)


def test_host_readers_read_nothing_without_records():
    for name in ("host_cpu_ms_per_mp", "native_ms_per_mp",
                 "host_wait_ms_per_mp", "upload_mib_per_mp",
                 "stream_ms_per_mp.transform", "idle_unspanned_share"):
        assert reader(name)(record()) is None
        assert reader(name)(record(host_spans(), mp=0.0)) is None
        r = record()
        r["program"] = None  # a port without the recorder
        assert reader(name)(r) is None


def test_upload_bytes_per_megapixel():
    spans = [span(1, "Upload", None, 1, 1, 1, bytes=2**20),
             span(2, "Upload", None, 5, 1, 1, bytes=2**19),
             span(3, "Upload", None, 99, 5, 1, bytes=2**30),  # after
             span(4, "Upload", None, 7, 1, 1)]  # counted nothing
    assert reader("upload_mib_per_mp")(record(spans)) == pytest.approx(
        1.5 / 2)
    assert reader("upload_mib_per_mp")(record(spans[3:])) is None


def test_stream_time_by_stage():
    device = [dev("Transform", 10, 3.0), dev("Transform", 20, 5.0),
              dev("Transform", 120, 7.0),  # closed after the window
              dev("Filters", 30, 2.5), dev("Filters", 40, None),
              dev("Colour tail", 50, 0.25)]
    r = record(host_spans(), device)
    assert reader("stream_ms_per_mp.transform")(r) == pytest.approx(8 / 2)
    assert reader("stream_ms_per_mp.filters")(r) == pytest.approx(2.5 / 2)
    assert reader("stream_ms_per_mp.colour")(r) == pytest.approx(0.25 / 2)
    r = record(host_spans(), device[:3])
    assert reader("stream_ms_per_mp.filters")(r) is None


def idle_record(spans_us, trace):
    """A 1 ms window of spans (sid, name, parent, request, start_us,
    end_us) and a trace whose window opens at ts 5000 us."""
    us = 1000  # ns
    spans = []
    for sid, name, parent, request, a, b in spans_us:
        s = span(sid, name, parent, 0, 0, 0, request=request)
        s["start_ns"], s["end_ns"] = W0 + a * us, W0 + b * us
        spans.append(s)
    return record(spans, window_ms=1, trace=trace)


def test_idle_unspanned_share_charges_the_request_the_card_waits_for(
        monkeypatch):
    path = os.path.join(PB, "metrics", "idle_unspanned_share.py")
    spec = importlib.util.spec_from_file_location("m_idle", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "LAUNCH_SLACK_NS", 200_000)
    # two clients' requests, 1 and 2, in a 1000 us window. The card runs
    # request 1's ops at 100-200 us and 950-1050 (clipped to 950-1000),
    # request 2's at 500-600: idle 0-100, 200-500 and 600-950.
    trace = {"device_ops": [("k", 5100.0, 100.0), ("k", 5500.0, 100.0),
                            ("k", 5950.0, 100.0)],
             "check_ops": [], "annotations": [], "window": (5000.0, 6000.0)}
    spans = [
        (1, "Decode batch", None, 1, 0, 1000),
        (2, "Host entropy stage", 1, 1, 0, 80),
        (3, "Upload", 1, 1, 80, 120),  # launches the op at 100
        (4, "Stacked program", 1, 1, 120, 190),
        (5, "Host entropy stage", 1, 1, 300, 900),
        (6, "Native", 5, 1, 320, 340),
        (7, "Upload", 1, 1, 900, 960),  # launches the op at 950
        (10, "Decode batch", None, 10, 0, 1000),
        (11, "Host entropy stage", 10, 10, 0, 400),
        # request 10 does unspanned host work at 400-480, while request
        # 1's host stage is open on another thread
        (12, "Upload", 10, 10, 480, 520),  # launches the op at 500
    ]
    r = idle_record(spans, trace)
    idle = 100 + 300 + 350
    assert mod.read(r) == pytest.approx(100 * 80 / idle)
    assert mod.read(r) > 0
    # with the unspanned stretch named, nothing is left
    r = idle_record(spans + [(13, "Parse headers", 10, 10, 400, 480)],
                    trace)
    assert mod.read(r) == pytest.approx(0.0)
    # a gap that no launch span explains counts whole: with request 10's
    # upload gone, the gap that its op ends is unspanned from 200 to 500
    r = idle_record([s for s in spans if s[0] != 12], trace)
    assert mod.read(r) == pytest.approx(100 * 300 / idle)
    # with no span but the roots, every idle moment is unspanned
    r = idle_record([spans[0], spans[7]], trace)
    assert mod.read(r) == pytest.approx(100.0)


def test_idle_unspanned_share_counts_the_windows_tail():
    # the card idles after its last op, at 100-200 us; no op ends that
    # gap, so it is unspanned even under an open launch span
    trace = {"device_ops": [("k", 5100.0, 100.0)], "check_ops": [],
             "annotations": [], "window": (5000.0, 6000.0)}
    spans = [(1, "Decode batch", None, 1, 0, 1000),
             (2, "Upload", 1, 1, 0, 150),
             (3, "Colour tail", 1, 1, 150, 1000)]
    r = idle_record(spans, trace)
    assert reader("idle_unspanned_share")(r) == pytest.approx(
        100 * 800 / 900)


def test_window_on_the_recorders_clock(monkeypatch):
    # a run whose port has no recorder: the window is still converted
    monkeypatch.delitem(sys.modules, "jxl_oxide_tpu_torch.utils.trace",
                        raising=False)
    t = time.perf_counter()
    now = time.time_ns()
    r = {"window": (t, t + 1.0), "mp": 1.0}
    assert recorder.program(r) is None
    assert r["program"] is None
    w0, w1 = r["window_ns"]
    assert abs(w0 - now) < 5 * MS
    assert w1 - w0 == pytest.approx(1e9, abs=1)


def test_the_ports_recorder_is_stopped_once(monkeypatch):
    calls = []

    class Port:
        @staticmethod
        def stop_recording():
            calls.append(1)
            return {"spans": host_spans(), "device": []}

    monkeypatch.setitem(sys.modules, "jxl_oxide_tpu_torch.utils.trace", Port)
    t = time.perf_counter()
    r = {"window": (t - 1.0, t), "mp": 2.0, "spans": []}
    recorder.program(r)
    recorder.program(r)
    assert calls == [1]
    assert r["program"]["spans"][0]["name"] == "Decode batch"
