"""The port's span recorder (jxl_oxide_tpu_torch/utils/trace.py) on the CPU,
and its device spans on the card.

With the recorder off a decode keeps the DEBUG line the CLI's -v and the
benchmark's span log read, and touches neither the thread CPU clock, nor
a context copy, nor a CUDA event. With it on, every span of a
decode_batch_stacked call carries the call's request, pool threads
included, and sits on torch.profiler's trace clock. The `cuda` test needs
the card and skips elsewhere:

    python -m pytest tests/test_torch_trace.py --noconftest -q -m cuda

This module imports neither JAX nor the JAX package.
"""

import contextvars
import json
import logging
import threading
import time

import numpy as np
import pytest
import torch

from jxl_oxide_tpu_torch import decode_batch_stacked, serving
from jxl_oxide_tpu_torch.encoders.encoder_vardct import encode_jxl_vardct
from jxl_oxide_tpu_torch.ops import vardct_pipeline as vp
from jxl_oxide_tpu_torch.utils import trace

HOST = ("Host entropy stage", "Fused program inputs")
NATIVE_FNS = {"decode_lf_groups_batch", "decode_hf_groups_batch_raw",
              "decode_hf_group_native", "parse_decoder_native",
              "sparse_extract", "place_varblocks", "zeroed_planes"}


def _streams(n=2, h=64, w=96):
    """`n` 4:4:4 VarDCT streams of noisy content (non-zero HF), with
    gaborish and 2 EPF passes: one stack."""
    rng = np.random.default_rng(20)
    return [encode_jxl_vardct(rng.random((h, w, 3)).astype(np.float32),
                              gabor=True, epf_iters=2) for _ in range(n)]


@pytest.fixture
def recorder():
    """The recorder on for the test, off after it whatever happens."""
    trace.start_recording()
    try:
        yield trace
    finally:
        trace.stop_recording()


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.records = []

    def emit(self, record):
        self.records.append(record)


@pytest.fixture
def debug_lines():
    """The port's DEBUG records while the test runs."""
    handler = _Lines()
    level = trace.logger.level
    trace.logger.addHandler(handler)
    trace.logger.setLevel(logging.DEBUG)
    try:
        yield handler.records
    finally:
        trace.logger.removeHandler(handler)
        trace.logger.setLevel(level)


@pytest.fixture(scope="module")
def recorded():
    """The records of one decode_batch_stacked call of two streams on two
    pool workers (a call first, so the program is built outside it), and
    the threads that ran the streams' host stages."""
    streams = _streams()
    decode_batch_stacked(streams, device="cpu", num_workers=2)
    stage = serving._host_stage_fast
    threads = set()

    def spy(*a, **k):
        threads.add(threading.get_ident())
        return stage(*a, **k)

    serving._host_stage_fast = spy
    trace.start_recording()
    try:
        decode_batch_stacked(streams, device="cpu", num_workers=2)
    finally:
        rec = trace.stop_recording()
        serving._host_stage_fast = stage
    rec["host_stage_threads"] = threads
    return rec


def test_recording_off_touches_no_cpu_clock_context_or_event(
        monkeypatch, debug_lines):
    def boom(*a, **k):
        raise AssertionError("called with the recorder off")

    monkeypatch.setattr(time, "thread_time_ns", boom)
    monkeypatch.setattr(contextvars, "copy_context", boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    out = decode_batch_stacked(_streams(), device="cpu", num_workers=2,
                               output="device")
    assert len(out) == 2
    spans = [r for r in debug_lines if r.msg.startswith("%s: %.2f ms")]
    names = {r.args[0] for r in spans}
    assert {"Decode batch", "Parse headers", "Host entropy stage",
            "Fused program inputs", "Native", "Stacked program inputs",
            "Upload", "Stacked program", "Colour tail"} <= names
    for r in spans:
        assert isinstance(r.args[0], str) and isinstance(r.args[1], float)
        assert r.args[1] >= 0
    # keyword attributes follow the ms, as " key=value"
    assert any(r.args[0] == "Stacked program inputs"
               and r.getMessage().endswith(" images=2") for r in spans)
    assert trace.bind(boom) is boom


def test_pool_thread_spans_carry_the_request_and_a_parent_chain(recorded):
    spans = recorded["spans"]
    by_id = {s["id"]: s for s in spans}
    roots = [s for s in spans if s["parent"] is None]
    assert [r["name"] for r in roots] == ["Decode batch"]
    root = roots[0]
    assert {s["request"] for s in spans} == {root["id"]}
    # the host stages ran on the pool, not on the calling thread
    threads = recorded["host_stage_threads"]
    assert threads and threading.get_ident() not in threads
    assert {"Parse headers", "Host entropy stage",
            "Fused program inputs"} <= {s["name"] for s in spans}
    for s in spans:
        p, hops = s, 0
        while p["parent"] is not None:
            p = by_id[p["parent"]]
            hops += 1
        assert p is root and (hops > 0 or s is root)
    # the calling thread's stages hang from the root directly, and so do
    # the pool's first spans
    for name in ("Parse headers", "Host entropy stage",
                 "Fused program inputs", "Stacked program inputs", "Upload",
                 "Stacked program", "Colour tail"):
        for s in spans:
            if s["name"] == name:
                assert s["parent"] == root["id"], s


def _cpu_clock_step() -> int:
    """The largest of a few steps of the thread CPU clock: well under a
    microsecond where the kernel accounts CPU time exactly, a scheduler
    tick (10 ms) where it charges whole ticks, as a sandboxed kernel may."""
    steps = []
    for _ in range(3):
        a = b = time.thread_time_ns()
        deadline = time.perf_counter() + 1.0
        while b == a and time.perf_counter() < deadline:
            b = time.thread_time_ns()
        steps.append(b - a)
    return max(steps)


def test_cpu_time_within_wall_and_native_calls_inside_host_stages(recorded):
    spans = recorded["spans"]
    by_id = {s["id"]: s for s in spans}
    # a span crosses at most wall / tick + 1 ticks of a tick-charged clock
    step = _cpu_clock_step()
    for s in spans:
        assert 0 <= s["cpu_ns"] <= s["end_ns"] - s["start_ns"] + step, s
    native = [s for s in spans if s["name"] == "Native"]
    assert native
    for s in native:
        assert s["attrs"]["fn"] in NATIVE_FNS
        p = by_id[s["parent"]]
        while p["name"] not in HOST:
            assert p["parent"] is not None, s
            p = by_id[p["parent"]]
        assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= p["end_ns"]
    stacked = [s for s in spans if s["name"] == "Stacked program inputs"]
    assert [s["attrs"] for s in stacked] == [{"images": 2}]
    # no device span on the CPU
    assert recorded["device"] == []


def test_upload_bytes_is_the_staging_buffers_size(recorder, monkeypatch):
    made = []
    empty = torch.empty

    def spy(*a, **k):
        t = empty(*a, **k)
        made.append(t)
        return t

    monkeypatch.setattr(vp.torch, "empty", spy)
    arrays = [np.arange(10, dtype=np.int32), np.ones((3, 5), np.int16),
              (np.arange(7, dtype=np.uint16), np.arange(7, dtype=np.int8))]
    with trace.span("Upload"):
        vp.upload_inputs(arrays, "cpu")
    with trace.span("Upload"):
        vp.upload_inputs([np.zeros(100, np.uint8)], "cpu")
    monkeypatch.undo()
    spans = trace.stop_recording()["spans"]
    staging = [t.numel() for t in made if t.dtype == torch.uint8]
    assert [s["attrs"]["bytes"] for s in spans] == staging
    assert staging[0] >= 40 + 30 + 14 + 7


def test_count_adds_to_the_innermost_span_and_bind_carries_it(recorder):
    seen = {}

    def work():
        with trace.span("inner"):
            trace.count(n=2)
            trace.count(n=3)
        seen["thread"] = threading.get_ident()

    with trace.span("outer", tag="a"):
        t = threading.Thread(target=trace.bind(work))
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    spans = {s["name"]: s for s in trace.stop_recording()["spans"]}
    assert spans["inner"]["attrs"] == {"n": 5}
    assert spans["outer"]["attrs"] == {"tag": "a"}
    assert spans["inner"]["parent"] == spans["outer"]["id"]
    assert spans["inner"]["request"] == spans["outer"]["id"]
    assert seen["thread"] != threading.get_ident()
    # a thread started without bind starts a request of its own
    trace.start_recording()
    with trace.span("outer"):
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
    spans = {s["name"]: s for s in trace.stop_recording()["spans"]}
    assert spans["inner"]["parent"] is None
    assert spans["inner"]["request"] == spans["inner"]["id"]


def test_threads_lose_no_record_under_a_short_switch_interval(recorder):
    import sys

    n_threads, n_spans = 16, 300
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for i in range(n_spans):
                with trace.span("outer", k=k):
                    with trace.span("inner"):
                        trace.count(n=1)

        with trace.span("root"):
            threads = [threading.Thread(target=trace.bind(work), args=(k,))
                       for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    spans = trace.stop_recording()["spans"]
    assert len(spans) == 1 + 2 * n_threads * n_spans
    assert len({s["id"] for s in spans}) == len(spans)
    by_id = {s["id"]: s for s in spans}
    root = next(s for s in spans if s["name"] == "root")
    children: dict = {}
    for s in spans:
        assert s["request"] == root["id"]
        if s["name"] == "inner":
            assert s["attrs"] == {"n": 1}
            parent = by_id[s["parent"]]
            assert parent["name"] == "outer"
            assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"]
            assert s["end_ns"] <= parent["end_ns"]
            children[parent["id"]] = children.get(parent["id"], 0) + 1
        elif s["name"] == "outer":
            assert s["parent"] == root["id"]
    # no thread's inner span hangs from another thread's outer one
    assert sorted(children.values()) == [1] * (n_threads * n_spans)


def test_spans_sit_on_the_profiler_trace_clock(recorder, tmp_path):
    from torch.profiler import ProfilerActivity, profile, record_function

    # several probes: a thread put off the CPU between a span's opening
    # and its range's delays that one probe only, while a clock that
    # disagrees moves them all
    probes = 5
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm"):
            torch.ones(4).sum()
        for i in range(probes):
            with trace.span(f"probe {i}"):
                with record_function(f"probe range {i}"):
                    torch.ones(4).sum()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    raw = json.loads(path.read_text())
    spans = {s["name"]: s for s in trace.stop_recording()["spans"]}
    gaps = []
    for i in range(probes):
        ev = next(e for e in raw["traceEvents"]
                  if e.get("name") == f"probe range {i}")
        on_clock = ev["ts"] * 1e3 + raw["baseTimeNanoseconds"]
        span = spans[f"probe {i}"]
        # the range opens inside its span, on one clock
        assert span["start_ns"] <= on_clock + 1e6
        assert on_clock <= span["end_ns"]
        gaps.append(abs(on_clock - span["start_ns"]))
    assert min(gaps) < 1e6, gaps


@pytest.mark.cuda
def test_device_spans_resolve_on_one_stacked_call():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: device spans time the card's stream")
    streams = _streams(h=512, w=512)
    decode_batch_stacked(streams, output="device", num_workers=2)
    torch.cuda.synchronize()
    trace.start_recording()
    try:
        out = decode_batch_stacked(streams, output="device", num_workers=2)
        assert out[0].device.type == "cuda"
        torch.cuda.synchronize()
    finally:
        rec = trace.stop_recording()
    root = next(s for s in rec["spans"] if s["name"] == "Decode batch")
    stages = {d["name"]: d for d in rec["device"]}
    assert sorted(stages) == ["Colour tail", "Filters", "Transform"]
    assert len(rec["device"]) == 3
    for d in rec["device"]:
        assert d["ms"] is not None and d["ms"] > 0, d
        assert d["request"] == root["id"]
        assert root["start_ns"] <= d["start_ns"] <= d["end_ns"]
