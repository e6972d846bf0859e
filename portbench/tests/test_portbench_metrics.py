"""The metric readers' arithmetic on synthetic records, and the shape of
BENCHMARK.json: names, units, and a file for every metric, configuration
and traffic mix."""

import importlib.util
import json
import os
import re
import statistics

import pytest

from portbench import tracing

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PB)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), os.path.join(PB, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def record(**kw):
    """A window of 10 s from t = 100 with requests of 16 images of 3 MP."""
    base = {
        "requests": [], "counted": [], "window": (100.0, 110.0),
        "images": 0, "mp": 0.0, "setup_s": 9.5, "spans": [], "trace": None,
        "config": {"geometry": {"height": 1536, "width": 2048},
                   "params": {"epf_iters": 2}},
        "traffic": {"max_stack": 16}, "peak_bytes": 0,
        "peaks": {"hbm_bytes_per_s": 3.35e12},
    }
    base.update(kw)
    return base


def test_rate_is_closed_on_the_last_completion():
    # 20 requests of 50 MP completed by t = 108: 1000 MP over 8 s, not 10
    r = record(window=(100.0, 108.0), images=320, mp=1000.0)
    assert reader("decode_mp_s")(r) == pytest.approx(125.0)
    assert reader("decode_mp_s")(record()) is None


def test_p95_over_every_counted_request():
    times = [0.1 * (i + 1) for i in range(40)]
    counted = [{"submit": 100.0, "done": 100.0 + t} for t in times]
    got = reader("latency_p95_ms.host_paced")(record(counted=counted))
    want = statistics.quantiles([t * 1e3 for t in times], n=100,
                                method="inclusive")[94]
    assert got == pytest.approx(want)
    assert got == pytest.approx(3805.0)


def test_span_sums_per_megapixel_and_occupancy():
    spans = [("Host entropy stage", 100.0, 100.5),
             ("Host entropy stage", 101.0, 101.25),
             ("Fused program inputs", 101.0, 101.1),
             ("Stacked program inputs", 102.0, 102.2),
             ("Stacked program inputs", 103.0, 103.2),
             ("Upload", 102.2, 102.21)]
    r = record(spans=spans, images=24, mp=75.0)
    assert reader("host_entropy_ms_per_mp")(r) == pytest.approx(750 / 75)
    assert reader("program_inputs_ms_per_mp")(r) == pytest.approx(500 / 75)
    assert reader("upload_ms_per_mp")(r) == pytest.approx(10 / 75)
    assert reader("stack_occupancy")(r) == pytest.approx(100 * 24 / 32)
    assert reader("upload_ms_per_mp")(record(mp=75.0)) is None


def trace(ops, window=(0.0, 1000.0)):
    return {"device_ops": ops, "annotations": [], "window": window}


def test_idle_share_is_one_minus_the_union():
    # overlapping ops on two streams count once; the part outside the
    # window does not count
    ops = [("a", 100.0, 100.0), ("b", 150.0, 100.0), ("c", 900.0, 200.0),
           ("d", -50.0, 60.0)]
    r = record(trace=trace(ops), mp=1.0)
    busy = 150 + 100 + 10
    assert reader("device_idle_share")(r) == pytest.approx(
        100 * (1 - busy / 1000))
    # each op's time inside the window: 100 + 100 + 100 + 10 us
    assert reader("device_ms_per_mp")(r) == pytest.approx(0.31)
    assert reader("device_idle_share")(record()) is None


def test_trace_window_closes_and_the_check_stream_is_kept_apart():
    def x(name, ts, dur, cat="kernel", stream=7):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "args": {"stream": stream}}

    raw = {"traceEvents": [
        x(tracing.WINDOW, 1000.0, 5e6, "user_annotation"),
        x("Host entropy stage", 1200.0, 50.0, "user_annotation"),
        x("void at::spin_kernel(long)", 990.0, 1.0, stream=13),
        x("before", 500.0, 400.0),           # ends before the opening
        x("k", 1500.0, 100.0),
        x("clone", 1700.0, 20.0, "gpu_memcpy", stream=13),
        x("amax", 1800.0, 10.0, stream=13),
        x("straddles", 2_000_900.0, 200.0),  # opens inside, ends after
        x("late", 2_001_200.0, 100.0),       # after the window closed
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 1600.0},
    ]}
    ev = tracing.read_trace(raw, 2.0)
    assert ev["window"] == (1000.0, 2_001_000.0)
    assert [o[0] for o in ev["device_ops"]] == ["k", "straddles"]
    assert [o[0] for o in ev["check_ops"]] == ["clone", "amax"]
    assert ev["annotations"] == [("Host entropy stage", 1200.0, 50.0)]
    r = record(trace=ev, mp=1.0)
    assert reader("device_ms_per_mp")(r) == pytest.approx(0.2)
    assert reader("device_idle_share")(r) == pytest.approx(
        100 * (1 - 200 / 2e6))
    # with no marker every op is the program's
    raw["traceEvents"] = [e for e in raw["traceEvents"]
                          if "spin" not in e["name"]]
    assert len(tracing.read_trace(raw, 2.0)["device_ops"]) == 4


def test_k1_roofline_from_shapes_and_epf_iters():
    # 4 stacks of 16 images, 2 passes each: 8 launches of 16 x 3.1 MP
    launches = [("void epf_kernel<1>(CUtensorMap, CUtensorMap, Args)",
                 1000.0 * i, 500.0) for i in range(8)]
    spans = [("Stacked program inputs", 0, 0)] * 4
    r = record(trace=trace(launches + [("other", 0.0, 500.0)]), spans=spans,
               images=64, mp=64 * 3.145728)
    least = 8 * 28 * 1536 * 2048 * 16 / 3.35e12
    got = reader("k1_roofline")(r)
    assert got == pytest.approx(100 * least / (8 * 500e-6))
    assert 0 < got < 105
    assert reader("k1_roofline")(record(trace=trace([]))) is None


def test_peak_and_setup():
    assert reader("device_peak_mib")(record(peak_bytes=3 * 2**20)) == 3.0
    assert reader("device_peak_mib")(record()) is None
    assert reader("setup_s")(record()) == 9.5


def test_breakdown_names_gaps_by_the_innermost_open_span():
    class P(tracing.Profiler):
        def __init__(self):
            self.events = {
                "device_ops": [("k", 100.0, 50.0), ("k", 400.0, 100.0),
                               ("m", 420.0, 10.0)],
                "annotations": [("Host entropy stage", 120.0, 300.0),
                                ("Fused program inputs", 250.0, 50.0),
                                ("Upload", 700.0, 100.0)],
                "window": (0.0, 1000.0)}

    p = P()
    assert p.busy_and_window() == pytest.approx((150e-6, 1000e-6))
    # a span from the harness's log: opened 10 us after the window's
    # opening at t = 50 s, on the trace's clock 10-90 us
    b = p.breakdown([("Stacked program inputs", 50.00001, 50.00009)], 50.0)
    assert b["device_ops"] == [["k", pytest.approx(150e-6)],
                               ["m", pytest.approx(10e-6)]]
    assert b["idle_gaps"] == [["Upload", pytest.approx(500e-6)],
                              ["Fused program inputs", pytest.approx(250e-6)],
                              ["Stacked program inputs",
                               pytest.approx(100e-6)]]


def test_benchmark_json_names_units_and_files():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(PB, "metrics", f"{m['name']}.py"))
    for m in b["end_to_end"]:
        assert 0 < m["bound"] <= 0.25
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for c in b["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("portbench/")
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        for mod in (f"streams/{conf['recipe']}.py",
                    f"reference/{conf['reference']}.py"):
            assert os.path.exists(os.path.join(PB, mod))
    for w in b["workloads"]:
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k])
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert os.path.exists(os.path.join(PB, "traffic",
                                           f"{w['traffic']}.json"))
    assert b["command"] == ["python3", "portbench/run.py"]
    assert len(json.dumps(b)) < 64 * 1024
