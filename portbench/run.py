#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell names a configuration and a traffic mix in BENCHMARK.json; the
harness finds `configs/<config>.json`, `traffic/<traffic>.json`,
`streams/<recipe>.py`, `reference/<reference>.py` and
`metrics/<metric>.py` by those names, so a cell, a mix or a metric is
added as new files and entries. It makes the seed's streams (cached in
`portbench/.stream_cache/`), pins its host noise (one thread for numpy
and torch on the CPU, the CPUs local to the card, the garbage collector
frozen after warm-up), warms up every shape, runs the traffic untimed,
then measures for `--seconds`, closing the window at the last completion
inside it: `--trace 0` the end-to-end metrics, `--trace 1` the per-layer
ones under torch.profiler with the port's spans.
After the window it checks the answers it produced against the plain
reference and prints, as its last stdout line, one JSON object:
correct, attempted, failed, metrics, device, breakdown (traced), checks.

It needs CUDA: with no card, or fewer than the cell asks for, it exits 2
and prints no result. Nothing here imports JAX or the JAX package."""

import os
import sys
import time

T_START = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pin_environment() -> None:
    """Before numpy or torch loads: one thread for numpy and torch on the
    CPU (nothing on the timed path runs torch there), and the build and
    kernel caches at fixed paths inside the checkout."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(HERE, ".cache", sub)


FORBIDDEN = ("jax", "jaxlib", "flax", "jxl_oxide_tpu")
PORT = "jxl_oxide_tpu_torch"


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def load_cell(name: str) -> tuple:
    """(cell, config, traffic, metric entries) of workload `name`."""
    import json

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(ROOT, entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", f"{cell['traffic']}.json")) as f:
        traffic = json.load(f)
    return cell, config, traffic, bench


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries this cell reports in a run of this kind."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def load_reader(name: str):
    """`metrics/<name>.py`'s `read(record)`."""
    import importlib.util

    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def card_cpus(cap: int) -> list:
    """The CPUs local to card 0 that this process may use, at most `cap`:
    the PCI device's `local_cpulist`, else every CPU this process has."""
    import torch

    allowed = sorted(os.sched_getaffinity(0))
    local = allowed
    props = torch.cuda.get_device_properties(0)
    addr = "{:04x}:{:02x}:{:02x}.0".format(
        getattr(props, "pci_domain_id", 0), getattr(props, "pci_bus_id", 0),
        getattr(props, "pci_device_id", 0))
    try:
        with open(f"/sys/bus/pci/devices/{addr}/local_cpulist") as f:
            text = f.read().strip()
        cpus = set()
        for part in text.split(","):
            a, _, b = part.partition("-")
            cpus.update(range(int(a), int(b or a) + 1))
        local = [c for c in allowed if c in cpus] or allowed
    except (OSError, ValueError):
        log(f"no local_cpulist for {addr}: every allowed CPU")
    return local[:cap]


def run_cell(cell: dict, config: dict, traffic: dict, bench: dict, seed: int,
             seconds: float, trace: bool, device: str = "cuda",
             decode=None, streams_workers: int | None = None) -> dict:
    """One run of the cell; returns the result line's object. `decode`
    replaces the port's `decode_batch_stacked` (the fault tests), and
    `device="cpu"` runs the same loop without a card (the CPU tests)."""
    import contextlib
    import gc
    import importlib
    import threading

    import numpy as np

    from portbench import tracing
    from portbench.streams.pool import make_pool

    cuda = device != "cpu"
    t0 = time.perf_counter()
    pool_n = traffic["pool"]
    rng = np.random.default_rng([seed, 0x5EED])
    check_slots = sorted(rng.choice(pool_n, traffic["check_slots"],
                                    replace=False).tolist())
    workers = streams_workers or len(os.sched_getaffinity(0))
    streams, ref_inputs = make_pool(config, seed, pool_n, workers,
                                    check_slots)
    streams_s = time.perf_counter() - t0
    mib = sum(len(s) for s in streams) / 2**20
    geo = config["geometry"]
    bits = 8 * sum(len(s) for s in streams) / (
        pool_n * geo["height"] * geo["width"])
    log(f"streams: {pool_n} of seed {seed} in {streams_s:.3f} s, "
        f"{mib:.3f} MiB, {bits:.4f} bits a pixel")

    import torch

    torch.set_num_threads(1)
    if cuda:
        cpus = card_cpus(traffic["cpus"])
        os.sched_setaffinity(0, cpus)
        log(f"cpus {cpus} of os.cpu_count() {os.cpu_count()}, "
            f"load average {os.getloadavg()}")
    if trace:
        os.environ["JXL_TPU_TRACE_ANNOTATE"] = "1"
    serving = importlib.import_module(f"{PORT}.serving")
    vardct = importlib.import_module(f"{PORT}.render.vardct")
    native = importlib.import_module(f"{PORT}.native")
    log(f"native host library: {native.available()}")
    decode = decode or serving.decode_batch_stacked
    spans = tracing.SpanLog(f"{PORT}") if trace else None

    batch = traffic["batch"]
    mp_image = geo["height"] * geo["width"] / 1e6
    kwargs = dict(output="device", max_stack=traffic["max_stack"],
                  num_workers=traffic["num_workers"],
                  num_threads=traffic["num_threads"], device=device)
    n_clients = traffic["clients"]
    client_streams = [torch.cuda.Stream() if cuda else None
                      for _ in range(n_clients)]
    check = tracing.AnswerCheck(check_slots, cuda)

    def one_call(k: int, r: int, checked: bool):
        """Client k's request r: the next `batch` streams of the pool,
        decoded and waited for; returns (submit, done, ok)."""
        ids = [(r * batch + j) % pool_n for j in range(batch)]
        data = [streams[i] for i in ids]
        ctx = (torch.cuda.stream(client_streams[k]) if cuda
               else contextlib.nullcontext())
        submit = time.perf_counter()
        try:
            with ctx:
                outs = decode(data, **kwargs)
                if cuda:
                    ev = torch.cuda.Event()
                    ev.record(client_streams[k])
            if cuda:
                ev.synchronize()
            done = time.perf_counter()
        except Exception as exc:  # a failed request counts, the run goes on
            import traceback

            log(f"client {k} request {r} failed: {exc!r}")
            traceback.print_exc()
            return submit, time.perf_counter(), False
        if checked:
            with ctx:
                check.add(outs, ids)
        del outs
        return submit, done, True

    def clients(deadline: float, records: list | None):
        """The closed loops until `deadline`; each request's record goes to
        `records` (None: warm-up)."""
        lock = threading.Lock()

        def loop(k):
            r = 0
            while time.perf_counter() < deadline:
                submit, done, ok = one_call(k, r, records is not None)
                if records is not None:
                    with lock:
                        records.append({"client": k, "request": r,
                                        "submit": submit, "done": done,
                                        "images": batch, "ok": ok})
                r += 1

        threads = [threading.Thread(target=loop, args=(k,), daemon=True)
                   for k in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    # warm-up: every client's call on its own stream until no program is
    # built, which grows the caching and pinned allocators (the first
    # round's answers through the check too); then the traffic itself,
    # untimed
    for rnd in range(4):
        builds = vardct.VardctFrameState.program_builds
        for k in range(n_clients):
            one_call(k, 0, rnd == 0)
        if rnd and vardct.VardctFrameState.program_builds == builds:
            break
    check.reset()  # its buffers stay in its stream's cache for the window
    log(f"warm-up: {vardct.VardctFrameState.program_builds} programs built")
    clients(time.perf_counter() + traffic["warmup_seconds"], None)
    if cuda:
        torch.cuda.synchronize()
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - T_START - streams_s
    log(f"set-up {setup_s:.3f} s (streams apart)")

    # the window
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    records: list = []
    prof = tracing.Profiler(cuda) if trace else None
    if spans:
        spans.start()
    if prof:
        prof.start()
        if cuda:
            check.mark()
    t_open = time.perf_counter()
    deadline = t_open + seconds
    with (prof.window() if prof else contextlib.nullcontext()):
        clients(deadline, records)
    if cuda:
        torch.cuda.synchronize()
    counted = [q for q in records if q["ok"] and q["done"] <= deadline]
    t_close = max((q["done"] for q in counted), default=t_open)
    if prof:
        prof.stop(t_close - t_open)
    if spans:
        spans.stop()
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    images = sum(q["images"] for q in counted)
    failed = sum(q["images"] for q in records if not q["ok"])
    attempted = sum(q["images"] for q in records)
    record = {
        "requests": records, "counted": counted, "window": (t_open, t_close),
        "images": images, "mp": images * mp_image, "setup_s": setup_s,
        "config": config, "traffic": traffic, "peak_bytes": peak,
        "spans": spans.records(t_open, t_close) if spans else [],
        "trace": prof.events if prof else None,
        "peaks": tracing.peaks(torch.cuda.get_device_name(0) if cuda
                               else "cpu"),
    }
    log(f"window: {len(counted)} requests, {images} images in "
        f"{t_close - t_open:.3f} s; {len(records)} requests issued, "
        f"failed images {failed}")
    log("requests (client, submit, done; ms from the opening): " + " ".join(
        f"{q['client']},{(q['submit'] - t_open) * 1e3:.0f},"
        f"{(q['done'] - t_open) * 1e3:.0f}"
        for q in sorted(records, key=lambda q: q["submit"])))

    metrics = {}
    for m in cell_metrics(bench, cell["name"], trace):
        value = load_reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind,
           "count": cell.get("chips", 1), "memory_peak_bytes": peak}
    result = {"correct": False, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if prof:
        busy, window_s = prof.busy_and_window()
        dev["busy_s"] = busy
        dev["window_s"] = window_s
        result["breakdown"] = prof.breakdown(record["spans"], t_open)
        log(f"answer check's own device operations in the window: "
            f"{len(prof.events['check_ops'])}, "
            f"{sum(d for _, _, d in prof.events['check_ops']) / 1e6:.6f} s "
            f"(not counted as the program's)")

    # the answers against the plain reference, after the window
    ref = importlib.import_module(f"portbench.reference.{config['reference']}")
    t_ref = time.perf_counter()
    gap = check.gap(lambda slot: ref.decode(ref_inputs[slot], torch.float64,
                                            device))
    log(f"reference: {len(check_slots)} slots {check_slots}, "
        f"{check.answers} answers compared, {time.perf_counter() - t_ref:.3f} s")
    limit = config["limits"]["max_abs_gap"]
    checks = {"max_abs_gap": {"value": gap, "limit": limit},
              "failed_images": {"value": failed, "limit": 0},
              "answers_compared": {"value": check.answers,
                                   "limit": len(check_slots)}}
    result["correct"] = bool(
        gap <= limit and failed == 0 and check.answers >= len(check_slots))
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for need in ("BENCHMARK.json", PORT):
        if not os.path.exists(os.path.join(ROOT, need)):
            log(f"{need} is not in the checkout {ROOT}: nothing to run")
            return 2
    cell, config, traffic, bench = load_cell(args.workload)
    pin_environment()
    import torch

    if not torch.cuda.is_available():
        log("CUDA is not available: the benchmark runs on the card only")
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        log(f"{torch.cuda.device_count()} cards, the cell asks for "
            f"{cell['chips']}")
        return 2
    result = run_cell(cell, config, traffic, bench, args.seed, args.seconds,
                      bool(args.trace))
    found = sorted({m.split(".")[0] for m in sys.modules}
                   & set(FORBIDDEN))
    if found:
        log(f"modules that must not load are loaded: {found}")
        return 3
    for name, c in result["checks"].items():
        print(f"{name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
