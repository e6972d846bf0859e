#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (jxl_oxide_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal (non-zero exit, no "ok" line):
  1. card name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the native host library (g++) and the EPF kernel (nvcc) from
     the checkout, in parallel, timed; ptxas's registers and spills of
     each EPF step (a spill is fatal) and the launch geometry;
  3. the EPF kernel against its plain torch version on the card, steps
     0, 1 and 2, max |diff| <= 2e-5, on shapes that take the TMA copy and
     the cp.async copy (W % 4 != 0), fit in one tile, have more tiles than
     resident blocks, or have H < 3 (rows reflect more than once). At
     3x1024^2, 3x2048^2 and 3x1000x1030 (cp.async) each pass is timed on
     the card's clock (see `time_pass`), warm and cold, beside its bound;
  4. the decode paths: decode the committed fixtures through
     JxlImage.from_bytes(data).render_frame(0).to_u8() on cuda, each
     within 1 LSB of the committed jxl_oxide_tpu reference, with the EPF
     launch count of that decode alone equal to the frame's EPF passes:
     the fused 4:4:4 program (flagship_1024, the main path; epf3_512;
     mixed_512), the fused chroma-subsampled program (ycbcr420_1024,
     bench.py's vardct_420; ycbcr422_256) and the staged path with its
     render tail (staged_1030, W = 1030). Host-stage ms, device-stage ms
     and end-to-end MP/s, warm, median of 5, for each. For one fixture of
     each path (TIMED) the EPF inputs are captured in the counted run,
     the kernel is held against the plain version on them and timed on
     them as in phase 3, and one traced decode is broken down by the
     port's spans and by kernel (torch.profiler).
The EPF timing helpers are the port's (ops/cuda/epf_measure.py);
tools/epf_variants.py times other versions of the kernel against this one.
It prints one {"kernels": [...]} JSON line, the nvidia-smi line, and as
its last line {"ok": true, "device": {...}}. It imports neither JAX nor
jxl_oxide_tpu, and exits non-zero without CUDA or without the package.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import statistics
import sys
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
EPF_ATOL = 2e-5
FIXTURES = ("flagship_1024", "epf3_512", "mixed_512", "ycbcr420_1024",
            "ycbcr422_256", "staged_1030")
MAIN_PATH = "flagship_1024"
# one fixture per decode path: fused 4:4:4, fused subsampled, staged (whose
# EPF runs at the sample width 1030, on the kernel's cp.async copy)
TIMED = ("flagship_1024", "ycbcr420_1024", "staged_1030")
# (shape, timed): TMA and cp.async copies, one tile and many, H < 3
KERNEL_SHAPES = (
    ((3, 1024, 1024), True),
    ((3, 2048, 2048), True),   # 1024 tiles: more than resident blocks
    ((3, 1000, 1030), True),   # W % 4 != 0 and more tiles than blocks
    ((3, 150, 42), False),     # W % 4 != 0
    ((3, 150, 40), False),
    ((3, 64, 64), False),      # exactly one tile
    ((3, 40, 36), False),      # inside one tile
    ((3, 2, 5), False),        # H < 3, W % 4 != 0
    ((3, 1, 8), False),        # H < 3 on the TMA path
)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean time of fn() in ms over `reps` back-to-back calls between CUDA
    events (host work of each call included; used for the plain
    version)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(planes, sigma, step, cs, sm, bsm, calls: int = 200) -> float:
    """The wrapper's host time per call in us: `calls` calls of
    epf_step_cuda on the host clock, without a synchronisation."""
    import torch

    from jxl_oxide_tpu_torch.ops.cuda.epf import epf_step_cuda

    for _ in range(3):
        epf_step_cuda(planes, sigma, step, cs, sm, bsm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        epf_step_cuda(planes, sigma, step, cs, sm, bsm)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def copy_path(planes) -> str:
    """The copy the kernel takes: TMA where rows are 16-B aligned (the
    caching allocator's blocks are, so W % 4 decides), cp.async else."""
    return "TMA" if planes.shape[2] % 4 == 0 else "cp.async"


def time_pass(planes, sigma, step, cs, sm, bsm) -> dict:
    """Device ms per pass of the committed kernel, warm and cold
    (epf_measure.input_sets), each the mean of two readings, with the
    wrapper's host us per call, the plain version's ms and the bound."""
    from jxl_oxide_tpu_torch.ops.cuda import epf_measure as em
    from jxl_oxide_tpu_torch.ops.cuda.epf import _fn
    from jxl_oxide_tpu_torch.ops.filters import epf_step

    row = {}
    for key, cold in (("warm", False), ("cold", True)):
        sets = em.input_sets(planes, sigma, cold)
        row[key] = statistics.fmean(
            em.device_ms(_fn(), sets, step, cs, sm, bsm) for _ in range(2))
        del sets
    row["host_us"] = host_us(planes, sigma, step, cs, sm, bsm)
    row["plain_ms"] = cuda_ms(
        lambda: epf_step(planes, sigma, step, cs, sm, bsm), 3)
    row["bound_ms"], row["bound_by"] = em.bound_ms(sigma, step)
    row["cold_share"] = row["bound_ms"] / row["cold"]
    return row


def pass_line(row: dict) -> str:
    return (f"device warm {row['warm']:.4f} ms, cold {row['cold']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), cold share "
            f"of bound {row['cold_share']:.3f}, wrapper host "
            f"{row['host_us']:.1f} us/call, plain {row['plain_ms']:.4f} ms")


def phase_build() -> None:
    """Build the native host library and the EPF kernel in parallel."""
    from jxl_oxide_tpu_torch import native
    from jxl_oxide_tpu_torch.ops.cuda import build

    times, errors = {}, {}

    def run(name, fn):
        t0 = time.perf_counter()
        try:
            fn()
        except Exception as e:  # reported below, fatal
            errors[name] = e
        times[name] = time.perf_counter() - t0

    jobs = [("native g++", native.get_lib),
            ("epf nvcc", lambda: build.load("epf"))]
    threads = [threading.Thread(target=run, args=job) for job in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for name, t in times.items():
        log(f"build {name}: {t:.1f} s")
    if errors:
        raise RuntimeError(f"build failed: {errors}")
    if not native.available():
        raise RuntimeError("native host library did not load")
    with open(os.path.join(build.BUILD_DIR, "epf.ptxas.txt")) as f:
        ptxas = f.read()
    kernel = None
    for line in ptxas.splitlines():
        m = re.search(r"epf_kernelILi(\d)E", line)
        if m and "Compiling entry" in line:
            kernel = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            log(f"ptxas step {kernel}: {line.strip()}")
            if int(m.group(1)) or int(m.group(2)):
                raise RuntimeError(f"EPF step {kernel} spills registers")
        if "registers" in line:
            log(f"ptxas step {kernel}: {line.strip()}")
    lib = build.load("epf")
    for step in range(3):
        th, smem, res = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        err = lib.jxl_epf_config(step, ctypes.byref(th), ctypes.byref(smem),
                                 ctypes.byref(res))
        if err != 0:
            raise RuntimeError(f"EPF step {step} cannot launch: error {err}")
        log(f"epf step {step}: {th.value} threads, {smem.value} B dynamic "
            f"shared memory per block, {res.value} resident blocks")


def check_kernel(planes, sigma, step, cs, sm, bsm) -> float:
    """max |kernel - plain| on one input, fatal above EPF_ATOL."""
    import torch

    from jxl_oxide_tpu_torch.ops.cuda.epf import epf_step_cuda
    from jxl_oxide_tpu_torch.ops.filters import epf_step

    got = epf_step_cuda(planes, sigma, step, cs, sm, bsm)
    want = epf_step(planes, sigma, step, cs, sm, bsm)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"EPF step {step} {tuple(planes.shape)}: "
                             "non-finite output")
    err = float((got - want).abs().max().item())
    if not err <= EPF_ATOL:
        raise AssertionError(
            f"EPF kernel disagrees at step {step} {tuple(planes.shape)}: "
            f"{err}")
    return err


def phase_kernel(device) -> float:
    import torch

    from jxl_oxide_tpu_torch.ops.cuda import epf_measure as em
    from jxl_oxide_tpu_torch.ops.filters import epf_step

    cs, bsm = em.CHANNEL_SCALE, em.BORDER_SAD_MUL
    worst = 0.0
    for i, (shape, timed) in enumerate(KERNEL_SHAPES):
        p, s = em.epf_inputs(shape, seed=i)
        planes = torch.from_numpy(p).to(device)
        sigma = torch.from_numpy(s).to(device)
        moved = (epf_step(planes, sigma, 1, cs, 1.0, bsm) - planes
                 ).abs().amax(0) > 1e-5
        if shape[1] * shape[2] >= 1024 and not (
                moved[sigma >= 0.3].float().mean() > 0.3):
            raise AssertionError(f"EPF inputs {shape} barely filter")
        path = copy_path(planes)
        for step, sm in em.STEPS:
            err = check_kernel(planes, sigma, step, cs, sm, bsm)
            worst = max(worst, err)
            line = f"epf step {step} {shape} {path}: max|diff| {err:.3g}"
            if timed:
                line += ", " + pass_line(
                    time_pass(planes, sigma, step, cs, sm, bsm))
            log(line)
    return worst


def profile_decode(name: str, data: bytes, top: int = 8) -> None:
    """Where the time of one warm decode goes: the port's own spans
    (utils/trace.py, host clock), kernel time by name from one
    torch.profiler trace, and the share of the decode's wall time in
    which the card ran no kernel or copy."""
    import logging

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from jxl_oxide_tpu_torch import JxlImage
    from jxl_oxide_tpu_torch.utils.trace import logger as trace_logger

    spans = []

    class Keep(logging.Handler):
        def emit(self, record):
            spans.append(record.getMessage())

    keep = Keep()
    level = trace_logger.level
    trace_logger.addHandler(keep)
    trace_logger.setLevel(logging.DEBUG)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            JxlImage.from_bytes(data).render_frame(0).to_u8()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        trace_logger.removeHandler(keep)
        trace_logger.setLevel(level)
    for line in spans:
        log(f"  {name} span {line}")
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        row = by_name.setdefault(e.name, [0.0, 0])
        row[0] += e.time_range.elapsed_us() / 1e3
        row[1] += 1
    if not by_name:
        log(f"{name} profile: torch.profiler recorded no device time "
            "(not measured)")
        return
    busy = sum(v[0] for v in by_name.values())
    log(f"{name} profile: decode {wall_ms:.3f} ms (traced), kernels and copies "
        f"{busy:.3f} ms in {sum(v[1] for v in by_name.values())} device "
        f"ops, device idle share {max(0.0, 1 - busy / wall_ms):.3f}")
    for kname, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[
            :top]:
        log(f"  {name} {ms:8.3f} ms {n:5d}x  {kname[:80]}")


def epf_passes(data: bytes) -> int:
    from jxl_oxide_tpu_torch import JxlImage

    img = JxlImage.from_bytes(data, device="cpu")
    epf = img._frames[0].header.restoration_filter.epf
    return epf.iters if epf.enabled else 0


def phase_decode() -> dict:
    """Every fixture through the entry point; returns the kernel report,
    the main path's numbers with each timed path's beside them."""
    import torch

    from jxl_oxide_tpu_torch import JxlImage
    from jxl_oxide_tpu_torch.ops.cuda import epf_measure as em
    from jxl_oxide_tpu_torch.ops.cuda.epf import epf_step_cuda

    tdir = os.path.join(REPO, "jxl_oxide_tpu_torch", "testdata")
    paths = {}
    for name in FIXTURES:
        with open(os.path.join(tdir, f"{name}.jxl"), "rb") as f:
            data = f.read()
        ref = np.load(os.path.join(tdir, f"{name}.npz"))["u8"]
        passes = epf_passes(data)

        # the counted run: launches of this decode only
        epf_step_cuda.launches = 0
        u8, captured = em.capture_decode(data)
        launches = epf_step_cuda.launches
        diff = int(np.abs(u8.astype(np.int32) - ref.astype(np.int32)).max())
        log(f"{name}: {u8.shape}, max |u8 - reference| {diff}, EPF launches "
            f"{launches} (passes {passes})")
        if u8.shape != ref.shape or diff > 1:
            raise AssertionError(f"{name}: decode differs from reference")
        if launches != passes:
            raise AssertionError(f"{name}: {launches} EPF launches, "
                                 f"{passes} passes")

        # warm timings, median of 5
        host_ms, dev_ms, e2e_s = [], [], []
        for _ in range(5):
            t0 = time.perf_counter()
            img = JxlImage.from_bytes(data)
            host = img._host_stage(0)
            t1 = time.perf_counter()
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            planes = img._device_stage(host)
            ev1.record()
            torch.cuda.synchronize()
            host_ms.append((t1 - t0) * 1e3)
            dev_ms.append(ev0.elapsed_time(ev1))
            t0 = time.perf_counter()
            JxlImage.from_bytes(data).render_frame(0).to_u8()
            e2e_s.append(time.perf_counter() - t0)
            del planes
        mp = u8.shape[0] * u8.shape[1] / 1e6
        log(f"{name}: host stage {statistics.median(host_ms):.2f} ms, "
            f"device stage {statistics.median(dev_ms):.3f} ms, end to end "
            f"{mp / statistics.median(e2e_s):.2f} MP/s "
            f"({statistics.median(e2e_s) * 1e3:.2f} ms), warm median of 5")

        if name in TIMED:
            profile_decode(name, data)
            rows, errs = [], []
            for planes, sigma, step, cs, sm, bsm in captured:
                errs.append(check_kernel(planes, sigma, step, cs, sm, bsm))
                path = copy_path(planes)
                row = time_pass(planes, sigma, step, cs, sm, bsm)
                rows.append(row)
                log(f"{name} EPF step {step} {tuple(planes.shape)} "
                    f"{path}: max|diff| {errs[-1]:.3g}, {pass_line(row)}")
            bys = [r["bound_by"] for r in rows]

            def mean(key):
                return statistics.fmean(r[key] for r in rows)

            # per pass, mean over this decode's passes
            paths[name] = {
                "launches": launches,
                "max_abs_err": max(errs),
                "ms": mean("warm"),
                "cold_ms": mean("cold"),
                "host_us": mean("host_us"),
                "plain_ms": mean("plain_ms"),
                "bound_ms": mean("bound_ms"),
                "bound_by": max(set(bys), key=bys.count),
                "cold_share_of_bound": mean("bound_ms") / mean("cold"),
            }
    main_path = paths[MAIN_PATH]
    return {
        "name": "epf_step",
        "route": "cuda",
        "source": "jxl_oxide_tpu_torch/csrc/epf.cu",
        "replaces": "jxl_oxide_tpu/ops/pallas/epf.py:30",
        **main_path,
        "max_abs_err": max(p["max_abs_err"] for p in paths.values()),
        "library_ms": None,
        "paths": paths,
    }


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing ran", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from jxl_oxide_tpu_torch.ops.cuda import epf_measure as em
    except ImportError as e:
        print(f"chip_smoke: the port is not here: {e}", file=sys.stderr)
        return 3
    t_start = time.perf_counter()
    log(f"card: {em.card()}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    device = torch.device("cuda")

    phase_build()
    worst = phase_kernel(device)
    log(f"EPF kernel vs plain: worst max|diff| {worst:.3g} (atol {EPF_ATOL})")
    report = phase_decode()
    report["max_abs_err"] = max(report["max_abs_err"], worst)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [report]}))
    print(f"card: {em.card()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
