#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (jxl_oxide_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal (non-zero exit, no "ok" line):
  1. card name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the native host library (g++), the EPF kernel, the squeeze
     kernel, the squeeze's chain probe and the noise field kernel (nvcc)
     from the checkout, in parallel, timed; ptxas's registers and spills
     of each EPF step, each squeeze kernel and the noise kernel (a spill
     is fatal) and the EPF launch geometry;
  2b. the squeeze's reachable bound (`phase_probe`): the chain probe
     (csrc/squeeze_probe.cu: one step of the recurrence alone, operands in
     registers) at 32 and 1024 lines, its checksums bit for bit the same
     walk in plain torch, in ns a step (CUDA events) and SM cycles a step
     (clock64); and the instructions on the squeeze kernels' loop-carried
     chain, by opcode, read from their SASS (tools/squeeze_sass.py);
  3. the EPF kernel against its plain torch version on the card, steps
     0, 1 and 2, max |diff| <= 2e-5, on shapes that take the TMA copy and
     the cp.async copy (W % 4 != 0), fit in one tile, have more tiles than
     resident blocks, or have H < 3 (rows reflect more than once). At
     3x1024^2, 3x2048^2 and 3x1000x1030 (cp.async) each pass is timed on
     the card's clock (see `time_pass`), warm and cold, beside its bound;
  3b. the squeeze kernel against its plain torch version on the card, bit
     for bit, horizontal and vertical, on odd and even lengths, no
     residual, one line, misaligned rows and bases, 2048^2, and samples
     at the INT32 extremes; then a default squeeze pyramid of a 2048^2
     plane through the port's device tail and through the host's C++
     Squeeze.inverse, bit for bit, timed on the card's clock (a CUDA graph
     replayed between CUDA events, warm and cold) in Msamples/s beside the
     host's single-thread rate, the byte bound and the chain bound, and
     each of its launches timed on its own (direction, lines, steps, ms,
     ns a step);
  3c. the EPF kernel on stacks [N, 3, H, W] in one launch, N = 1, 2, 5
     and 8, on the TMA and cp.async copies: bit for bit the N one-image
     launches, and within EPF_ATOL of the plain version on the stack;
  4. the decode paths: decode the committed fixtures through
     JxlImage.from_bytes(data).render_frame(0).to_u8() on cuda, each
     within 1 LSB of the committed jxl_oxide_tpu reference (an alpha
     channel exactly), with the EPF launch count of that decode alone
     equal to the frame's EPF passes: the fused 4:4:4 program
     (flagship_1024, the main path of a single decode; epf3_512;
     mixed_512; flagship_alpha_1024 with an alpha channel;
     orient6_512x384, EXIF orientation 6 on a non-square frame), the fused
     chroma-subsampled program (ycbcr420_1024, bench.py's vardct_420;
     ycbcr422_256) and the staged path with its render tail (staged_1030,
     W = 1030), and lossless Modular with the device tail (modular_1024:
     one squeeze launch, 2 EPF passes) and with the host tail
     (modular_xyb_512, XYB; modular_alpha_512, alpha), each decode's
     squeeze launches counted too. End-to-end MP/s, warm, median of 5,
     for each, and the same decode split by its spans (host entropy
     stage, frame device stage, composite, the rest). For one fixture of each
     path (TIMED) the EPF and squeeze inputs are captured in the counted
     run, the kernels are held against the plain versions on them and
     timed on them as in phase 3 (a squeeze beside its byte bound and its
     chain bound: its steps times the probe's ns a step),
     and one traced decode is broken down by the port's spans and by
     kernel (torch.profiler);
  5. serving (`phase_serving`): one decode_batch_stacked call over 8 x
     flagship_1024, four 1024^2 alpha streams, 2 x ycbcr420_1024 and
     modular_xyb_512 (per-image path), output "u8" and "device": every
     result equal to its per-image decode (else the differing pixels are
     counted and each image held within 1 LSB of its reference), each
     fixture within 1 LSB of its reference, and the K1 launches of the
     counted call equal to the stacked groups' EPF passes (not images).
     Then, warm, median of 5: MP/s of the stacked call, of decode_batch
     and of sequential per-image decodes; one traced stacked call by span
     (summed over threads) and by kernel; the 8-image group's host enqueue
     time and torch.profiler device-op count against one image's (fatal
     above 1.1x, the kernels whose counts differ listed); the stacked EPF
     passes timed on the card's clock, warm and cold, against their
     bound;
  6. multi-frame streams (`phase_animation`): K1 on a [1, 3, 45, 77]
     plane; for each of ANIMATIONS, the last keyframe rendered cold
     through render_frame (its dependency cone: frames rendered counted,
     each on a thread that must see CUDA as the decode device; K1
     launches equal to 2 per filtered frame rendered), then every earlier
     keyframe, each a cache hit with no render and no launch; every
     keyframe against its expected u8 (animation_4f_blend and
     patch_alpha_256 exactly, the filtered ones within 1 LSB, alpha
     exactly); warm medians of 5 per keyframe and per cone; one traced
     cone by span (host entropy stage, frame device stage, composite,
     summed over threads) and kernel, with the device idle share; the
     counted runs' EPF passes held and timed as in phase 3;
  7. colour encodings (`phase_color`, Pillow blocked: no leg of it needs
     a CMS): each of COLOR_FIXTURES decoded on the card within 1 LSB of
     its reference (alpha exactly) with its K1 and K9 launches counted
     (grey_squeeze_2048x1024: its squeeze on the device tail, 1 K9
     launch, and 2 K1 launches on its plane cloned to three;
     xyb_hdr_1024: 4000-nit XYB tone-mapped, 2 K1 launches), then
     flagship_1024 under each requested encoding (REQUESTS, from
     tools/make_torch_port_fixtures.py) within 1 LSB in u8 and, for PQ and
     HLG, REQUEST_U16_TOL in u16 of its reference; the launches of the
     timed fixtures held against the plain versions and timed as in phase
     3 (K9 beside its chain bound); warm medians of 5 for each decode, end
     to end and split by span (host entropy stage, frame device stage,
     composite, transform to requested color encoding, the rest). Pixels
     whose luminance lands across the tone map's step on the card and on
     counted, not held (see TONE_MAP_STEP);
  8. the rest of the render pipeline (`phase_features`): K12, the noise
     field kernel, bit for bit against its plain version (ops/noise.py,
     numpy) on NOISE_SHAPES (one pixel, W % 16 != 0, partial groups at the
     right and bottom edges, one group, 2048^2, features_up2_1024's one
     1024^2 group), timed on the card's clock warm and cold beside its
     byte bound and its serial steps a lane; then each of
     FEATURE_FIXTURES (splines, noise and x2 upsampling; an LF frame on
     the fused path; a two-level XYB LF chain; an alpha at dim_shift 2)
     decoded within 1 LSB of its reference, alpha exactly, its K1 and K12
     launches counted from 0 for that decode alone (K1 2 and K12 1 on
     features_up2_1024, K1 2 on lf_frame_1024's main frame); warm medians
     of 5 by span (Splines, Noise, Upsampling and LF frame inside them);
     the FEATURE_TIMED fixtures' K1 passes held and timed as in phase 3,
     and one traced decode each;
  9. progressive and partial decode (`phase_progressive`): each of
     PROGRESSIVE (flagship_1024, passes3_1024 with three passes,
     modular_1024) fed to JxlImage() on the card at the four cuts of its
     committed <name>_progressive.npz, render_loading_frame().to_u8()
     after each piece within 1 LSB of the JAX package's loading render
     there, with the same sections decoded, its K1, K9 and K12 launches
     counted from 0 just before the render and read just after (K1 2 a
     render; K9 at least 1 on modular_1024, none elsewhere; K12 none),
     every K1 pass held within 2e-5 of the plain version and every K9
     launch bit for bit; the last render equal to the one-shot
     render_frame(0) on the card bit for bit; the fused programs built
     during the feed counted; then, warm, median of 5 feeds, each call's
     latency and its split by span, the feed's sum against one one-shot
     decode, the last render's K1 passes and K9 launches timed as in
     phases 3 and 3b, and one traced feed by span and kernel;
 10. every extra-channel kind (`phase_extra_channels`): each of
     EC_FIXTURES (ec_mix_1024: an alpha, a spot colour, an f16 alpha and
     a depth channel through the squeeze on the device tail;
     ec_blend_premul_512: three frames blended over an associated alpha,
     alpha channel 1) rendered keyframe by keyframe with its K1, K9 and
     K12 launches counted from 0 for that run alone (K1 2 and K9 1;
     K1 6), u8 within 1 LSB of its reference, alphas exactly, every extra
     channel bit for bit; each launch held against its plain version and
     timed as in phases 3 and 3b; warm medians of 5 by span, one traced
     run;
 11. region-of-interest decode (`phase_roi`): each region of each of
     ROI_FIXTURES' <name>_roi.npz through render_frame_cropped on a
     fresh image, its launches counted from 0 for that render alone,
     within 1 LSB of the JAX package's region render and equal to the
     crop of the card's full render, and set_image_region +
     render_frame equal to it; the device rect the fused program computed
     and K1's plane shape on it logged, each launch held and timed; the
     warm region render against the full render, by span;
     flagship_1024's loading render with a region set against its
     reference;
 12. the front ends (`phase_frontends`, Pillow blocked): the CLI in
     process (cli.main): decode of flagship_1024 with --num-reps 5 (K1 2
     launches a rep, the PNG read with zlib alone equal to the card's
     render_frame(0).to_u8() and within 1 LSB of the reference, the CLI's
     geomean and MP/s beside a direct decode's and the PNG write's host
     time), of modular_1024 (K9 1, K1 2), of animation_4f_blend to an APNG
     (four fcTL chunks with the JAX CLI's delays, each frame its input)
     and of jbrd_container_256 to npy; `info` on FRONTENDS against the
     JAX CLI's JSON (frontends.json); `progressive` on flagship_1024 (K1
     2 a loading render, the final PNG equal to the one-shot decode); the
     metadata boxes of jbrd_container_256 against the JAX package's
     payloads, and where the system libbrotlidec loads (the run says
     whether it does) the brob box, dump-jbrd's bytes against the JAX
     package's reconstruction and reconstruct_jpeg's host time; `python
     -m jxl_oxide_tpu_torch info` in a subprocess; --num-devices one
     more than the cards raising a clear error; clear_program_caches()
     lowering torch.cuda.memory_reserved(), then the flagship exact with
     K1 2;
 13. the sharded decode (`phase_mesh`): each of MESH_DECODES over a mesh
     of explicit shards on cuda:0, its K1, K9 and K12 launches and calls
     of the plain epf_step on a CUDA tensor counted (none allowed), equal
     to the card's single-device decode bit for bit (planes and u8) and
     within 1 LSB of the reference (alpha exact); K1 launches against
     passes (the bands of one card go as one stack), K9 one a row band on
     modular_1024, halo bytes exchanged; MESH_TIMED's launches held and
     timed (K1's bound on the haloed band), one traced decode each; warm
     medians of 5 of flagship_1024 at 1, 2 and 4 shards by span (the
     sharded program and the halo exchange inside); the CLI's decode
     --num-devices 1. With two cards or more, the flagship over real
     cards and tools/torch_multihost_check.py over NCCL; else the run
     says they did not run;
 14. the two YCbCr layouts of ROADMAP item 7 (`phase_ycbcr`): each of
     YCBCR_FIXTURES (4:4:4 YCbCr VarDCT; 4:2:0 YCbCr Modular on the
     device tail) within 1 LSB of its reference, its K1, K9 and K12
     launches counted and each K1 and K9 launch held against the plain
     version and timed beside its bound; the decode warm and cold
     (`cold_decode`) by span, one traced decode; a region against the JAX
     package's; the decode over 4 shards of cuda:0 bit for bit the
     single-device one; 4 x ycbcr444_1024 stacked, 0 pixels different
     from the per-image decode; the port's generate-fixture on this host
     against the committed SHA-256 of tools/'s output.
The EPF timing helpers are the port's (ops/cuda/epf_measure.py);
tools/epf_variants.py times other versions of the kernel against this one.
The squeeze's are ops/cuda/squeeze_measure.py (the probe among them);
tools/squeeze_variants.py times other versions of the squeeze kernel.
It prints one {"kernels": [...]} JSON line, the nvidia-smi line, and as
its last line {"ok": true, "device": {...}}. It imports neither JAX nor
jxl_oxide_tpu, and exits non-zero without CUDA or without the package.
"""

from __future__ import annotations

import collections
import contextlib
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
            "ycbcr422_256", "staged_1030", "modular_1024", "modular_xyb_512",
            "flagship_alpha_1024", "modular_alpha_512", "orient6_512x384")
MAIN_PATH = "flagship_1024"
# the serving phase's streams: bench.py's _bench_serving_batched shape (8 x
# the flagship stream), four distinct 1024^2 alpha streams (the last three
# committed without references), two 4:2:0 streams, and a Modular stream
# that takes the per-image path
SERVING = (("flagship_1024",) * 8
           + ("flagship_alpha_1024", "flagship_alpha_1024_s1",
              "flagship_alpha_1024_s2", "flagship_alpha_1024_s3")
           + ("ycbcr420_1024",) * 2 + ("modular_xyb_512",))
# the multi-frame fixtures (phase_animation): (name, EPF passes per frame,
# exact): bench.py's animation_4f_blend (four Replace keyframes, held
# against its seeded input frames), a Blend chain with an alpha and EPF 2
# on every frame, a BlendAbove patch from a reference-only frame, and a
# 77x45 cropped frame with EPF 2 (planes smaller than one tile, W % 4 != 0)
ANIMATIONS = (("animation_4f_blend", 0, True),
              ("anim_blend_epf_512", 2, False),
              ("patch_alpha_256", 0, True), ("crop_epf_77x45", 2, False))
# stacks of the batched EPF checks: (N, 3, H, W), TMA and cp.async copies
STACK_SHAPES = ((1, 3, 150, 40), (2, 3, 150, 40), (5, 3, 150, 42),
                (2, 3, 64, 64), (8, 3, 1024, 1024))
# the Modular path's fixture: its squeeze launch is the squeeze kernel's
# main-path launch
MODULAR_PATH = "modular_1024"
# squeeze launches of each decode (the device tail engages at 2^20 samples)
SQUEEZES = {"modular_1024": 1}
# one fixture per decode path: fused 4:4:4, fused subsampled, staged (whose
# EPF runs at the sample width 1030, on the kernel's cp.async copy), Modular
TIMED = ("flagship_1024", "ycbcr420_1024", "staged_1030", "modular_1024")
# the colour fixtures (phase_color): (name, K1 launches, K9 launches) of
# one decode on the card: greyscale with its squeeze on the device tail
# (2^20-sample halves) and K1 on its plane cloned to three, grey + alpha
# and bench.py's modular_wp (host tail, no filter), XYB mastered at 4000
# nits (tone-mapped; at 256^2 relative to its peak), an embedded Display
# P3 profile (the enum transform)
COLOR_FIXTURES = (("grey_squeeze_2048x1024", 2, 1), ("grey_alpha_512", 0, 0),
                  ("modular_wp_256", 0, 0), ("xyb_hdr_1024", 2, 0),
                  ("xyb_hdr_peak_256", 2, 0), ("icc_p3_512", 0, 0))
# the colour fixtures whose launches are held and timed (the kernels' rows)
COLOR_TIMED = ("grey_squeeze_2048x1024", "xyb_hdr_1024")
# the u16 bound of flagship_1024's PQ and HLG renders against their
# references, in LSB of 65535: what the CPU tests measure
# (tests/torch_parity.py REQUEST_U16_TOL)
REQUEST_U16_TOL = 1
# The reference's BT.2408 tone map (jxl_oxide_tpu/ops/color.py:287-296,
# copied by the port) steps at a luminance of |y| = TONE_MAP_STEP: below
# it a pixel's ratio is y_mapped * scale (about 0: black), above it
# y_mapped / y * scale (about 15.7 at 4000 nits). A pixel whose colour
# cancels to a luminance near 0 (out of gamut) can land on the other side
# of the step under the last-ulp differences K1 is allowed against its
# plain version (2e-5), and then differs by up to 255 (ROADMAP Queue 3).
# Such pixels, found by decoding the stream on the CPU too (the plain
# versions: what the CPU tests hold to the reference) and comparing the
# side of the step each decode's tone map saw, are counted and printed,
# not held; every other pixel is held to 1 LSB.
TONE_MAP_STEP = 1e-7
# at most this share of a fixture's pixels may cross the step
TONE_MAP_CROSSED_MAX = 1e-4
# (lines, n) of the squeeze kernel checks: n odd and even, no residual
# (n = 1), one line (a row for the horizontal kernel, a column for the
# vertical one), partial blocks and tiles, na % 4 of 0 (TMA where nr % 4
# is 0 too), 1, 2 and 3 (cp.async), more tiles than ring stages, 2048^2;
# each also on bases off a 16-byte boundary (cp.async)
SQUEEZE_SHAPES = ((1, 2), (3, 3), (70, 1), (33, 64), (40, 65), (1, 131),
                  (7, 70), (31, 68), (20, 264), (3, 257), (2048, 2048))
I32_EDGES = (-2**31, -2**31 + 1, -2**30, -13, -1, 0, 1, 12, 2**30,
             2**31 - 2, 2**31 - 1)
# the squeeze kernels whose loop-carried chain is counted in their SASS,
# by library
SASS_KERNELS = (("modular_squeeze", "inv_squeeze_h_kernel"),
                ("modular_squeeze", "inv_squeeze_v_kernel"),
                ("squeeze_probe", "squeeze_probe_kernel"))
# lines of the chain probe: one warp on one SM, and 32 warps on 32 SMs (a
# 1024-line plane's horizontal squeeze); the bound takes the second
PROBE_LINES = (32, 1024)
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


def animation_4f_frames() -> list:
    """The expected keyframes of animation_4f_blend, [512, 512, 3] u8
    each: bench.py's recipe (bench.py:207-218, seed 7), whose frames are
    full-canvas Replace keyframes, so each decodes to its input frame."""
    rng = np.random.default_rng(7)
    frames = [[rng.integers(0, 200, (512, 512), dtype=np.int64)
               for _ in range(3)]]
    for _ in range(3):
        frames.append([np.clip(c + rng.integers(-8, 9, c.shape), 0, 255)
                       for c in frames[-1]])
    return [np.stack([c.astype(np.uint8) for c in f], -1) for f in frames]


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
    caching allocator's blocks are, so W % 4 decides), cp.async else.
    planes: [3, H, W] or a stack [N, 3, H, W]."""
    return "TMA" if planes.shape[-1] % 4 == 0 else "cp.async"


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


def pass_rows(label: str, captured) -> dict:
    """K1 on the EPF passes captured from one counted run: each held
    against the plain version and timed (time_pass); the mean per pass."""
    rows, errs = [], []
    for planes, sigma, step, cs, sm, bsm in captured:
        errs.append(check_kernel(planes, sigma, step, cs, sm, bsm))
        rows.append(time_pass(planes, sigma, step, cs, sm, bsm))
        log(f"{label} EPF step {step} {tuple(planes.shape)} "
            f"{copy_path(planes)}: max|diff| {errs[-1]:.3g}, "
            f"{pass_line(rows[-1])}")

    def mean(k):
        return statistics.fmean(r[k] for r in rows)

    bys = [r["bound_by"] for r in rows]
    return {
        "max_abs_err": max(errs),
        "ms": mean("warm"),
        "cold_ms": mean("cold"),
        "host_us": mean("host_us"),
        "plain_ms": mean("plain_ms"),
        "bound_ms": mean("bound_ms"),
        "bound_by": max(set(bys), key=bys.count),
        "cold_share_of_bound": mean("bound_ms") / mean("cold"),
    }


def check_ptxas(name: str, label) -> None:
    """Print each kernel's registers and spills from the ptxas output of
    library `name`; a spill is fatal. `label(entry)` names a kernel by its
    mangled entry."""
    from jxl_oxide_tpu_torch.ops.cuda import build

    with open(os.path.join(build.BUILD_DIR, f"{name}.ptxas.txt")) as f:
        ptxas = f.read()
    kernel = None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = label(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            log(f"ptxas {kernel}: {line.strip()}")
            if int(m.group(1)) or int(m.group(2)):
                raise RuntimeError(f"{kernel} spills registers")
        if "registers" in line:
            log(f"ptxas {kernel}: {line.strip()}")


def phase_build() -> None:
    """Build the native host library and the two kernel libraries in
    parallel, one compiler each."""
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

    jobs = [("native g++", native.get_lib)] + [
        (f"{lib} nvcc", lambda lib=lib: build.load(lib))
        for lib in build.SOURCES]
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

    def epf_step(entry):
        m = re.search(r"epf_kernelILi(\d)E", entry)
        return f"epf step {m.group(1)}" if m else entry

    def squeeze_kernel(entry):
        m = re.search(r"inv_squeeze_h_kernelILb([01])E", entry)
        if m:
            return ("inv_squeeze_h_kernel (TMA)" if m.group(1) == "1"
                    else "inv_squeeze_h_kernel (cp.async)")
        m = re.search(r"inv_squeeze_v_kernel|squeeze_probe_kernel", entry)
        return m.group(0) if m else entry

    check_ptxas("epf", epf_step)
    check_ptxas("modular_squeeze", squeeze_kernel)
    check_ptxas("squeeze_probe", squeeze_kernel)
    check_ptxas("noise", lambda entry: "noise_field_kernel"
                if "noise_field_kernel" in entry else entry)
    lib = build.load("epf")
    for step in range(3):
        th, smem, res = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        err = lib.jxl_epf_config(step, ctypes.byref(th), ctypes.byref(smem),
                                 ctypes.byref(res))
        if err != 0:
            raise RuntimeError(f"EPF step {step} cannot launch: error {err}")
        log(f"epf step {step}: {th.value} threads, {smem.value} B dynamic "
            f"shared memory per block, {res.value} resident blocks")


def phase_probe() -> dict:
    """The squeeze's reachable bound: the chain probe at PROBE_LINES lines,
    each line's checksum bit for bit the plain torch walk; then the
    loop-carried chain of each of SASS_KERNELS counted in its SASS.
    Returns the probe at the last line count, with the SASS counts."""
    import importlib.util

    from jxl_oxide_tpu_torch.ops.cuda import build
    from jxl_oxide_tpu_torch.ops.cuda import squeeze_measure as sm

    want = sm.probe_checksums(*sm.probe_tables(), max(PROBE_LINES),
                              sm.PROBE_ROUNDS)
    rows = {}
    for lines in PROBE_LINES:
        row = sm.probe(lines)
        if not bool((row.pop("checksum") == want[:lines]).all()):
            raise AssertionError(f"squeeze probe at {lines} lines: checksums "
                                 "differ from the plain walk")
        rows[lines] = row
        log(f"squeeze chain probe, {lines} lines x {row['steps']} steps: "
            f"checksums equal to plain; {row['ns_per_step']:.3f} ns a step "
            f"(CUDA events), {row['cycles_per_step']:.2f} SM cycles a step "
            f"(clock64, mean over lines; max {row['cycles_per_step_max']:.2f})"
            f", so {row['cycles_per_step'] / row['ns_per_step']:.3f} GHz")

    spec = importlib.util.spec_from_file_location(
        "squeeze_sass", os.path.join(REPO, "tools", "squeeze_sass.py"))
    sass = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sass)
    counts = {}
    for lib, kernel in SASS_KERNELS:
        c = sass.analyse(build.library_path(lib), kernel)
        counts[kernel] = c
        log(f"sass {kernel}: longest dependency path {c['path_instructions']}"
            f" instructions in a block of {c['block_instructions']}; "
            f"{c['ops_per_step']} a step on the loop-carried chain "
            f"({c['steps_on_path']} steps on the path), by opcode over "
            f"{c['steps_per_period']} step(s): {c['by_opcode']}")
    out = dict(rows[max(PROBE_LINES)])
    out["ns_per_step_32_lines"] = rows[min(PROBE_LINES)]["ns_per_step"]
    out["sass"] = counts
    return out


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


def phase_stack_kernel(device) -> float:
    """The EPF kernel on stacks [N, 3, H, W], one launch each: bit for bit
    the N one-image launches, and within EPF_ATOL of the plain version on
    the stack. Returns the worst |kernel - plain|."""
    import torch

    from jxl_oxide_tpu_torch.ops.cuda import epf_measure as em
    from jxl_oxide_tpu_torch.ops.cuda.epf import epf_step_cuda
    from jxl_oxide_tpu_torch.ops.filters import epf_step

    cs, bsm = em.CHANNEL_SCALE, em.BORDER_SAD_MUL
    worst = 0.0
    for i, shape in enumerate(STACK_SHAPES):
        n = shape[0]
        ins = [em.epf_inputs(shape[1:], seed=100 + 10 * i + j)
               for j in range(n)]
        planes = torch.from_numpy(np.stack([p for p, _ in ins])).to(device)
        sigma = torch.from_numpy(np.stack([s for _, s in ins])).to(device)
        for step, sm in em.STEPS:
            before = epf_step_cuda.launches
            got = epf_step_cuda(planes, sigma, step, cs, sm, bsm)
            if epf_step_cuda.launches != before + 1:
                raise AssertionError("a stacked EPF pass is not one launch")
            singles = torch.stack([
                epf_step_cuda(planes[j], sigma[j], step, cs, sm, bsm)
                for j in range(n)])
            want = epf_step(planes, sigma, step, cs, sm, bsm)
            torch.cuda.synchronize()
            if not torch.equal(got, singles):
                raise AssertionError(
                    f"stacked EPF step {step} {shape}: "
                    f"{int((got != singles).sum())} values differ from the "
                    "one-image launches")
            err = float((got - want).abs().max().item())
            if not err <= EPF_ATOL:
                raise AssertionError(f"stacked EPF step {step} {shape}: "
                                     f"{err} from plain")
            worst = max(worst, err)
        log(f"epf stack {shape} {copy_path(planes)}: one launch per pass "
            f"equals {n} one-image launches bit for bit, max|diff| to plain "
            f"{worst:.3g}")
    return worst


@contextlib.contextmanager
def watching(module, name: str, see):
    """Within the block, each call of module.name first shows its
    arguments to see(*args). The decode looks each kernel's wrapper up on
    its module at every call, so this sees every launch of a decode; the
    wrapper still runs, and still counts."""
    fn = getattr(module, name)

    def watched(*args):
        see(*args)
        return fn(*args)

    setattr(module, name, watched)
    try:
        yield
    finally:
        setattr(module, name, fn)


def squeeze_plain_ms(avg, res, horizontal: bool) -> float:
    from jxl_oxide_tpu_torch.ops import modular_tail as mt

    plain = mt.inv_squeeze_h if horizontal else mt.inv_squeeze_v
    return cuda_ms(lambda: plain(avg, res), 2, warmup=1)


def check_squeeze(avg, res, horizontal: bool) -> None:
    """The kernel against the plain version on one input, fatal unless
    equal (integer arithmetic, bit for bit)."""
    import torch

    from jxl_oxide_tpu_torch.ops import modular_tail as mt
    from jxl_oxide_tpu_torch.ops.cuda.squeeze import inv_squeeze_cuda

    got = inv_squeeze_cuda(avg, res, horizontal)
    want = (mt.inv_squeeze_h if horizontal else mt.inv_squeeze_v)(avg, res)
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.equal(got, want):
        diff = (got.long() - want.long()).abs().max().item() if (
            got.shape == want.shape) else "shape"
        raise AssertionError(
            f"squeeze kernel disagrees ({'h' if horizontal else 'v'}, "
            f"{tuple(avg.shape)}, {tuple(res.shape)}): {diff}")


def phase_squeeze(device, probe: dict) -> dict:
    """The squeeze kernel against its plain version (also on bases off a
    16-B boundary), then the 2048^2 pyramid against the host tail, timed
    whole and launch by launch; returns the pyramid's row."""
    import torch

    from jxl_oxide_tpu_torch.models.modular import inverse_transforms_device
    from jxl_oxide_tpu_torch.ops.cuda import squeeze as kernel
    from jxl_oxide_tpu_torch.ops.cuda import squeeze_measure as sm

    rng = np.random.default_rng(0)
    edges = np.array(I32_EDGES, dtype=np.int32)
    for lines, n in SQUEEZE_SHAPES:
        na, nr = (n + 1) // 2, n // 2
        for horizontal in (True, False):
            shapes = (((lines, na), (lines, nr)) if horizontal
                      else ((na, lines), (nr, lines)))
            for extremes in (False, True):
                if extremes:
                    avg, res = (rng.choice(edges, s) for s in shapes)
                else:
                    avg, res = (rng.integers(-4096, 4096, s).astype(np.int32)
                                for s in shapes)
                avg = torch.from_numpy(avg).to(device)
                res = torch.from_numpy(res).to(device)
                check_squeeze(avg, res, horizontal)
                if nr:
                    check_squeeze(sm.misaligned(avg), sm.misaligned(res),
                                  horizontal)
            log(f"squeeze {'h' if horizontal else 'v'} lines {lines} n {n}: "
                "equal to plain (random and INT32 extremes, aligned and "
                "misaligned bases)")

    size = 2048
    got, launches = sm.pyramid_on_device(size, device)
    host_s = []
    for _ in range(3):
        sq_host, slots, parent = sm.pyramid(size)
        t0 = time.perf_counter()
        sq_host.inverse(slots, 16)
        host_s.append(time.perf_counter() - t0)
    if not torch.equal(got.cpu(), torch.from_numpy(parent)):
        raise AssertionError("squeeze pyramid: device tail differs from the "
                             "host tail")
    squeeze, slots, _ = sm.pyramid(size)
    planes = [torch.from_numpy(np.ascontiguousarray(s.arr)).to(device)
              for s in slots]

    def run():
        inverse_transforms_device([squeeze], planes, 16)

    warm = sm.graph_ms(run)
    cold = sm.graph_ms(run, cold=True)
    bytes_total = sum(sm.squeeze_bytes(a, r) for a, r, _ in launches)
    steps = sum(sm.steps(r, h) for _, r, h in launches)
    chain = sum(sm.chain_bound_ms(r, h, probe["ns_per_step"])
                for _, r, h in launches)
    per_launch = []
    for avg, res, horizontal in launches:
        ms = sm.device_ms(kernel._fn(), avg, res, horizontal, cold=False)
        k = sm.steps(res, horizontal)
        per_launch.append({
            "dir": "h" if horizontal else "v",
            "lines": avg.shape[0] if horizontal else avg.shape[1],
            "steps": k, "ms": ms, "ns_per_step": ms * 1e6 / k})
    row = {
        "size": size,
        "launches": len(launches),
        "steps": steps,
        "warm_ms": warm,
        "cold_ms": cold,
        "device_msps": size * size / warm / 1e3,
        "device_msps_cold": size * size / cold / 1e3,
        "host_msps_1t": size * size / min(host_s) / 1e6,
        "bound_ms": bytes_total / sm.HBM_BYTES_PER_S * 1e3,
        "chain_bound_ms": chain,
        "cold_share_of_chain_bound": chain / cold,
        "per_launch": per_launch,
    }
    log(f"squeeze pyramid {size}^2 ({len(launches)} launches, {steps} serial "
        f"steps): equal to the host tail; device warm {warm:.4f} ms "
        f"({row['device_msps']:.1f} Msamples/s), cold {cold:.4f} ms "
        f"({row['device_msps_cold']:.1f}), host C++ 1 thread "
        f"{min(host_s) * 1e3:.2f} ms ({row['host_msps_1t']:.1f} Msamples/s), "
        f"byte bound {row['bound_ms']:.4f} ms ({bytes_total} B), chain bound "
        f"{chain:.4f} ms (steps x {probe['ns_per_step']:.3f} ns), cold share "
        f"of chain bound {chain / cold:.3f}")
    log("squeeze pyramid launches, each alone (warm, CUDA graph): "
        "dir lines steps ms ns/step")
    for r in per_launch:
        log(f"  {r['dir']} {r['lines']:5d} {r['steps']:5d} {r['ms']:.4f} "
            f"{r['ns_per_step']:.1f}")
    return row


def profile_decode(name: str, data: bytes, top: int = 8) -> None:
    """Where the time of one warm decode goes (profile_run)."""
    from jxl_oxide_tpu_torch import JxlImage

    profile_run(name, lambda: JxlImage.from_bytes(data).render_frame(0)
                .to_u8(), top)


@contextlib.contextmanager
def collecting_spans():
    """The messages ("name: t ms") of the port's spans (utils/trace.py:
    DEBUG records on the host clock) logged inside, on any thread."""
    import logging

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
        yield spans
    finally:
        trace_logger.removeHandler(keep)
        trace_logger.setLevel(level)


def span_totals(spans) -> dict:
    """{span name: [summed ms, count]} of collecting_spans' messages."""
    summed: dict[str, list] = {}
    for line in spans:
        span_name, ms = line.rsplit(": ", 1)
        row = summed.setdefault(span_name, [0.0, 0])
        row[0] += float(ms.split()[0])
        row[1] += 1
    return summed


def profile_run(name: str, run, top: int = 8,
                sum_spans: bool = False) -> None:
    """Where the time of one warm call of run() goes: the port's own spans
    (utils/trace.py, host clock; with sum_spans, summed by name over the
    call's threads), kernel time by name from one torch.profiler trace,
    and the share of the call's wall time in which the card ran no kernel
    or copy."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with collecting_spans() as spans, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if sum_spans:
        spans = [f"{k}: {v[0]:.2f} ms in {v[1]} spans (summed over threads)"
                 for k, v in sorted(span_totals(spans).items(),
                                    key=lambda kv: -kv[1][0])]
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
    log(f"{name} profile: call {wall_ms:.3f} ms (traced), kernels and copies "
        f"{busy:.3f} ms in {sum(v[1] for v in by_name.values())} device "
        f"ops, device idle share {max(0.0, 1 - busy / wall_ms):.3f}")
    for kname, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[
            :top]:
        log(f"  {name} {ms:8.3f} ms {n:5d}x  {kname[:80]}")


def max_lsb(a: np.ndarray, b: np.ndarray) -> int:
    """max |a - b| of two u8 images; 256 where the shapes differ."""
    if a.shape != b.shape:
        return 256
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def alpha_exact(a: np.ndarray, b: np.ndarray) -> bool:
    """The alpha channel of two [H, W, 4] images is equal (True without
    one)."""
    return a.shape[-1] != 4 or np.array_equal(a[..., 3], b[..., 3])


def epf_passes(data: bytes) -> int:
    from jxl_oxide_tpu_torch import JxlImage

    img = JxlImage.from_bytes(data, device="cpu")
    epf = img._frames[0].header.restoration_filter.epf
    return epf.iters if epf.enabled else 0


def squeeze_row(name: str, captured, probe: dict) -> dict:
    """The squeeze kernel on the launches captured from one decode: held
    against the plain version, timed warm and cold, per launch (mean over
    the decode's launches), beside its byte bound and its chain bound (its
    steps times the probe's ns a step)."""
    from jxl_oxide_tpu_torch.ops.cuda import squeeze as sq
    from jxl_oxide_tpu_torch.ops.cuda import squeeze_measure as sm

    rows = []
    for avg, res, horizontal in captured:
        check_squeeze(avg, res, horizontal)
        bound, by = sm.bound_ms(avg, res)
        steps = sm.steps(res, horizontal)
        row = {
            "ms": sm.device_ms(sq._fn(), avg, res, horizontal, cold=False),
            "cold_ms": sm.device_ms(sq._fn(), avg, res, horizontal,
                                    cold=True),
            "plain_ms": squeeze_plain_ms(avg, res, horizontal),
            "bound_ms": bound,
            "bound_by": by,
            "chain_bound_ms": sm.chain_bound_ms(res, horizontal,
                                                probe["ns_per_step"]),
        }
        rows.append(row)
        log(f"{name} squeeze {'h' if horizontal else 'v'} avg "
            f"{tuple(avg.shape)} residual {tuple(res.shape)}: equal to plain, "
            f"device warm {row['ms']:.4f} ms, cold {row['cold_ms']:.4f} ms "
            f"({row['ms'] * 1e6 / steps:.1f} / "
            f"{row['cold_ms'] * 1e6 / steps:.1f} ns a step over {steps} "
            f"steps), chain bound {row['chain_bound_ms']:.4f} ms (by: chain, "
            f"probe {probe['ns_per_step']:.3f} ns a step; SASS "
            f"{probe['sass']['inv_squeeze_h_kernel']['ops_per_step']} "
            "instructions a step on the chain), cold share of "
            f"chain bound {row['chain_bound_ms'] / row['cold_ms']:.3f}; byte "
            f"bound {bound:.4f} ms ({by}), cold share "
            f"{bound / row['cold_ms']:.3f}; plain {row['plain_ms']:.2f} ms")
    out = {k: statistics.fmean(r[k] for r in rows)
           for k in ("ms", "cold_ms", "plain_ms", "bound_ms",
                     "chain_bound_ms")}
    out["bound_by"] = rows[0]["bound_by"]
    out["cold_share_of_bound"] = out["bound_ms"] / out["cold_ms"]
    out["chain_bound_by"] = "chain (probe)"
    out["cold_share_of_chain_bound"] = out["chain_bound_ms"] / out["cold_ms"]
    return out


# the top-level spans of one frame's render_frame (render/render.py,
# render/context.py)
SPLIT_SPANS = ("Host entropy stage", "Frame device stage", "Composite")


def log_warm_split(name: str, u8: np.ndarray, run, split_spans,
                   nested=(), prepare=None) -> dict:
    """Warm timings of run() (one decode), median of 5: end to end, then
    the same decode split by the port's spans `split_spans` (host clock;
    the readback in to_u8 waits for the card, so device work queued by
    the device stage can land in "rest"), and the spans `nested` inside
    them, each on its own. With `prepare`, it runs before each decode,
    outside the timing (`cold_decode`: the decodes are then cold). Returns
    the medians by span, with "e2e"."""
    import torch

    def decode():
        if prepare is not None:
            prepare()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        return (time.perf_counter() - t0) * 1e3

    e2e_ms = [decode() for _ in range(5)]
    split = {k: [] for k in split_spans + tuple(nested) + ("rest", "wall")}
    for _ in range(5):
        with collecting_spans() as spans:
            wall = decode()
        totals = span_totals(spans)
        parts = [totals.get(k, [0.0])[0] for k in split_spans]
        for k, v in zip(split_spans, parts):
            split[k].append(v)
        for k in nested:
            split[k].append(totals.get(k, [0.0])[0])
        split["rest"].append(wall - sum(parts))
        split["wall"].append(wall)
    med = {k: statistics.median(v) for k, v in split.items()}
    mp = u8.shape[0] * u8.shape[1] / 1e6
    e2e = statistics.median(e2e_ms)
    log(f"{name}: end to end {mp / e2e * 1e3:.2f} MP/s ({e2e:.2f} ms), "
        f"{'cold' if prepare else 'warm'} median of 5; the same decode by "
        "span, median of 5: "
        + ", ".join(f"{k} {med[k]:.2f}" for k in split_spans)
        + f", rest (postprocess, readback) {med['rest']:.2f}, of "
        f"{med['wall']:.2f} ms"
        + ("; of which " + ", ".join(f"{k} {med[k]:.2f}" for k in nested)
           if nested else ""))
    med["e2e"] = e2e
    return med


def phase_decode(probe: dict) -> tuple[dict, dict]:
    """Every fixture through the entry point; returns the EPF kernel's
    report (the main path's numbers with each timed path's beside them)
    and the squeeze kernel's rows of the timed paths that launch it
    (`probe`: phase_probe's, for the chain bound)."""
    import torch

    from jxl_oxide_tpu_torch import JxlImage
    from jxl_oxide_tpu_torch.ops.cuda import epf_measure as em
    from jxl_oxide_tpu_torch.ops.cuda import squeeze as sq
    from jxl_oxide_tpu_torch.ops.cuda import squeeze_measure as sm
    from jxl_oxide_tpu_torch.ops.cuda.epf import epf_step_cuda

    paths, squeeze_paths = {}, {}
    for name in FIXTURES:
        data, ref = read_fixture(name)
        passes = epf_passes(data)

        # the counted run: launches of this decode only
        epf_step_cuda.launches = 0
        sq.inv_squeeze_cuda.launches = 0
        (u8, captured), squeezes = sm.capture_launches(
            lambda: em.capture_decode(data))
        launches = epf_step_cuda.launches
        squeeze_launches = sq.inv_squeeze_cuda.launches
        diff = max_lsb(u8, ref)
        log(f"{name}: {u8.shape}, max |u8 - reference| {diff}, EPF launches "
            f"{launches} (passes {passes}), squeeze launches "
            f"{squeeze_launches}")
        if diff > 1 or not alpha_exact(u8, ref):
            raise AssertionError(f"{name}: decode differs from reference")
        if launches != passes:
            raise AssertionError(f"{name}: {launches} EPF launches, "
                                 f"{passes} passes")
        if squeeze_launches != SQUEEZES.get(name, 0):
            raise AssertionError(f"{name}: {squeeze_launches} squeeze "
                                 f"launches, {SQUEEZES.get(name, 0)} wanted")

        log_warm_split(name, u8,
                       lambda: JxlImage.from_bytes(data).render_frame(0)
                       .to_u8(), SPLIT_SPANS)

        if name in TIMED:
            profile_decode(name, data)
            paths[name] = {"launches": launches, **pass_rows(name, captured)}
            if squeezes:
                squeeze_paths[name] = {"launches": squeeze_launches,
                                       **squeeze_row(name, squeezes, probe)}
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
    }, squeeze_paths


def read_fixture(name: str) -> tuple[bytes, np.ndarray | None]:
    """A committed stream and its reference u8 (None for the streams
    committed without one)."""
    tdir = os.path.join(REPO, "jxl_oxide_tpu_torch", "testdata")
    with open(os.path.join(tdir, f"{name}.jxl"), "rb") as f:
        data = f.read()
    ref_path = os.path.join(tdir, f"{name}.npz")
    ref = np.load(ref_path)["u8"] if os.path.exists(ref_path) else None
    return data, ref


def device_ops(run) -> collections.Counter:
    """Device ops (kernels, copies, sets) of one call of run() in a
    torch.profiler trace, counted by name; empty when the trace holds no
    device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return collections.Counter(e.name for e in prof.events()
                               if e.device_type == DeviceType.CUDA)


def phase_serving(device) -> dict:
    """The serving path: one decode_batch_stacked
    call over SERVING on `device`, held against the per-image decodes and
    the references, its K1 launches counted; then timed. Returns K1's row
    of the stacked path."""
    import torch

    from jxl_oxide_tpu_torch import JxlImage, decode_batch
    from jxl_oxide_tpu_torch import decode_batch_stacked
    from jxl_oxide_tpu_torch.ops.cuda import epf as kernel
    from jxl_oxide_tpu_torch.ops.cuda import squeeze as sq
    from jxl_oxide_tpu_torch.ops.cuda.epf import epf_step_cuda
    from jxl_oxide_tpu_torch.ops.vardct_pipeline import (
        stack_inputs,
        upload_inputs,
    )
    from jxl_oxide_tpu_torch.render.render import host_stage
    from jxl_oxide_tpu_torch.render.vardct import VardctFrameState
    from jxl_oxide_tpu_torch.utils.options import use_decode_device

    fixtures = {n: read_fixture(n) for n in dict.fromkeys(SERVING)}
    streams = [fixtures[n][0] for n in SERVING]
    mp = sum(img.width * img.height for img in (
        JxlImage.from_bytes(d, device="cpu") for d in streams)) / 1e6
    # the per-image decodes every stacked result is held against
    def render(d):
        return JxlImage.from_bytes(d, device=device).render_frame(0)

    per_u8 = {n: render(d).to_u8() for n, (d, _) in fixtures.items()}
    per_dev = {n: render(d).image_device() for n, (d, _) in fixtures.items()}
    # K1 launches of the call: one per EPF pass of each stacked group (the
    # flagship 8, the four alpha streams, the two 4:2:0 streams), and the
    # per-image Modular stream's own passes
    groups = ("flagship_1024", "flagship_alpha_1024", "ycbcr420_1024")
    expected = (sum(epf_passes(fixtures[g][0]) for g in groups)
                + epf_passes(fixtures["modular_xyb_512"][0]))

    # the counted run; the 8-image group's EPF inputs are kept
    captured = []

    def keep(planes, sigma, step, cs, sm, bsm):
        if planes.dim() == 4 and planes.shape[0] == 8:
            captured.append((planes.clone(), sigma.clone(), step, cs, sm,
                             bsm))

    epf_step_cuda.launches = 0
    sq.inv_squeeze_cuda.launches = 0
    with watching(kernel, "epf_step_cuda", keep):
        got = decode_batch_stacked(streams, output="u8", device=device)
    launches = epf_step_cuda.launches
    squeezes = sq.inv_squeeze_cuda.launches
    log(f"serving: decode_batch_stacked of {len(streams)} streams: EPF "
        f"launches {launches} (stacked groups' passes {expected}), squeeze "
        f"launches {squeezes}")
    if launches != expected:
        raise AssertionError(f"serving: {launches} EPF launches, "
                             f"{expected} wanted")

    differing = 0
    for name, img in zip(SERVING, got):
        mine, ref = per_u8[name], fixtures[name][1]
        if img.shape != mine.shape:
            raise AssertionError(f"serving {name}: shape {img.shape}, "
                                 f"per-image {mine.shape}")
        differing += int((img != mine).any(axis=-1).sum())
        if max_lsb(img, mine) > 1 or not alpha_exact(img, mine):
            raise AssertionError(f"serving {name}: differs from the "
                                 "per-image decode")
        if ref is not None and (max_lsb(img, ref) > 1
                                or not alpha_exact(img, ref)):
            raise AssertionError(f"serving {name}: differs from reference")
    got_dev = decode_batch_stacked(streams, output="device", device=device)
    torch.cuda.synchronize()
    dev_differing = 0
    for name, t in zip(SERVING, got_dev):
        if t.device != per_dev[name].device or t.shape != per_dev[name].shape:
            raise AssertionError(f"serving {name}: output=device gave "
                                 f"{t.device} {tuple(t.shape)}")
        dev_differing += int((t != per_dev[name]).any(dim=-1).sum().item())
    log(f"serving: u8 results against the per-image decodes: {differing} "
        f"differing pixels; output=device: {dev_differing} differing "
        "pixels; every fixture within 1 LSB of its reference, alpha exact")

    # warm, median of 5
    def timed(fn) -> float:
        fn()
        ts = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts)

    t_stacked = timed(lambda: decode_batch_stacked(streams, output="u8",
                                                   device=device))
    t_batch = timed(lambda: decode_batch(streams, output="u8",
                                         device=device))
    t_seq = timed(lambda: [render(d).to_u8() for d in streams])
    log(f"serving {mp:.2f} MP in {len(streams)} streams, warm median of 5: "
        f"decode_batch_stacked {t_stacked * 1e3:.2f} ms "
        f"({mp / t_stacked:.2f} MP/s), decode_batch {t_batch * 1e3:.2f} ms "
        f"({mp / t_batch:.2f} MP/s), sequential per-image "
        f"{t_seq * 1e3:.2f} ms ({mp / t_seq:.2f} MP/s)")

    profile_run("serving", lambda: decode_batch_stacked(
        streams, output="u8", device=device), sum_spans=True)

    # the 8-image flagship group against one image: host enqueue time and
    # device ops of the stacked program alone
    data = fixtures["flagship_1024"][0]
    parts = []
    for _ in range(8):
        with use_decode_device(device):
            host = host_stage(JxlImage.from_bytes(data, device=device)
                              ._frames[0])
        parts.append(host.state.fused_program_parts(host.hf_global))
    key, make_fn, _ = parts[0]
    fn = VardctFrameState.program(key, make_fn, device)
    row = {}
    for n in (1, 8):
        placed = upload_inputs(stack_inputs([p[2] for p in parts[:n]]),
                               device)
        fn.stacked(*placed)
        ts = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn.stacked(*placed)
            ts.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        row[n] = (statistics.median(ts) * 1e3,
                  device_ops(lambda: fn.stacked(*placed)))
    (e1, names1), (e8, names8) = row[1], row[8]
    ops1, ops8 = sum(names1.values()) or None, sum(names8.values()) or None
    log(f"serving: flagship stacked program, host enqueue {e8:.2f} ms for 8 "
        f"images, {e1:.2f} ms for 1 (warm median of 5); torch.profiler "
        f"device ops {ops8} for 8, {ops1} for 1")
    for name in sorted(set(names1) | set(names8)):
        if names1[name] != names8[name]:
            log(f"  device op count 1 -> 8 images: {names1[name]} -> "
                f"{names8[name]}  {name[:90]}")
    if ops1 is None or ops8 is None:
        log("serving: torch.profiler recorded no device ops (not measured)")
    elif ops8 > 1.1 * ops1:
        raise AssertionError(f"serving: {ops8} device ops for 8 images, "
                             f"{ops1} for one")

    # the stacked EPF passes of the counted run, on the card's clock
    if len(captured) != epf_passes(data):
        raise AssertionError(f"serving: {len(captured)} stacked flagship "
                             "passes captured")
    return {
        "launches": launches,
        **pass_rows("serving", captured),
        "stack": 8,
        "differing_pixels": differing + dev_differing,
        "mp_per_s": {"stacked": mp / t_stacked, "decode_batch": mp / t_batch,
                     "sequential": mp / t_seq},
        "enqueue_ms": {"1": e1, "8": e8},
        "device_ops": {"1": ops1, "8": ops8},
    }


@contextlib.contextmanager
def counting_renders():
    """Within the block, the frames rendered (api.py's cone workers and
    render/context.py's inline render), each with the decode device its
    thread saw: a worker without the decode's context would see the CPU."""
    from jxl_oxide_tpu_torch import api
    from jxl_oxide_tpu_torch.render import context
    from jxl_oxide_tpu_torch.utils import options as opts

    seen = []

    def see(frame, device):
        seen.append((frame, opts.get_decode_device().type))

    with watching(api, "render_frame", see), \
            watching(context, "render_frame", see):
        yield seen


def phase_animation(device) -> dict:
    """Multi-frame streams on the card (this slice's path): every keyframe
    of ANIMATIONS decoded against its expected output, the cone of the
    last keyframe rendered cold with K1's launches counted (2 per filtered
    frame rendered; none for the cached keyframes after it), K1 held on a
    [1, 3, 45, 77] plane and on every pass of the counted runs, then
    timed: per keyframe and per cone, warm median of 5, and one traced
    cone by span and kernel. Returns K1's rows of the animation paths."""
    import torch

    from jxl_oxide_tpu_torch import JxlImage
    from jxl_oxide_tpu_torch.ops.cuda import epf as kernel
    from jxl_oxide_tpu_torch.ops.cuda import epf_measure as em
    from jxl_oxide_tpu_torch.ops.cuda import squeeze as sq
    from jxl_oxide_tpu_torch.ops.cuda.epf import epf_step_cuda

    # K1 on a plane smaller than one tile, W % 4 != 0 (cp.async)
    p, s = em.epf_inputs((3, 45, 77), seed=45)
    planes = torch.from_numpy(p).to(device)[None]
    sigma = torch.from_numpy(s).to(device)[None]
    worst = max(check_kernel(planes, sigma, step, em.CHANNEL_SCALE, sm,
                             em.BORDER_SAD_MUL) for step, sm in em.STEPS)
    log(f"animation: epf steps 0-2 on (1, 3, 45, 77) cp.async: max|diff| "
        f"{worst:.3g}")

    paths = {}
    for name, passes, exact in ANIMATIONS:
        data, ref = read_fixture(name)
        if name == "animation_4f_blend":
            ref = np.stack(animation_4f_frames())
        elif ref.ndim == 3:
            ref = ref[None]
        img = JxlImage.from_bytes(data, device=device)
        last = img.num_keyframes - 1
        cone, _ = img._dependency_cone(img._keyframe_index(last))

        # the counted run: the last keyframe's cone, cold
        captured = []

        def keep(planes, sigma, step, cs, sm, bsm):
            captured.append((planes.clone(), sigma.clone(), step, cs, sm,
                             bsm))

        epf_step_cuda.launches = 0
        sq.inv_squeeze_cuda.launches = 0
        with counting_renders() as seen, watching(kernel, "epf_step_cuda",
                                                  keep):
            u8 = {last: img.render_frame(last).to_u8()}
        launches = epf_step_cuda.launches
        squeezes = sq.inv_squeeze_cuda.launches
        rendered = len(seen)
        devices = {d for _, d in seen}
        log(f"{name}: keyframe {last} cold: {len(seen)} frames rendered "
            f"(cone {len(cone)}) on {sorted(devices)}, EPF launches "
            f"{launches} ({passes} per frame), squeeze launches {squeezes}")
        if len(seen) != len(cone) or devices != {device.type}:
            raise AssertionError(f"{name}: frames rendered {len(seen)} on "
                                 f"{devices}, cone {len(cone)} on "
                                 f"{device.type}")
        if launches != passes * len(seen) or squeezes:
            raise AssertionError(f"{name}: {launches} EPF launches for "
                                 f"{len(seen)} frames of {passes} passes")
        # the keyframes before it: those its cone composited come from the
        # cache (no render, no launch), the others render their own cones
        hits = []
        for k in range(last):
            cached = img._keyframe_cache.get(k)
            kcone, _ = img._dependency_cone(img._keyframe_index(k))
            epf_step_cuda.launches = 0
            with counting_renders() as seen:
                u8[k] = img.render_frame(k).to_u8()
            if cached is not None:
                hits.append(k)
                ok = (img._keyframe_cache.get(k) is cached and not seen
                      and not epf_step_cuda.launches)
            else:
                ok = (len(seen) == len(kcone)
                      and epf_step_cuda.launches == passes * len(seen))
            if not ok:
                raise AssertionError(
                    f"{name}: keyframe {k} (cached: {cached is not None}) "
                    f"rendered {len(seen)} frames with "
                    f"{epf_step_cuda.launches} EPF launches")
        got = np.stack([u8[k] for k in range(last + 1)])
        diff = max_lsb(got, ref)
        log(f"{name}: {got.shape}, max |u8 - expected| {diff} over "
            f"{last + 1} keyframes; cache hits (no render, no EPF launch): "
            f"keyframes {hits}")
        if diff > (0 if exact else 1) or not alpha_exact(got, ref):
            raise AssertionError(f"{name}: decode differs from expected")

        # warm, median of 5: each keyframe on a fresh image (its own cone)
        # and the last keyframe's cone then every cached keyframe
        def timed(fn) -> float:
            fn()
            ts = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ts.append(time.perf_counter() - t0)
            return statistics.median(ts) * 1e3

        def fresh():
            return JxlImage.from_bytes(data, device=device)

        per_kf = [timed(lambda k=k: fresh().render_frame(k).to_u8())
                  for k in range(last + 1)]

        def all_keyframes():
            im = fresh()
            for k in range(last, -1, -1):
                im.render_frame(k).to_u8()

        cone_ms = timed(all_keyframes)
        mp = got.shape[1] * got.shape[2] / 1e6
        log(f"{name}: warm median of 5, one keyframe on a fresh image: "
            + ", ".join(f"{k}: {t:.2f} ms" for k, t in enumerate(per_kf))
            + f"; every keyframe on one image, last first (the cone of "
            f"keyframe {last}, then the rest): {cone_ms:.2f} ms ({(last + 1) * mp / cone_ms * 1e3:.2f} "
            "MP/s of keyframes)")
        profile_run(name, lambda: fresh().render_frame(last).to_u8(),
                    sum_spans=True)
        if captured:
            paths[name] = {"launches": launches, "frames": rendered,
                           **pass_rows(name, captured)}
            paths[name]["max_abs_err"] = max(paths[name]["max_abs_err"],
                                             worst)
    return paths


def tone_map_lums(color, run) -> tuple:
    """run()'s result and the luminance (host numpy) that each BT.2408
    tone map of it read (ops/color.py `tone_map_rec2408`, looked up on its
    module at each call)."""
    lums = []

    def see(r, g, b, luminances, *rest):
        lums.append(color._luma(r, g, b, luminances).cpu().numpy())

    with watching(color, "tone_map_rec2408", see):
        out = run()
    return out, lums


# phase_color's split adds the colour tail's span (api.py `_final_color`)
COLOR_SPANS = SPLIT_SPANS + ("Transform to requested color encoding",)


def phase_color(probe: dict) -> tuple[dict, dict]:
    """Colour encodings on the card, with Pillow blocked (no leg here needs
    a CMS): COLOR_FIXTURES, each within 1 LSB of its reference with its
    K1 and K9 launches counted; flagship_1024 under each requested
    encoding; the COLOR_TIMED fixtures' launches held against the plain
    versions and timed; warm medians by span. Returns K1's and K9's rows
    of the colour paths."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from make_torch_port_fixtures import REQUESTS_U16, requested_encodings

    from jxl_oxide_tpu_torch import JxlImage
    from jxl_oxide_tpu_torch.headers import image
    from jxl_oxide_tpu_torch.ops import color
    from jxl_oxide_tpu_torch.ops.cuda import epf_measure as em
    from jxl_oxide_tpu_torch.ops.cuda import squeeze as sq
    from jxl_oxide_tpu_torch.ops.cuda import squeeze_measure as sm
    from jxl_oxide_tpu_torch.ops.cuda.epf import epf_step_cuda

    k1_paths, k9_paths = {}, {}
    pil = sys.modules.get("PIL")
    sys.modules["PIL"] = None  # an import of Pillow raises ImportError
    try:
        for name, k1, k9 in COLOR_FIXTURES:
            data, ref = read_fixture(name)
            # the counted run: launches of this decode only
            epf_step_cuda.launches = 0
            sq.inv_squeeze_cuda.launches = 0
            ((u8, captured), squeezes), lum = tone_map_lums(
                color, lambda: sm.capture_launches(
                    lambda: em.capture_decode(data)))
            got = (epf_step_cuda.launches, sq.inv_squeeze_cuda.launches)
            if u8.shape != ref.shape:
                raise AssertionError(f"{name}: shape {u8.shape}")
            off = np.abs(u8.astype(np.int32) - ref).max(-1)
            crossed = np.zeros(off.shape, bool)
            if lum:
                # the same decode on the CPU: the side of the step each saw
                _, lum_cpu = tone_map_lums(
                    color, lambda: JxlImage.from_bytes(data, device="cpu")
                    .render_frame(0).to_u8())
                for a, b in zip(lum, lum_cpu):
                    crossed |= ((np.abs(a) <= TONE_MAP_STEP)
                                != (np.abs(b) <= TONE_MAP_STEP))
            diff = int(off[~crossed].max())
            log(f"{name}: {u8.shape}, max |u8 - reference| {diff}, K1 "
                f"launches {got[0]}, K9 launches {got[1]} (wanted {k1}, "
                f"{k9})" + (f"; tone map: {int(crossed.sum())} pixels' "
                            "luminance crossed its step against the CPU "
                            "decode's, of them more than 1 LSB off: "
                            f"{int((off[crossed] > 1).sum())}" if lum else ""))
            if diff > 1 or (u8.shape[-1] in (2, 4) and not np.array_equal(
                    u8[..., -1], ref[..., -1])):
                raise AssertionError(f"{name}: decode differs from reference")
            if crossed.sum() > TONE_MAP_CROSSED_MAX * crossed.size:
                raise AssertionError(f"{name}: {int(crossed.sum())} pixels "
                                     "crossed the tone map's step")
            if got != (k1, k9):
                raise AssertionError(f"{name}: launches {got}, wanted "
                                     f"{(k1, k9)}")
            log_warm_split(name, u8,
                           lambda: JxlImage.from_bytes(data).render_frame(0)
                           .to_u8(), COLOR_SPANS)
            if name in COLOR_TIMED:
                profile_decode(name, data)
                k1_paths[name] = {"launches": got[0],
                                  **pass_rows(name, captured)}
                if squeezes:
                    k9_paths[name] = {"launches": got[1],
                                      **squeeze_row(name, squeezes, probe)}

        data, _ = read_fixture(MAIN_PATH)
        refs = np.load(os.path.join(REPO, "jxl_oxide_tpu_torch", "testdata",
                                    "flagship_1024_requests.npz"))
        passes = epf_passes(data)
        for req, enc in requested_encodings(image).items():
            def render():
                img = JxlImage.from_bytes(data)
                img.request_color_encoding(enc)
                return img.render_frame(0)

            epf_step_cuda.launches = 0
            r = render()
            u8 = r.to_u8()
            diff = max_lsb(u8, refs[f"u8_{req}"])
            line = (f"{MAIN_PATH} requested {req}: {u8.shape}, max |u8 - "
                    f"reference| {diff}, K1 launches {epf_step_cuda.launches}")
            diff16 = 0
            if req in REQUESTS_U16:
                diff16 = max_lsb(r.to_u16(), refs[f"u16_{req}"])
                line += f", max |u16 - reference| {diff16}"
            log(line)
            if (diff > 1 or diff16 > REQUEST_U16_TOL
                    or epf_step_cuda.launches != passes):
                raise AssertionError(f"{MAIN_PATH} requested {req}: u8 "
                                     f"{diff}, u16 {diff16} LSB, "
                                     f"{epf_step_cuda.launches} K1 launches")
            log_warm_split(f"{MAIN_PATH} requested {req}", u8,
                           lambda: render().to_u8(), COLOR_SPANS)
    finally:
        if pil is None:
            del sys.modules["PIL"]
        else:
            sys.modules["PIL"] = pil
    return k1_paths, k9_paths


# the render pipeline's fixtures (phase_features): (name, K1 launches, K12
# launches) of one decode on the card: splines, noise and x2 upsampling of
# a filtered 512^2 frame (the slice's main path); an LF frame under a
# filtered 1024^2 frame (the fused program's LF override); a two-level XYB
# LF chain; an alpha at dim_shift 2 (K10 x4 on it)
FEATURE_FIXTURES = (("features_up2_1024", 2, 1), ("lf_frame_1024", 2, 0),
                    ("lf_chain_xyb_512", 0, 0), ("alpha_shift_512", 0, 0))
FEATURE_PATH = "features_up2_1024"
# the fixtures whose K1 passes are held against the plain version and timed
FEATURE_TIMED = ("features_up2_1024", "lf_frame_1024")
# the spans of the feature pass, the upsampling and the LF slot, inside
# "Composite" (an LF frame's upsampling inside "LF frame")
FEATURE_SPANS = ("Splines", "Noise", "Upsampling", "LF frame")
# K12 against its plain version, bit for bit: (W, H, group_dim, timed):
# one pixel, W % 16 != 0, partial groups at the right and bottom edges,
# one group, 2048^2; timed at 1024^2 and 2048^2 in 256^2 groups (an
# encoder's default) and at features_up2_1024's field, one 1024^2 group
NOISE_SHAPES = ((1, 1, 128, False), (17, 5, 128, False),
                (300, 260, 128, False), (513, 130, 256, False),
                (256, 256, 256, False), (1024, 1024, 256, True),
                (2048, 2048, 256, True), (1024, 1024, 1024, True))
# 32-bit integer operations of one XorShift128+ step and its two floats:
# the 64-bit add, three 64-bit shifts and three xors (two halves each),
# and a shift and an or per float; counted against the fp32 rate outside
# the tensor cores, as the squeeze's are (the data sheet gives no integer
# rate)
NOISE_OPS_PER_STEP = 20


def noise_bound_ms(w: int, h: int, gdim: int) -> tuple[float, str, int]:
    """K12's least time on a w x h field in gdim groups: the field's bytes
    (written once) over the HBM rate against its integer operations over
    the ALU rate; which of the two; and its XorShift128+ steps in all."""
    from jxl_oxide_tpu_torch.ops.cuda import squeeze_measure as sm
    from jxl_oxide_tpu_torch.ops.noise import N_LANES, noise_groups

    steps = sum(N_LANES * wn2 * gh * 3
                for *_, gh, wn2 in noise_groups(w, h, gdim))
    byte_ms = 3 * h * w * 4 / sm.HBM_BYTES_PER_S * 1e3
    op_ms = NOISE_OPS_PER_STEP * steps / sm.ALU_OPS_PER_S * 1e3
    return (max(byte_ms, op_ms), "bytes" if byte_ms >= op_ms
            else "operations", steps)


def noise_device_ms(w: int, h: int, gdim: int, seed0: int) -> tuple:
    """K12's device ms per launch on the card's clock, warm (20 launches
    back to back between two CUDA events) and cold (the L2 overwritten
    before each of 5 launches, each between its own events)."""
    import torch

    from jxl_oxide_tpu_torch.ops.cuda import noise as k12
    from jxl_oxide_tpu_torch.ops.cuda import squeeze_measure as sm

    out = torch.empty((3, h, w), dtype=torch.float32, device="cuda")
    for _ in range(3):
        k12.launch(out, gdim, seed0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        k12.launch(out, gdim, seed0)
    end.record()
    torch.cuda.synchronize()
    warm = start.elapsed_time(end) / 20
    flush = torch.empty(int(2 * sm.L2_BYTES) // 4, dtype=torch.float32,
                        device="cuda")
    cold = []
    for _ in range(5):
        flush.fill_(1.0)
        start.record()
        k12.launch(out, gdim, seed0)
        end.record()
        torch.cuda.synchronize()
        cold.append(start.elapsed_time(end))
    return warm, statistics.fmean(cold)


def phase_noise(device) -> dict:
    """K12 against its plain version (ops/noise.py, numpy on the host) on
    NOISE_SHAPES, bit for bit; the timed shapes timed warm and cold beside
    their bound and their serial steps a lane. Returns the rows by shape."""
    import torch

    from jxl_oxide_tpu_torch.ops.cuda.noise import noise_field_cuda
    from jxl_oxide_tpu_torch.ops.noise import (
        noise_field_plain,
        noise_seed0,
        noise_steps,
    )

    seed0 = noise_seed0(1, 0)
    rows = {}
    for w, h, gdim, timed in NOISE_SHAPES:
        got = noise_field_cuda(w, h, gdim, seed0, device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = noise_field_plain(w, h, gdim, seed0)
        plain_ms = (time.perf_counter() - t0) * 1e3
        differ = int((got.cpu().numpy().view(np.uint32)
                      != want.view(np.uint32)).sum())
        line = (f"noise field {w}x{h} in {gdim}^2 groups: {differ} samples "
                "differ from the plain version")
        if differ:
            log(line)
            raise AssertionError(f"K12 {w}x{h}/{gdim}: {differ} samples "
                                 "differ from the plain version")
        if timed:
            warm, cold = noise_device_ms(w, h, gdim, seed0)
            bound, by, steps = noise_bound_ms(w, h, gdim)
            lane = noise_steps(w, h, gdim)
            rows[(w, h, gdim)] = {
                "ms": warm, "cold_ms": cold, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": by,
                "cold_share_of_bound": bound / cold,
                "steps_per_lane": lane, "steps": steps,
                "ns_per_step": warm * 1e6 / lane,
            }
            line += (f"; device warm {warm:.4f} ms, cold {cold:.4f} ms, "
                     f"bound {bound:.4f} ms ({by}; {steps} steps in all), "
                     f"cold share {bound / cold:.4f}; {lane} serial steps a "
                     f"lane, {warm * 1e6 / lane:.2f} ns a step; plain "
                     f"(numpy, host) {plain_ms:.1f} ms")
        log(line)
    return rows


def phase_features(device) -> tuple[dict, dict]:
    """The rest of the render pipeline on the card (this slice's paths):
    K12 held and timed (phase_noise); each of FEATURE_FIXTURES decoded
    within 1 LSB of its reference (alpha exactly), its K1 and K12
    launches counted from 0 just before the decode and read just after;
    the FEATURE_TIMED fixtures' K1 passes held against the plain version
    and timed, and one traced decode each; warm medians of 5 by span.
    Returns K1's rows of these paths and K12's row."""
    from jxl_oxide_tpu_torch import JxlImage
    from jxl_oxide_tpu_torch.ops.cuda import epf_measure as em
    from jxl_oxide_tpu_torch.ops.cuda import noise as k12
    from jxl_oxide_tpu_torch.ops.cuda import squeeze as sq
    from jxl_oxide_tpu_torch.ops.cuda.epf import epf_step_cuda
    from jxl_oxide_tpu_torch.ops.cuda.noise import noise_field_cuda

    shapes = phase_noise(device)
    k1_paths, k12_launches = {}, None
    for name, k1, k12_want in FEATURE_FIXTURES:
        data, ref = read_fixture(name)
        fields = []
        epf_step_cuda.launches = 0
        noise_field_cuda.launches = 0
        sq.inv_squeeze_cuda.launches = 0
        with watching(k12, "noise_field_cuda",
                      lambda *args: fields.append(args[:3])):
            u8, captured = em.capture_decode(data)
        got = (epf_step_cuda.launches, noise_field_cuda.launches)
        if sq.inv_squeeze_cuda.launches:
            raise AssertionError(f"{name}: {sq.inv_squeeze_cuda.launches} "
                                 "K9 launches, none wanted")
        diff = max_lsb(u8, ref)
        log(f"{name}: {u8.shape}, max |u8 - reference| {diff}, K1 launches "
            f"{got[0]}, K12 launches {got[1]} (wanted {k1}, {k12_want}); "
            f"noise fields (W, H, group) {fields}")
        if diff > 1 or not alpha_exact(u8, ref):
            raise AssertionError(f"{name}: decode differs from reference")
        if got != (k1, k12_want):
            raise AssertionError(f"{name}: launches {got}, wanted "
                                 f"{(k1, k12_want)}")
        if name == FEATURE_PATH:
            k12_launches = got[1]
            field_shape = fields[0]
        log_warm_split(name, u8,
                       lambda: JxlImage.from_bytes(data).render_frame(0)
                       .to_u8(), SPLIT_SPANS, FEATURE_SPANS)
        if name in FEATURE_TIMED:
            profile_decode(name, data)
            k1_paths[name] = {"launches": got[0],
                              **pass_rows(name, captured)}
    main = shapes[field_shape]
    k12_row = {
        "name": "noise_field",
        "route": "cuda",
        "source": "jxl_oxide_tpu_torch/csrc/noise.cu",
        "replaces": "jxl_oxide_tpu/render/features.py:419 _noise_field "
                    "(host numpy; no TPU kernel)",
        "launches": k12_launches,
        # integer bits: every comparison was equality
        "max_abs_err": 0,
        **main,
        "library_ms": None,
        "shapes": {f"{w}x{h}/{g}": row for (w, h, g), row in shapes.items()},
    }
    return k1_paths, k12_row


# the progressive fixtures (phase_progressive): (name, K1 launches and
# least K9 launches of one loading render on the card); each is fed at
# the cuts of its <name>_progressive.npz (tools/make_torch_port_fixtures.py
# `progressive_cuts`: before HfGlobal, half of pass 0, pass 0 or all groups
# but one, the whole stream)
PROGRESSIVE = (("flagship_1024", 2, 0), ("passes3_1024", 2, 0),
               ("modular_1024", 2, 1))


def loading_feed(data: bytes, cuts, device, spans: bool = False) -> tuple:
    """One feed of `data` at `cuts` to a new JxlImage on `device`, with
    render_loading_frame().to_u8() after each piece: the host ms of each
    feed_bytes and of each render (to_u8 waits for the card), and with
    `spans` each render's span totals."""
    import torch

    from jxl_oxide_tpu_torch import JxlImage

    img = JxlImage(device=device)
    feed_ms, render_ms, split = [], [], []
    prev = 0
    for cut in cuts:
        t0 = time.perf_counter()
        img.feed_bytes(data[prev:cut])
        feed_ms.append((time.perf_counter() - t0) * 1e3)
        prev = cut
        torch.cuda.synchronize()
        with (collecting_spans() if spans
              else contextlib.nullcontext([])) as got:
            t0 = time.perf_counter()
            img.render_loading_frame().to_u8()
            render_ms.append((time.perf_counter() - t0) * 1e3)
        split.append(span_totals(got))
    return feed_ms, render_ms, split


def phase_progressive(device, probe: dict) -> tuple[dict, dict]:
    """Progressive and partial decode on the card (this slice's path):
    each of PROGRESSIVE fed at its committed cuts through JxlImage() and
    render_loading_frame, each render held against the JAX package's
    loading render and its kernels counted and held, the last against the
    one-shot decode; then warm timings by call and by span, the kernels
    timed on the last render's inputs, one traced feed. Returns K1's and
    K9's rows of these paths."""
    import torch

    from jxl_oxide_tpu_torch import JxlImage
    from jxl_oxide_tpu_torch.ops.cuda import epf as k1mod
    from jxl_oxide_tpu_torch.ops.cuda import squeeze as sq
    from jxl_oxide_tpu_torch.ops.cuda.epf import epf_step_cuda
    from jxl_oxide_tpu_torch.ops.cuda.noise import noise_field_cuda
    from jxl_oxide_tpu_torch.render.vardct import VardctFrameState

    k1_paths, k9_paths = {}, {}
    tdir = os.path.join(REPO, "jxl_oxide_tpu_torch", "testdata")
    for name, k1_want, k9_least in PROGRESSIVE:
        data, _ = read_fixture(name)
        ref = np.load(os.path.join(tdir, f"{name}_progressive.npz"))
        cuts = [int(c) for c in ref["cuts"]]

        # the counted feed: every count from 0 just before each render
        img = JxlImage()
        builds = VardctFrameState.program_builds
        k1_seen, k9_seen, worst = [], [], 0.0
        prev = 0
        for k, cut in enumerate(cuts):
            img.feed_bytes(data[prev:cut])
            prev = cut
            eps, sqs = [], []
            epf_step_cuda.launches = 0
            sq.inv_squeeze_cuda.launches = 0
            noise_field_cuda.launches = 0
            with watching(k1mod, "epf_step_cuda", lambda *a: eps.append(
                    (a[0].clone(), a[1].clone(), *a[2:]))), \
                    watching(sq, "inv_squeeze_cuda", lambda *a: sqs.append(
                        (a[0].clone(), a[1].clone(), a[2]))):
                u8 = img.render_loading_frame().to_u8()
            got = (epf_step_cuda.launches, sq.inv_squeeze_cuda.launches,
                   noise_field_cuda.launches)
            count = img._frames[0]._progressive_cache.sections_decoded()
            diff = max_lsb(u8, ref["u8"][k])
            for args in eps:
                worst = max(worst, check_kernel(*args))
            for args in sqs:
                check_squeeze(*args)
            log(f"{name} loading render {k} at byte {cut} of {len(data)}: "
                f"max |u8 - JAX loading render| {diff}, sections {count} "
                f"(JAX {int(ref['sections'][k])}), K1 launches {got[0]}, K9 "
                f"{got[1]}, K12 {got[2]}; each K1 pass within "
                f"{worst:.3g} of plain, each K9 launch equal to plain")
            if diff > 1 or count != int(ref["sections"][k]):
                raise AssertionError(f"{name} render {k}: {diff} LSB, "
                                     f"{count} sections")
            if (got[0] != k1_want or got[2]
                    or not (got[1] >= k9_least if k9_least else not got[1])):
                raise AssertionError(f"{name} render {k}: launches {got}")
            k1_seen.append((got[0], eps))
            k9_seen.append((got[1], sqs))
        builds = VardctFrameState.program_builds - builds
        one = JxlImage.from_bytes(data).render_frame(0).to_u8()
        log(f"{name}: last loading render equal to the one-shot decode: "
            f"{bool(np.array_equal(u8, one))}; fused programs built during "
            f"the feed {builds}")
        if not np.array_equal(u8, one):
            raise AssertionError(f"{name}: last loading render differs from "
                                 "the one-shot decode")

        # warm: one feed to warm up, then medians of 5, untraced and split
        loading_feed(data, cuts, device)
        plain = [loading_feed(data, cuts, device) for _ in range(5)]
        split = [loading_feed(data, cuts, device, spans=True)
                 for _ in range(5)]
        calls = [statistics.median(f[1][k] for f in plain)
                 for k in range(len(cuts))]
        feeds = statistics.median(sum(f[0]) for f in plain)
        total = statistics.median(sum(f[0]) + sum(f[1]) for f in plain)
        for k in range(len(cuts)):
            # the split runs' own wall time less their spans: the rest
            parts = {sp: statistics.median(
                f[2][k].get(sp, [0.0])[0] for f in split)
                for sp in SPLIT_SPANS}
            rest = statistics.median(
                f[1][k] - sum(f[2][k].get(sp, [0.0])[0] for sp in SPLIT_SPANS)
                for f in split)
            log(f"{name} loading render {k} warm, median of 5: "
                f"{calls[k]:.2f} ms; the same call by span, median of 5: "
                + ", ".join(f"{sp} {v:.2f}" for sp, v in parts.items())
                + f", rest (postprocess, readback) {rest:.2f}")
        one_shot = log_warm_split(
            f"{name} one-shot", one,
            lambda: JxlImage.from_bytes(data).render_frame(0).to_u8(),
            SPLIT_SPANS)["e2e"]
        log(f"{name}: a whole feed, warm, median of 5: {total:.2f} ms "
            f"({len(cuts)} renders {sum(calls):.2f} ms, feed_bytes "
            f"{feeds:.2f} ms) against one one-shot decode "
            f"{one_shot:.2f} ms: {total / one_shot:.2f}x")
        profile_run(f"{name} loading feed",
                    lambda: loading_feed(data, cuts, device),
                    sum_spans=True)

        n_k1 = sum(n for n, _ in k1_seen)
        k1_paths[f"{name} loading"] = {
            "launches": n_k1, "renders": len(cuts), "program_builds": builds,
            **pass_rows(f"{name} loading", k1_seen[-1][1])}
        k1_paths[f"{name} loading"]["max_abs_err"] = max(
            k1_paths[f"{name} loading"]["max_abs_err"], worst)
        n_k9 = sum(n for n, _ in k9_seen)
        if n_k9:
            k9_paths[f"{name} loading"] = {
                "launches": n_k9, "renders": len(cuts),
                **squeeze_row(f"{name} loading", k9_seen[-1][1], probe)}
    return k1_paths, k9_paths


# the extra-channel fixtures (phase_extra_channels): (name, K1 and K9
# launches of rendering every keyframe in order on the card, keyframes);
# ec_mix_1024's squeeze runs on the device tail with an f16 alpha beside
# it, ec_blend_premul_512 blends over an associated alpha
EC_FIXTURES = (("ec_mix_1024", 2, 1, 1), ("ec_blend_premul_512", 6, 0, 3))


def render_all(data: bytes) -> list:
    """Every keyframe of `data` on the card, in order: (to_u8(),
    image_all_channels()) of each."""
    from jxl_oxide_tpu_torch import JxlImage

    img = JxlImage.from_bytes(data)
    renders = [img.render_frame(k) for k in range(img.num_keyframes)]
    return [(r.to_u8(), r.image_all_channels()) for r in renders]


@contextlib.contextmanager
def capturing_kernels():
    """Within the block, K1's and K9's launches with their inputs copied
    (each launch still goes through its counted wrapper): two lists of
    argument tuples, as check_kernel and check_squeeze take them."""
    from jxl_oxide_tpu_torch.ops.cuda import epf as k1mod
    from jxl_oxide_tpu_torch.ops.cuda import squeeze as sq

    eps, sqs = [], []
    with watching(k1mod, "epf_step_cuda", lambda *a: eps.append(
            (a[0].clone(), a[1].clone(), *a[2:]))), \
            watching(sq, "inv_squeeze_cuda", lambda *a: sqs.append(
                (a[0].clone(), a[1].clone(), a[2]))):
        yield eps, sqs


def reset_counts() -> None:
    from jxl_oxide_tpu_torch.ops.cuda.epf import epf_step_cuda
    from jxl_oxide_tpu_torch.ops.cuda.noise import noise_field_cuda
    from jxl_oxide_tpu_torch.ops.cuda.squeeze import inv_squeeze_cuda

    epf_step_cuda.launches = 0
    inv_squeeze_cuda.launches = 0
    noise_field_cuda.launches = 0


def read_counts() -> tuple:
    """(K1, K9, K12) launches since reset_counts."""
    from jxl_oxide_tpu_torch.ops.cuda.epf import epf_step_cuda
    from jxl_oxide_tpu_torch.ops.cuda.noise import noise_field_cuda
    from jxl_oxide_tpu_torch.ops.cuda.squeeze import inv_squeeze_cuda

    return (epf_step_cuda.launches, inv_squeeze_cuda.launches,
            noise_field_cuda.launches)


def phase_extra_channels(device, probe: dict) -> tuple[dict, dict]:
    """Every extra-channel kind on the card (this slice's first path): each
    of EC_FIXTURES rendered, every keyframe in order, through
    render_frame(k) with its K1, K9 and K12 launches counted from 0 just
    before and read just after; each u8 within 1 LSB of its reference
    (alphas exactly, spot colours applied), every extra channel of
    image_all_channels() bit for bit (ec_mix_1024's f16 alpha out of the
    device tail among them); each K1 launch within EPF_ATOL of the plain
    version and each K9 launch bit for bit; warm medians of 5 by span,
    one traced decode, the launches timed as in phases 3 and 3b. Returns
    K1's and K9's rows of these paths."""
    k1_paths, k9_paths = {}, {}
    tdir = os.path.join(REPO, "jxl_oxide_tpu_torch", "testdata")
    for name, k1_want, k9_want, keyframes in EC_FIXTURES:
        data, u8_ref = read_fixture(name)
        extra_ref = np.load(os.path.join(tdir, f"{name}.npz"))["extra"]
        if keyframes == 1:
            u8_ref, extra_ref = u8_ref[None], extra_ref[None]
        reset_counts()
        with capturing_kernels() as (eps, sqs):
            outs = render_all(data)
        got = read_counts()
        if len(outs) != keyframes:
            raise AssertionError(f"{name}: {len(outs)} keyframes")
        for k, (u8, allc) in enumerate(outs):
            diff = max_lsb(u8, u8_ref[k])
            ec_equal = [bool(np.array_equal(allc[..., 3 + e],
                                            extra_ref[k][..., e]))
                        for e in range(extra_ref.shape[-1])]
            log(f"{name} keyframe {k}: {u8.shape}, max |u8 - reference| "
                f"{diff}, alpha exact {alpha_exact(u8, u8_ref[k])}, extra "
                f"channels equal to the reference {ec_equal}")
            if diff > 1 or not alpha_exact(u8, u8_ref[k]) or not all(
                    ec_equal):
                raise AssertionError(f"{name} keyframe {k} differs")
        worst = max([check_kernel(*a) for a in eps], default=0.0)
        for a in sqs:
            check_squeeze(*a)
        log(f"{name}: K1 launches {got[0]}, K9 {got[1]}, K12 {got[2]} "
            f"(wanted {k1_want}, {k9_want}, 0); each K1 launch within "
            f"{worst:.3g} of plain, each K9 launch equal to plain")
        if got != (k1_want, k9_want, 0):
            raise AssertionError(f"{name}: launches {got}")
        log_warm_split(name, outs[-1][0], lambda: render_all(data),
                       SPLIT_SPANS)
        profile_run(name, lambda: render_all(data), sum_spans=True)
        k1_paths[name] = {"launches": got[0], **pass_rows(name, eps)}
        k1_paths[name]["max_abs_err"] = max(k1_paths[name]["max_abs_err"],
                                            worst)
        if sqs:
            k9_paths[name] = {"launches": got[1],
                              **squeeze_row(name, sqs, probe)}
    return k1_paths, k9_paths


# the fixtures whose region renders are committed (<name>_roi.npz,
# phase_roi)
ROI_FIXTURES = ("flagship_1024", "ycbcr420_1024", "orient6_512x384",
                "modular_1024")


def phase_roi(device, probe: dict) -> tuple[dict, dict]:
    """Region-of-interest decode on the card (this slice's second path):
    for each of ROI_FIXTURES and each region of its <name>_roi.npz,
    render_frame_cropped(0, region).to_u8() on a fresh image, its K1, K9
    and K12 launches counted from 0 just before and read just after, held
    within 1 LSB of the JAX package's region render and equal to the crop
    of the card's full render; set_image_region(*region) and
    render_frame(0) equal to it; the rect the fused program computed
    (render/roi.py device_rect) and K1's plane shape logged; each K1
    launch held against the plain version and timed (phase 3); warm
    medians of 5 of the region render beside the full render, split by
    span. flagship_1024's loading render with a region set against its
    reference. Returns K1's and K9's rows of these paths."""
    from jxl_oxide_tpu_torch import JxlImage
    from jxl_oxide_tpu_torch.render.vardct import VardctFrameState

    k1_paths, k9_paths = {}, {}
    tdir = os.path.join(REPO, "jxl_oxide_tpu_torch", "testdata")
    for name in ROI_FIXTURES:
        data, _ = read_fixture(name)
        ref = np.load(os.path.join(tdir, f"{name}_roi.npz"))
        full = JxlImage.from_bytes(data).render_frame(0).to_u8()
        full_ms = log_warm_split(
            f"{name} full", full,
            lambda: JxlImage.from_bytes(data).render_frame(0).to_u8(),
            SPLIT_SPANS)["e2e"]
        for r, region in enumerate(ref["regions"].tolist()):
            label = f"{name} region {tuple(region)}"
            rects = []
            reset_counts()
            with capturing_kernels() as (eps, sqs), watching(
                    VardctFrameState, "run_device_pipeline",
                    lambda *a: rects.append(a[3] if len(a) > 3 else None)):
                u8 = JxlImage.from_bytes(data).render_frame_cropped(
                    0, region).to_u8()
            got = read_counts()
            left, top, w, h = region
            crop = full[top:top + h, left:left + w]
            img = JxlImage.from_bytes(data)
            img.set_image_region(*region)
            again = img.render_frame(0).to_u8()
            diff = max_lsb(u8, ref[f"u8_{r}"])
            worst = max([check_kernel(*a) for a in eps], default=0.0)
            for a in sqs:
                check_squeeze(*a)
            log(f"{label}: {u8.shape}, max |u8 - JAX region render| {diff}, "
                f"equal to the crop of the full render "
                f"{bool(np.array_equal(u8, crop))}, set_image_region + "
                f"render_frame equal {bool(np.array_equal(again, u8))}; "
                f"device rect {rects} (K1 planes "
                f"{[tuple(a[0].shape) for a in eps]}); launches K1 "
                f"{got[0]}, K9 {got[1]}, K12 {got[2]}; each K1 launch "
                f"within {worst:.3g} of plain")
            if (diff > 1 or not np.array_equal(u8, crop)
                    or not np.array_equal(again, u8) or got[2]):
                raise AssertionError(f"{label}: region render differs")
            roi_ms = log_warm_split(
                label, u8, lambda: JxlImage.from_bytes(data)
                .render_frame_cropped(0, region).to_u8(), SPLIT_SPANS)["e2e"]
            log(f"{label}: warm region render {roi_ms:.2f} ms against the "
                f"full render {full_ms:.2f} ms: {roi_ms / full_ms:.3f}x")
            if eps:
                k1_paths[label] = {"launches": got[0],
                                   "rect": rects[-1] if rects else None,
                                   "region_ms": roi_ms, "full_ms": full_ms,
                                   **pass_rows(label, eps)}
            if sqs:
                k9_paths[label] = {"launches": got[1],
                                   **squeeze_row(label, sqs, probe)}
        if "loading_u8" in ref:
            img = JxlImage()
            img.set_image_region(*ref["regions"][0].tolist())
            img.feed_bytes(data[:int(ref["loading_cut"])])
            reset_counts()
            u8 = img.render_loading_frame().to_u8()
            got = read_counts()
            diff = max_lsb(u8, ref["loading_u8"])
            log(f"{name} loading render at byte {int(ref['loading_cut'])} "
                f"with region {ref['regions'][0].tolist()}: {u8.shape}, max "
                f"|u8 - JAX| {diff}, launches K1 {got[0]}, K9 {got[1]}")
            if diff > 1:
                raise AssertionError(f"{name}: loading region render differs")
    return k1_paths, k9_paths


# the front ends' fixtures (phase_frontends): each one's `info` JSON from
# the JAX CLI is committed in frontends.json
FRONTENDS = ("flagship_1024", "modular_1024", "animation_4f_blend",
             "jbrd_container_256")
CLI_REPS = 5


def read_png(path: str) -> tuple[list, list]:
    """The frames ([H, W, C] u8 or u16) and fcTL delays of a PNG or APNG
    written with filter type None, decoded with zlib alone (the tests'
    reader, tests/torch_parity.py)."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_parity import read_png as read

    got = read(path)
    return got["frames"], [list(d) for d in got["delays"]]


def run_cli(argv) -> tuple[int, str, str, float]:
    """The port's CLI in process: (exit code, stdout, stderr, wall ms)."""
    import io

    from jxl_oxide_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue(), (
        time.perf_counter() - t0) * 1e3


def counted_cli(argv) -> tuple:
    """run_cli with K1's, K9's and K12's launches counted from 0 just
    before and read just after, and K1's and K9's launches captured:
    (exit code, stdout, stderr, wall ms, counts, K1 args, K9 args)."""
    reset_counts()
    with capturing_kernels() as (eps, sqs):
        rc, out, err, ms = run_cli(argv)
    return rc, out, err, ms, read_counts(), eps, sqs


def phase_frontends(device, probe: dict) -> tuple[dict, dict]:
    """The front ends on the card (this slice's path), Pillow blocked:
    the CLI's decode of flagship_1024 with --num-reps 5 (K1 2 a rep, the
    PNG read with zlib alone equal to render_frame(0).to_u8() on the card
    and within 1 LSB of the reference, the CLI's MP/s beside a direct
    decode's), of modular_1024 (K9 1, K1 2, equal to the card's decode),
    animation_4f_blend to an APNG (four fcTL chunks with the JAX CLI's
    delays, each frame its seeded input) and jbrd_container_256 to npy;
    `info` on each of FRONTENDS against the JAX CLI's committed JSON;
    `progressive` on flagship_1024 (K1 2 a loading render, the final PNG
    equal to the one-shot decode); the metadata boxes, dump-jbrd and
    reconstruct_jpeg's host time on jbrd_container_256 (the brob and jbrd
    legs only where libbrotlidec loads, which the run reports); `python
    -m jxl_oxide_tpu_torch info` in a subprocess; --num-devices exiting
    non-zero with the item-13 message; clear_program_caches() lowering
    torch.cuda.memory_reserved(), then the flagship again exact with K1
    2. Returns K1's and K9's rows of the CLI paths."""
    import subprocess
    import tempfile

    import torch

    from jxl_oxide_tpu_torch import JxlImage, clear_program_caches
    from jxl_oxide_tpu_torch.io.png import write_png
    from jxl_oxide_tpu_torch.ops.cuda import epf_measure as em
    from jxl_oxide_tpu_torch.utils import brotli

    tdir = os.path.join(REPO, "jxl_oxide_tpu_torch", "testdata")
    with open(os.path.join(tdir, "frontends.json")) as f:
        committed = json.load(f)
    k1_paths, k9_paths = {}, {}
    pil = sys.modules.get("PIL")
    sys.modules["PIL"] = None  # an import of Pillow raises ImportError
    try:
        with tempfile.TemporaryDirectory() as tmp:
            flag = os.path.join(tdir, "flagship_1024.jxl")
            data, ref = read_fixture("flagship_1024")
            full = JxlImage.from_bytes(data).render_frame(0).to_u8()
            out = os.path.join(tmp, "flagship.png")
            rc, _, err, wall, got, eps, _ = counted_cli(
                ["decode", flag, "-o", out, "--num-reps", str(CLI_REPS)])
            png = read_png(out)[0][0]
            log(f"CLI decode flagship_1024 x{CLI_REPS}: rc {rc}, launches "
                f"K1 {got[0]}, K9 {got[1]}, K12 {got[2]} (wanted "
                f"{2 * CLI_REPS}, 0, 0); PNG {png.shape} equal to the "
                f"card's render_frame(0).to_u8() "
                f"{bool(np.array_equal(png, full))}, max |PNG - reference| "
                f"{max_lsb(png, ref)}; {err.strip()}")
            if (rc or got != (2 * CLI_REPS, 0, 0)
                    or not np.array_equal(png, full) or max_lsb(png, ref) > 1):
                raise AssertionError("CLI decode of flagship_1024")
            m = re.search(r"geomean ([0-9.]+) ms \(range ([0-9.]+)\.\."
                          r"([0-9.]+) ms\), ([0-9.]+) MP/s", err)
            cli_ms, cli_mps = float(m.group(1)), float(m.group(4))

            def direct():
                img = JxlImage.from_bytes(data)
                img.render_frame(0)
                torch.cuda.synchronize()

            times = []
            for _ in range(CLI_REPS):
                t0 = time.perf_counter()
                direct()
                times.append(time.perf_counter() - t0)
            direct_ms = float(np.exp(np.mean(np.log(times)))) * 1e3
            t0 = time.perf_counter()
            write_png(os.path.join(tmp, "again.png"), full)
            png_ms = (time.perf_counter() - t0) * 1e3
            log(f"CLI decode flagship_1024 on {em.card()}: geomean "
                f"{cli_ms:.2f} ms a rep ({cli_mps:.2f} MP/s; range "
                f"{m.group(2)}..{m.group(3)} ms) against from_bytes + "
                f"render_frame(0) + synchronize alone {direct_ms:.2f} ms "
                f"(geomean of {CLI_REPS}, {1.048576 / direct_ms * 1e3:.2f} "
                f"MP/s); the whole CLI call {wall:.1f} ms, of which writing "
                f"the PNG about {png_ms:.1f} ms (write_png of a 1024^2 u8 "
                "image, host)")
            row = pass_rows("CLI decode flagship_1024", eps[-2:])
            row["max_abs_err"] = max([row["max_abs_err"]]
                                     + [check_kernel(*a) for a in eps])
            k1_paths["CLI decode flagship_1024"] = {
                "launches": got[0], "reps": CLI_REPS, "cli_ms": cli_ms,
                "cli_mp_s": cli_mps, "direct_ms": direct_ms, **row}

            data, ref = read_fixture("modular_1024")
            card = JxlImage.from_bytes(data).render_frame(0).to_u8()
            out = os.path.join(tmp, "modular.png")
            rc, _, _, _, got, eps, sqs = counted_cli(
                ["decode", os.path.join(tdir, "modular_1024.jxl"), "-o", out])
            png = read_png(out)[0][0]
            log(f"CLI decode modular_1024: rc {rc}, launches K1 {got[0]}, "
                f"K9 {got[1]}, K12 {got[2]} (wanted 2, 1, 0); PNG equal to "
                f"the card's decode {bool(np.array_equal(png, card))}, max "
                f"|PNG - reference| {max_lsb(png, ref)}")
            if (rc or got != (2, 1, 0) or not np.array_equal(png, card)
                    or max_lsb(png, ref) > 1):
                raise AssertionError("CLI decode of modular_1024")
            k1_paths["CLI decode modular_1024"] = {
                "launches": got[0], **pass_rows("CLI decode modular_1024",
                                                eps)}
            k9_paths["CLI decode modular_1024"] = {
                "launches": got[1],
                **squeeze_row("CLI decode modular_1024", sqs, probe)}

            out = os.path.join(tmp, "anim.png")
            rc, _, _, _, got, _, _ = counted_cli(
                ["decode", os.path.join(tdir, "animation_4f_blend.jxl"),
                 "-o", out])
            frames, delays = read_png(out)
            want = animation_4f_frames()
            equal = [bool(np.array_equal(a, b)) for a, b in zip(frames,
                                                                want)]
            log(f"CLI decode animation_4f_blend to APNG: rc {rc}, "
                f"{len(frames)} frames equal to the input frames {equal}, "
                f"fcTL delays {delays} (the JAX CLI's "
                f"{committed['apng_delays']['animation_4f_blend']}), "
                f"launches {got}")
            if (rc or len(frames) != 4 or not all(equal) or delays
                    != committed["apng_delays"]["animation_4f_blend"]):
                raise AssertionError("CLI APNG of animation_4f_blend")

            data, ref = read_fixture("jbrd_container_256")
            jpath = os.path.join(tdir, "jbrd_container_256.jxl")
            out = os.path.join(tmp, "jbrd.npy")
            rc, _, _, _, got, _, _ = counted_cli(
                ["decode", jpath, "--output-format", "npy", "-o", out])
            arr = np.load(out)
            allc = JxlImage.from_bytes(data).render_frame(0)\
                .image_all_channels()
            u8 = np.clip(np.round(arr[0] * 255), 0, 255).astype(np.uint8)
            log(f"CLI decode jbrd_container_256 to npy: rc {rc}, "
                f"{arr.shape} {arr.dtype}, equal to image_all_channels() "
                f"{bool(np.array_equal(arr[0], allc))}, max |u8 - "
                f"reference| {max_lsb(u8, ref)}, launches {got}")
            if (rc or arr.shape != (1, 256, 256, 3)
                    or not np.array_equal(arr[0], allc)
                    or max_lsb(u8, ref) > 1):
                raise AssertionError("CLI npy of jbrd_container_256")

            for name in FRONTENDS:
                rc, stdout, _, _ = run_cli(
                    ["info", os.path.join(tdir, f"{name}.jxl")])
                same = rc == 0 and json.loads(stdout) == committed["info"][
                    name]
                log(f"CLI info {name}: equal to the JAX CLI's {same}")
                if not same:
                    raise AssertionError(f"CLI info of {name}")

            k1_per_render = []
            render_loading = JxlImage.render_loading_frame

            def counted_loading(self):
                # a render that raises (not renderable yet) is not counted
                before = read_counts()[0]
                r = render_loading(self)
                k1_per_render.append(read_counts()[0] - before)
                return r

            prefix = os.path.join(tmp, "prog")
            reset_counts()
            JxlImage.render_loading_frame = counted_loading
            try:
                rc, _, err, _ = run_cli(["progressive", flag, "-o", prefix])
            finally:
                JxlImage.render_loading_frame = render_loading
            got = read_counts()
            written = sorted(f for f in os.listdir(tmp)
                             if f.startswith("prog-"))
            final = read_png(prefix + "-final.png")[0][0]
            log(f"CLI progressive flagship_1024: rc {rc}, {len(written)} "
                f"PNGs, K1 launches per loading render {k1_per_render} "
                f"(2 each), all {got[0]}; final equal to the one-shot decode "
                f"{bool(np.array_equal(final, full))}")
            if (rc or not k1_per_render or any(k != 2 for k in k1_per_render)
                    or not np.array_equal(final, full)):
                raise AssertionError("CLI progressive of flagship_1024")

            refz = np.load(os.path.join(tdir, "jbrd_container_256.npz"))
            img = JxlImage.from_bytes(data)
            checks = {
                "Exif": img.aux_box(b"Exif") == refz["exif"].tobytes(),
                "raw_exif_data": img.raw_exif_data == refz[
                    "raw_exif"].tobytes(),
                "hdr_gain_map": img.hdr_gain_map == refz["jhgm"].tobytes(),
                "jpeg_reconstruction_available":
                    img.jpeg_reconstruction_available,
            }
            has_brotli = brotli.available()
            if has_brotli:
                checks["raw_xmp (brob)"] = img.raw_xmp == refz[
                    "xmp"].tobytes()
                out = os.path.join(tmp, "x.jpg")
                rc, _, _, _ = run_cli(["dump-jbrd", jpath, "-o", out])
                with open(out, "rb") as f:
                    checks["dump-jbrd"] = rc == 0 and f.read() == refz[
                        "jpeg"].tobytes()
                rec_ms = []
                for _ in range(5):
                    fresh = JxlImage.from_bytes(data)
                    t0 = time.perf_counter()
                    fresh.reconstruct_jpeg()
                    rec_ms.append((time.perf_counter() - t0) * 1e3)
                log(f"reconstruct_jpeg of jbrd_container_256 (256^2, host "
                    f"work): median of 5 {statistics.median(rec_ms):.2f} ms "
                    f"(range {min(rec_ms):.2f}..{max(rec_ms):.2f})")
            else:
                log(f"{brotli.LIBRARY} is absent on this host: the brob "
                    "(raw_xmp) and jbrd (dump-jbrd, reconstruct_jpeg) legs "
                    "did not run")
            log(f"metadata of jbrd_container_256 against the JAX "
                f"package's committed payloads: {checks}; "
                f"{brotli.LIBRARY} loads: {has_brotli}")
            if not all(checks.values()):
                raise AssertionError("metadata of jbrd_container_256")

            t0 = time.perf_counter()
            res = subprocess.run(
                [sys.executable, "-m", "jxl_oxide_tpu_torch", "info", jpath],
                cwd=REPO, capture_output=True, text=True, timeout=300)
            same = res.returncode == 0 and json.loads(res.stdout) == \
                committed["info"]["jbrd_container_256"]
            log(f"python -m jxl_oxide_tpu_torch info jbrd_container_256: rc "
                f"{res.returncode}, equal to the JAX CLI's {same} "
                f"({time.perf_counter() - t0:.1f} s)")
            if not same:
                raise AssertionError(f"python -m: {res.stderr[-2000:]}")

            # a mesh of more cards than there are raises, naming the count
            # (phase_mesh drives the decodes --num-devices makes)
            n_over = torch.cuda.device_count() + 1
            try:
                run_cli(["decode", flag, "--num-devices", str(n_over)])
                refused = ""
            except RuntimeError as e:
                refused = str(e)
            log(f"CLI decode --num-devices {n_over}: {refused}")
            if "CUDA device" not in refused:
                raise AssertionError("--num-devices did not refuse")

        torch.cuda.synchronize()
        reserved = torch.cuda.memory_reserved()
        allocated = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        clear_program_caches()
        clear_ms = (time.perf_counter() - t0) * 1e3
        after = torch.cuda.memory_reserved()
        allocated_after = torch.cuda.memory_allocated()
        data, ref = read_fixture("flagship_1024")
        reset_counts()
        u8 = JxlImage.from_bytes(data).render_frame(0).to_u8()
        got = read_counts()
        log(f"clear_program_caches ({clear_ms:.1f} ms): memory_reserved "
            f"{reserved / 2**20:.1f} -> {after / 2**20:.1f} MiB, "
            f"memory_allocated {allocated / 2**20:.1f} -> "
            f"{allocated_after / 2**20:.1f} MiB; the flagship again: equal "
            f"{bool(np.array_equal(u8, full))}, launches {got}")
        if (after >= reserved or got != (2, 0, 0)
                or not np.array_equal(u8, full)):
            raise AssertionError("clear_program_caches")
    finally:
        if pil is None:
            sys.modules.pop("PIL", None)
        else:
            sys.modules["PIL"] = pil
    return k1_paths, k9_paths


# the sharded decodes of phase_mesh: (fixture, shard counts on one card).
# flagship_1024 at 3 shards: shard 2 is pure padding (last_shard 1); the
# wide fixtures shard by column bands; staged_1030's plan overflows (the
# staged path, K1 on the whole plane); modular_1024's squeeze runs per row
# band
MESH_DECODES = (("flagship_1024", (1, 2, 3, 4)), ("ycbcr420_1024", (2, 4)),
                ("mixed_512", (2,)), ("epf3_512", (2,)),
                ("lf_frame_1024", (2,)), ("flagship_alpha_1024", (4,)),
                ("wide_epf_1024x256", (4,)), ("wide_420_1024x256", (4,)),
                ("staged_1030", (2,)), ("modular_1024", (4,)))
# (fixture, shards) whose K1 and K9 launches are held and timed (the
# kernels' mesh rows): row bands, column bands, the Modular tail's bands
MESH_TIMED = (("flagship_1024", 4), ("wide_epf_1024x256", 4),
              ("modular_1024", 4))
MESH_SPANS = ("Dequant and transform (sharded)", "Halo exchange")


def phase_mesh(device, probe: dict) -> tuple[dict, dict]:
    """The sharded decode on the card (this slice's path): each of
    MESH_DECODES over a mesh of explicit shards on cuda:0
    (decode_mesh(n, devices=["cuda:0"] * n)), through
    JxlImage(mesh=...).render_frame(0) with K1's, K9's and K12's launches
    counted from 0 just before and read just after, and every call of the
    plain epf_step on a CUDA tensor counted (none allowed); each decode
    equal to the card's single-device decode bit for bit (planes and u8)
    and within 1 LSB of the committed reference (alpha exact); K1 launches
    against passes x device groups (the bands of one device go as one
    stack), halo bytes exchanged; for MESH_TIMED each K1 and K9 launch
    held against the plain version and timed (phases 3 and 3b, K1's bound
    on the haloed band's shape); the warm median of 5 of flagship_1024 at
    1, 2 and 4 shards by span; the CLI's decode --num-devices 1. With two
    or more cards, the flagship over real cards and
    tools/torch_multihost_check.py over NCCL; else the run says they did
    not run. Returns K1's and K9's rows of these paths."""
    import subprocess
    import tempfile

    import torch

    from jxl_oxide_tpu_torch import JxlImage
    from jxl_oxide_tpu_torch.ops import filters
    from jxl_oxide_tpu_torch.ops.cuda import epf as k1mod
    from jxl_oxide_tpu_torch.parallel import decode_mesh, sharded

    k1_paths, k9_paths = {}, {}
    plain_on_card = []

    def see_plain(planes, *rest):
        if planes.device.type == "cuda":
            plain_on_card.append(tuple(planes.shape))

    def planes_u8(img):
        r = img.render_frame(0)
        return torch.stack(r.planes).cpu().numpy(), r.to_u8()

    card0 = torch.device("cuda:0")
    for name, counts in MESH_DECODES:
        data, ref = read_fixture(name)
        # K1 launches of the single-device decode: one a filtered frame's
        # pass (phase 4 holds them to the passes)
        reset_counts()
        want, want_u8 = planes_u8(JxlImage.from_bytes(data))
        passes = read_counts()[0]
        for n in counts:
            label = f"{name} on {n} shards"
            mesh = decode_mesh(n, devices=[card0] * n)
            reset_counts()
            sharded.reset_exchanged()
            plain_on_card.clear()
            with capturing_kernels() as (eps, sqs), \
                    watching(filters, "epf_step", see_plain), \
                    watching(k1mod, "epf_step", see_plain):
                got, u8 = planes_u8(JxlImage.from_bytes(data, mesh=mesh))
            counted = read_counts()
            moved = dict(sharded.exchanged)
            same = bool(got.shape == want.shape and np.array_equal(got, want))
            diff = max_lsb(u8, ref)
            log(f"{label}: {u8.shape}, planes equal to the single-device "
                f"decode {same}, u8 equal {bool(np.array_equal(u8, want_u8))}"
                f", max |u8 - reference| {diff}, alpha exact "
                f"{alpha_exact(u8, ref)}; launches K1 {counted[0]} (passes "
                f"{passes}; passes x shards {passes * n}, the bands of one "
                f"card stacked), K9 {counted[1]}, K12 {counted[2]}; K1 planes "
                f"{sorted({tuple(a[0].shape) for a in eps})}; plain epf_step "
                f"on the card {len(plain_on_card)}; halo bytes exchanged "
                f"{moved['bytes']} (to another device {moved['device_bytes']})")
            if (not same or not np.array_equal(u8, want_u8) or diff > 1
                    or not alpha_exact(u8, ref)):
                raise AssertionError(f"{label}: sharded decode differs")
            if counted[0] != passes or plain_on_card or counted[2]:
                raise AssertionError(f"{label}: launches {counted}, plain "
                                     f"EPF on the card {plain_on_card}")
            if name == MODULAR_PATH and counted[1] != n:
                raise AssertionError(f"{label}: K9 {counted[1]}, one a band "
                                     "wanted")
            if (name, n) in MESH_TIMED:
                worst = max([check_kernel(*a) for a in eps], default=0.0)
                log(f"{label}: each K1 launch within {worst:.3g} of plain")
                if eps:
                    k1_paths[label] = {"launches": counted[0],
                                       "halo_bytes": moved["bytes"],
                                       **pass_rows(label, eps)}
                if sqs:
                    k9_paths[label] = {"launches": counted[1],
                                       **squeeze_row(label, sqs, probe)}
                profile_run(label, lambda: JxlImage.from_bytes(
                    data, mesh=mesh).render_frame(0).to_u8(), sum_spans=True)

    data, _ = read_fixture(MAIN_PATH)
    warm = {}
    for n in (1, 2, 4):
        mesh = decode_mesh(n, devices=[card0] * n)
        u8 = JxlImage.from_bytes(data, mesh=mesh).render_frame(0).to_u8()
        warm[n] = log_warm_split(
            f"{MAIN_PATH} on {n} shards of one card", u8,
            lambda: JxlImage.from_bytes(data, mesh=mesh).render_frame(0)
            .to_u8(), SPLIT_SPANS, nested=MESH_SPANS)["e2e"]
    log(f"{MAIN_PATH} warm end to end on one card by shards: "
        + ", ".join(f"{n}: {ms:.2f} ms" for n, ms in warm.items())
        + " (measured, no speed-up expected: the shards share one card)")

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "mesh.png")
        flag = os.path.join(REPO, "jxl_oxide_tpu_torch", "testdata",
                            f"{MAIN_PATH}.jxl")
        reset_counts()
        rc, _, err, _ = run_cli(["decode", flag, "-o", out,
                                 "--num-devices", "1"])
        counted = read_counts()
        frames, _ = read_png(out) if rc == 0 else ([None], None)
        full = JxlImage.from_bytes(data).render_frame(0).to_u8()
        same = frames[0] is not None and np.array_equal(frames[0], full)
        log(f"CLI decode --num-devices 1: rc {rc}, PNG equal to "
            f"render_frame(0).to_u8() {same}, launches {counted}")
        if rc != 0 or not same or counted[0] != 2:
            raise AssertionError(f"CLI --num-devices 1: {err[-2000:]}")

    cards = torch.cuda.device_count()
    if cards >= 2:
        n = min(cards, 4)
        mesh = decode_mesh(n)
        reset_counts()
        got, u8 = planes_u8(JxlImage.from_bytes(data, mesh=mesh))
        want, _ = planes_u8(JxlImage.from_bytes(data))
        same = bool(np.array_equal(got, want))
        log(f"{MAIN_PATH} over {n} cards: equal to one card {same}, "
            f"launches {read_counts()}")
        if not same:
            raise AssertionError("decode over several cards differs")
        res = subprocess.run(
            [sys.executable, os.path.join(REPO, "tools",
                                          "torch_multihost_check.py"),
             "--hosts", "2", "--chips", "1", "--backend", "nccl",
             "--device", "cuda", "--timeout", "240"],
            cwd=REPO, capture_output=True, text=True, timeout=300)
        log(f"torch_multihost_check over NCCL: rc {res.returncode}, "
            f"{res.stdout.strip()[-2000:]}")
        if res.returncode != 0:
            raise AssertionError("torch_multihost_check over NCCL failed")
    else:
        log(f"{cards} card: the decode over several cards and "
            "tools/torch_multihost_check.py over NCCL did not run")
    return k1_paths, k9_paths


# the two YCbCr layouts of ROADMAP item 7 (phase_ycbcr): (name, K1
# launches, K9 launches) of one decode on the card: 4:4:4 YCbCr VarDCT
# (the fused 4:4:4 program with adaptive LF smoothing, its region rendered
# whole and cut) and lossless 4:2:0 YCbCr Modular (K9 on the squeeze of
# its Cb plane on the device tail, K1 on the upsampled planes)
YCBCR_FIXTURES = (("ycbcr444_1024", 2, 0), ("modular_420_1024", 2, 1))
# the stacked decode of phase_ycbcr: this many ycbcr444_1024 streams
YCBCR_STACK = 4
# the sharded decodes of phase_ycbcr: shards of cuda:0
YCBCR_SHARDS = 4


def cold_decode() -> None:
    """Before a cold decode: the port's process-wide caches released
    (clear_program_caches: the fused programs, the plane pool, the device
    tables) and the L2 cache overwritten (256 MB written on the card)."""
    import torch

    from jxl_oxide_tpu_torch import clear_program_caches

    clear_program_caches()
    torch.empty(64 << 20, dtype=torch.int32, device="cuda").fill_(1)
    torch.cuda.synchronize()


def generate_fixture_digests() -> list:
    """The port's generate-fixture (cli.py, encoders/: numpy on the host)
    for each form of generate_fixture.json, in process and once as
    `python3 -m jxl_oxide_tpu_torch` in a subprocess: (args, SHA-256 equal
    to the committed one of the JAX CLI's output, ms) of each."""
    import contextlib
    import hashlib
    import io
    import subprocess
    import tempfile

    from jxl_oxide_tpu_torch import cli

    with open(os.path.join(REPO, "jxl_oxide_tpu_torch", "testdata",
                           "generate_fixture.json")) as f:
        forms = json.load(f)["forms"]
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "g.jxl")
        for form in forms:
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(io.StringIO()):
                rc = cli.main(["generate-fixture", "-o", out, *form["args"]])
            ms = (time.perf_counter() - t0) * 1e3
            with open(out, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
            rows.append((form["args"], rc == 0 and digest == form["sha256"],
                         ms))
            os.remove(out)
        res = subprocess.run(
            [sys.executable, "-m", "jxl_oxide_tpu_torch", "generate-fixture",
             "-o", out, *forms[-1]["args"]], cwd=tmp, capture_output=True,
            text=True, timeout=120,
            env=dict(os.environ, PYTHONPATH=REPO))
        with open(out, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        rows.append((["python3 -m jxl_oxide_tpu_torch", *forms[-1]["args"]],
                     res.returncode == 0 and digest == forms[-1]["sha256"],
                     None))
    return rows


def phase_ycbcr(device, probe: dict) -> tuple[dict, dict]:
    """The two YCbCr layouts of ROADMAP item 7 on the card (this slice's
    path): each of YCBCR_FIXTURES through render_frame(0).to_u8() with its
    K1, K9 and K12 launches counted from 0 just before and read just
    after, within 1 LSB of its reference; each K1 launch within EPF_ATOL
    of the plain version and each K9 launch bit for bit, timed beside
    their bounds (phases 3 and 3b: K1's byte bound, K9's chain bound);
    the decode warm and cold (`cold_decode`), medians of 5 by span, and
    one traced decode; its first region (<name>_roi.npz) within 1 LSB of
    the JAX package's region render and equal to the crop of the full
    render; a decode over YCBCR_SHARDS shards of cuda:0 equal to the
    single-device decode bit for bit (planes and u8). YCBCR_STACK x
    ycbcr444_1024 through decode_batch_stacked as one stack (one K1
    launch a pass), 0 pixels different from the per-image decodes. The
    port's generate-fixture on this host (no JAX here) against the
    committed SHA-256 of tools/'s output. Returns K1's and K9's rows of
    these paths."""
    import torch

    from jxl_oxide_tpu_torch import JxlImage, decode_batch_stacked
    from jxl_oxide_tpu_torch.parallel import decode_mesh

    k1_paths, k9_paths = {}, {}
    tdir = os.path.join(REPO, "jxl_oxide_tpu_torch", "testdata")
    card0 = torch.device("cuda:0")

    def planes_u8(img):
        r = img.render_frame(0)
        return torch.stack(r.planes).cpu().numpy(), r.to_u8()

    for name, k1_want, k9_want in YCBCR_FIXTURES:
        data, ref = read_fixture(name)
        reset_counts()
        with capturing_kernels() as (eps, sqs):
            planes, u8 = planes_u8(JxlImage.from_bytes(data))
        got = read_counts()
        diff = max_lsb(u8, ref)
        log(f"{name}: {u8.shape}, max |u8 - reference| {diff}; launches K1 "
            f"{got[0]}, K9 {got[1]}, K12 {got[2]} (wanted {k1_want}, "
            f"{k9_want}, 0); K1 planes "
            f"{sorted({tuple(a[0].shape) for a in eps})}, K9 avg "
            f"{sorted({tuple(a[0].shape) for a in sqs})}")
        if diff > 1:
            raise AssertionError(f"{name}: decode differs from reference")
        if got != (k1_want, k9_want, 0):
            raise AssertionError(f"{name}: launches {got}")

        def run():
            return JxlImage.from_bytes(data).render_frame(0).to_u8()

        warm = log_warm_split(name, u8, run, SPLIT_SPANS)
        cold = log_warm_split(f"{name} cold", u8, run, SPLIT_SPANS,
                              prepare=cold_decode)
        profile_run(name, run, sum_spans=True)
        k1_paths[name] = {"launches": got[0], "decode_warm_ms": warm["e2e"],
                          "decode_cold_ms": cold["e2e"],
                          **pass_rows(name, eps)}
        if sqs:
            k9_paths[name] = {"launches": got[1],
                              "decode_warm_ms": warm["e2e"],
                              "decode_cold_ms": cold["e2e"],
                              **squeeze_row(name, sqs, probe)}

        rois = np.load(os.path.join(tdir, f"{name}_roi.npz"))
        region = rois["regions"][0].tolist()
        left, top, w, h = region
        reset_counts()
        cut = JxlImage.from_bytes(data).render_frame_cropped(
            0, region).to_u8()
        counted = read_counts()
        rdiff = max_lsb(cut, rois["u8_0"])
        same = bool(np.array_equal(cut, u8[top:top + h, left:left + w]))
        log(f"{name} region {tuple(region)}: {cut.shape}, max |u8 - JAX "
            f"region render| {rdiff}, equal to the crop of the full render "
            f"{same}, launches {counted}")
        if rdiff > 1 or not same:
            raise AssertionError(f"{name}: region render differs")

        mesh = decode_mesh(YCBCR_SHARDS, devices=[card0] * YCBCR_SHARDS)
        reset_counts()
        sharded, su8 = planes_u8(JxlImage.from_bytes(data, mesh=mesh))
        counted = read_counts()
        equal = bool(sharded.shape == planes.shape
                     and np.array_equal(sharded, planes)
                     and np.array_equal(su8, u8))
        log(f"{name} on {YCBCR_SHARDS} shards of cuda:0: planes and u8 equal "
            f"to the single-device decode {equal}, launches {counted}")
        if not equal:
            raise AssertionError(f"{name}: sharded decode differs")

    data, _ = read_fixture(YCBCR_FIXTURES[0][0])
    one = JxlImage.from_bytes(data).render_frame(0).to_u8()
    streams = [data] * YCBCR_STACK
    reset_counts()
    outs = decode_batch_stacked(streams)
    counted = read_counts()
    different = sum(int(np.count_nonzero((o != one).any(axis=-1)))
                    for o in outs)
    log(f"{YCBCR_STACK} x {YCBCR_FIXTURES[0][0]} through "
        f"decode_batch_stacked: {different} pixels different from the "
        f"per-image decode, launches {counted} (one K1 a pass on the stack)")
    if different or counted[0] != YCBCR_FIXTURES[0][1]:
        raise AssertionError("stacked 4:4:4 YCbCr decode differs")
    stacked_ms = log_warm_split(
        f"{YCBCR_STACK} x {YCBCR_FIXTURES[0][0]} stacked",
        np.concatenate(outs), lambda: decode_batch_stacked(streams),
        ("Stacked program inputs", "Upload", "Stacked program"))["e2e"]
    log(f"stacked: {stacked_ms / YCBCR_STACK:.2f} ms an image")

    for args, ok, ms in generate_fixture_digests():
        log(f"generate-fixture {' '.join(args)}: SHA-256 equal to tools/'s "
            f"{ok}" + (f", {ms:.1f} ms on the host" if ms is not None
                       else ""))
        if not ok:
            raise AssertionError(f"generate-fixture {args} differs")
    return k1_paths, k9_paths


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
    worst = max(worst, phase_stack_kernel(device))
    probe = phase_probe()
    pyramid = phase_squeeze(device, probe)
    report, squeeze_paths = phase_decode(probe)
    report["paths"]["stacked"] = phase_serving(device)
    report["paths"].update(phase_animation(device))
    color_k1, color_k9 = phase_color(probe)
    report["paths"].update(color_k1)
    feature_k1, noise = phase_features(device)
    report["paths"].update(feature_k1)
    progressive_k1, progressive_k9 = phase_progressive(device, probe)
    report["paths"].update(progressive_k1)
    ec_k1, ec_k9 = phase_extra_channels(device, probe)
    report["paths"].update(ec_k1)
    roi_k1, roi_k9 = phase_roi(device, probe)
    report["paths"].update(roi_k1)
    frontend_k1, frontend_k9 = phase_frontends(device, probe)
    report["paths"].update(frontend_k1)
    mesh_k1, mesh_k9 = phase_mesh(device, probe)
    report["paths"].update(mesh_k1)
    ycbcr_k1, ycbcr_k9 = phase_ycbcr(device, probe)
    report["paths"].update(ycbcr_k1)
    report["max_abs_err"] = max([report["max_abs_err"], worst]
                                + [p["max_abs_err"]
                                   for p in report["paths"].values()])
    squeeze = {
        "name": "inv_squeeze",
        "route": "cuda",
        "source": "jxl_oxide_tpu_torch/csrc/modular_squeeze.cu",
        "replaces": "jxl_oxide_tpu/ops/modular_tail.py:82",
        **squeeze_paths[MODULAR_PATH],
        "probe_ns_per_step": probe["ns_per_step"],
        "probe_cycles_per_step": probe["cycles_per_step"],
        "sass_chain_ops": probe["sass"]["inv_squeeze_h_kernel"][
            "ops_per_step"],
        # integer arithmetic: every comparison above was equality
        "max_abs_err": 0,
        "library_ms": None,
        "pyramid": pyramid,
        "paths": {MODULAR_PATH: squeeze_paths[MODULAR_PATH], **color_k9,
                  **progressive_k9, **ec_k9, **roi_k9, **frontend_k9,
                  **mesh_k9, **ycbcr_k9},
    }
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [report, squeeze, noise]}))
    print(f"card: {em.card()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
