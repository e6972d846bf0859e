"""Measuring the EPF kernel (csrc/epf.cu) on the card: shared by
chip_smoke.py and tools/epf_variants.py. Nothing in the decode imports it.

- `epf_inputs`: planes and sigma on which a pass really filters;
- `bound_ms`: the least time one pass could take on these inputs;
- `input_sets` and `device_ms`: device time per launch on the card's own
  clock, with the inputs in L2 (warm) or not (cold);
- `capture_decode`: a decode through the public entry point that keeps
  each EPF pass's inputs;
- `card`: the card's name and power limit, as nvidia-smi gives them.
"""

from __future__ import annotations

import math
import subprocess

import numpy as np
import torch

from .epf import epf_step_cuda, launch

__all__ = ["BORDER_SAD_MUL", "CHANNEL_SCALE", "STEPS", "bound_ms", "card",
           "capture_decode", "device_ms", "epf_inputs", "input_sets"]

# one H100 SXM (NVIDIA data sheet): HBM rate, fp32 non-tensor peak, L2
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
L2_BYTES = 50e6
# a pass reads three planes and sigma and writes three planes
BYTES_PER_PIXEL = 28
# (step, step_multiplier) of the three EPF steps, as a frame sets them
STEPS = ((0, 1.65), (1, 1.0), (2, 2.35))
CHANNEL_SCALE = (40.0, 5.0, 3.5)
BORDER_SAD_MUL = 2.0 / 3.0


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def epf_inputs(shape, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Planes [3, H, W] and sigma [H, W] on which an EPF pass really
    filters (as tests/torch_parity.py makes them): values near 0.5 with
    per-row noise amplitudes from 1e-4 to 1e-1 (on uniform noise in
    [0, 1) every tap weight is 0 and the pass is the identity); sigma
    spans the < 0.3 passthrough, exact zeros included, and filtered
    pixels."""
    rng = np.random.default_rng(seed)
    amp = 10.0 ** rng.uniform(-4, -1, (1, shape[1], 1))
    planes = (0.5 + rng.random(shape) * amp).astype(np.float32)
    sigma = (rng.random(shape[1:]) * 2.0).astype(np.float32)
    sigma[rng.random(shape[1:]) < 0.1] = 0.0
    return planes, sigma


def ops_per_pixel(step: int) -> int:
    """fp32 operations of one filtered pixel in the plain formula
    (ops/filters.py epf_step): per tap and channel, kDist x (sub, abs,
    add) plus the scaled add; per tap the weight (mul, add, max), the
    weight sum and 3 x (mul, add); per pixel 2 ops for the sigma term and
    3 divisions."""
    taps = 12 if step == 0 else 4
    dist = 1 if step == 2 else 5
    return taps * (3 * (3 * dist + 2) + 10) + 5


def bound_ms(sigma: torch.Tensor, step: int) -> tuple[float, str]:
    """Least time of one pass on these inputs: the bytes (3 planes and
    sigma read once, 3 planes written once) over the HBM rate, against
    the operations that the data needs (pixels with sigma < 0.3 pass
    through) over the fp32 peak; and which of the two it is. sigma is
    one image's [H, W] or a stack's [N, H, W]."""
    byte_ms = BYTES_PER_PIXEL * sigma.numel() / HBM_BYTES_PER_S * 1e3
    active = int((sigma >= 0.3).sum().item())
    op_ms = ops_per_pixel(step) * active / FP32_FLOPS * 1e3
    return max(byte_ms, op_ms), "bytes" if byte_ms >= op_ms else "operations"


def input_sets(planes: torch.Tensor, sigma: torch.Tensor, cold: bool):
    """(planes, sigma, out) sets to launch on in turn. Warm: one set, so
    each launch finds its inputs where the last one left them, as the
    decode finds the planes that gaborish has just written. Cold: enough
    copies that between two uses of one copy the other launches move at
    least twice the 50 MB L2. (A pass at 3x2048^2 moves more than the L2
    holds, so warm is not warm there.)"""
    pixels = planes.numel() // 3
    copies = 1 + math.ceil(2 * L2_BYTES / (BYTES_PER_PIXEL * pixels))
    sets = [(planes, sigma, torch.empty_like(planes))]
    for _ in range(copies - 1 if cold else 0):
        sets.append((planes.clone(), sigma.clone(), torch.empty_like(planes)))
    return sets


def device_ms(fn, sets, step: int, channel_scale, step_multiplier: float,
              border_sad_mul: float, launches: int = 24,
              replays: int = 5) -> float:
    """Device time of one launch of `fn` (ops/cuda/epf.py `bind`) in ms,
    on the card's clock: `launches` launches, cycling over `sets`, are
    captured in one CUDA graph and replayed between CUDA events, so no
    host work falls in the window."""
    args = (step, channel_scale, step_multiplier, border_sad_mul)
    for planes, sigma, out in sets:
        launch(fn, planes, sigma, out, *args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(launches):
            launch(fn, *sets[i % len(sets)], *args)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (launches * replays)


def capture_decode(data: bytes, device=None):
    """Decode `data` on `device` (CUDA by default) through
    JxlImage.from_bytes(data).render_frame(0).to_u8(); returns the u8
    image and, per EPF pass, its inputs (planes, sigma, step,
    channel_scale, step_multiplier, border_sad_mul), the planes copied
    before the pass. Every pass of every path goes through
    ops/filters.py apply_epf, which looks the wrapper up on this package's
    epf module at each call: the capture wraps it there, and each pass
    still goes through epf_step_cuda and is counted there."""
    from ...api import JxlImage
    from . import epf as kernel

    captured = []

    def recording(planes, sigma, step, cs, sm, bsm):
        captured.append((planes.clone(), sigma, step, cs, sm, bsm))
        return epf_step_cuda(planes, sigma, step, cs, sm, bsm)

    kernel.epf_step_cuda = recording
    try:
        u8 = JxlImage.from_bytes(data, device=device).render_frame(0).to_u8()
    finally:
        kernel.epf_step_cuda = epf_step_cuda
    return u8, captured
