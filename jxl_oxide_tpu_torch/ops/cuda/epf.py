"""Wrapper of the hand-written CUDA EPF kernel (csrc/epf.cu).

Replaces jxl_oxide_tpu/ops/pallas/epf.py (the Pallas TPU kernel
_epf_tile_kernel, public epf_step_pallas, which the JAX package's stacked
serving path vmaps); same contract as ops/filters.py::epf_step, on one
image [3, H, W] or a stack [N, 3, H, W] in one launch. For a tensor on
the CPU the wrapper runs that plain version; for a CUDA tensor it
launches the kernel on the current stream or raises. It never falls back
from the card to the CPU.

The kernel is bound by the pass's 28 B/px of device memory traffic: one
persistent block per SM walks 64x64 tiles through a two-stage
shared-memory ring filled by TMA (cp.async where W % 4 != 0), mirrors only
on edge tiles, and shares each tap pair's SAD plane (csrc/epf.cu). The
wrapper keeps its host work per call small: the ctypes function is bound
once, the float arguments are cached per filter setting. `bind` and
`launch` serve the timing tools (ops/cuda/epf_measure.py), which launch
into outputs they allocated and are not counted.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

from ..filters import EPF_NEG_K, epf_step
from . import build

__all__ = ["BAND_HALO", "bind", "epf_step_bands", "epf_step_cuda",
           "kernel_params", "launch"]


_FLOATS = [ctypes.c_float] * 6


def bind(lib: ctypes.CDLL):
    """The C entry jxl_epf_step_batched of a built EPF library, its
    argument types set: (in, sigma, out, images, height, width, step,
    six floats, stream). A library of an earlier version of the kernel has
    only the one-image entry jxl_epf_step; it is bound behind the same
    signature and takes images == 1 only (tools/epf_variants.py)."""
    ptrs = [ctypes.c_void_p] * 3
    if hasattr(lib, "jxl_epf_step_batched"):
        fn = lib.jxl_epf_step_batched
        fn.argtypes = [*ptrs, *[ctypes.c_int] * 4, *_FLOATS, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        return fn
    one = lib.jxl_epf_step
    one.argtypes = [*ptrs, *[ctypes.c_int] * 3, *_FLOATS, ctypes.c_void_p]
    one.restype = ctypes.c_int

    def batched(inp, sigma, out, images, *rest):
        if images != 1:
            raise ValueError("this EPF library takes one image per launch")
        return one(inp, sigma, out, *rest)

    return batched


@functools.cache
def _fn():
    return bind(build.load("epf"))


@functools.lru_cache(maxsize=64)
def kernel_params(channel_scale: tuple, step_multiplier: float,
                  border_sad_mul: float) -> tuple:
    """The float arguments of the C entry jxl_epf_step_batched, (cs0, cs1, cs2,
    sm_border, sm_plain, neg_k), each rounded to float32 as epf_step
    rounds it."""
    cs = [float(np.float32(v)) for v in channel_scale]
    return (
        cs[0], cs[1], cs[2],
        float(np.float32(step_multiplier * border_sad_mul)),
        float(np.float32(step_multiplier)),
        float(EPF_NEG_K),
    )


def launch(fn, planes: torch.Tensor, sigma: torch.Tensor, out: torch.Tensor,
           step: int, channel_scale, step_multiplier: float,
           border_sad_mul: float) -> None:
    """One launch of `fn` (from `bind`) on contiguous float32 CUDA tensors,
    planes [3, H, W] or [N, 3, H, W], into `out`, on the current stream of
    their device, which is made the current device for the launch (a mesh
    puts bands on several cards). No checks and no launch count: the
    caller has made both."""
    h, w = planes.shape[-2:]
    images = planes.shape[0] if planes.dim() == 4 else 1
    # torch.cuda.device's own calls: the context manager's argument parsing
    # costs more host time than the launch
    prev = torch.cuda._exchange_device(planes.device.index)
    try:
        err = fn(
            planes.data_ptr(), sigma.data_ptr(), out.data_ptr(), images, h,
            w, step,
            *kernel_params(tuple(channel_scale), float(step_multiplier),
                           float(border_sad_mul)),
            # the current stream's handle; torch.cuda.current_stream()
            # builds a Stream object and costs more than the launch itself
            torch._C._cuda_getCurrentRawStream(planes.device.index),
        )
    finally:
        torch.cuda._maybe_exchange_device(prev)
    if err != 0:
        raise RuntimeError(f"EPF kernel launch failed: error {err}")


def epf_step_cuda(planes: torch.Tensor, sigma: torch.Tensor, step: int,
                  channel_scale, step_multiplier: float,
                  border_sad_mul: float) -> torch.Tensor:
    """One EPF pass: planes [3, H, W] float32 with sigma [H, W] float32,
    or a stack of N images, planes [N, 3, H, W] with sigma [N, H, W].

    CPU tensors take the plain torch `epf_step`; CUDA tensors launch the
    kernel: one launch whatever N is, counted once in
    `epf_step_cuda.launches` (launches, not images)."""
    if planes.device.type == "cpu" and sigma.device.type == "cpu":
        return epf_step(planes, sigma, step, tuple(channel_scale),
                        step_multiplier, border_sad_mul)
    if planes.device.type != "cuda" or sigma.device != planes.device:
        raise ValueError(
            f"epf_step_cuda: planes on {planes.device}, sigma on "
            f"{sigma.device}; both must be on one CUDA device (or the CPU)"
        )
    if step not in (0, 1, 2):
        raise ValueError(f"EPF step {step} (0, 1 or 2)")
    if planes.dtype != torch.float32 or sigma.dtype != torch.float32:
        raise TypeError("epf_step_cuda takes float32 planes and sigma")
    if planes.dim() not in (3, 4) or planes.shape[-3] != 3:
        raise ValueError("planes must be [3, H, W] or [N, 3, H, W], got "
                         f"{tuple(planes.shape)}")
    lead = tuple(planes.shape[:-3])
    h, w = planes.shape[-2:]
    if tuple(sigma.shape) != (*lead, h, w):
        raise ValueError(f"sigma {tuple(sigma.shape)} does not match planes "
                         f"{tuple(planes.shape)}")
    if h * w >= 1 << 31:
        raise ValueError("plane too large for the kernel's int indexing")
    if (lead[0] if lead else 1) * -(-h // 64) * -(-w // 64) > 1 << 30:
        raise ValueError("stack too large for the kernel's tile count")
    planes = planes.contiguous()
    sigma = sigma.contiguous()
    out = torch.empty_like(planes)
    launch(_fn(), planes, sigma, out, step, channel_scale, step_multiplier,
           border_sad_mul)
    with _count_lock:
        _counted.launches += 1
    return out


epf_step_cuda.launches = 0
# frames of one keyframe render on several threads: `+=` on an attribute
# is a read and a write, and two launches between them would count once
_count_lock = threading.Lock()
# the count lives on the wrapper; `_counted` keeps naming it while a
# measurement rebinds this module's `epf_step_cuda` to a wrapper of its own
# (epf_measure.capture_decode)
_counted = epf_step_cuda


# halo of a shard band for one K1 pass: one 8-pixel block row (column), so
# the kernel's y % 8 / x % 8 border pattern and its TMA row alignment hold
# on the haloed band
BAND_HALO = 8


def epf_step_bands(bands: list, sigmas: list, step: int, channel_scale,
                   step_multiplier: float, border_sad_mul: float, mesh,
                   vloc: int, last_shard: int, dim: int) -> list:
    """One EPF pass over the bands of a plane sharded across `mesh` (ops/
    vardct_pipeline.py build_fused_pipeline_sharded): `bands` are this
    process's shards in mesh order, [3, h, w] each, split along `dim` (-2
    rows, -1 columns); `sigmas` their sigma maps with BAND_HALO real
    samples on each side along `dim` already (they do not change between
    passes).

    Each band takes a BAND_HALO halo from its neighbours
    (parallel/sharded.py, mirrored at the valid edges as the whole plane
    is), the bands on one device go through `epf_step_cuda` as one stack
    [n, 3, h + 16, w] (one launch), and each keeps its middle: an output
    sample reads +-3 samples, all real there, so the kept samples are
    epf_step(prepad_rows=3) (prepad_cols) of the band bit for bit on the
    CPU, and the samples the kernel mirrored at the stack's own edges are
    thrown away."""
    from ...parallel.sharded import _halo_pad

    padded = _halo_pad(bands, BAND_HALO, mesh, vloc, last_shard, dim)
    groups: dict = {}
    for k, p in enumerate(padded):
        groups.setdefault(p.device, []).append(k)
    out = [None] * len(bands)
    for ks in groups.values():
        x = torch.stack([padded[k] for k in ks])
        s = torch.stack([sigmas[k] for k in ks])
        y = epf_step_cuda(x, s, step, channel_scale, step_multiplier,
                          border_sad_mul)
        for j, k in enumerate(ks):
            out[k] = y[j].narrow(dim, BAND_HALO, bands[k].shape[dim])
    return out
