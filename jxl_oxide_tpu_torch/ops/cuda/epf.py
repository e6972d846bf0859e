"""Wrapper of the hand-written CUDA EPF kernel (csrc/epf.cu).

Replaces jxl_oxide_tpu/ops/pallas/epf.py (the Pallas TPU kernel
_epf_tile_kernel, public epf_step_pallas); same contract as
ops/filters.py::epf_step. For a tensor on the CPU the wrapper runs that
plain version; for a CUDA tensor it launches the kernel on the current
stream or raises. It never falls back from the card to the CPU.

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

import numpy as np
import torch

from ..filters import EPF_NEG_K, epf_step
from . import build

__all__ = ["bind", "epf_step_cuda", "kernel_params", "launch"]


def bind(lib: ctypes.CDLL):
    """The C entry jxl_epf_step of a built EPF library, its argument types
    set."""
    fn = lib.jxl_epf_step
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _fn():
    return bind(build.load("epf"))


@functools.lru_cache(maxsize=64)
def kernel_params(channel_scale: tuple, step_multiplier: float,
                  border_sad_mul: float) -> tuple:
    """The float arguments of the C entry jxl_epf_step, (cs0, cs1, cs2,
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
    into `out`, on the current stream. No checks and no launch count: the
    caller has made both."""
    _, h, w = planes.shape
    err = fn(
        planes.data_ptr(), sigma.data_ptr(), out.data_ptr(), h, w, step,
        *kernel_params(tuple(channel_scale), float(step_multiplier),
                       float(border_sad_mul)),
        # the current stream's handle; torch.cuda.current_stream() builds a
        # Stream object and costs more than the launch itself
        torch._C._cuda_getCurrentRawStream(planes.device.index),
    )
    if err != 0:
        raise RuntimeError(f"EPF kernel launch failed: error {err}")


def epf_step_cuda(planes: torch.Tensor, sigma: torch.Tensor, step: int,
                  channel_scale, step_multiplier: float,
                  border_sad_mul: float) -> torch.Tensor:
    """One EPF pass: planes [3, H, W] float32, sigma [H, W] float32.

    CPU tensors take the plain torch `epf_step`; CUDA tensors launch the
    kernel (one launch, counted in `epf_step_cuda.launches`)."""
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
    if planes.dim() != 3 or planes.shape[0] != 3:
        raise ValueError(f"planes must be [3, H, W], got {tuple(planes.shape)}")
    _, h, w = planes.shape
    if tuple(sigma.shape) != (h, w):
        raise ValueError(f"sigma {tuple(sigma.shape)} != planes {(h, w)}")
    if h * w >= 1 << 31:
        raise ValueError("plane too large for the kernel's int indexing")
    planes = planes.contiguous()
    sigma = sigma.contiguous()
    out = torch.empty_like(planes)
    launch(_fn(), planes, sigma, out, step, channel_scale, step_multiplier,
           border_sad_mul)
    _counted.launches += 1
    return out


epf_step_cuda.launches = 0
# the count lives on the wrapper; `_counted` keeps naming it while a
# measurement rebinds this module's `epf_step_cuda` to a wrapper of its own
# (epf_measure.capture_decode)
_counted = epf_step_cuda
