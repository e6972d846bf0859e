"""Wrapper of K12, the hand-written CUDA noise field kernel
(csrc/noise.cu, its arithmetic in csrc/noise_math.cuh).

K12 has no TPU counterpart: the JAX package builds the field on the host
(jxl_oxide_tpu/render/features.py `_noise_field`). Its plain version is
ops/noise.py `noise_field_plain` (numpy). On the CPU the wrapper returns
that; on a CUDA device it launches the kernel on the current stream or
raises. It never falls back from the card to the CPU.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from ..noise import N_LANES, noise_field_plain
from . import build

__all__ = ["launch", "noise_field_cuda"]


@functools.cache
def _fn():
    fn = build.load("noise").jxl_noise_field
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_ulonglong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(out: torch.Tensor, group_dim: int, seed0: int) -> None:
    """One launch into `out`, a contiguous [3, H, W] float32 CUDA tensor,
    on the current stream. No checks and no launch count: the caller has
    made both (the timing in chip_smoke.py launches through here)."""
    _, h, w = out.shape
    err = _fn()(out.data_ptr(), w, h, group_dim, seed0,
                torch._C._cuda_getCurrentRawStream(out.device.index))
    if err != 0:
        raise RuntimeError(f"noise field kernel launch failed: error {err}")


def noise_field_cuda(width: int, height: int, group_dim: int, seed0: int,
                     device) -> torch.Tensor:
    """The [3, height, width] float32 noise field of a frame cut into
    group_dim squares, seeded with seed0, on `device`. On the CPU: the
    plain version. On a CUDA device: one launch of K12, counted in
    `noise_field_cuda.launches`."""
    device = torch.device(device)
    if device.type == "cpu":
        return torch.from_numpy(
            noise_field_plain(width, height, group_dim, seed0))
    if device.type != "cuda":
        raise ValueError(f"noise_field_cuda: device {device} (CUDA or CPU)")
    if width <= 0 or height <= 0 or group_dim <= 0:
        raise ValueError(f"noise field {width}x{height}, group {group_dim}")
    groups = -(-width // group_dim) * -(-height // group_dim)
    if groups * N_LANES >= 1 << 31:
        raise ValueError("too many noise groups for the kernel's indexing")
    if not 0 <= seed0 < 1 << 64:
        raise ValueError(f"seed {seed0} is not a u64")
    out = torch.empty((3, height, width), dtype=torch.float32, device=device)
    launch(out, group_dim, seed0)
    with _count_lock:
        _counted.launches += 1
    return out


noise_field_cuda.launches = 0
# frames of one keyframe render on several threads
_count_lock = threading.Lock()
# the count lives on the wrapper; `_counted` keeps naming it while a
# measurement rebinds this module's `noise_field_cuda` to a wrapper of its
# own (chip_smoke.py watches the launches of a decode so)
_counted = noise_field_cuda
