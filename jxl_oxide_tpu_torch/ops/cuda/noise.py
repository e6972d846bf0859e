"""Wrapper of K12, the hand-written CUDA noise field kernel
(csrc/noise.cu, its arithmetic in csrc/noise_math.cuh).

K12 has no TPU counterpart: the JAX package builds the field on the host
(jxl_oxide_tpu/render/features.py `_noise_field`). Its plain version is
ops/noise.py `noise_field_plain` (numpy). On the CPU the wrapper returns
that; on a CUDA device it launches the kernel on the current stream of
that device, made current for the launch, or raises. It never falls back
from the card to the CPU.

The kernel runs one thread per (group, lane, segment of `seg` batches):
each jumps to its segment's start with a row of the jump table
(ops/noise.py `jump_table`), which lives on the device, one per (seg,
device), until `clear_jump_tables` (called by `clear_program_caches`).
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading

import numpy as np
import torch

from ..noise import N_LANES, jump_table, noise_field_plain, noise_groups
from . import build

__all__ = ["bind", "clear_jump_tables", "launch", "launch_shape",
           "noise_field_cuda", "segment_steps"]

# The reckoning behind `segment_steps` (csrc/noise.cu's note). A thread
# costs 128 + seg steps of latency, STEP_LATENCY_S a step when few warps
# share an SM (one-group 1024^2 at seg 1024 on an H100: 26.6 us over 1,152
# steps, launches replayed from a CUDA graph, tools/noise_variants.py);
# the card runs all threads' steps, (1 + 128 / seg) x the frame's, at
# STEP_SPREAD_S a step when they fill it (2048^2 in 256^2 groups at seg
# 32: 38.6 us over 5 x 6.29 M steps). With the two costs added, t(seg) =
# STEP_LATENCY_S (128 + seg) + STEP_SPREAD_S steps (1 + 128 / seg) is least
# at seg = sqrt(128 steps STEP_SPREAD_S / STEP_LATENCY_S), rounded up to a
# power of two in [SEG_MIN, SEG_MAX]: 128 for a 1024^2 field (the sweeps'
# best), 256 for 2048^2 in 256^2 groups (within 6 % of the best, 128-512
# being flat).
STEP_LATENCY_S = 23e-9
STEP_SPREAD_S = 1.23e-12
SEG_MIN, SEG_MAX = 32, 4096


def bind(lib: ctypes.CDLL):
    """The C entry jxl_noise_field of a built noise library, typed."""
    fn = lib.jxl_noise_field
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_ulonglong, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _fn():
    return bind(build.load("noise"))


@functools.lru_cache(maxsize=64)
def segment_steps(width: int, height: int, group_dim: int) -> int:
    """seg, the batches a thread walks after its jump, for a width x height
    field in group_dim squares: the least of the reckoning's t(seg) above,
    rounded up to a power of two."""
    steps = sum(N_LANES * wn2 * gh * 3
                for *_, gh, wn2 in noise_groups(width, height, group_dim))
    best = math.sqrt(128 * steps * STEP_SPREAD_S / STEP_LATENCY_S)
    seg = 1 << max(0, math.ceil(math.log2(max(1.0, best))))
    return min(SEG_MAX, max(SEG_MIN, seg))


@functools.lru_cache(maxsize=64)
def launch_shape(width: int, height: int, group_dim: int,
                 seg: int) -> tuple[int, int]:
    """(segments, threads) of a launch: the segments of the largest group's
    lane walk (the jump table's rows), and one thread per (group, lane,
    segment)."""
    _, _, _, gh, wn2 = noise_groups(width, height, group_dim)[0]
    segments = -(-wn2 * gh * 3 // seg)
    groups = -(-width // group_dim) * -(-height // group_dim)
    return segments, groups * N_LANES * segments


_tables: dict = {}  # (seg, device) -> int64 [rows, 2]: ops/noise.py's rows
_tables_lock = threading.Lock()


def _device_table(seg: int, segments: int, device) -> torch.Tensor:
    """The jump table of `seg` with at least `segments` rows on `device`,
    cached; a frame that needs more rows extends it."""
    key = (seg, device)
    table = _tables.get(key)
    if table is None or table.shape[0] < segments:
        with _tables_lock:
            table = _tables.get(key)
            if table is None or table.shape[0] < segments:
                host = jump_table(seg, segments).view(np.int64)
                table = torch.from_numpy(host).to(device)
                _tables[key] = table
    return table


def clear_jump_tables() -> None:
    """Drop the device jump tables (api.py `clear_program_caches`)."""
    with _tables_lock:
        _tables.clear()


def launch(out: torch.Tensor, group_dim: int, seed0: int,
           seg: int | None = None, fn=None) -> None:
    """One launch of `fn` (from `bind`; default the port's K12) into `out`,
    a contiguous [3, H, W] float32 CUDA tensor, with segments of `seg`
    batches (default `segment_steps`), on the current stream of out's
    device, which is made the current device for the launch; the jump
    table is put on that device. No checks and no launch count: the
    caller has made both (the timing in chip_smoke.py launches through
    here)."""
    _, h, w = out.shape
    seg = seg or segment_steps(w, h, group_dim)
    segments, _ = launch_shape(w, h, group_dim, seg)
    table = _device_table(seg, segments, out.device)
    prev = torch.cuda._exchange_device(out.device.index)
    try:
        err = (fn or _fn())(out.data_ptr(), w, h, group_dim, seed0,
                    table.data_ptr(), table.shape[0], seg,
                    torch._C._cuda_getCurrentRawStream(out.device.index))
    finally:
        torch.cuda._maybe_exchange_device(prev)
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
    _, threads = launch_shape(width, height, group_dim,
                              segment_steps(width, height, group_dim))
    if threads >= 1 << 31:
        raise ValueError("too many noise threads for the kernel's indexing")
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
