"""Wrapper of the hand-written CUDA inverse-squeeze kernel
(csrc/modular_squeeze.cu).

Replaces jxl_oxide_tpu/ops/modular_tail.py::_inv_squeeze_h_core (a
lax.scan, reached from inv_squeeze_h_device / inv_squeeze_v_device); same
contract as ops/modular_tail.py inv_squeeze_h / inv_squeeze_v. For tensors
on the CPU the wrapper runs that plain version; for CUDA tensors it
launches the kernel on the current stream or raises. It never falls back
from the card to the CPU.

The recurrence is sequential along the squeezed axis, so the kernel runs
one thread per line across the other axis and is bound by its chain of
dependent integer operations, not by its 8 B per output sample
(csrc/modular_squeeze.cu; the bound, measured by the chain probe, is
squeeze_measure.py `chain_bound_ms`). `bind` and `launch` serve the
timing in chip_smoke.py and tools/squeeze_variants.py, which launch into
outputs they allocated and are not counted.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from ..modular_tail import inv_squeeze_h, inv_squeeze_v
from . import build

__all__ = ["bind", "inv_squeeze_cuda", "launch"]


def bind(lib: ctypes.CDLL):
    """The C entry jxl_inv_squeeze of a built squeeze library, its
    argument types set."""
    fn = lib.jxl_inv_squeeze
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _fn():
    return bind(build.load("modular_squeeze"))


def launch(fn, avg: torch.Tensor, residu: torch.Tensor, out: torch.Tensor,
           horizontal: bool) -> None:
    """One launch of `fn` (from `bind`) on contiguous int32 CUDA tensors,
    into `out`, on the current stream of their device, which is made the
    current device for the launch (a mesh puts row bands on several
    cards). No checks and no launch count: the caller has made both."""
    if horizontal:
        lines, na = avg.shape
        nr = residu.shape[1]
    else:
        na, lines = avg.shape
        nr = residu.shape[0]
    prev = torch.cuda._exchange_device(avg.device.index)
    try:
        err = fn(avg.data_ptr(), residu.data_ptr(), out.data_ptr(), lines,
                 na, nr, int(horizontal),
                 torch._C._cuda_getCurrentRawStream(avg.device.index))
    finally:
        torch.cuda._maybe_exchange_device(prev)
    if err != 0:
        raise RuntimeError(f"squeeze kernel launch failed: error {err}")


def inv_squeeze_cuda(avg: torch.Tensor, residu: torch.Tensor,
                     horizontal: bool) -> torch.Tensor:
    """Inverse squeeze of one channel along its columns (horizontal: avg
    [h, (w+1)//2], residu [h, w//2] -> [h, w]) or its rows (avg
    [(h+1)//2, w], residu [h//2, w] -> [h, w]), int32.

    CPU tensors take the plain `inv_squeeze_h` / `inv_squeeze_v`; CUDA
    tensors launch the kernel (one launch, counted in
    `inv_squeeze_cuda.launches`), except where there is no residual, which
    returns avg as the plain version does."""
    if avg.device.type == "cpu" and residu.device.type == "cpu":
        return (inv_squeeze_h if horizontal else inv_squeeze_v)(avg, residu)
    if avg.device.type != "cuda" or residu.device != avg.device:
        raise ValueError(
            f"inv_squeeze_cuda: avg on {avg.device}, residual on "
            f"{residu.device}; both must be on one CUDA device (or the CPU)"
        )
    if avg.dtype != torch.int32 or residu.dtype != torch.int32:
        raise TypeError("inv_squeeze_cuda takes int32 planes")
    if avg.dim() != 2 or residu.dim() != 2:
        raise ValueError("inv_squeeze_cuda takes 2-D planes")
    axis = 1 if horizontal else 0
    na, nr = avg.shape[axis], residu.shape[axis]
    if avg.shape[1 - axis] != residu.shape[1 - axis] or na not in (nr, nr + 1):
        raise ValueError(f"squeeze planes {tuple(avg.shape)} and "
                         f"{tuple(residu.shape)} do not pair "
                         f"({'horizontal' if horizontal else 'vertical'})")
    if nr == 0:
        return avg
    shape = (avg.shape[0], na + nr) if horizontal else (na + nr, avg.shape[1])
    if shape[0] * shape[1] >= 1 << 31:
        raise ValueError("plane too large for the kernel")
    avg = avg.contiguous()
    residu = residu.contiguous()
    out = torch.empty(shape, dtype=torch.int32, device=avg.device)
    launch(_fn(), avg, residu, out, horizontal)
    with _count_lock:
        _counted.launches += 1
    return out


inv_squeeze_cuda.launches = 0
# frames of one keyframe render on several threads: `+=` on an attribute
# is a read and a write, and two launches between them would count once
_count_lock = threading.Lock()
# the count lives on the wrapper; `_counted` keeps naming it while a
# measurement rebinds this module's `inv_squeeze_cuda` to a wrapper of its
# own (chip_smoke.py)
_counted = inv_squeeze_cuda
