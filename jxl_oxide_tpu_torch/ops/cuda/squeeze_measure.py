"""Measuring the squeeze kernel (csrc/modular_squeeze.cu) on the card:
shared by chip_smoke.py and tools/squeeze_variants.py. Nothing in the
decode imports it.

- `probe`: the chain probe (csrc/squeeze_probe.cu), one step of the
  recurrence timed alone on the card, with `probe_tables` and
  `probe_checksums`, its walk in plain torch;
- `chain_bound_ms`: the squeeze's reachable bound, its serial steps times
  the probe's ns a step; `bound_ms`: its bytes over the HBM rate against
  its int32 operations over the ALU rate;
- `graph_ms` and `device_ms`: device time of a call or of one launch on
  the card's own clock, warm or cold; `misaligned`: a plane whose base is
  off a 16-byte boundary;
- `capture_launches`, `pyramid` and `pyramid_on_device`: the kernel's
  launches in a call, the default squeeze pyramid of a random plane, and
  its inverse on the device with the launches the device tail makes.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from .. import modular_tail as mt
from . import build
from . import squeeze as sq

__all__ = ["PROBE_ROUNDS", "PROBE_SPAN", "bound_ms", "capture_launches",
           "chain_bound_ms", "device_ms", "graph_ms", "misaligned", "probe",
           "probe_checksums", "probe_tables",
           "pyramid", "pyramid_on_device", "squeeze_bytes", "steps"]

# one H100 SXM (NVIDIA data sheet): HBM rate, L2; the fp32 rate outside the
# tensor cores (the sheet gives no integer-ALU rate), against which the
# squeeze's int32 operations are counted
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
L2_BYTES = 50e6
# int32 operations per squeeze step (two outputs) in the plain formula
# (ops/modular_tail.py): the tendency's 8 for its differences and 4a-3c-b,
# 11 for each of its two candidate quotients, 8 for the case test and
# select; the step's sum, halving (4) and two sums
OPS_PER_STEP = 45
# squeeze_math.cuh kProbeSpan: the values a probe line cycles through
PROBE_SPAN = 16
# the timed probe walks PROBE_ROUNDS x PROBE_SPAN steps (16,384: the launch
# is under 1 % of its time)
PROBE_ROUNDS = 1024


def steps(res: torch.Tensor, horizontal: bool) -> int:
    """Serial steps of one squeeze: the residual positions along the
    squeezed axis."""
    return res.shape[1] if horizontal else res.shape[0]


def squeeze_bytes(avg: torch.Tensor, res: torch.Tensor) -> int:
    """Bytes one squeeze must move: avg and the residual read once, the
    output (as many samples as both) written once, int32."""
    return 2 * 4 * (avg.numel() + res.numel())


def bound_ms(avg: torch.Tensor, res: torch.Tensor) -> tuple[float, str]:
    """Least time of one squeeze on these inputs by bytes and operations:
    its bytes over the HBM rate against its int32 operations over the ALU
    rate; and which of the two it is. The recurrence is serial, so the
    card cannot reach it: `chain_bound_ms` is the bound it can reach."""
    byte_ms = squeeze_bytes(avg, res) / HBM_BYTES_PER_S * 1e3
    op_ms = OPS_PER_STEP * res.numel() / ALU_OPS_PER_S * 1e3
    return max(byte_ms, op_ms), "bytes" if byte_ms >= op_ms else "operations"


def chain_bound_ms(res: torch.Tensor, horizontal: bool,
                   ns_per_step: float) -> float:
    """The squeeze's reachable bound: its serial steps times the probe's
    ns a step. Lines run beside each other and add nothing while they fit
    the card."""
    return steps(res, horizontal) * ns_per_step * 1e-6


def probe_tables(seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """The probe's seeded avg and residual values, PROBE_SPAN int32
    each, in the range of a 12-bit plane's squeeze."""
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(-4096, 4096, PROBE_SPAN).astype(np.int32)
                 for _ in range(2))


def probe_checksums(tab_avg: np.ndarray, tab_res: np.ndarray, lines: int,
                    rounds: int) -> torch.Tensor:
    """The probe's walk in plain torch (squeeze_math.cuh probe_load,
    probe_walk): the int32 checksum of each of `lines` lines."""
    idx = (np.arange(lines)[:, None] + np.arange(PROBE_SPAN)) % PROBE_SPAN
    a = torch.from_numpy(tab_avg[idx])
    r = torch.from_numpy(tab_res[idx])
    left = a[:, 0]
    total = torch.zeros(lines, dtype=torch.int32)
    for _ in range(rounds):
        for j in range(PROBE_SPAN):
            diff = r[:, j] + mt._tendency(left, a[:, j],
                                          a[:, (j + 1) % PROBE_SPAN])
            first = a[:, j] + mt._trunc_div2(diff)
            left = first - diff
            total = total + first + left
    return total


@functools.cache
def _probe_lib():
    lib = build.load("squeeze_probe")
    lib.jxl_squeeze_probe.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.jxl_squeeze_probe.restype = ctypes.c_int
    if lib.jxl_squeeze_probe_span() != PROBE_SPAN:
        raise RuntimeError("squeeze_probe.cu and PROBE_SPAN disagree")
    return lib


def probe(lines: int, rounds: int = PROBE_ROUNDS, seed: int = 0,
          launches: int = 3) -> dict:
    """The chain probe on the card: `lines` lines of rounds x PROBE_SPAN
    steps, after one launch to warm up. ns_per_step: CUDA events around
    `launches` launches, over their steps; cycles_per_step: each line's
    clock64 cycles of its walk over its steps (mean and max over lines,
    last launch); checksum: the last launch's, int32 on the CPU."""
    lib = _probe_lib()
    tabs = [torch.from_numpy(t).cuda() for t in probe_tables(seed)]
    checksum = torch.empty(lines, dtype=torch.int32, device="cuda")
    cycles = torch.empty(lines, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = lib.jxl_squeeze_probe(tabs[0].data_ptr(), tabs[1].data_ptr(),
                                    lines, rounds, checksum.data_ptr(),
                                    cycles.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"squeeze probe launch failed: error {err}")

    launch()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        launch()
    end.record()
    torch.cuda.synchronize()
    n = rounds * PROBE_SPAN
    per_line = cycles.double().cpu() / n
    return {
        "lines": lines,
        "steps": n,
        "ns_per_step": start.elapsed_time(end) / launches * 1e6 / n,
        "cycles_per_step": float(per_line.mean()),
        "cycles_per_step_max": float(per_line.max()),
        "checksum": checksum.cpu(),
    }


def graph_ms(run, cold: bool = False, replays: int = 5) -> float:
    """Device ms of one call of `run` on the card's clock: run() captured
    once in a CUDA graph and replayed between CUDA events, so no host work
    falls in the window. Warm: `replays` replays back to back. Cold: each
    replay timed alone after 256 MB (five times the L2) written to the
    card."""
    run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run()
    graph.replay()
    torch.cuda.synchronize()
    scratch = (torch.empty(1 << 26, dtype=torch.int32, device="cuda")
               if cold else None)
    times = []
    for _ in range(replays if cold else 1):
        if cold:
            scratch.fill_(1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(1 if cold else replays):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / (1 if cold else replays))
    return sum(times) / len(times)


def device_ms(fn, avg: torch.Tensor, res: torch.Tensor, horizontal: bool,
              cold: bool, launches: int = 20) -> float:
    """Device ms of one launch of `fn` (ops/cuda/squeeze.py `bind`) on
    these inputs, on the card's clock, not counted: `launches` launches
    timed as one graph (graph_ms, warm). Warm: all on one set of inputs.
    Cold: cycling over enough copies that between two uses of one copy
    the others move twice the 50 MB L2."""
    copies = 1 + math.ceil(2 * L2_BYTES / squeeze_bytes(avg, res)) if cold \
        else 1
    shape = ((avg.shape[0], avg.shape[1] + res.shape[1]) if horizontal
             else (avg.shape[0] + res.shape[0], avg.shape[1]))
    sets = [(avg.clone(), res.clone(),
             torch.empty(shape, dtype=torch.int32, device=avg.device))
            for _ in range(copies)]

    def run():
        for i in range(launches):
            sq.launch(fn, *sets[i % copies], horizontal)

    return graph_ms(run) / launches


def misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of `t` whose base is 4 bytes past a 16-byte
    boundary (the caching allocator's blocks are aligned): the horizontal
    kernel then copies with cp.async, not TMA."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


def pyramid(size: int, seed: int = 0):
    """(squeeze, slots, parent): the default squeeze pyramid of one random
    size x size plane (tools/measure_modular_device.py
    build_squeeze_case), in the port's own host structures."""
    from ...models import modular_transform as mtr

    rng = np.random.default_rng(seed)
    parent = rng.integers(-(1 << 10), 1 << 10, (size, size)).astype(np.int32)
    squeeze = mtr.Squeeze()
    squeeze.set_default_params([mtr.ChannelInfo(size, size)], 0)
    slots = [mtr.Slot(parent)]
    squeeze.check([mtr.ChannelInfo(size, size)], 0, slots, [])
    return squeeze, slots, parent


def capture_launches(run) -> tuple:
    """run()'s result and the squeeze launches it made, in order: (avg,
    residual, horizontal), the inputs copied. The decode and the device
    tail look the wrapper up on its module at each call; each launch still
    goes through it and is counted."""
    wrapper = sq.inv_squeeze_cuda
    seen = []

    def recording(avg, res, horizontal):
        seen.append((avg.clone(), res.clone(), horizontal))
        return wrapper(avg, res, horizontal)

    sq.inv_squeeze_cuda = recording
    try:
        out = run()
    finally:
        sq.inv_squeeze_cuda = wrapper
    return out, seen


def pyramid_on_device(size: int, device) -> tuple:
    """The device tail's inverse of `pyramid(size)` on `device`: its
    output plane and its kernel launches (capture_launches)."""
    from ...models.modular import inverse_transforms_device

    squeeze, slots, _ = pyramid(size)
    planes = [torch.from_numpy(np.ascontiguousarray(s.arr)).to(device)
              for s in slots]
    (out,), seen = capture_launches(
        lambda: inverse_transforms_device([squeeze], planes, 16))
    return out, seen
