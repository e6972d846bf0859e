#!/usr/bin/env python3
"""Time versions of the port's EPF kernel against each other on one GPU.

    python3 tools/epf_variants.py DIR [DIR ...]

Each DIR holds an epf.cu (and the headers it includes) with the C entry
jxl_epf_step_batched of jxl_oxide_tpu_torch/csrc/epf.cu, or the one-image
jxl_epf_step of an earlier version (ops/cuda/epf.py `bind` takes either,
and times one image through both alike); the committed kernel is
DIR = jxl_oxide_tpu_torch/csrc, an earlier one is that folder of an
earlier commit unpacked with `git archive`. Each is built with the port's
nvcc flags (ptxas registers and spills printed), held against the plain
torch epf_step, and timed on the card's clock with the helpers of
jxl_oxide_tpu_torch/ops/cuda/epf_measure.py (launches replayed from a CUDA
graph), warm and cold, in turns: the versions in order, then in reverse;
each later version's output is also held bit for bit against the first
one's (the count of differing values, 0 where a change keeps the
arithmetic).
The inputs: seeded planes of each shape in SHAPES (environment,
"3x1024x1024,3x2048x2048" by default), then the EPF passes of the
committed flagship fixture's decode on the card (the main path). Prints
the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import os
import re
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAIN_PATH = os.path.join(REPO, "jxl_oxide_tpu_torch", "testdata",
                         "flagship_1024.jxl")


def build(i: int, src_dir: str):
    """nvcc DIR/epf.cu into _build/variants/<i>/; the bound C entry."""
    from jxl_oxide_tpu_torch.ops.cuda import build as b
    from jxl_oxide_tpu_torch.ops.cuda.epf import bind

    out = os.path.join(b.BUILD_DIR, "variants", str(i))
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, "libepf.so")
    proc = subprocess.run(
        [b._nvcc(), *b.NVCC_FLAGS, "-o", lib,
         os.path.join(src_dir, "epf.cu")],
        capture_output=True, text=True, timeout=600,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src_dir}:\n{proc.stderr}")
    step = "?"
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"epf_kernelILi(\d)E", line)
        if m and "Compiling entry" in line:
            step = m.group(1)
        if "registers" in line or "spill" in line:
            print(f"  {src_dir} step {step}: {line.strip()}")
    return bind(ctypes.CDLL(lib))


def cases():
    """(label, planes, sigma, step, channel_scale, step_multiplier,
    border_sad_mul) of every pass to time."""
    import torch

    from jxl_oxide_tpu_torch.ops.cuda import epf_measure as em

    shapes = [tuple(int(v) for v in s.split("x")) for s in os.environ.get(
        "SHAPES", "3x1024x1024,3x2048x2048").split(",")]
    for i, shape in enumerate(shapes):
        p, s = em.epf_inputs(shape, seed=i)
        planes = torch.from_numpy(p).cuda()
        sigma = torch.from_numpy(s).cuda()
        for step, sm in em.STEPS:
            yield (f"{shape} step {step}", planes, sigma, step,
                   em.CHANNEL_SCALE, sm, em.BORDER_SAD_MUL)
    with open(MAIN_PATH, "rb") as f:
        _, passes = em.capture_decode(f.read())
    for planes, sigma, step, cs, sm, bsm in passes:
        yield (f"main path {tuple(planes.shape)} step {step}", planes, sigma,
               step, cs, sm, bsm)


def main() -> int:
    import torch

    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from jxl_oxide_tpu_torch.ops.cuda import epf_measure as em
    from jxl_oxide_tpu_torch.ops.cuda.epf import launch
    from jxl_oxide_tpu_torch.ops.filters import epf_step

    print(f"card: {em.card()}", flush=True)
    names = sys.argv[1:]
    fns = {n: build(i, n) for i, n in enumerate(names)}
    for label, planes, sigma, step, cs, sm, bsm in cases():
        args = (step, cs, sm, bsm)
        want = epf_step(planes, sigma, *args)
        bound, by = em.bound_ms(sigma, step)
        warm = em.input_sets(planes, sigma, cold=False)
        cold = em.input_sets(planes, sigma, cold=True)
        times = {n: ([], []) for n in names}
        for n in names + names[::-1]:
            times[n][0].append(em.device_ms(fns[n], warm, *args))
            times[n][1].append(em.device_ms(fns[n], cold, *args))
        parts = []
        first = None
        for n in names:
            out = torch.empty_like(planes)
            launch(fns[n], planes, sigma, out, *args)
            torch.cuda.synchronize()
            err = float((out - want).abs().max())
            w, c = (statistics.fmean(v) for v in times[n])
            same = ""
            if first is None:
                first = out
            else:
                same = (f", {int((out != first).sum())} values differ "
                        f"from {names[0]}")
            parts.append(f"{n}: max|diff| {err:.2g}{same}, warm {w:.4f} ms, "
                         f"cold {c:.4f} ms ({bound / c:.3f} of bound)")
        print(f"{label}, bound {bound:.4f} ms ({by}): " + " | ".join(parts),
              flush=True)
        del warm, cold
    return 0


if __name__ == "__main__":
    sys.exit(main())
