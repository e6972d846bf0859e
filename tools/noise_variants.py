#!/usr/bin/env python3
"""Time versions of the port's noise field kernel (K12) against each other
on one GPU, at several segment lengths.

    python3 tools/noise_variants.py DIR [DIR ...] [--segs 64,128,256]

Each DIR holds a noise.cu (and the noise_math.cuh it includes) with the C
entry jxl_noise_field of jxl_oxide_tpu_torch/csrc/noise.cu; the committed
kernel is DIR = jxl_oxide_tpu_torch/csrc, an earlier one that folder of an
earlier commit unpacked with `git archive` into a gitignored folder:

    git archive HEAD~1 jxl_oxide_tpu_torch/csrc | tar -x -C scratch_checkout/
    python3 tools/noise_variants.py \\
        scratch_checkout/jxl_oxide_tpu_torch/csrc jxl_oxide_tpu_torch/csrc

Each is built with the port's nvcc flags (ptxas registers and spills
printed), held bit for bit against the plain version (ops/noise.py
`noise_field_plain`) at every segment length on every shape below, and
timed on the card's clock (chip_smoke.py `noise_device_ms`: launches
replayed from CUDA graphs between CUDA events; warm, 20 launches a graph;
cold, one a graph, 256 MB written to the card before each) in turns: the
versions in order, then in reverse. The shapes are chip_smoke.py's timed
ones: 1024^2 and 2048^2 in 256^2 groups, and
features_up2_1024's one 1024^2 group. Beside each time: the function's
bound (chip_smoke.py `noise_bound_ms`) and the cold share of it. Prints
the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((1024, 1024, 256), (2048, 2048, 256), (1024, 1024, 1024))
SEGS = (64, 128, 256)


def build(i: int, src_dir: str):
    """nvcc DIR/noise.cu into _build/noise_variants/<i>/; the bound C
    entry."""
    from jxl_oxide_tpu_torch.ops.cuda import build as b
    from jxl_oxide_tpu_torch.ops.cuda.noise import bind

    out = os.path.join(b.BUILD_DIR, "noise_variants", str(i))
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, "libnoise.so")
    proc = subprocess.run(
        [b._nvcc(), *b.NVCC_FLAGS, "-o", lib,
         os.path.join(src_dir, "noise.cu")],
        capture_output=True, text=True, timeout=600,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src_dir}:\n{proc.stderr}")
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"  {src_dir}: {line.strip()}")
            if "spill" in line and not (" 0 bytes spill stores, 0 bytes "
                                        "spill loads" in line):
                raise RuntimeError(f"{src_dir} spills registers")
    return bind(ctypes.CDLL(lib))


def main() -> int:
    import numpy as np
    import torch

    args = sys.argv[1:]
    segs = SEGS
    if "--segs" in args:
        i = args.index("--segs")
        segs = tuple(int(s) for s in args[i + 1].split(","))
        del args[i:i + 2]
    if not torch.cuda.is_available() or not args:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from jxl_oxide_tpu_torch.ops.cuda import epf_measure as em
    from jxl_oxide_tpu_torch.ops.cuda import noise as k12
    from jxl_oxide_tpu_torch.ops.noise import noise_field_plain, noise_seed0

    print(f"card: {em.card()}", flush=True)
    fns = {n: build(i, n) for i, n in enumerate(args)}
    seed0 = noise_seed0(1, 0)
    device = torch.device("cuda")
    for w, h, gdim in SHAPES:
        want = noise_field_plain(w, h, gdim, seed0).view(np.uint32)
        bound, by, _ = cs.noise_bound_ms(w, h, gdim)
        for seg in segs:
            for n, fn in fns.items():
                out = torch.empty((3, h, w), dtype=torch.float32,
                                  device=device)
                k12.launch(out, gdim, seed0, seg, fn)
                if not np.array_equal(out.cpu().numpy().view(np.uint32),
                                      want):
                    raise AssertionError(f"{n} differs from plain on "
                                         f"{w}x{h}/{gdim}, seg {seg}")
            times = {n: ([], []) for n in fns}
            for n in list(fns) + list(fns)[::-1]:
                warm, cold = cs.noise_device_ms(w, h, gdim, seed0, seg,
                                                fns[n])
                times[n][0].append(warm)
                times[n][1].append(cold)
            parts = []
            for n in fns:
                wm, cm = (statistics.fmean(v) for v in times[n])
                parts.append(
                    f"{n}: warm {wm:.4f} ms "
                    f"({' / '.join(f'{t:.4f}' for t in times[n][0])}), cold "
                    f"{cm:.4f} ms "
                    f"({' / '.join(f'{t:.4f}' for t in times[n][1])}), "
                    f"cold share {bound / cm:.3f}")
            print(f"{w}x{h} in {gdim}^2 groups, seg {seg} "
                  f"({k12.launch_shape(w, h, gdim, seg)[1]} threads), bound "
                  f"{bound:.4f} ms ({by}), bit for bit: " + " | ".join(parts),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
