#!/usr/bin/env python3
"""Time versions of the port's squeeze kernel against each other on one
GPU.

    python3 tools/squeeze_variants.py DIR [DIR ...]

Each DIR holds a modular_squeeze.cu (and the squeeze_math.cuh it
includes) with the C entry jxl_inv_squeeze of
jxl_oxide_tpu_torch/csrc/modular_squeeze.cu; the committed kernel is DIR =
jxl_oxide_tpu_torch/csrc, an earlier one is that folder of an earlier
commit unpacked with `git archive` into a gitignored folder:

    git archive HEAD~1 jxl_oxide_tpu_torch/csrc | tar -x -C scratch_checkout/
    python3 tools/squeeze_variants.py \\
        scratch_checkout/jxl_oxide_tpu_torch/csrc jxl_oxide_tpu_torch/csrc

Each is built with the port's nvcc flags (ptxas registers, shared memory
and spills printed), held bit for bit against the plain torch
inv_squeeze_h / inv_squeeze_v on every launch below, and timed on the
card's clock (ops/cuda/squeeze_measure.py: launches replayed from a CUDA
graph between CUDA events), warm and cold, in turns: the versions in
order, then in reverse (old, new, new, old for two). The launches:
`modular_1024`'s squeeze, captured from its decode on the card through
the public entry point, and the 16 launches of the default squeeze
pyramid of a 2048^2 plane, timed as one graph. Beside each time: the
chain bound (the launch's serial steps times the chain probe's ns a step,
csrc/squeeze_probe.cu) and the cold share of it. Prints the card's name
and power limit first.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "jxl_oxide_tpu_torch", "testdata",
                       "modular_1024.jxl")
PYRAMID = 2048


def build(i: int, src_dir: str):
    """nvcc DIR/modular_squeeze.cu into _build/squeeze_variants/<i>/; the
    bound C entry."""
    from jxl_oxide_tpu_torch.ops.cuda import build as b
    from jxl_oxide_tpu_torch.ops.cuda.squeeze import bind

    out = os.path.join(b.BUILD_DIR, "squeeze_variants", str(i))
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, "libmodular_squeeze.so")
    proc = subprocess.run(
        [b._nvcc(), *b.NVCC_FLAGS, "-o", lib,
         os.path.join(src_dir, "modular_squeeze.cu")],
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


def pass_ms(fn, launches, outs, cold: bool) -> float:
    """Device ms of one pass over `launches` (avg, residual, horizontal)
    with `fn`, into `outs`, timed as one graph (squeeze_measure.graph_ms:
    cold, each replay after the L2 is flushed)."""
    from jxl_oxide_tpu_torch.ops.cuda import squeeze as sq
    from jxl_oxide_tpu_torch.ops.cuda import squeeze_measure as sm

    def run():
        for (avg, res, horizontal), out in zip(launches, outs):
            sq.launch(fn, avg, res, out, horizontal)

    return sm.graph_ms(run, cold)


def cases(device):
    """(label, launches): modular_1024's squeeze launch, captured from its
    decode, and the 2048^2 pyramid's launches."""
    from jxl_oxide_tpu_torch import JxlImage
    from jxl_oxide_tpu_torch.ops.cuda import squeeze_measure as sm

    with open(FIXTURE, "rb") as f:
        data = f.read()
    _, launches = sm.capture_launches(
        lambda: JxlImage.from_bytes(data, device=device).render_frame(0)
        .to_u8())
    yield "modular_1024 launch", launches
    _, launches = sm.pyramid_on_device(PYRAMID, device)
    yield f"pyramid {PYRAMID}^2 ({len(launches)} launches)", launches


def main() -> int:
    import torch

    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from jxl_oxide_tpu_torch.ops import modular_tail as mt
    from jxl_oxide_tpu_torch.ops.cuda import epf_measure as em
    from jxl_oxide_tpu_torch.ops.cuda import squeeze as sq
    from jxl_oxide_tpu_torch.ops.cuda import squeeze_measure as sm

    print(f"card: {em.card()}", flush=True)
    names = sys.argv[1:]
    fns = {n: build(i, n) for i, n in enumerate(names)}
    probe = sm.probe(1024)
    print(f"chain probe, 1024 lines: {probe['ns_per_step']:.3f} ns a step, "
          f"{probe['cycles_per_step']:.2f} SM cycles", flush=True)
    device = torch.device("cuda")
    for label, launches in cases(device):
        steps = sum(sm.steps(r, h) for _, r, h in launches)
        chain = steps * probe["ns_per_step"] * 1e-6
        wants = [(mt.inv_squeeze_h if h else mt.inv_squeeze_v)(a, r)
                 for a, r, h in launches]
        outs = {n: [torch.empty_like(w) for w in wants] for n in names}
        for n in names:
            for (avg, res, horizontal), out, want in zip(launches, outs[n],
                                                         wants):
                sq.launch(fns[n], avg, res, out, horizontal)
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise AssertionError(f"{n} differs from plain on {label} "
                                         f"{tuple(avg.shape)} "
                                         f"{'h' if horizontal else 'v'}")
        times = {n: ([], []) for n in names}
        for n in names + names[::-1]:
            times[n][0].append(pass_ms(fns[n], launches, outs[n], False))
            times[n][1].append(pass_ms(fns[n], launches, outs[n], True))
        parts = []
        for n in names:
            w, c = (statistics.fmean(v) for v in times[n])
            parts.append(f"{n}: equal to plain, warm {w:.4f} ms "
                         f"({' / '.join(f'{t:.4f}' for t in times[n][0])}), "
                         f"cold {c:.4f} ms "
                         f"({' / '.join(f'{t:.4f}' for t in times[n][1])}), "
                         f"{c * 1e6 / steps:.1f} ns a step cold, cold share "
                         f"of chain bound {chain / c:.3f}")
        print(f"{label}, {steps} serial steps, chain bound {chain:.4f} ms: "
              + " | ".join(parts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
