"""k1_roofline (%): the least time K1's passes in the window could take,
over their time in the profiler's trace.

K1 is the port's EPF kernel (`csrc/epf.cu`, symbol `epf_kernel`). A pass
reads three planes and sigma and writes three planes, 28 B a pixel (the
byte count of `ops/cuda/epf_measure.py`, frozen here), each byte once,
at the card's HBM rate from peaks.json. The pixels: each K1 launch in the
trace filters one stack, frame height x width x the stack's images, the
images decoded over the `Stacked program inputs` spans of the window. The
launch count is checked against stacks x the frame's `epf_iters` on
standard error. The card's name and power limit go there too."""

import subprocess
import sys

BYTES_PER_PIXEL = 28
SYMBOL = "epf_kernel"


def pass_bytes(height: int, width: int, images: float) -> float:
    return BYTES_PER_PIXEL * height * width * images


def read(record):
    trace = record["trace"]
    rate = record["peaks"].get("hbm_bytes_per_s")
    if not trace or not rate:
        return None
    k1 = [d for name, _, d in trace["device_ops"] if SYMBOL in name]
    stacks = sum(1 for s in record["spans"]
                 if s[0] == "Stacked program inputs")
    if not k1 or not stacks or not record["images"]:
        return None
    geo = record["config"]["geometry"]
    per_stack = record["images"] / stacks
    least_s = len(k1) * pass_bytes(geo["height"], geo["width"],
                                   per_stack) / rate
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        card = "nvidia-smi not readable"
    print(f"[portbench] k1_roofline: {len(k1)} launches, {stacks} stacks x "
          f"epf_iters {record['config']['params'].get('epf_iters')}, "
          f"{per_stack:.3f} images a stack; card {card}", file=sys.stderr)
    return 100.0 * least_s / (sum(k1) / 1e6)
