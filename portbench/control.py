#!/usr/bin/env python3
"""The readings that a configuration's limit is set from, on the card.

    python3 portbench/control.py --config <name> --seeds 1,2,3 [--slots 16]

For each seed it decodes the seed's pool with the port's
`decode_batch_stacked` as the loader does (output on the card, the
traffic's stack), and judges every image against the plain reference in
float64: the program's reading. The control is the reference itself put in
the program's place in the nearest precision below the float32 that the
port states: float32 with TF32 allowed in its matrix products. Its
reading is its gap from the float64 reference. The limit lies between
the largest program reading and the smallest control reading. One line
of JSON a seed on stdout; benchmark runs never run this."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def readings(config: dict, traffic: dict, seed: int, slots: int,
             device: str = "cuda") -> dict:
    """Per slot, the port's and the control's largest absolute gap from the
    float64 reference."""
    import importlib

    import torch

    from jxl_oxide_tpu_torch.serving import decode_batch_stacked
    from portbench.streams.pool import make_pool

    ref = importlib.import_module(f"portbench.reference.{config['reference']}")
    streams, inputs = make_pool(config, seed, slots,
                                len(os.sched_getaffinity(0)), range(slots))
    outs = decode_batch_stacked(
        streams, output="device", max_stack=traffic["max_stack"],
        num_workers=traffic["num_workers"],
        num_threads=traffic["num_threads"], device=device)
    port, control = [], []
    for slot, out in enumerate(outs):
        want = ref.decode(inputs[slot], torch.float64, device)
        port.append(float((out.double() - want).abs().max()))
        low = ref.decode(inputs[slot], torch.float32, device, tf32=True)
        control.append(float((low.double() - want).abs().max()))
        del want, low
    return {"seed": seed, "port": port, "control": control,
            "port_max": max(port), "control_min": min(control)}


def main() -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", default="loader_b16")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--slots", type=int, default=16)
    args = ap.parse_args()
    with open(os.path.join(HERE, "configs", f"{args.config}.json")) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", f"{args.traffic}.json")) as f:
        traffic = json.load(f)
    import torch

    if not torch.cuda.is_available():
        print("control.py needs the card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(config, traffic, seed, args.slots)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
