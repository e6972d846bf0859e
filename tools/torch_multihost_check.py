"""Cross-process check of the port's sharded decode (jxl_oxide_tpu_torch).

The torch counterpart of tools/multihost_check.py: HOSTS processes, wired
through torch.distributed (gloo on the CPU, NCCL on cards), build one
("hosts", "chips") mesh of HOSTS x CHIPS shards
(parallel.decode_mesh_multihost), each process holding its CHIPS shards.
Every process runs the whole host stage on the same bytes and feeds only
its own shards; the halos at process borders cross the process boundary
(batch_isend_irecv), and every rank ends with the whole frame after an
all-gather of the bands. Each rank holds its sharded decode of two
committed fixtures, epf3_512 (row bands, EPF steps 0-2) and
wide_epf_1024x256 (column bands), bit for bit against its own
single-device decode.

Usage:
  python tools/torch_multihost_check.py [--hosts 2] [--chips 1]
      [--backend gloo|nccl] [--device cpu|cuda] [--timeout S]

The orchestrator starts the workers (the same script with --worker RANK),
prints one JSON line {"ok": bool, ...} and exits 0 or 1; it kills every
worker that outlives --timeout. With --device cuda, rank r's shards are
cards r*CHIPS.. when the host has a card for every shard.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = ("epf3_512", "wide_epf_1024x256")


def worker(args) -> dict:
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, _ROOT)
    from jxl_oxide_tpu_torch import JxlImage
    from jxl_oxide_tpu_torch.parallel import decode_mesh_multihost, sharded

    dist.init_process_group(
        args.backend, init_method=f"tcp://localhost:{args.port}",
        world_size=args.hosts, rank=args.worker)
    try:
        devices = ["cpu"] * args.chips if args.device == "cpu" else None
        mesh = decode_mesh_multihost(args.hosts, args.chips, devices=devices)
        if mesh.home_device.type == "cuda":
            torch.cuda.set_device(mesh.home_device)
        result = {"rank": args.worker, "mesh": repr(mesh), "fixtures": {}}
        ok = True
        for name in FIXTURES:
            path = os.path.join(_ROOT, "jxl_oxide_tpu_torch", "testdata",
                                f"{name}.jxl")
            with open(path, "rb") as f:
                data = f.read()
            single = JxlImage.from_bytes(data, device=mesh.home_device)
            want = torch.stack(single.render_frame(0).planes).cpu().numpy()
            sharded.reset_exchanged()
            got_img = JxlImage.from_bytes(data, mesh=mesh)
            got = torch.stack(got_img.render_frame(0).planes).cpu().numpy()
            equal = bool(got.shape == want.shape
                         and np.array_equal(got, want))
            ok = ok and equal
            result["fixtures"][name] = {
                "shape": list(got.shape), "equal": equal,
                "max_abs_diff": float(np.abs(got - want).max())
                if got.shape == want.shape else None,
                **dict(sharded.exchanged)}
        result["ok"] = ok
        return result
    finally:
        dist.destroy_process_group()


def orchestrate(hosts: int = 2, chips: int = 1, backend: str = "gloo",
                device: str = "cpu", timeout: float = 300.0) -> dict:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", str(r),
             "--port", str(port), "--hosts", str(hosts), "--chips",
             str(chips), "--backend", backend, "--device", device],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(hosts)
    ]
    result = {"ok": True, "hosts": hosts, "chips_per_host": chips,
              "backend": backend, "device": device, "workers": []}
    for r, p in enumerate(procs):
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, err = p.communicate()
            result["ok"] = False
            result["workers"].append({"rank": r, "rc": "timeout",
                                      "tail": err.strip().splitlines()[-3:]})
            continue
        lines = out.strip().splitlines()
        try:
            info = json.loads(lines[-1]) if lines else {}
        except json.JSONDecodeError:
            info = {}
        info["rc"] = p.returncode
        if p.returncode != 0 or not info.get("ok"):
            result["ok"] = False
            info["tail"] = err.strip().splitlines()[-3:]
        result["workers"].append(info)
    return result


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", type=int, default=None)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--hosts", type=int, default=2)
    ap.add_argument("--chips", type=int, default=1)
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--device", choices=["cpu", "cuda"], default="cpu")
    ap.add_argument("--timeout", type=float, default=300.0)
    args = ap.parse_args()
    if args.worker is not None:
        res = worker(args)
        print(json.dumps(res), flush=True)
        return 0 if res["ok"] else 1
    result = orchestrate(args.hosts, args.chips, args.backend, args.device,
                         args.timeout)
    print(json.dumps(result), flush=True)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
