"""Entry points of the PyTorch/CUDA port (jxl_oxide_tpu_torch) for a test
harness: a single-device forward step and a multi-device dry run.

`entry()` returns the flagship's forward step: the fused 4:4:4 VarDCT
program of the committed flagship_1024 stream (dequant, CfL, the dense
varblock transforms, gaborish, EPF through the K1 kernel) and its inputs
uploaded to the device, so that fn(*args) decodes the frame's planes.

`dryrun_multichip(n)` decodes committed fixtures (the card's host has no
encoder: the in-repo encoders import the JAX package) over a mesh of n
shards (parallel.decode_mesh: the first n CUDA devices, or `devices`) and
asserts that each equals the single-device decode bit for bit: row bands
(flagship_1024), column bands (wide_epf_1024x256), the subsampled program
(ycbcr420_1024) and the Modular device tail in row bands (modular_1024,
on CUDA); with n >= 4 and even, the 2-D ("hosts", "chips") mesh too.

    python3 graft_entry_torch.py [N]
"""

from __future__ import annotations

import os
import sys

import numpy as np

_ROOT = os.path.dirname(os.path.abspath(__file__))
_TESTDATA = os.path.join(_ROOT, "jxl_oxide_tpu_torch", "testdata")
DRYRUN_FIXTURES = ("flagship_1024", "wide_epf_1024x256", "ycbcr420_1024",
                   "modular_1024")


def _fixture(name: str) -> bytes:
    with open(os.path.join(_TESTDATA, f"{name}.jxl"), "rb") as f:
        return f.read()


def entry(device=None):
    """(fn, example_args): the flagship frame's fused program on `device`
    (default CUDA) and its uploaded inputs; fn(*args) -> [3, H, W]."""
    sys.path.insert(0, _ROOT)
    from jxl_oxide_tpu_torch import JxlImage
    from jxl_oxide_tpu_torch.device import resolve_device
    from jxl_oxide_tpu_torch.ops.vardct_pipeline import upload_inputs
    from jxl_oxide_tpu_torch.render.render import host_stage

    device = resolve_device(device)
    img = JxlImage.from_bytes(_fixture("flagship_1024"), device=device)
    host = host_stage(img._frames[0])
    _, make_fn, inputs = host.state.fused_program_parts(host.hf_global)
    return make_fn(device), upload_inputs(inputs, device)


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Each of DRYRUN_FIXTURES decoded over a mesh of n shards equals the
    single-device decode bit for bit; returns {fixture: shape}."""
    import torch

    sys.path.insert(0, _ROOT)
    from jxl_oxide_tpu_torch import JxlImage
    from jxl_oxide_tpu_torch.parallel import (
        decode_mesh,
        decode_mesh_multihost,
    )

    mesh = decode_mesh(n_devices, devices=devices)
    meshes = [mesh]
    if n_devices >= 4 and n_devices % 2 == 0:
        meshes.append(decode_mesh_multihost(2, n_devices // 2,
                                            devices=devices))

    def planes(data, **kw):
        r = JxlImage.from_bytes(data, **kw).render_frame(0)
        return torch.stack(r.planes).cpu().numpy()

    shapes = {}
    for name in DRYRUN_FIXTURES:
        data = _fixture(name)
        single = planes(data, device=mesh.home_device)
        assert np.isfinite(single).all(), name
        for m in meshes:
            got = planes(data, mesh=m)
            assert got.shape == single.shape, (name, m, got.shape)
            assert np.array_equal(got, single), (
                f"{name} over {m} differs from the single-device decode",
                float(np.abs(got - single).max()))
        shapes[name] = single.shape
    return shapes


if __name__ == "__main__":
    import torch

    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry ok", tuple(out.shape))
    n = int(sys.argv[1]) if len(sys.argv) > 1 else torch.cuda.device_count()
    print("dryrun ok", dryrun_multichip(n))
