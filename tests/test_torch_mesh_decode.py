"""Decodes over a mesh of CPU shards (jxl_oxide_tpu_torch.parallel
decode_mesh(n, devices=["cpu"] * n)): each equal to the port's
single-device decode bit for bit (planes and u8), and within 1 LSB of the
JAX package's decode over a mesh of as many virtual CPU devices
(tests/conftest.py) in u8; lossless streams exactly. Rows and columns, 2,
3 and 4 shards, trailing pure-padding shards, both fused programs, the
staged fallback, the Modular device tail in row bands, serving, a loading
render, a region and the CLI.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import jxl_oxide_tpu.render.vardct as jvmod
import torch_parity as tp
from jxl_oxide_tpu import JxlImage as JaxImage
from jxl_oxide_tpu_torch import JxlImage, decode_batch, decode_batch_stacked
from jxl_oxide_tpu_torch.parallel import decode_mesh, sharded
from jxl_oxide_tpu_torch.render import vardct as tvmod
from jxl_oxide_tpu_torch.utils import options as opts


def _cpu_mesh(n):
    return decode_mesh(n, devices=["cpu"] * n)


def _jax_mesh(n):
    return Mesh(np.array(jax.devices()[:n]), axis_names=("groups",))


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads a test: the tier-1 run has six workers on the
    machine's cores, and torch's default (one thread a core in each
    worker) oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _port(img):
    r = img.render_frame(0)
    return torch.stack(r.planes).numpy(), r.to_u8()


def _jax_u8(data, n):
    return JaxImage.from_bytes(data, mesh=_jax_mesh(n)).render_frame(
        0).to_u8()


@pytest.fixture
def paths(monkeypatch):
    """The device paths the port's VarDCT frames took, in order."""
    taken = []
    for name in ("_run_fused", "_run_fused_subsampled", "_run_fused_sharded",
                 "_run_fused_subsampled_sharded", "_run_staged"):
        real = getattr(tvmod.VardctFrameState, name)

        def spy(self, *a, _real=real, _name=name, **k):
            taken.append(_name)
            return _real(self, *a, **k)

        monkeypatch.setattr(tvmod.VardctFrameState, name, spy)
    return taken


def _check(data, n, paths=None):
    """The port over n CPU shards against its single-device decode (bit
    for bit) and the JAX package over n devices (u8 within 1 LSB); returns
    the halo bytes the sharded decode moved. `paths` (the fixture) is
    cleared after the single-device decode."""
    want, want_u8 = _port(JxlImage.from_bytes(data, device="cpu"))
    if paths is not None:
        paths.clear()
    sharded.reset_exchanged()
    got, u8 = _port(JxlImage.from_bytes(data, mesh=_cpu_mesh(n)))
    moved = sharded.exchanged["bytes"]
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(u8, want_u8)
    assert tp.max_lsb(u8, _jax_u8(data, n)) <= 1
    return moved


def _alpha(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w)).astype(
        np.int64)


# name -> (stream, shards, the sharded path it takes)
CASES = {
    # two group rows, DCT8, gaborish + EPF 2
    "rows_2": (lambda: tp.vardct_stream(512, 256, 1, gabor=True,
                                        epf_iters=2), 2, "_run_fused_sharded"),
    # two group rows on 3 shards: shard 2 is pure padding
    "rows_3_padding": (lambda: tp.vardct_stream(512, 256, 1, gabor=True,
                                                epf_iters=2), 3,
                       "_run_fused_sharded"),
    # three group rows on 2 shards: the valid edge inside shard 1
    "three_rows_2": (lambda: tp.vardct_stream(768, 200, 2, gabor=True,
                                              epf_iters=2), 2,
                     "_run_fused_sharded"),
    # a wide frame by column bands, three group columns on 4 shards
    "cols_4_padding": (lambda: tp.vardct_stream(200, 768, 3, gabor=True,
                                                epf_iters=2), 4,
                       "_run_fused_sharded"),
    # per-tile CfL, adaptive LF smoothing across the band edge, EPF steps
    # 0-2 (the other transform types: test_torch_sharded_pipeline.py)
    "cfl_smooth_epf3": (lambda: tp.tiled_stream(
        512, 256, 3, types=[0], cfl=True, skip_lf_smoothing=False,
        gabor=True, epf_iters=3), 2, "_run_fused_sharded"),
    "ycbcr420_rows": (lambda: tp.ycbcr_stream(512, 256, (0, 1, 0), 5,
                                              gabor=True, epf_iters=2), 2,
                      "_run_fused_subsampled_sharded"),
    "ycbcr420_cols_4": (lambda: tp.ycbcr_stream(256, 768, (0, 1, 0), 6,
                                                gabor=True, epf_iters=2), 4,
                        "_run_fused_subsampled_sharded"),
    "lf_frame": (lambda: tp.vardct_stream(512, 256, 7, gabor=True,
                                          epf_iters=2, use_lf_frame=True), 2,
                 "_run_fused_sharded"),
    "two_passes": (lambda: tp.vardct_stream(512, 256, 8, num_passes=2), 2,
                   "_run_fused_sharded"),
    "alpha": (lambda: tp.tiled_stream(512, 256, 4, types=[0],
                                      alpha=_alpha(512, 256, 9), gabor=True,
                                      epf_iters=1), 2, "_run_fused_sharded"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_decode_is_the_single_device_one(name, paths):
    make, n, path = CASES[name]
    data = make()
    moved = _check(data, n, paths)
    assert path in paths
    assert "_run_fused" not in paths and "_run_fused_subsampled" not in paths
    if name != "two_passes":   # no filter, no halo
        assert moved > 0


def test_plan_over_the_cap_takes_the_staged_path(monkeypatch, paths):
    """A plan over DENSE_PLAN_MAX_ENTRIES (lowered in both packages, as
    tests/test_torch_staged.py does: DCT8 and DCT16 make a plan of up to
    five entries) falls back to the staged path on the home device,
    sharded or not."""
    monkeypatch.setattr(jvmod, "DENSE_PLAN_MAX_ENTRIES", 1)
    monkeypatch.setattr(tvmod, "DENSE_PLAN_MAX_ENTRIES", 1)
    _check(tp.tiled_stream(512, 200, 7, types=[0, 4], gabor=True,
                           epf_iters=2), 2, paths)
    assert paths == ["_run_fused_sharded", "_run_staged"]


@pytest.mark.parametrize("n", [2, 4])
def test_modular_device_tail_in_row_bands(monkeypatch, n):
    """The Modular tail forced onto the device: RCT and the horizontal
    squeezes per row band (one kernel-wrapper call a band), the vertical
    squeezes gathered; exactly the host tail's and the JAX package's
    (device tail over its mesh)."""
    from encoder import encode_jxl_modular

    from jxl_oxide_tpu_torch.ops.cuda import squeeze as sq

    rng = np.random.default_rng(11)
    data = encode_jxl_modular(
        [rng.integers(0, 256, (96, 80)) for _ in range(3)], bit_depth=8,
        squeeze=True, rct=True)
    host_planes, host_u8 = _port(JxlImage.from_bytes(data, device="cpu"))
    monkeypatch.setattr(opts, "device_modular_may_engage", lambda: True)
    monkeypatch.setattr(opts, "DEVICE_TAIL_MIN_SAMPLES", 0)
    monkeypatch.setenv("JXL_TPU_DEVICE_MODULAR", "1")
    calls = []
    real = sq.inv_squeeze_cuda

    def spy(avg, res, horizontal):
        calls.append((horizontal, avg.shape[0]))
        return real(avg, res, horizontal)

    monkeypatch.setattr(sq, "inv_squeeze_cuda", spy)
    got, u8 = _port(JxlImage.from_bytes(data, mesh=_cpu_mesh(n)))
    np.testing.assert_array_equal(got, host_planes)
    np.testing.assert_array_equal(u8, host_u8)
    np.testing.assert_array_equal(u8, _jax_u8(data, n))
    heights = {h for horizontal, h in calls if horizontal}
    assert heights and max(heights) <= -(-96 // n)


def test_decode_batch_with_a_mesh():
    """decode_batch decodes each stream over the mesh; the stacked path
    runs its single-device stacks on the mesh's home device, as the JAX
    package's does."""
    streams = [tp.vardct_stream(512, 256, 12, gabor=True, epf_iters=2)]
    mesh = _cpu_mesh(2)
    for got in (decode_batch(streams, mesh=mesh, num_workers=2),
                decode_batch_stacked(streams, mesh=mesh, num_workers=2)):
        for data, u8 in zip(streams, got):
            np.testing.assert_array_equal(u8, tp.torch_u8(data))


def test_loading_render_under_a_mesh(paths):
    """A stream fed in part renders over the mesh (the loading frame's
    cached state through the sharded program) as it does on one device;
    the JAX package's loading render (which ignores meshes) within 1 LSB."""
    data = tp.vardct_stream(512, 256, 14, gabor=True, epf_iters=2)
    cut = len(data) * 3 // 4

    def loading(**kw):
        img = JxlImage(**kw)
        img.feed_bytes(data[:cut])
        return img.render_loading_frame().to_u8()

    want = loading(device="cpu")
    got = loading(mesh=_cpu_mesh(2))
    assert "_run_fused_sharded" in paths
    np.testing.assert_array_equal(got, want)
    ref = JaxImage()
    ref.feed_bytes(data[:cut])
    assert tp.max_lsb(got, ref.render_loading_frame().to_u8()) <= 1


def test_cropped_render_under_a_mesh(paths):
    """render_frame_cropped over a mesh renders the frame whole (the rect
    is ignored, as the JAX package ignores it) and cuts the region: equal
    to the single-device region render."""
    data = tp.vardct_stream(512, 256, 15, gabor=True, epf_iters=2)
    region = (40, 230, 120, 70)
    want = JxlImage.from_bytes(data, device="cpu").render_frame_cropped(
        0, region).to_u8()
    got = JxlImage.from_bytes(data, mesh=_cpu_mesh(2)).render_frame_cropped(
        0, region).to_u8()
    assert paths[-1] == "_run_fused_sharded"
    np.testing.assert_array_equal(got, want)
    ref = JaxImage.from_bytes(data, mesh=_jax_mesh(2)).render_frame_cropped(
        0, region).to_u8()
    assert tp.max_lsb(got, ref) <= 1


def test_cli_num_devices_on_cpu_shards(tmp_path):
    from jxl_oxide_tpu_torch import cli

    src = tmp_path / "in.jxl"
    src.write_bytes(tp.vardct_stream(512, 256, 16, gabor=True, epf_iters=2))
    pngs = []
    for extra in ([], ["--num-devices", "2"]):
        out = tmp_path / f"out{len(pngs)}.png"
        assert cli.main(["decode", str(src), "-o", str(out), "--device",
                         "cpu", *extra]) == 0
        pngs.append(out.read_bytes())
    assert len(pngs[1]) > 0 and pngs[0] == pngs[1]


def test_graft_entry_torch_on_cpu():
    """graft_entry_torch.py's entry() is the flagship's fused program with
    its inputs: its output is the decode's planes. (Its dryrun_multichip
    decodes four 1024-px fixtures three times each: tests/test_torch_cuda.py
    runs it on the card.)"""
    import graft_entry_torch as g

    fn, args = g.entry("cpu")
    out = fn(*args)
    data = tp.fixture("flagship_1024")[0]
    want, _ = _port(JxlImage.from_bytes(data, device="cpu"))
    np.testing.assert_array_equal(out.numpy(), want)
