"""The two YCbCr layouts that were outside the port's envelope until its
twelfth slice, against the JAX package on the CPU: 4:4:4 YCbCr VarDCT and
chroma-subsampled YCbCr Modular.

4:4:4 YCbCr VarDCT (the layout of a lossless transcode of a 4:4:4 colour
JPEG) within 1 LSB in u8 on every path: the fused 4:4:4 program with
adaptive LF smoothing skipped and on, the staged path, the stacked path
(0 pixels different from the per-image decode), a mesh of two CPU shards
(bit for bit the single-device decode), a region (the rect program where
LF smoothing is skipped, the whole frame cut where it is not), loading
renders at the cuts of tools/make_torch_port_fixtures.py
`progressive_cuts`, and the CLI.

Chroma-subsampled YCbCr Modular at (0, 1, 0), (0, 2, 0), (0, 3, 0) and
the fuzz stream's (0, 3, 1), with and without squeeze: exact unfiltered,
within 1 LSB filtered; the device tail (forced on the CPU) with its
squeeze on a chroma plane, alone and in row bands; loading renders of a
multi-group frame (the snapshot of its channels); a region and the CLI
(a blended cone: tests/test_torch_animation.py).

The streams: the single-group encoders as they are, the multi-group
encoder spliced into a 4:4:4 YCbCr frame (`with_ycbcr_444`), and
tools/encoder.py compiled without its asserts for the subsampled Modular
frames (`unchecked_modular_encoder`); the validity of both is held here
too. Last, every stream of tests/fuzz_found/ through both packages: the
same error class, or pixels within 1 LSB.
"""

import glob
import os

import numpy as np
import pytest
import torch

import jxl_oxide_tpu.render.vardct as jvmod
import torch_parity as tp
from jxl_oxide_tpu_torch import JxlImage, decode_batch_stacked, serving
from jxl_oxide_tpu_torch.parallel import decode_mesh
from jxl_oxide_tpu_torch.render import vardct as tvmod
from jxl_oxide_tpu_torch.utils import options as opts
from make_torch_port_fixtures import progressive_cuts, with_ycbcr_444
# two intra-op threads a test (autouse), and the VarDCT paths taken
from test_torch_mesh_decode import _two_threads, paths  # noqa: F401
from test_torch_progressive import feed_both

FILTERED = dict(gabor=True, epf_iters=2)
FUZZ = sorted(glob.glob(os.path.join(tp.REPO, "tests", "fuzz_found",
                                     "*.fuzz")))


def _is_ycbcr(data, ups):
    header = JxlImage.from_bytes(data, device="cpu")._frames[0].header
    return header.do_ycbcr and tuple(header.jpeg_upsampling) == ups


def _jax_ref(data):
    r = tp.jax_image(data).render_frame(0)
    return r.to_u8(), np.asarray(r.image())


def _assert_lsb(data, u8):
    assert tp.max_lsb(u8, tp.jax_u8(data)) <= 1


# -- 4:4:4 YCbCr VarDCT -----------------------------------------------------

def _smooth_on():
    """Two groups, adaptive LF smoothing on, gaborish + 2 EPF passes."""
    return tp.ycbcr444_stream(256, 512, 90, 0.2, skip_lf_smoothing=False,
                              **FILTERED)


def _smooth_off():
    return tp.ycbcr444_stream(256, 256, 91, 0.2, **FILTERED)


@pytest.mark.parametrize("make,smooth", [(_smooth_off, False),
                                         (_smooth_on, True)])
def test_444_fused_program(make, smooth, paths):
    data = make()
    assert _is_ycbcr(data, (0, 0, 0))
    img = JxlImage.from_bytes(data, device="cpu")
    assert (img._frames[0].header.flags.skip_adaptive_lf_smoothing
            is not smooth)
    r = img.render_frame(0)
    want_u8, want_f32 = _jax_ref(data)
    assert paths == ["_run_fused"]
    assert tp.max_lsb(r.to_u8(), want_u8) <= 1
    np.testing.assert_allclose(r.image(), want_f32, atol=2e-5, rtol=0)


def test_444_staged_path(monkeypatch, paths):
    """A plan over DENSE_PLAN_MAX_ENTRIES (0 in both packages) takes the
    staged path, its chroma untouched by the upsample (4:4:4)."""
    monkeypatch.setattr(jvmod, "DENSE_PLAN_MAX_ENTRIES", 0)
    monkeypatch.setattr(tvmod, "DENSE_PLAN_MAX_ENTRIES", 0)
    data = _smooth_on()
    u8 = tp.torch_u8(data)
    # the fused program finds the plan over the cap and hands over
    assert paths == ["_run_fused", "_run_staged"]
    _assert_lsb(data, u8)


def test_444_stacked_equals_per_image(monkeypatch):
    """Two 4:4:4 YCbCr streams and one again run as one stack with the
    BT.601 leg on the stack: 0 pixels different from the per-image
    decodes."""
    chunks = []
    real = serving._decode_stack

    def spy(chunk, key, output):
        chunks.append(len(chunk))
        return real(chunk, key, output)

    monkeypatch.setattr(serving, "_decode_stack", spy)
    a, b = _smooth_off(), tp.ycbcr444_stream(256, 256, 92, 0.2, **FILTERED)
    streams = [a, b, a]
    got = decode_batch_stacked(streams, device="cpu", num_workers=2)
    assert chunks == [3]
    for data, u8 in zip(streams, got):
        np.testing.assert_array_equal(u8, tp.torch_u8(data))
    _assert_lsb(b, got[1])


def test_444_sharded_is_the_single_device_decode(paths):
    data = _smooth_on()
    one = JxlImage.from_bytes(data, device="cpu").render_frame(0)
    paths.clear()
    two = JxlImage.from_bytes(
        data, mesh=decode_mesh(2, devices=["cpu"] * 2)).render_frame(0)
    assert paths == ["_run_fused_sharded"]
    np.testing.assert_array_equal(torch.stack(two.planes).numpy(),
                                  torch.stack(one.planes).numpy())
    np.testing.assert_array_equal(two.to_u8(), one.to_u8())
    _assert_lsb(data, two.to_u8())


def _smooth_off_wide():
    """Three groups in a row, adaptive LF smoothing skipped: a region in
    the first group takes a third of the plane."""
    return tp.ycbcr444_stream(256, 768, 95, 0.2, skip_lf_smoothing=True,
                              **FILTERED)


@pytest.mark.parametrize("make,rect", [(_smooth_off_wide, True),
                                       (_smooth_on, False)])
def test_444_region(make, rect, monkeypatch):
    """With LF smoothing skipped the fused program computes the rect
    around the region (render/roi.py device_rect); with it on the frame
    decodes whole and is cut (frame_supports_roi, as the JAX
    package's)."""
    rects = []
    real = tvmod.VardctFrameState.run_device_pipeline

    def spy(self, *a, **k):
        rects.append(a[2] if len(a) > 2 else k.get("rect"))
        return real(self, *a, **k)

    monkeypatch.setattr(tvmod.VardctFrameState, "run_device_pipeline", spy)
    data = make()
    region = (30, 100, 90, 60)
    got = JxlImage.from_bytes(data, device="cpu").render_frame_cropped(
        0, region).to_u8()
    assert (rects[-1] is not None) is rect
    want = tp.jax_image(data).render_frame_cropped(0, region).to_u8()
    assert got.shape == (60, 90, 3)
    assert tp.max_lsb(got, want) <= 1
    full = tp.torch_u8(data)
    np.testing.assert_array_equal(got, full[100:160, 30:120])


def test_444_loading_renders():
    """Three groups fed at progressive_cuts: a pure-LF render, then more
    groups; the last equals the one-shot decode."""
    data = tp.ycbcr444_stream(256, 768, 93, 0.2, skip_lf_smoothing=False,
                              **FILTERED)
    cuts = progressive_cuts(JxlImage.from_bytes(
        data, device="cpu")._frames[0])
    _, u8, rendered = feed_both(data, cuts, exact=False)
    assert rendered == 4
    np.testing.assert_array_equal(u8, tp.torch_u8(data))


@pytest.mark.parametrize("layout", ["444_vardct", "420_modular"])
def test_cli_decode(layout, tmp_path):
    from jxl_oxide_tpu_torch import cli

    data = (_smooth_off() if layout == "444_vardct" else
            tp.modular_ycbcr_stream(64, 72, (0, 1, 0), 70, **FILTERED)[0])
    src, out = tmp_path / "in.jxl", tmp_path / "out.png"
    src.write_bytes(data)
    assert cli.main(["decode", str(src), "-o", str(out), "--device",
                     "cpu"]) == 0
    png = tp.read_png(out)["frames"][0]
    np.testing.assert_array_equal(png, tp.torch_u8(data))
    _assert_lsb(data, png)


def test_444_splice_is_the_single_group_encoders_frame():
    """with_ycbcr_444 on a single-group stream of encode_jxl_vardct_mixed
    gives the frame encode_jxl_vardct_420 writes with jpeg_upsampling
    (0, 0, 0) from the same coefficients, LF and global_scale: the JAX
    package decodes both to the same pixels."""
    from encoder_vardct import encode_jxl_vardct_420, encode_jxl_vardct_mixed

    rng = np.random.default_rng(94)
    h = w = 64
    coeff = np.zeros((3, h, w), np.int64)
    live = rng.random(coeff.shape) < 0.2
    coeff[live] = rng.integers(-10, 11, int(live.sum()))
    lf = rng.integers(-60, 61, (3, h // 8, w // 8)).astype(np.int64)
    native = encode_jxl_vardct_420(h, w, list(coeff), list(lf),
                                   jpeg_upsampling=(0, 0, 0))
    plain = encode_jxl_vardct_mixed(
        h, w, np.zeros((h // 8, w // 8), np.int64),
        np.ones((h // 8, w // 8), np.int64), coeff, lf)
    spliced = with_ycbcr_444(plain)
    assert len(spliced) in (len(plain), len(plain) + 1)
    a, b = _jax_ref(native), _jax_ref(spliced)
    np.testing.assert_array_equal(a[1], b[1])
    assert tp.max_lsb(tp.torch_u8(spliced), a[0]) <= 1


# -- chroma-subsampled YCbCr Modular ----------------------------------------

LAYOUTS = [(0, 1, 0), (0, 2, 0), (0, 3, 0), (0, 3, 1)]


@pytest.mark.parametrize("squeeze", [False, True])
@pytest.mark.parametrize("ups", LAYOUTS)
def test_subsampled_modular_unfiltered_is_exact(ups, squeeze):
    data, planes = tp.modular_ycbcr_stream(64, 72, ups, 71, squeeze=squeeze)
    assert _is_ycbcr(data, ups)
    # the stream codes the planes: the JAX package's channels before any
    # upsampling are they, exactly
    chans = tp.jax_image(data)._frames[0].decode_modular_frame()
    for got, want in zip(chans[:3], planes):
        np.testing.assert_array_equal(np.asarray(got), want)
    r = JxlImage.from_bytes(data, device="cpu").render_frame(0)
    want_u8, want_f32 = _jax_ref(data)
    np.testing.assert_array_equal(r.to_u8(), want_u8)
    np.testing.assert_array_equal(r.image(), want_f32)


@pytest.mark.parametrize("ups", LAYOUTS)
def test_subsampled_modular_filtered(ups):
    data, _ = tp.modular_ycbcr_stream(64, 72, ups, 72, squeeze=True,
                                      **FILTERED)
    r = JxlImage.from_bytes(data, device="cpu").render_frame(0)
    want_u8, want_f32 = _jax_ref(data)
    assert tp.max_lsb(r.to_u8(), want_u8) <= 1
    np.testing.assert_allclose(r.image(), want_f32, atol=2e-5, rtol=0)


def test_fuzz_stream_decodes_as_the_jax_package():
    """The 9x8 Modular frame of tests/fuzz_found with jpeg_upsampling
    (0, 3, 1), which the JAX package's tests/test_api.py replays."""
    with open(os.path.join(tp.REPO, "tests", "fuzz_found",
                           "modular_ycbcr_asym_subsample.fuzz"), "rb") as f:
        data = f.read()
    assert _is_ycbcr(data, (0, 3, 1))
    np.testing.assert_array_equal(tp.torch_u8(data), tp.jax_u8(data))


@pytest.fixture
def device_tail(monkeypatch):
    """The Modular tail forced onto the device in both packages; the
    squeeze wrapper's calls as (horizontal, avg shape)."""
    from jxl_oxide_tpu_torch.ops.cuda import squeeze as sq

    monkeypatch.setattr(opts, "device_modular_may_engage", lambda: True)
    monkeypatch.setattr(opts, "DEVICE_TAIL_MIN_SAMPLES", 0)
    monkeypatch.setenv("JXL_TPU_DEVICE_MODULAR", "1")
    calls = []
    real = sq.inv_squeeze_cuda

    def spy(avg, res, horizontal):
        calls.append((horizontal, tuple(avg.shape)))
        return real(avg, res, horizontal)

    monkeypatch.setattr(sq, "inv_squeeze_cuda", spy)
    return calls


@pytest.mark.parametrize("shards", [1, 2])
def test_subsampled_modular_device_tail(shards, device_tail):
    """The squeeze of channel 0 (Cb, at half the rows and columns) on the
    device tail, whole or in row bands: the host tail's decode and the
    JAX package's, exactly."""
    data, _ = tp.modular_ycbcr_stream(96, 80, (0, 1, 0), 73, squeeze=True,
                                      **FILTERED)
    kw = (dict(device="cpu") if shards == 1 else
          dict(mesh=decode_mesh(shards, devices=["cpu"] * shards)))
    u8 = JxlImage.from_bytes(data, **kw).render_frame(0).to_u8()
    assert device_tail
    # Cb is 48 x 40; its squeezed avg 48 x 20, in bands of 24 rows
    assert {s for _, s in device_tail} == {(48 // shards, 20)}
    np.testing.assert_array_equal(u8, tp.jax_u8(data))


def test_subsampled_modular_loading_renders():
    """A 4-group frame (Cb subsampled and squeezed into the global
    section; Y and Cr over the groups, layout (0, 1, 1)) fed in six
    pieces: each loading render finishes a snapshot of the channels
    decoded so far, within 1 LSB of the JAX package's (filtered)."""
    data, _ = tp.modular_ycbcr_stream(256, 256, (0, 1, 1), 75,
                                      group_size_shift=0, squeeze=True,
                                      **FILTERED)
    assert JxlImage.from_bytes(data, device="cpu")._frames[0].header \
        .num_groups == 4
    step = -(-len(data) // 6)
    cuts = [min(len(data), step * (k + 1)) for k in range(6)]
    _, u8, rendered = feed_both(data, cuts, exact=False)
    assert rendered >= 5
    np.testing.assert_array_equal(u8, tp.torch_u8(data))


def test_subsampled_modular_region_and_stacked():
    """A region of a subsampled Modular frame against the JAX package's
    region render; decode_batch_stacked sends it per image."""
    data, _ = tp.modular_ycbcr_stream(64, 72, (0, 2, 0), 76, **FILTERED)
    region = (10, 20, 40, 30)
    got = JxlImage.from_bytes(data, device="cpu").render_frame_cropped(
        0, region).to_u8()
    want = tp.jax_image(data).render_frame_cropped(0, region).to_u8()
    assert tp.max_lsb(got, want) <= 1
    [u8] = decode_batch_stacked([data], device="cpu", num_workers=1)
    np.testing.assert_array_equal(u8, tp.torch_u8(data))


# -- the committed fixtures --------------------------------------------------

@pytest.mark.parametrize("name", tp.YCBCR_FIXTURES)
def test_committed_fixture_and_its_regions(name):
    """The fixtures chip_smoke.py's phase_ycbcr decodes on the card, on the
    CPU: within 1 LSB of the JAX package's render, and each committed
    region (<name>_roi.npz) within 1 LSB of the JAX package's region
    render."""
    data, ref = tp.fixture(name)
    img = JxlImage.from_bytes(data, device="cpu")
    ups = (0, 0, 0) if name.startswith("ycbcr444") else (0, 1, 0)
    assert _is_ycbcr(data, ups)
    assert tp.max_lsb(img.render_frame(0).to_u8(), ref) <= 1
    path = os.path.join(tp.TESTDATA, f"{name}_roi.npz")
    if not os.path.exists(path):
        return
    rois = np.load(path)
    for r, region in enumerate(rois["regions"].tolist()):
        got = JxlImage.from_bytes(data, device="cpu").render_frame_cropped(
            0, region).to_u8()
        assert tp.max_lsb(got, rois[f"u8_{r}"]) <= 1, region


def test_modular_420_1024_takes_the_device_tail(monkeypatch):
    """Only the device gate forced (the CPU is no CUDA decode): Y's 2^20
    samples open the size gate as they do on the card, and the squeeze of
    Cb ([512, 256] avg) goes through K9's wrapper, once."""
    from jxl_oxide_tpu_torch.ops.cuda import squeeze as sq

    monkeypatch.setattr(opts, "device_modular_may_engage", lambda: True)
    calls = []
    real = sq.inv_squeeze_cuda

    def spy(avg, res, horizontal):
        calls.append((horizontal, tuple(avg.shape)))
        return real(avg, res, horizontal)

    monkeypatch.setattr(sq, "inv_squeeze_cuda", spy)
    data, ref = tp.fixture("modular_420_1024")
    u8 = tp.torch_u8(data)
    assert calls == [(True, (512, 256))]
    assert tp.max_lsb(u8, ref) <= 1


# -- the fuzz corpus ---------------------------------------------------------

def _outcome(decode, data):
    try:
        return decode(data), None
    except Exception as e:  # compared by class name across packages
        return None, type(e).__name__


@pytest.mark.parametrize("path", FUZZ, ids=os.path.basename)
def test_fuzz_corpus_as_the_jax_package(path):
    """Every stream of tests/fuzz_found through both packages: the same
    error class, or pixels within 1 LSB."""
    with open(path, "rb") as f:
        data = f.read()
    want, want_err = _outcome(tp.jax_u8, data)
    got, err = _outcome(tp.torch_u8, data)
    assert err == want_err
    if want is not None:
        assert tp.max_lsb(got, want) <= 1
