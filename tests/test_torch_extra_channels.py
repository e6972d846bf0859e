"""Every kind of extra channel through the port's entry points, on the
CPU, against jxl_oxide_tpu: spot colours, several alphas (a blend that
reads alpha channel 1), associated (premultiplied) alpha in a blended
animation and in a patch, float alphas and float extra channels (16 and
32 bits), depth and named channels, and CMYK's Black; through
render_frame(k).to_u8(), image_all_channels() and stream(), and with the
Modular tail forced onto the device.

Tolerances: integer and float extra channels bit for bit; the colour of
a lossless unfiltered frame bit for bit, and with spot colours applied
within 1e-6 in float32 (tests/test_api.py:342-385); u8 of a filtered
frame within 1 LSB with every extra channel exact.
"""

import numpy as np
import pytest
import torch

import torch_parity as tp
from encoder import encode_jxl_modular
from jxl_oxide_tpu_torch import JxlImage
from jxl_oxide_tpu_torch.utils import options as opts

H, W = 40, 48
F16 = {"ty": 0, "bits": 16, "float_exp_bits": 5}
F32 = {"ty": 1, "bits": 32, "float_exp_bits": 8}


def _planes(seed, n, h=H, w=W, hi=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, hi, (h, w)) for _ in range(n)]


def _f16(seed, h=H, w=W):
    """A smooth float field in [0, 1] as f16 bit patterns."""
    rng = np.random.default_rng(seed)
    small = rng.random((h // 8 + 1, w // 8 + 1))
    field = np.kron(small, np.ones((8, 8)))[:h, :w]
    return np.float16(field).view(np.uint16).astype(np.int64)


def _f32(seed, h=H, w=W):
    """float32 samples (depths up to 1e3) as bit patterns; positive, since
    the in-repo encoder codes no sample of 2^31 or more (negative float
    patterns are held in test_float_samples_to_float_bit_for_bit)."""
    rng = np.random.default_rng(seed)
    v = (rng.random((h, w)) * 1e3).astype(np.float32)
    return v.view(np.uint32).astype(np.int64)


def spot():
    return encode_jxl_modular(
        _planes(1, 5), bit_depth=8, extra_alpha=True,
        spot_colour=(1.0, 0.25, 0.0, 0.75))


def spot_filtered():
    return encode_jxl_modular(
        _planes(2, 5, hi=200), bit_depth=8, extra_alpha=True,
        spot_colour=(0.0, 0.5, 1.0, 1.0), gabor=True, epf_iters=2)


def two_alphas_blend():
    """Three frames, each blended over slot 1 with alpha channel 1 (the
    second alpha); the first alpha mixes as an alpha channel of its own."""
    frames = [_planes(10 + k, 5) for k in range(3)]
    return encode_jxl_modular(
        frames[0], bit_depth=8, extra_alpha=True,
        extra_channel_specs=[{"ty": 0}], animation_frames=frames,
        animation_blend={"mode": 2, "alpha_channel": 1})


def premul_blend():
    """An associated alpha at dim_shift 0 in a blended animation: the
    premultiplied branch of the frame blend."""
    frames = [_planes(20 + k, 4) for k in range(3)]
    return encode_jxl_modular(
        frames[0], bit_depth=8,
        extra_channel_specs=[{"ty": 0, "alpha_associated": True}],
        animation_frames=frames, animation_blend=True)


def premul_patch():
    """A patch blended with BlendAbove over an associated alpha: the
    premultiplied branch of the patch blend."""
    spec = dict(ref_idx=0, x0=4, y0=6, width=20, height=18, x=12, y=10,
                mode=4, ec_modes=[4], clamp=False)
    return encode_jxl_modular(
        _planes(30, 4), bit_depth=8,
        extra_channel_specs=[{"ty": 0, "alpha_associated": True}],
        reference_patch=(_planes(31, 4), spec))


def f16_alpha():
    return encode_jxl_modular(
        _planes(40, 3) + [_f16(41)], bit_depth=8,
        extra_channel_specs=[F16])


def f32_depth():
    return encode_jxl_modular(_planes(50, 3) + [_f32(51)], bit_depth=8,
                              extra_channel_specs=[F32])


def depth_named():
    """An alpha, a depth channel and a named selection mask."""
    return encode_jxl_modular(
        _planes(60, 6), bit_depth=8, extra_alpha=True,
        extra_channel_specs=[{"ty": 1, "name": "depth"},
                             {"ty": 3, "name": "mask"}])


def cmyk():
    return encode_jxl_modular(_planes(70, 4), bit_depth=8,
                              extra_channel_specs=[{"ty": 4}])


def ec_mix(h=H, w=W, **kw):
    """The ec_mix_1024 fixture's recipe at a small size: colour, an alpha,
    a spot colour, an f16 alpha and a depth channel, squeezed, gaborish,
    2 EPF passes."""
    return encode_jxl_modular(
        _planes(80, 3, h, w) + _planes(81, 2, h, w) + [_f16(82, h, w)]
        + _planes(83, 1, h, w), bit_depth=8, extra_alpha=True,
        spot_colour=(1.0, 0.0, 0.0, 0.5),
        extra_channel_specs=[F16, {"ty": 1, "name": "depth"}],
        squeeze=True, gabor=True, epf_iters=2, **kw)


# name -> (stream maker, lossless and unfiltered)
STREAMS = {
    "spot": (spot, True),
    "spot_filtered": (spot_filtered, False),
    "two_alphas_blend": (two_alphas_blend, True),
    "premul_blend": (premul_blend, True),
    "premul_patch": (premul_patch, True),
    "f16_alpha": (f16_alpha, True),
    "f32_depth": (f32_depth, True),
    "depth_named": (depth_named, True),
    "cmyk": (cmyk, True),
    "ec_mix": (ec_mix, False),
}


@pytest.fixture
def device_tail(monkeypatch):
    """The port's Modular tail on the device (the CPU here), for every
    plane size: its output stays in int32 tensors, as on the card."""
    monkeypatch.setattr(opts, "device_modular_may_engage", lambda: True)
    monkeypatch.setattr(opts, "DEVICE_TAIL_MIN_SAMPLES", 0)


def _assert_render_matches(a, b, lossless, what=""):
    """One keyframe's Render of each package: u8, the float image and
    every channel of image_all_channels (extra channels exact)."""
    u8, want = a.to_u8(), b.to_u8()
    assert u8.shape == want.shape, what
    ncolor = len(a.planes)
    if lossless:
        np.testing.assert_array_equal(u8, want, err_msg=what)
    else:
        assert tp.max_lsb(u8, want) <= 1, what
    np.testing.assert_array_equal(u8[..., ncolor:], want[..., ncolor:])
    allc, ref = a.image_all_channels(), np.asarray(b.image_all_channels())
    assert allc.shape == ref.shape and allc.dtype == np.float32, what
    np.testing.assert_array_equal(allc[..., ncolor:], ref[..., ncolor:],
                                  err_msg=what)
    np.testing.assert_allclose(allc[..., :ncolor], ref[..., :ncolor],
                               atol=1e-6 if lossless else 2e-5, rtol=0,
                               err_msg=what)


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_extra_channels_match_jax(name):
    """Every keyframe, every extra channel, against the JAX package."""
    make, lossless = STREAMS[name]
    data = make()
    ref = tp.jax_image(data)
    ours = JxlImage.from_bytes(data, device="cpu")
    assert len(ours.image_header.metadata.ec_info) == len(
        ref.image_header.metadata.ec_info) >= 1
    assert ours.num_keyframes == ref.num_keyframes
    if name.startswith("premul"):
        # the premultiplied branches of render/context.py blend it
        assert ours.image_header.metadata.ec_info[0].alpha_associated
    for k in range(ref.num_keyframes):
        _assert_render_matches(ours.render_frame(k), ref.render_frame(k),
                               lossless, f"{name} keyframe {k}")


@pytest.mark.parametrize("name", sorted(STREAMS))
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
def test_stream_matches_jax(name, dtype):
    """Render.stream() of the last keyframe, in pieces of 1000 samples,
    against the JAX package's: spot colours applied, every extra channel
    interleaved."""
    make, lossless = STREAMS[name]
    data = make()
    ref = tp.jax_image(data)
    k = ref.num_keyframes - 1
    ours = JxlImage.from_bytes(data, device="cpu").render_frame(k)

    def drain(stream):
        out, buf = [], np.zeros(1000, dtype)
        while n := stream.write_to_buffer(buf):
            out.append(buf[:n].copy())
        return np.concatenate(out)

    a, b = drain(ours.stream()), drain(ref.render_frame(k).stream())
    assert a.shape == b.shape
    if dtype == np.float32:
        np.testing.assert_allclose(a, b, atol=1e-6 if lossless else 2e-5,
                                   rtol=0)
    elif lossless:
        np.testing.assert_array_equal(a, b)
    else:
        assert tp.max_lsb(a, b) <= 1


def test_spot_colors_apply_once():
    """Every pixel output applies the spot colours once; a stream applies
    them to a copy and leaves the Render as it was."""
    data = spot()
    r = JxlImage.from_bytes(data, device="cpu").render_frame(0)
    before = [p.clone() for p in r.planes]
    r.stream()
    assert not r._spot_applied
    for p, q in zip(r.planes, before):
        assert torch.equal(p, q)
    first = r.to_u8()
    after = [p.clone() for p in r.planes]
    assert r._spot_applied
    assert not torch.equal(after[2], before[2])
    np.testing.assert_array_equal(r.to_u8(), first)
    np.testing.assert_array_equal(r.image(), r.image())
    for p, q in zip(r.planes, after):
        assert torch.equal(p, q)
    np.testing.assert_allclose(
        np.stack(r.image_planar(), -1),
        np.asarray(tp.jax_image(data).render_frame(0).image())[..., :3],
        atol=1e-6, rtol=0)


# streams whose Modular tail has a transform to run (the squeeze)
SQUEEZED = {
    "ec_mix": ec_mix,
    "f16_alpha": lambda: encode_jxl_modular(
        _planes(40, 3) + [_f16(41)], bit_depth=8, extra_channel_specs=[F16],
        squeeze=True),
    "f32_depth": lambda: encode_jxl_modular(
        _planes(50, 3) + [_f32(51)], bit_depth=8, extra_channel_specs=[F32],
        squeeze=True),
}


@pytest.mark.parametrize("name", sorted(SQUEEZED))
def test_float_ec_through_the_device_tail(name, device_tail):
    """A float extra channel that comes out of the device tail as int32
    tensors converts with its own float bit depth (the colour's bit depth
    alone used to decide it, so on the card it read as integers): bit for
    bit the JAX package's."""
    data = SQUEEZED[name]()
    host = tp.torch_host_stage(data)
    assert host.channels is None  # the device tail will run
    _assert_render_matches(
        JxlImage.from_bytes(data, device="cpu").render_frame(0),
        tp.jax_image(data).render_frame(0), lossless=name != "ec_mix")


def test_float_samples_to_float_bit_for_bit():
    """The torch conversion of float samples against the JAX package's
    numpy, on every f16 pattern and on random f32, f24 (e8) and bf16-like
    (16 bits, e8) patterns, negative lanes included."""
    from types import SimpleNamespace

    from jxl_oxide_tpu.render.render import _parse_integer_samples
    from jxl_oxide_tpu_torch.render.render import float_samples_to_float

    rng = np.random.default_rng(5)
    cases = [(16, 5, np.arange(1 << 16, dtype=np.int64)),
             (16, 5, np.arange(1 << 16, dtype=np.int64).astype(np.int16)),
             (32, 8, rng.integers(-(1 << 31), 1 << 31, 5000)),
             (24, 8, rng.integers(0, 1 << 24, 5000)),
             (16, 8, rng.integers(0, 1 << 16, 5000)),
             (32, 6, rng.integers(0, 1 << 32, 5000))]
    for bits, exp_bits, arr in cases:
        bd = SimpleNamespace(is_float=True, bits_per_sample=bits,
                             exp_bits=exp_bits)
        with np.errstate(over="ignore"):  # e6 patterns beyond float32
            want = _parse_integer_samples(arr, bd)
        got = float_samples_to_float(torch.from_numpy(arr), bd).numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32),
                                      err_msg=f"{bits} bits, e{exp_bits}")


class _StubCms:
    """A CMS that records the planes it is handed and mixes the fourth
    (Black) into the colour, for both packages alike (numpy only)."""

    def __init__(self):
        self.seen = []

    def prepare_transform(self, from_icc, to_icc, intent=0):
        return self

    def transform(self, planes):
        self.seen.append(len(planes))
        k = planes[3] if len(planes) > 3 else np.float32(1.0)
        return [np.asarray(p, np.float32) * k for p in planes[:3]]


def _cmyk_icc_stream():
    """A CMYK stream whose embedded profile no enum expresses (Pillow's
    sRGB profile relabelled CMYK: no CMYK profile can be made here
    without a file), so its colour takes the CMS leg."""
    from PIL import ImageCms

    icc = bytearray(ImageCms.ImageCmsProfile(
        ImageCms.createProfile("sRGB")).tobytes())
    icc[16:20] = b"CMYK"
    return encode_jxl_modular(_planes(71, 4), bit_depth=8,
                              extra_channel_specs=[{"ty": 4}],
                              embed_icc=bytes(icc))


@pytest.mark.parametrize("cms", ["stub", "null"])
def test_cmyk_black_reaches_the_cms(cms):
    """A CMYK source hands its Black channel to the CMS as a fourth
    plane, as the JAX package does; with NullCms the samples are kept."""
    pytest.importorskip("PIL")
    from jxl_oxide_tpu.color.cms import NullCms as JaxNull
    from jxl_oxide_tpu_torch.color.cms import NullCms

    data = _cmyk_icc_stream()
    ref = tp.jax_image(data)
    ours = JxlImage.from_bytes(data, device="cpu")
    stubs = (_StubCms(), _StubCms()) if cms == "stub" else (NullCms(),
                                                           JaxNull())
    ours.set_cms(stubs[0])
    ref.set_cms(stubs[1])
    _assert_render_matches(ours.render_frame(0), ref.render_frame(0), True)
    if cms == "stub":
        assert stubs[0].seen == stubs[1].seen == [4]


@pytest.mark.parametrize("name,k1,k9,keyframes", tp.EC_FIXTURES)
def test_fixture_matches_reference(name, k1, k9, keyframes):
    """The committed extra-channel fixtures against their JAX references:
    u8 within 1 LSB with the alphas exact, every extra channel of every
    keyframe bit for bit."""
    data, u8 = tp.fixture(name)
    extra = np.load(f"{tp.TESTDATA}/{name}.npz")["extra"]
    img = JxlImage.from_bytes(data, device="cpu")
    assert img.num_keyframes == keyframes
    if keyframes == 1:
        u8, extra = u8[None], extra[None]
    for k in range(keyframes):
        r = img.render_frame(k)
        got = r.to_u8()
        assert tp.max_lsb(got, u8[k]) <= 1
        np.testing.assert_array_equal(got[..., 3], u8[k][..., 3])
        np.testing.assert_array_equal(r.image_all_channels()[..., 3:],
                                      extra[k])


def test_ec_mix_fixture_through_the_device_tail(device_tail):
    """ec_mix_1024 with the Modular tail on the device (the CPU here, as
    on the card, where its size opens the gate): every extra channel bit
    for bit its reference, the f16 alpha among them."""
    data, u8 = tp.fixture("ec_mix_1024")
    extra = np.load(f"{tp.TESTDATA}/ec_mix_1024.npz")["extra"]
    assert tp.torch_host_stage(data).channels is None
    r = JxlImage.from_bytes(data, device="cpu").render_frame(0)
    assert tp.max_lsb(r.to_u8(), u8) <= 1
    np.testing.assert_array_equal(r.image_all_channels()[..., 3:], extra)
