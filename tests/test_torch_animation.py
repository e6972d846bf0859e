"""Multi-frame streams in the port (jxl_oxide_tpu_torch/render/context.py
and the keyframe machinery of api.py) against the JAX package, on the
CPU: animation chains, every frame blend mode with and without alpha,
XYB frames converted before blending (ct_done), filtered animations,
cropped frames, keyframe order and the keyframe cache, dependency cones,
the decode device in the frame-render workers, and a cone of
chroma-subsampled YCbCr frames.

Tolerances: unfiltered Modular frames exactly, in u8 and in the float32
image; filtered frames within 1 LSB in u8 and 2e-5 in float32; alpha
exactly. The card's composites are held against these CPU ones in
tests/test_torch_cuda.py.
"""

import threading

import numpy as np
import pytest
import torch

import torch_parity as tp
from encoder import encode_jxl_modular
from jxl_oxide_tpu_torch import JxlImage
from jxl_oxide_tpu_torch import api as torch_api
from jxl_oxide_tpu_torch.render import context as torch_context
from jxl_oxide_tpu_torch.utils import options as opts


def replace_frames(size: int, seed: int = 7):
    """bench.py's animation_4f_blend recipe (bench.py:207-218) at
    size^2: four frames, each a small random walk from the last."""
    rng = np.random.default_rng(seed)
    frames = [[rng.integers(0, 200, (size, size), dtype=np.int64)
               for _ in range(3)]]
    for _ in range(3):
        frames.append([np.clip(c + rng.integers(-8, 9, c.shape), 0, 255)
                       for c in frames[-1]])
    return frames


def replace_stream(size: int = 64) -> bytes:
    frames = replace_frames(size)
    return encode_jxl_modular(frames[0], bit_depth=8, animation_frames=frames)


def blend_stream(blend, alpha: bool, seed: int = 500, h: int = 24,
                 w: int = 24, frames: int = 3, **kw) -> bytes:
    """tests/test_oracle.py:340-384's chains: random 8-bit frames, each
    after the first blended with `blend` (True: Blend over slot 1)."""
    rng = np.random.default_rng(seed)

    def fr():
        return [rng.integers(0, 256, (h, w), dtype=np.int64)
                for _ in range(3 + alpha)]

    return encode_jxl_modular(
        fr(), bit_depth=8, extra_alpha=alpha,
        animation_frames=[fr() for _ in range(frames)],
        animation_blend=blend, **kw)


def test_replace_chain_matches_jax_and_the_input_frames():
    frames = replace_frames(64)
    ours = tp.assert_keyframes_match(replace_stream(64))
    assert ours.is_animation
    for k, f in enumerate(frames):
        want = np.stack([c.astype(np.uint8) for c in f], -1)
        np.testing.assert_array_equal(ours.render_frame(k).to_u8(), want)


@pytest.mark.parametrize("blend", [False, True])
@pytest.mark.parametrize("alpha", [False, True])
def test_blend_chain(blend, alpha):
    tp.assert_keyframes_match(blend_stream(blend, alpha, seed=500, frames=3))


@pytest.mark.parametrize("spec", [
    1,                              # Add
    3,                              # MulAdd (the alpha channel skips)
    4,                              # Mul
    {"mode": 4, "clamp": True},     # Mul, samples clamped
    {"mode": 2, "clamp": True},     # Blend, alpha clamped
], ids=["add", "muladd", "mul", "mul_clamp", "blend_clamp"])
@pytest.mark.parametrize("alpha", [False, True])
def test_blend_modes(spec, alpha):
    tp.assert_keyframes_match(blend_stream(spec, alpha, seed=501, frames=2))


@pytest.mark.parametrize("spec", [1, True], ids=["add", "blend"])
def test_xyb_frames_convert_before_blending(spec):
    """XYB blending frames composite in the signalled space: the colour
    transform runs before the blend (ct_done) and not again after it. The
    transform is float arithmetic (cube, matrix, sRGB curve): the
    filtered tolerances apply (1 LSB, 2e-5); a second transform would be
    far outside them."""
    data = blend_stream(spec, True, seed=503, h=32, w=40, frames=3,
                        xyb=True)
    ours = tp.assert_keyframes_match(data, exact=False)
    ref = tp.jax_image(data)
    assert ours.image_header.metadata.xyb_encoded
    # every frame is saved to slot 1 before its colour transform would run
    assert [ours._render_keyframe(k).ct_done for k in range(3)] == [
        ref._render_keyframe(k).ct_done for k in range(3)] == [True] * 3


def test_filtered_animation():
    """Gaborish and 2 EPF passes on every frame of a Blend chain with an
    alpha, on multi-group frames (72 x 136)."""
    data = blend_stream(True, True, seed=506, h=72, w=136, frames=2,
                        gabor=True, epf_iters=2)
    rf = JxlImage.from_bytes(data, device="cpu")._frames[1].header \
        .restoration_filter
    assert rf.gab.enabled and rf.epf.iters == 2
    tp.assert_keyframes_match(data, exact=False)


def _crop(chans, image_size, crop, **kw):
    return encode_jxl_modular(chans, bit_depth=8, image_size=image_size,
                              crop=crop, **kw)


@pytest.mark.parametrize("case", ["positive", "negative", "filtered"])
def test_cropped_frames(case):
    """have_crop frames composite at (x0, y0), clipped against the canvas
    (tests/test_api.py:659, 676); a filtered one runs the EPF on a plane
    narrower than one 64x64 tile, W % 4 != 0."""
    if case == "positive":
        rng = np.random.default_rng(113)
        chans = [rng.integers(0, 256, (12, 16)) for _ in range(3)]
        data = _crop(chans, (24, 32), (5, 3, 16, 12))
        want = np.zeros((24, 32, 3), dtype=np.uint8)
        want[3:15, 5:21] = np.stack([c.astype(np.uint8) for c in chans], -1)
    elif case == "negative":
        rng = np.random.default_rng(115)
        chans = [rng.integers(0, 256, (8, 8)) for _ in range(3)]
        data = _crop(chans, (10, 10), (-3, -2, 8, 8))
        want = np.zeros((10, 10, 3), dtype=np.uint8)
        want[:6, :5] = np.stack([c.astype(np.uint8) for c in chans],
                                -1)[2:, 3:]
    else:
        chans = [np.round(c) for c in np.moveaxis(
            tp.smooth_rgb(21, 45, 5) * 255, -1, 0)]
        data = _crop(chans, (32, 48), (-4, 7, 45, 21), gabor=True,
                     epf_iters=2)
        want = None
    ours = tp.assert_keyframes_match(data, exact=want is not None)
    if want is not None:
        np.testing.assert_array_equal(ours.render_frame(0).to_u8(), want)


def test_keyframe_order_and_cache():
    """Keyframe 2 first, then 0 and 1: each equals the JAX decode, and a
    second request returns the cached keyframe itself."""
    data = blend_stream(True, True, seed=507, frames=3)
    ours = tp.assert_keyframes_match(data, order=[2, 0, 1])
    assert sorted(ours._keyframe_cache) == [0, 1, 2]
    for k in range(3):
        kf = ours._keyframe_cache[k]
        assert ours._render_keyframe(k) is kf
        # the Render never hands out the cache's own tensors
        r = ours.render_frame(k)
        assert all(p is not q for p in (*r.planes, *r.extra)
                   for q in (*kf.color, *kf.extra))


def test_keyframe_cache_evicts_by_bytes(monkeypatch):
    """The byte cap, patched in both packages below two canvases (one
    canvas is 3 x 64^2 float32, 48 KiB): one entry stays, the newest."""
    from jxl_oxide_tpu import JxlImage as JaxImage

    data = replace_stream(64)
    monkeypatch.setattr(JxlImage, "_KEYFRAME_CACHE_MAX_BYTES", 60 * 1024)
    monkeypatch.setattr(JaxImage, "_KEYFRAME_CACHE_MAX_BYTES", 60 * 1024)
    ours = JxlImage.from_bytes(data, device="cpu")
    ref = JaxImage.from_bytes(data)
    for k in range(3):
        np.testing.assert_array_equal(ours.render_frame(k).to_u8(),
                                      ref.render_frame(k).to_u8())
    assert list(ours._keyframe_cache) == [2]
    assert [key[0] for key in ref._keyframe_cache] == [2]


@pytest.mark.parametrize("limit_kib", [150, 250, 400])
def test_memory_limit_matches_jax(limit_kib):
    """approx_memory_limit: the tracked bytes (channel buffers, slots,
    retained canvases) and the cache's cap of half the limit behave as
    the JAX package's, out-of-memory included."""
    from jxl_oxide_tpu import JxlImage as JaxImage

    data = replace_stream(64)
    runs = []
    for img in (JxlImage.from_bytes(data, device="cpu",
                                    approx_memory_limit=limit_kib << 10),
                JaxImage.from_bytes(data,
                                    approx_memory_limit=limit_kib << 10)):
        sizes = []
        try:
            for k in range(4):
                img.render_frame(k)
                sizes.append(len(img._keyframe_cache))
        except Exception as e:  # noqa: BLE001 - compared across packages
            sizes.append(type(e).__name__)
        runs.append((sizes, img._tracker.used, img._tracker.peak))
    assert runs[0] == runs[1]
    assert (runs[0][0][-1] == "JxlOutOfMemoryError") == (limit_kib == 150)


def _count_renders(monkeypatch):
    """Codestream indices of the frames the port renders, in both places
    that render a frame (the cone's worker pool and an inline render)."""
    seen = []

    def counting(module):
        real = module.render_frame

        def render(frame, device):
            seen.append(frame)
            return real(frame, device)

        monkeypatch.setattr(module, "render_frame", render)

    counting(torch_api)
    counting(torch_context)
    return seen


def test_dependency_cone(monkeypatch):
    """A Replace animation's keyframe renders its own frame only; a Blend
    chain's last keyframe renders the whole chain, and after it every
    keyframe comes from the cache."""
    seen = _count_renders(monkeypatch)
    img = JxlImage.from_bytes(replace_stream(32), device="cpu")
    img.render_frame(0)
    assert seen == [img._frames[0]]
    seen.clear()
    img.render_frame(3)
    assert seen == [img._frames[3]]

    seen.clear()
    img = JxlImage.from_bytes(blend_stream(True, False, frames=3),
                              device="cpu")
    img.render_frame(2)
    assert sorted(img._frames.index(f) for f in seen) == [0, 1, 2]
    seen.clear()
    img.render_frame(0)
    img.render_frame(1)
    assert seen == []


def test_frame_workers_see_the_decode_device(monkeypatch):
    """Every frame render of a cone runs with the decode's device set in
    its context, on the worker threads too: a worker without it would see
    no device (the CPU default) and turn the Modular tail back to the
    host on a CUDA decode."""
    seen = []
    real = torch_api.render_frame

    def render(frame, device):
        seen.append((threading.current_thread() is threading.main_thread(),
                     opts._decode_device.get()))
        return real(frame, device)

    monkeypatch.setattr(torch_api, "render_frame", render)
    img = JxlImage.from_bytes(blend_stream(True, True, frames=3),
                              device="cpu")
    assert opts._decode_device.get() is None
    img.render_frame(2)
    assert len(seen) == 3
    assert not any(main for main, _ in seen)
    assert all(dev == torch.device("cpu") for _, dev in seen)


def _splines():
    base = [np.full((48, 48), 128, dtype=np.int64) for _ in range(3)]
    xyb_dct = np.zeros((3, 32), dtype=np.int64)
    xyb_dct[:, 0] = [50, 80, 60]
    sigma_dct = np.zeros(32, dtype=np.int64)
    sigma_dct[0] = 40
    spec = dict(points=[(10, 12), (30, 18), (38, 34)], xyb_dct=xyb_dct,
                sigma_dct=sigma_dct)
    return encode_jxl_modular(base, bit_depth=8, splines_spec=([spec], 0))


def _noise():
    rng = np.random.default_rng(1)
    base = [rng.integers(0, 256, (32, 32)) for _ in range(3)]
    return encode_jxl_modular(base, bit_depth=8, noise_lut=[0.1] * 8)


def _upsampling():
    rng = np.random.default_rng(2)
    base = [rng.integers(0, 256, (16, 16)) for _ in range(3)]
    return encode_jxl_modular(base, bit_depth=8, upsampling=2,
                              image_size=(32, 32))


def _second_alpha():
    """tests/test_oracle.py:437's Blend over the second of two alphas."""
    rng = np.random.default_rng(504)

    def fr():
        return [rng.integers(0, 256, (24, 24)) for _ in range(5)]

    return encode_jxl_modular(
        fr(), bit_depth=8, extra_alpha=True,
        extra_channel_specs=[dict(ty=0)], animation_frames=[fr(), fr()],
        animation_blend={"mode": 2, "alpha_channel": 1})


@pytest.mark.parametrize("make,item", [
    (_splines, "item 9a-rest"),
    (_noise, "item 9a-rest"),
    (_upsampling, "item 9b"),
    (_second_alpha, "item 17"),
])
def test_out_of_envelope_cones_raise(make, item):
    """Cones that were outside the envelope: the splines, noise and
    upsampling of items 9a-rest and 9b (until the port's seventh slice)
    and a Blend over the second of two alphas (item 17, until its ninth)
    now decode as the JAX package's do, the lossless blend bit for bit.
    The layouts still outside raise: test_every_frame_of_the_cone_is_
    checked."""
    data = make()
    tp.assert_keyframes_match(data, exact=item == "item 17")


def test_every_frame_of_the_cone_is_checked():
    """Every frame of a cone decodes whatever its layout: three
    chroma-subsampled YCbCr Modular frames (4:2:0, tools/encoder.py
    without its asserts), each after the first blended over slot 1, so
    every frame takes the BT.601 leg before blending
    (`_convert_color_for_record`); every keyframe bit for bit the JAX
    package's. The envelope that checked each frame of the cone is gone:
    no layout is refused."""
    from make_torch_port_fixtures import smooth_u8, unchecked_modular_encoder

    frames = [[p[::1 << s, ::1 << s] for p, s in
               zip(smooth_u8(24, 24, 510 + k), (1, 0, 1))] for k in range(3)]
    data = unchecked_modular_encoder().encode_jxl_modular(
        frames[0], bit_depth=8, do_ycbcr=True, jpeg_upsampling=(0, 1, 0),
        image_size=(24, 24), animation_frames=frames, animation_blend=True)
    ours = tp.assert_keyframes_match(data, exact=True)
    assert all(f.header.do_ycbcr for f in ours._frames)
    assert not hasattr(ours, "_check_envelope")


def test_single_section_vardct_frame_renders_twice():
    """A frame rendered a second time (a keyframe evicted from the cache,
    a reference frame in two cones) decodes afresh: a single-section
    VarDCT frame used to resume its groups from the bitstream its first
    decode had consumed, and raised."""
    data = tp.vardct_stream(61, 75, 1)
    img = JxlImage.from_bytes(data, device="cpu")
    assert img._frames[0].toc.is_single_entry
    first = img.render_frame(0).to_u8()
    img._keyframe_cache.clear()
    np.testing.assert_array_equal(img.render_frame(0).to_u8(), first)
    np.testing.assert_array_equal(first, tp.jax_u8(data))


def test_animation_4f_blend_fixture_is_the_bench_case():
    """The committed animation_4f_blend stream is bench.py's case: both
    decoders give back its seeded input frames exactly, and
    chip_smoke.py's recipe makes the same frames."""
    import chip_smoke
    from make_torch_port_fixtures import animation_4f_frames

    with open(f"{tp.TESTDATA}/animation_4f_blend.jxl", "rb") as f:
        data = f.read()
    frames = animation_4f_frames()
    smoke = chip_smoke.animation_4f_frames()
    ref = tp.jax_image(data)
    ours = JxlImage.from_bytes(data, device="cpu")
    assert ref.num_keyframes == ours.num_keyframes == 4
    for k, f in enumerate(frames):
        want = np.stack([c.astype(np.uint8) for c in f], -1)
        np.testing.assert_array_equal(smoke[k], want)
        np.testing.assert_array_equal(ref.render_frame(k).to_u8(), want)
        np.testing.assert_array_equal(ours.render_frame(k).to_u8(), want)


@pytest.mark.parametrize("name,exact", [("anim_blend_epf_512", False),
                                        ("crop_epf_77x45", False)])
def test_filtered_fixture_references(name, exact):
    """The committed reference of each filtered fixture is the JAX decode
    of every keyframe, and the port is within tolerance of it."""
    data, ref = tp.fixture(name)
    ref = ref if ref.ndim == 4 else ref[None]
    jax_img = tp.jax_image(data)
    np.testing.assert_array_equal(
        np.stack([jax_img.render_frame(k).to_u8()
                  for k in range(jax_img.num_keyframes)]), ref)
    ours = JxlImage.from_bytes(data, device="cpu")
    got = np.stack([ours.render_frame(k).to_u8()
                    for k in range(ours.num_keyframes)])
    assert tp.max_lsb(got, ref) <= (0 if exact else 1)
    if got.shape[-1] == 4:
        np.testing.assert_array_equal(got[..., 3], ref[..., 3])
