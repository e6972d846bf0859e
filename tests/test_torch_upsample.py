"""K10, the non-separable upsampling (jxl_oxide_tpu_torch/ops/upsample.py,
torch ops), and the frame and EC upsampling of the render tail
(render/render.py `upsample_ec_to_color`, `apply_frame_upsampling`)
against jxl_oxide_tpu, on the CPU.

Tolerances: K10 within 1e-6 of jxl_oxide_tpu/ops/upsample.py (the k*k
phases are one float32 matmul over 25 views, summed in another order
than XLA's einsum: a few ulps of values in [0, 1]); decodes within 1 LSB
in u8 and 2e-5 in float32, the alpha's u8 bit for bit
(tests/torch_parity.py assert_keyframes_match).
"""

import numpy as np
import pytest
import torch

import torch_parity as tp
from encoder import encode_jxl_modular
from jxl_oxide_tpu.ops import upsample as jax_upsample
from jxl_oxide_tpu_torch import JxlImage
from jxl_oxide_tpu_torch.ops import upsample

UP_TOL = 1e-6


class _Meta:
    """The metadata fields K10 reads."""

    def __init__(self, up2=None, up4=None, up8=None):
        self.up2_weight, self.up4_weight, self.up8_weight = up2, up4, up8


def custom_up2(seed: int = 0) -> tuple:
    """15 weights near the defaults, rounded to f16 as a stream codes
    them."""
    rng = np.random.default_rng(seed)
    w = np.asarray(jax_upsample.D_UP2) + rng.uniform(-0.02, 0.02, 15)
    return tuple(float(v) for v in w.astype(np.float16))


@pytest.mark.parametrize("shape", [(1, 1), (1, 2), (2, 1), (2, 3), (3, 3),
                                   (3, 2), (7, 9), (13, 6)])
@pytest.mark.parametrize("factor", [2, 4, 8, 16])
def test_upsample_matches_jax(shape, factor):
    plane = np.random.default_rng(sum(shape) + factor).random(shape).astype(
        np.float32)
    meta = _Meta()
    want = np.asarray(jax_upsample.upsample_nonseparable(plane, factor, meta))
    got = upsample.upsample_nonseparable(torch.from_numpy(plane), factor,
                                         meta)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape == (shape[0] * factor,
                                              shape[1] * factor)
    np.testing.assert_allclose(got.numpy(), want, atol=UP_TOL, rtol=0)


@pytest.mark.parametrize("shape", [(1, 1), (2, 3), (9, 5)])
def test_custom_up2_weights_match_jax(shape):
    plane = np.random.default_rng(3).random(shape).astype(np.float32)
    meta = _Meta(up2=custom_up2())
    want = np.asarray(jax_upsample.upsample_nonseparable(plane, 2, meta))
    got = upsample.upsample_nonseparable(torch.from_numpy(plane), 2, meta)
    np.testing.assert_allclose(got.numpy(), want, atol=UP_TOL, rtol=0)
    default = upsample.upsample_nonseparable(torch.from_numpy(plane), 2,
                                             _Meta())
    if shape != (1, 1):
        assert not torch.equal(got, default)


@pytest.mark.parametrize("k", [2, 4, 8])
def test_phase_kernels_are_the_jax_tables(k):
    table = {2: upsample.D_UP2, 4: upsample.D_UP4, 8: upsample.D_UP8}[k]
    np.testing.assert_array_equal(upsample._phase_kernels(k, table),
                                  jax_upsample._phase_kernels(k, table))


def test_invalid_factor_raises():
    from jxl_oxide_tpu_torch.utils.errors import JxlValidationError

    with pytest.raises(JxlValidationError):
        upsample.upsample_nonseparable(torch.zeros(2, 2), 3, _Meta())


def test_output_is_clamped_to_the_window():
    """A step edge: every output sample lies within its 5x5 window's
    min and max, as the reference clamps it."""
    plane = np.zeros((6, 6), np.float32)
    plane[:, 3:] = 1.0
    got = upsample.upsample_nonseparable(torch.from_numpy(plane), 2,
                                         _Meta()).numpy()
    assert got.min() >= 0.0 and got.max() <= 1.0


# -- the render tail: frame and EC upsampling -------------------------------

def _ec_stream(ec_up: int, up: int = 2, seed: int = 43, h: int = 64):
    """tests/test_oracle.py:718-737: upsampling 2 with an alpha at
    ec_upsampling ec_up."""
    rng = np.random.default_rng(seed)
    hs = h // up
    rel = ec_up // up
    chans = [rng.integers(0, 256, (hs, hs), dtype=np.int64)
             for _ in range(3)]
    alpha = rng.integers(0, 256, (hs // rel, hs // rel), dtype=np.int64)
    return encode_jxl_modular(
        chans + [alpha], bit_depth=8, image_size=(h, h), upsampling=up,
        extra_alpha=True, ec_upsampling=[ec_up])


def _two_stage_stream(dim_shift: int = 1, seed: int = 47):
    """tests/test_oracle.py:740-760: patches over an alpha at dim_shift:
    the alpha goes to colour resolution before the patch blends."""
    rng = np.random.default_rng(seed)
    h = w = 32
    base = [rng.integers(0, 256, (h, w), dtype=np.int64) for _ in range(3)]
    alpha = rng.integers(0, 256, (h >> dim_shift, w >> dim_shift),
                         dtype=np.int64)
    ref = [rng.integers(0, 256, (h, w), dtype=np.int64) for _ in range(3)]
    ref_alpha = rng.integers(0, 256, (h >> dim_shift, w >> dim_shift),
                             dtype=np.int64)
    spec = dict(ref_idx=0, x0=2, y0=4, width=10, height=8, x=5, y=6,
                mode=1)
    return encode_jxl_modular(
        base + [alpha], bit_depth=8, extra_alpha=True,
        alpha_dim_shift=dim_shift,
        reference_patch=(ref + [ref_alpha], spec))


def _alpha_shift_stream(dim_shift: int, seed: int = 4):
    rng = np.random.default_rng(seed)
    return encode_jxl_modular(
        [rng.integers(0, 256, (32, 32)) for _ in range(3)]
        + [rng.integers(0, 256, (32 >> dim_shift, 32 >> dim_shift))],
        bit_depth=8, extra_alpha=True, alpha_dim_shift=dim_shift)


STREAMS = {
    # one-shot: the alpha upsamples by its whole factor after the features
    "ec_up2": lambda: _ec_stream(2),
    "ec_up4": lambda: _ec_stream(4),
    "ec_up8_frame_up4": lambda: _ec_stream(8, up=4),
    "dim_shift_1": lambda: _alpha_shift_stream(1),
    "dim_shift_2": lambda: _alpha_shift_stream(2),
    "dim_shift_3": lambda: _alpha_shift_stream(3),
    # two-stage: patches bring the alpha to colour resolution first
    "two_stage_shift_1": lambda: _two_stage_stream(1),
    "two_stage_shift_2": lambda: _two_stage_stream(2, seed=48),
    # frame upsampling with the stream's own up2 weights
    "custom_up2": lambda: encode_jxl_modular(
        [np.random.default_rng(9).integers(0, 256, (24, 20))
         for _ in range(3)], bit_depth=8, image_size=(48, 40),
        upsampling=2, up2_weights=list(custom_up2(9))),
    "frame_up4_odd": lambda: encode_jxl_modular(
        [np.random.default_rng(10).integers(0, 256, (9, 13))
         for _ in range(3)], bit_depth=8, image_size=(35, 50),
        upsampling=4),
    "frame_up8_grey": lambda: encode_jxl_modular(
        [np.random.default_rng(11).integers(0, 256, (5, 7))], bit_depth=8,
        image_size=(40, 56), upsampling=8),
}


@pytest.mark.parametrize("name", list(STREAMS))
def test_upsampled_streams_decode_as_jax(name):
    tp.assert_keyframes_match(STREAMS[name](), exact=False)


def test_custom_weights_reach_the_decode():
    """The stream's up2 weights are the metadata's, and they change the
    decode against the default table."""
    data = STREAMS["custom_up2"]()
    img = JxlImage.from_bytes(data, device="cpu")
    meta = img.image_header.metadata
    assert meta.up2_weight == tp.jax_image(data).image_header.metadata\
        .up2_weight
    ours = img.render_frame(0).image()
    meta.up2_weight = None
    img._keyframe_cache.clear()
    assert not np.array_equal(img.render_frame(0).image(), ours)


@pytest.mark.parametrize("patches", [False, True])
def test_ec_paths_one_shot_and_two_stage(monkeypatch, patches):
    """Without patches the alpha upsamples once by its whole factor; with
    patches it goes to colour resolution in `upsample_ec_to_color` (the
    patch pass) and by the frame's factor after it."""
    from jxl_oxide_tpu_torch.render import context as ctx_mod
    from jxl_oxide_tpu_torch.render import render as torch_render

    data = (STREAMS["two_stage_shift_1"] if patches
            else STREAMS["dim_shift_1"])()
    staged = []

    def see(fr):
        before = [tuple(p.shape) for p in fr.extra]
        torch_render.upsample_ec_to_color(fr)
        staged.append((before, [tuple(p.shape) for p in fr.extra]))

    monkeypatch.setattr(ctx_mod, "upsample_ec_to_color", see)
    img = JxlImage.from_bytes(data, device="cpu")
    out = img.render_frame(img.num_keyframes - 1)
    if patches:
        assert staged and all(b == [(16, 16)] and a == [(32, 32)]
                              for b, a in staged)
    else:
        assert not staged
    assert tuple(out.extra[0].shape) == (32, 32)
    tp.assert_keyframes_match(data, exact=False)


def test_alpha_shift_512_fixture():
    """The committed alpha_shift_512 (an alpha at dim_shift 2, K10 x4 on
    it): its reference is the JAX decode, and the port's colour equals
    it and its alpha too."""
    data, ref = tp.fixture("alpha_shift_512")
    img = JxlImage.from_bytes(data, device="cpu")
    assert img.image_header.metadata.ec_info[0].dim_shift == 2
    assert ref.shape == (512, 512, 4)
    got = img.render_frame(0).to_u8()
    assert tp.max_lsb(got, ref) <= 1
    np.testing.assert_array_equal(got[..., 3], ref[..., 3])
    np.testing.assert_array_equal(tp.jax_u8(data), ref)
