"""EXIF orientations 1-8 through the port's entry point against
jxl_oxide_tpu, on the CPU: a non-square VarDCT stream (gaborish and EPF;
u8 and u16 within 1 LSB, float within 2e-5, as tests/test_torch_decode.py)
and a non-square lossless Modular stream with alpha (bit for bit). The
render keeps the coded planes; every pixel output applies the
orientation, so a wrong transpose or flip shows as a shape or value
mismatch."""

import numpy as np
import pytest

import torch_parity as tp
from encoder import encode_jxl_modular
from jxl_oxide_tpu_torch import JxlImage

ORIENTATIONS = range(1, 9)


def _vardct(o):
    return tp.vardct_stream(40, 72, 5, orientation=o, gabor=True,
                            epf_iters=2)


def _modular(o):
    rng = np.random.default_rng(6)
    return encode_jxl_modular(
        [rng.integers(0, 256, (24, 56)) for _ in range(4)], bit_depth=8,
        extra_alpha=True, orientation=o)


def _pair(data):
    from jxl_oxide_tpu import JxlImage as JaxImage

    return (JxlImage.from_bytes(data, device="cpu"),
            JaxImage.from_bytes(data))


@pytest.mark.parametrize("o", ORIENTATIONS)
def test_vardct_orientation_matches_jax(o):
    ours, ref = _pair(_vardct(o))
    assert (ours.width, ours.height) == (ref.width, ref.height)
    r, j = ours.render_frame(0), ref.render_frame(0)
    u8, want = r.to_u8(), j.to_u8()
    assert u8.shape == want.shape == (ref.height, ref.width, 3)
    assert tp.max_lsb(u8, want) <= 1
    assert tp.max_lsb(r.to_u16(), j.to_u16()) <= 1
    np.testing.assert_allclose(r.image(), np.asarray(j.image()), atol=2e-5,
                               rtol=0)
    for p, q in zip(r.image_planar(), j.image_planar()):
        np.testing.assert_allclose(p.numpy(), np.asarray(q), atol=2e-5,
                                   rtol=0)


@pytest.mark.parametrize("o", ORIENTATIONS)
def test_modular_orientation_matches_jax(o):
    ours, ref = _pair(_modular(o))
    r, j = ours.render_frame(0), ref.render_frame(0)
    for a, b in ((r.to_u8(), j.to_u8()), (r.to_u16(), j.to_u16()),
                 (r.image_all_channels(), np.asarray(j.image_all_channels()))):
        assert a.shape == b.shape
        assert a.shape[:2] == ((56, 24) if o >= 5 else (24, 56))
        np.testing.assert_array_equal(a, b)


def test_orientation_fixture_matches_reference():
    data, ref = tp.fixture("orient6_512x384")
    img = JxlImage.from_bytes(data, device="cpu")
    assert (img.width, img.height) == (384, 512)
    got = img.render_frame(0).to_u8()
    assert got.shape == ref.shape == (512, 384, 3)
    assert tp.max_lsb(got, ref) <= 1
