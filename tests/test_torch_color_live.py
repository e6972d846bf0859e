"""Colour encodings through the port's entry points on small streams (64 to
256 px), against a live jxl_oxide_tpu decode of the same stream on the
CPU: greyscale under every EXIF orientation, with an alpha, blended over
reference slots; requested encodings on VarDCT, XYB HDR and ICC streams;
and decode_batch / decode_batch_stacked over a mix of them.

Tolerances: u8 within 1 LSB; float planes within 2e-5 at unit scale
(tests/test_torch_alpha.py) and u16 within 1 LSB, or, through a PQ curve
or the tone map, within 1e-4 and 1e-4 of the value (the ops' tolerance,
tests/test_torch_color_ops.py) and u16 within 8 LSB (1e-4 of 65535, plus
rounding, at values up to 1.2); alpha exactly; stacked decodes equal to
the port's per-image decodes (0 differing pixels).
"""

import numpy as np
import pytest

import torch_parity as tp
from encoder import encode_jxl_modular
from jxl_oxide_tpu.headers import image as jimage
from jxl_oxide_tpu_torch import JxlImage, decode_batch, decode_batch_stacked
from jxl_oxide_tpu_torch.headers import image as timage
from make_torch_port_fixtures import (
    REQUESTS,
    requested_encodings,
    smooth_alpha,
    smooth_u8,
)


def _grey(h, w, seed, alpha=False, **kw):
    chans = [smooth_u8(h, w, seed)[0]]
    if alpha:
        chans.append(smooth_alpha(h, w, seed + 1))
    return encode_jxl_modular(chans, bit_depth=8, grayscale=True,
                              extra_alpha=alpha, **kw)


F32_TOL = dict(atol=2e-5, rtol=0)
PQ_TOL = dict(atol=1e-4, rtol=1e-4)


def _check(data, req=None, f32=F32_TOL):
    """The port against the JAX package on `data` (keyframe 0), under the
    request `req` (a REQUESTS name) if given; float planes within the
    tolerance `f32`."""
    from jxl_oxide_tpu import JxlImage as JaxImage

    ours = JxlImage.from_bytes(data, device="cpu")
    ref = JaxImage.from_bytes(data)
    if req is not None:
        ours.request_color_encoding(requested_encodings(timage)[req])
        ref.request_color_encoding(requested_encodings(jimage)[req])
    a, b = ours.render_frame(0), ref.render_frame(0)
    u16_tol = 1 if f32 is F32_TOL else 8
    for x, y, tol in ((a.to_u8(), b.to_u8(), 1),
                      (a.to_u16(), b.to_u16(), u16_tol)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert tp.max_lsb(x, y) <= tol
        if x.shape[-1] in (2, 4):
            np.testing.assert_array_equal(x[..., -1], y[..., -1])
    np.testing.assert_allclose(a.image(), np.asarray(b.image()), **f32)
    return a


@pytest.mark.parametrize("orientation", range(1, 9))
def test_grey_under_every_orientation(orientation):
    """A grey plane, gaborish and an EPF pass (the filters on its plane
    cloned to three), oriented: [H, W, 1] with H and W swapped for 5-8."""
    data = _grey(48, 40, 60, gabor=True, epf_iters=1,
                 orientation=orientation)
    r = _check(data)
    shape = (40, 48) if orientation >= 5 else (48, 40)
    assert r.to_u8().shape == shape + (1,)
    assert len(r.image_planar()) == 1


@pytest.mark.parametrize("orientation", [1, 5, 8])
def test_grey_alpha(orientation):
    """Grey + alpha: [H, W, 2], the alpha exact, never filtered."""
    data = _grey(40, 56, 62, alpha=True, gabor=True, epf_iters=2,
                 orientation=orientation)
    r = _check(data)
    assert r.to_u8().shape[-1] == 2
    assert r.image_all_channels().shape[-1] == 2


def test_grey_squeeze_epf_matches():
    """Squeezed grey with EPF 2, 3 passes of the filter on a clone."""
    _check(_grey(64, 96, 64, squeeze=True, gabor=True, epf_iters=3))


def test_grey_blend_chain_matches():
    """Three grey + alpha frames blended over slot 1 with the alpha, EPF on
    each: the canvas is one colour plane and an alpha."""
    frames = [[smooth_u8(48, 40, 70 + k)[0], smooth_alpha(48, 40, 80 + k)]
              for k in range(3)]
    data = encode_jxl_modular(frames[0], bit_depth=8, grayscale=True,
                              extra_alpha=True, animation_frames=frames,
                              animation_blend=True, gabor=True, epf_iters=1)
    tp.assert_keyframes_match(data, exact=False)


@pytest.mark.parametrize("req", REQUESTS)
@pytest.mark.parametrize("stream", ["vardct", "vardct_xyb", "modular_rgb",
                                    "grey"])
def test_requests_on_small_streams(stream, req):
    data = {
        "vardct": lambda: tp.vardct_stream(40, 48, 3, gabor=True,
                                           epf_iters=1),
        "vardct_xyb": lambda: tp.vardct_stream(40, 48, 4, xyb=True,
                                               gabor=True, epf_iters=2),
        "modular_rgb": lambda: encode_jxl_modular(smooth_u8(40, 48, 65),
                                                  bit_depth=8),
        "grey": lambda: _grey(40, 48, 66, gabor=True, epf_iters=1),
    }[stream]()
    r = _check(data, req, PQ_TOL if req == "pq" else F32_TOL)
    assert len(r.planes) == (1 if req == "grey" else 3)


@pytest.mark.parametrize("req", [None, "pq", "hlg", "bt709",
                                 "p3_perceptual"])
@pytest.mark.parametrize("relative", [False, True])
def test_xyb_hdr(req, relative):
    """XYB mastered at 4000 nits: tone-mapped to an SDR target (with the
    peak read from the image when relative), passed to PQ and HLG as they
    are."""
    data = encode_jxl_modular(smooth_u8(40, 48, 67), bit_depth=8, xyb=True,
                              tone_mapping=(4000.0, 0.0, relative, 0.0),
                              gabor=True, epf_iters=1)
    _check(data, req, PQ_TOL)


def test_xyb_hdr_to_grey_raises_as_the_reference_does():
    """A fault of the reference, kept by the port (ROADMAP Queue 3): an
    HDR XYB image rendered to a grey target tone-maps after the transform
    has made one plane, and unpacking three planes from it raises."""
    from jxl_oxide_tpu import JxlImage as JaxImage

    data = encode_jxl_modular(smooth_u8(32, 32, 68), bit_depth=8, xyb=True,
                              tone_mapping=(4000.0, 0.0, False, 0.0))
    for mod, img in ((timage, JxlImage.from_bytes(data, device="cpu")),
                     (jimage, JaxImage.from_bytes(data))):
        img.request_color_encoding(requested_encodings(mod)["grey"])
        with pytest.raises(ValueError):
            img.render_frame(0)


@pytest.mark.parametrize("req", [None, "pq", "grey"])
def test_embedded_p3_profile(req):
    """An embedded profile an enum expresses: the enum transform to the
    request, sRGB by default."""
    from jxl_oxide_tpu.color.synthesize import colour_encoding_to_icc

    icc = colour_encoding_to_icc(requested_encodings(jimage)["p3_perceptual"])
    data = encode_jxl_modular(smooth_u8(40, 48, 69), bit_depth=8,
                              embed_icc=icc, gabor=True, epf_iters=1)
    _check(data, req)


def _mix():
    from jxl_oxide_tpu.color.synthesize import colour_encoding_to_icc

    icc = colour_encoding_to_icc(requested_encodings(jimage)["p3_perceptual"])
    v1 = tp.vardct_stream(64, 64, 1, gabor=True, epf_iters=1)
    v2 = tp.vardct_stream(64, 64, 2, gabor=True, epf_iters=1)
    return [
        v1,
        _grey(64, 64, 71, gabor=True, epf_iters=1),
        v2,
        encode_jxl_modular(smooth_u8(64, 64, 72), bit_depth=8,
                           embed_icc=icc),
        _grey(64, 64, 73, alpha=True),
        encode_jxl_modular(smooth_u8(64, 64, 74), bit_depth=8, xyb=True,
                           tone_mapping=(4000.0, 0.0, True, 0.0)),
        v1,
    ]


def test_batches_over_a_colour_mix():
    """decode_batch and decode_batch_stacked over VarDCT streams (stacked),
    grey, grey + alpha, an embedded profile and a peak-detecting HDR
    stream (per image): every result equal to its per-image decode, and
    each within 1 LSB of the JAX package's."""
    from jxl_oxide_tpu import JxlImage as JaxImage

    streams = _mix()
    single = [JxlImage.from_bytes(d, device="cpu").render_frame(0).to_u8()
              for d in streams]
    for fn in (decode_batch, decode_batch_stacked):
        out = fn(streams, device="cpu", num_workers=3)
        for got, want in zip(out, single):
            assert got.shape == want.shape
            assert int((got != want).sum()) == 0
    for data, got in zip(streams, single):
        want = JaxImage.from_bytes(data).render_frame(0).to_u8()
        assert tp.max_lsb(got, want) <= 1


def test_stacked_envelope_leaves_colour_legs_out():
    """The stacked path takes sRGB VarDCT only: greyscale, an embedded or
    requested ICC profile and a peak-detecting tone map go per image."""
    from jxl_oxide_tpu_torch.color import cms
    from jxl_oxide_tpu_torch.serving import _host_stage_fast

    streams = _mix()
    fast = [_host_stage_fast(JxlImage.from_bytes(d, device="cpu"), 0)
            is not None for d in streams]
    assert fast == [True, False, True, False, False, False, True]
    img = JxlImage.from_bytes(streams[0], device="cpu")
    img.request_icc(cms.srgb_icc())
    assert _host_stage_fast(img, 0) is None


def test_request_on_a_blended_xyb_frame_follows_the_reference():
    """A fault of the reference, kept by the port (ROADMAP Queue 3): an XYB
    frame that blends is converted to the signalled encoding before
    blending (ct_done), and the final tail then skips the requested
    encoding, though rendered_cicp names it."""
    from jxl_oxide_tpu import JxlImage as JaxImage

    frames = [smooth_u8(32, 32, 90 + k) + [smooth_alpha(32, 32, 95 + k)]
              for k in range(2)]
    data = encode_jxl_modular(frames[0], bit_depth=8, xyb=True,
                              extra_alpha=True, animation_frames=frames,
                              animation_blend=True)
    ours = JxlImage.from_bytes(data, device="cpu")
    ref = JaxImage.from_bytes(data)
    plain = ours.render_frame(1).to_u8()
    ours.request_color_encoding(requested_encodings(timage)["pq"])
    ref.request_color_encoding(requested_encodings(jimage)["pq"])
    got, want = ours.render_frame(1).to_u8(), ref.render_frame(1).to_u8()
    assert tp.max_lsb(got, want) <= 1
    np.testing.assert_array_equal(got, plain)
    assert ours.rendered_cicp() == ref.rendered_cicp() == (9, 16, 0, 1)
