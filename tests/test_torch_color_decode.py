"""The colour fixtures (jxl_oxide_tpu_torch/testdata, written by
tools/make_torch_port_fixtures.py) decoded by the port on the CPU through
JxlImage.from_bytes(data, device="cpu").render_frame(0), against their
committed jxl_oxide_tpu references: greyscale (squeezed, with an alpha,
bench.py's modular_wp), XYB mastered at 4000 nits (tone-mapped, and
through the peak-detecting leg), an embedded Display P3 profile, and the
flagship stream under each requested encoding.

Tolerance: u8 within 1 LSB of the reference (the float colour tail
differs from XLA's by ulps, tests/test_torch_color_ops.py); lossless
unfiltered frames and alpha exactly. The u16 references of the PQ and HLG
requests: within torch_parity.REQUEST_U16_TOL (1 LSB of 65535, as
measured), far inside BASELINE.md's 0.004 x 65535.
"""

import numpy as np
import pytest

import torch_parity as tp
from jxl_oxide_tpu_torch import JxlImage
from jxl_oxide_tpu_torch.headers import image as timage
from jxl_oxide_tpu_torch.utils import options as opts
from make_torch_port_fixtures import (
    REQUESTS,
    REQUESTS_U16,
    requested_encodings,
)


def _requests_ref():
    return np.load(f"{tp.TESTDATA}/flagship_1024_requests.npz")


@pytest.mark.parametrize("name,exact", [f[:2] for f in tp.COLOR_FIXTURES])
def test_color_fixture_decodes(name, exact):
    data, ref = tp.fixture(name)
    img = JxlImage.from_bytes(data, device="cpu")
    u8 = img.render_frame(0).to_u8()
    assert u8.shape == ref.shape and u8.dtype == np.uint8
    assert tp.max_lsb(u8, ref) <= (0 if exact else 1)
    if ref.shape[-1] in (2, 4):
        np.testing.assert_array_equal(u8[..., -1], ref[..., -1])


def test_color_fixtures_take_their_paths():
    """What each fixture carries: greyscale with a squeeze whose halves
    hold 2^20 samples (the device tail's gate), gaborish and 2 EPF
    passes; one colour channel and an alpha; 4000-nit XYB, relative or
    not; an embedded profile that an enum expresses (P3, perceptual)."""
    from jxl_oxide_tpu_torch.headers.image import ColourSpace

    def image(name):
        return JxlImage.from_bytes(tp.fixture(name)[0], device="cpu")

    grey = image("grey_squeeze_2048x1024")
    meta = grey.image_header.metadata
    assert meta.colour_encoding.colour_space == ColourSpace.GREY
    assert (grey.width, grey.height) == (2048, 1024)
    fr = grey._frames[0]
    rf = fr.header.restoration_filter
    assert rf.gab.enabled and rf.epf.iters == 2
    modular = fr.decode_modular_sections()
    assert [s.arr.size for s in modular.slots] == [1 << 20, 1 << 20]
    assert image("grey_alpha_512")._frames[0].header.encoded_color_channels \
        == 1
    for name, rel in (("xyb_hdr_1024", False), ("xyb_hdr_peak_256", True)):
        m = image(name).image_header.metadata
        assert m.xyb_encoded and m.tone_mapping.intensity_target == 4000.0
        assert m.tone_mapping.relative_to_max_display == rel
    icc = image("icc_p3_512")
    enc = icc._embedded_enum()
    assert icc.image_header.metadata.colour_encoding.want_icc
    assert enc.primaries.kind == "p3"
    assert enc.rendering_intent == timage.RenderingIntent.PERCEPTUAL
    ops = [op.kind for op in icc._cached_transform(
        enc, timage.ColourEncoding(), icc.image_header.metadata).ops]
    assert ops == ["tf_inv", "gamut_map", "matrix", "matrix", "matrix",
                   "tf_fwd"]


def test_grey_squeeze_on_the_device_tail(monkeypatch):
    """The grey fixture with the Modular device tail forced on the CPU
    (the squeeze's plain version, the path the card takes): the reference
    within 1 LSB, as the host tail."""
    monkeypatch.setattr(opts, "device_modular_may_engage", lambda: True)
    data, ref = tp.fixture("grey_squeeze_2048x1024")
    img = JxlImage.from_bytes(data, device="cpu")
    assert img._frames[0].decode_modular_sections().device_tail_selected()
    img = JxlImage.from_bytes(data, device="cpu")
    assert tp.max_lsb(img.render_frame(0).to_u8(), ref) <= 1


@pytest.mark.parametrize("req", REQUESTS)
def test_flagship_under_each_request(req):
    """flagship_1024 rendered to each requested encoding: u8 within 1 LSB
    of the reference, and u16 within REQUEST_U16_TOL for PQ and HLG."""
    data, _ = tp.fixture("flagship_1024")
    refs = _requests_ref()
    img = JxlImage.from_bytes(data, device="cpu")
    img.request_color_encoding(requested_encodings(timage)[req])
    r = img.render_frame(0)
    u8 = r.to_u8()
    want = refs[f"u8_{req}"]
    assert u8.shape == want.shape
    assert tp.max_lsb(u8, want) <= 1
    if req in REQUESTS_U16:
        assert tp.max_lsb(r.to_u16(), refs[f"u16_{req}"]) <= \
            tp.REQUEST_U16_TOL


def test_requests_do_not_reach_the_keyframe_cache():
    """A requested encoding runs at postprocess: the cached keyframe stays
    in the signalled encoding, and a second render under another request
    (and none) reads the same cache entry."""
    data, ref = tp.fixture("xyb_hdr_peak_256")
    img = JxlImage.from_bytes(data, device="cpu")
    enc = requested_encodings(timage)
    plain = img.render_frame(0).to_u8()
    cached = img._keyframe_cache[0]
    img.request_color_encoding(enc["pq"])
    pq = img.render_frame(0).to_u8()
    img.request_color_encoding(None)
    again = img.render_frame(0).to_u8()
    assert img._keyframe_cache[0] is cached
    np.testing.assert_array_equal(again, plain)
    assert tp.max_lsb(plain, ref) <= 1
    assert tp.max_lsb(pq, plain) > 8
