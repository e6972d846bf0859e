"""ICC profiles in the port against jxl_oxide_tpu on the CPU: parsing
(color/parse.py), synthesis (color/synthesize.py), the CMS leg
(color/cms.py, Pillow's Little CMS) and the JxlImage calls that read or
set the output encoding (rendered_icc, rendered_cicp, request_icc,
set_cms).

Parsing and synthesis are host numpy in both packages: equal field for
field and byte for byte. The CMS leg runs Little CMS on u8 samples in both:
its output is equal.
"""

import numpy as np
import pytest

import torch_parity as tp
from encoder import encode_jxl_modular
from jxl_oxide_tpu.color import parse as jparse
from jxl_oxide_tpu.color import synthesize as jsynth
from jxl_oxide_tpu.headers import image as jimage
from jxl_oxide_tpu_torch import JxlImage
from jxl_oxide_tpu_torch.color import cms as tcms
from jxl_oxide_tpu_torch.color import parse as tparse
from jxl_oxide_tpu_torch.color import synthesize as tsynth
from jxl_oxide_tpu_torch.headers import image as timage
from jxl_oxide_tpu_torch.utils.errors import JxlError
from make_torch_port_fixtures import REQUESTS, requested_encodings, smooth_u8

TFS = ("srgb", "linear", "bt709", "pq", "hlg", "dci", "gamma")
PRIMS = ("srgb", "p3", "bt2100")
WHITES = ("d65", "dci", "e")
INTENTS = ("PERCEPTUAL", "RELATIVE", "SATURATION", "ABSOLUTE")


GRID = ([("RGB", p, tf, i, w) for p in PRIMS for tf in TFS for w in WHITES
         for i in INTENTS[:2]]
        + [("GREY", "srgb", tf, i, w) for tf in TFS for w in WHITES
           for i in INTENTS])


def _fields(x):
    """A parsed value as plain data: dataclasses by class name and fields,
    enums by name, arrays as lists."""
    if hasattr(x, "__dataclass_fields__"):
        return (type(x).__name__,
                {k: _fields(v) for k, v in vars(x).items()})
    if isinstance(x, np.ndarray):
        return ("array", x.tolist())
    if isinstance(x, (tuple, list)):
        return tuple(_fields(v) for v in x)
    if hasattr(x, "name") and hasattr(x, "value"):
        return (type(x).__name__, x.name)
    return x


def _outcome(fn, *args):
    """fn's result as plain data, or its exception's class name and
    message."""
    try:
        return _fields(fn(*args))
    except Exception as e:  # noqa: BLE001 - compared across packages
        return ("raised", type(e).__name__, str(e))


@pytest.mark.parametrize("space", ["RGB", "GREY"])
def test_synthesis_and_parsing_match(space):
    """colour_encoding_to_icc byte for byte; parse_icc, detect_profile_info
    and icc_tf of each synthesized profile field for field."""
    n = 0
    for case in GRID:
        if case[0] != space:
            continue
        want = _outcome(jsynth.colour_encoding_to_icc,
                        tp.colour_encoding(jimage, *case))
        got = _outcome(tsynth.colour_encoding_to_icc,
                       tp.colour_encoding(timage, *case))
        assert got == want, case
        if isinstance(want, bytes):
            n += 1
            for jfn, tfn in ((jparse.parse_icc, tparse.parse_icc),
                             (jparse.detect_profile_info,
                              tparse.detect_profile_info),
                             (jparse.icc_tf, tparse.icc_tf)):
                assert _outcome(tfn, want) == _outcome(jfn, want), case
    assert n > 0


def _pillow_srgb() -> bytes:
    return tcms.srgb_icc()


@pytest.mark.parametrize("profile", [
    "pillow_srgb", "empty", "short", "size_mismatch", "bad_intent",
    "truncated_tags", "p3_flipped_byte"])
def test_parsing_foreign_profiles_matches(profile):
    """Profiles that no synthesis makes: Little CMS's sRGB (it carries a
    chrm tag: no enum), and damaged profiles; each parses, or raises the
    same error, in both."""
    p3 = jsynth.colour_encoding_to_icc(jimage.ColourEncoding(
        primaries=jimage.Primaries.P3))
    data = {
        "pillow_srgb": _pillow_srgb(),
        "empty": b"",
        "short": p3[:100],
        "size_mismatch": p3 + b"\0",
        "bad_intent": p3[:0x43] + b"\x07" + p3[0x44:],
        "truncated_tags": p3[:0x84] + b"\xff" * 8,
        "p3_flipped_byte": p3[:200] + bytes([p3[200] ^ 0x55]) + p3[201:],
    }[profile]
    for jfn, tfn in ((jparse.parse_icc, tparse.parse_icc),
                     (jparse.detect_profile_info,
                      tparse.detect_profile_info)):
        assert _outcome(tfn, data) == _outcome(jfn, data)


def test_request_icc_rejects_garbage():
    img = JxlImage.from_bytes(tp.fixture("modular_wp_256")[0], device="cpu")
    for bad in (b"", b"\0" * 131, b"x" * 400,
                _pillow_srgb()[:36] + b"nope" + _pillow_srgb()[40:]):
        with pytest.raises(JxlError):
            img.request_icc(bad)
    assert img.requested_icc is None
    img.request_icc(_pillow_srgb())
    assert img.requested_icc == _pillow_srgb()


NEW_FIXTURES = ("grey_squeeze_2048x1024", "grey_alpha_512", "modular_wp_256",
                "xyb_hdr_1024", "xyb_hdr_peak_256", "icc_p3_512")


def _images(data):
    from jxl_oxide_tpu import JxlImage as JaxImage

    return JxlImage.from_bytes(data, device="cpu"), JaxImage.from_bytes(data)


@pytest.mark.parametrize("name", NEW_FIXTURES + ("flagship_1024",))
def test_rendered_icc_and_cicp_match(name):
    """Each fixture with no request, under each of the flagship's
    requests, and under a requested ICC profile (then no CICP)."""
    ours, ref = _images(tp.fixture(name)[0])
    assert ours.rendered_icc() == ref.rendered_icc()
    assert ours.rendered_cicp() == ref.rendered_cicp()
    tenc, jenc = requested_encodings(timage), requested_encodings(jimage)
    for req in REQUESTS:
        ours.request_color_encoding(tenc[req])
        ref.request_color_encoding(jenc[req])
        assert ours.rendered_icc() == ref.rendered_icc(), req
        assert ours.rendered_cicp() == ref.rendered_cicp(), req
    icc = jsynth.colour_encoding_to_icc(jenc["p3_perceptual"])
    ours.request_icc(icc)
    ref.request_icc(icc)
    assert ours.rendered_icc() == ref.rendered_icc() == icc
    assert ours.rendered_cicp() is ref.rendered_cicp() is None


def test_rendered_icc_without_a_cms():
    """An embedded profile no enum expresses: the CMS leg's sRGB target,
    or with NullCms (and with no CMS) the embedded profile itself."""
    from jxl_oxide_tpu.color.cms import NullCms as JaxNullCms

    ours, ref = _images(_cms_stream())
    assert ours.rendered_icc() == ref.rendered_icc() == tcms.srgb_icc()
    for a, b in ((tcms.NullCms(), JaxNullCms()), (None, None)):
        ours.set_cms(a)
        ref.set_cms(b)
        assert ours.rendered_icc() == ref.rendered_icc() == ours.embedded_icc


def _cms_stream(h=48, w=40, seed=50, **kw):
    """RGB Modular with Little CMS's sRGB profile embedded: parse_icc
    rejects it (a chrm tag), so it takes the CMS leg."""
    return encode_jxl_modular(smooth_u8(h, w, seed), bit_depth=8,
                              embed_icc=_pillow_srgb(), **kw)


def _both_u8(data, setup=None):
    ours, ref = _images(data)
    if setup is not None:
        setup(ours, ref)
    return ours.render_frame(0).to_u8(), ref.render_frame(0).to_u8()


def test_cms_leg_decode_matches():
    """The embedded profile through Little CMS to sRGB, on the host, in
    both packages: equal."""
    with pytest.raises(JxlError):
        tparse.parse_icc(_pillow_srgb())
    got, want = _both_u8(_cms_stream())
    np.testing.assert_array_equal(got, want)


def test_cms_leg_with_gabor_and_null_cms():
    """The CMS leg after the filters; with NullCms the samples stay as
    decoded, in both."""
    from jxl_oxide_tpu.color.cms import NullCms as JaxNullCms

    data = _cms_stream(64, 56, 51, gabor=True, epf_iters=1)
    got, want = _both_u8(data)
    assert tp.max_lsb(got, want) <= 1

    def null(ours, ref):
        ours.set_cms(tcms.NullCms())
        ref.set_cms(JaxNullCms())

    got, want = _both_u8(data, null)
    assert tp.max_lsb(got, want) <= 1


@pytest.mark.parametrize("stream", ["vardct", "modular_xyb"])
def test_requested_icc_that_no_enum_expresses(stream):
    """A requested profile parse_icc rejects: the enum transform to sRGB on
    the decode device, then the CMS leg from sRGB to it, in both."""
    data = (tp.vardct_stream(40, 48, 3, gabor=True, epf_iters=1)
            if stream == "vardct" else encode_jxl_modular(
                smooth_u8(40, 48, 52), bit_depth=8, xyb=True))

    def req(ours, ref):
        ours.request_icc(_pillow_srgb())
        ref.request_icc(_pillow_srgb())

    got, want = _both_u8(data, req)
    assert tp.max_lsb(got, want) <= 1


def test_importing_the_port_needs_no_pillow():
    """The port imports Pillow only inside a CMS leg: a fresh interpreter
    that cannot import PIL decodes a stream with no ICC leg."""
    import os
    import subprocess
    import sys

    script = (
        "import sys\n"
        "sys.modules['PIL'] = None\n"
        f"sys.path.insert(0, {tp.REPO!r})\n"
        "from jxl_oxide_tpu_torch import JxlImage\n"
        f"data = open({os.path.join(tp.TESTDATA, 'modular_wp_256.jxl')!r},"
        " 'rb').read()\n"
        "print(JxlImage.from_bytes(data, device='cpu').render_frame(0)"
        ".to_u8().shape)\n"
    )
    out = subprocess.run([sys.executable, "-c", script], cwd=tp.REPO,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    assert out.stdout.strip().splitlines()[-1] == "(256, 256, 1)"
