"""End to end through the port's entry point,
JxlImage.from_bytes(data, device="cpu").render_frame(0).to_u8(), against
jxl_oxide_tpu: within 1 LSB on the parity streams and on the committed
fixtures. Every frame layout decodes (the two YCbCr layouts of ROADMAP
item 7 too: tests/test_torch_ycbcr.py holds them on every path), and
with no device= the port wants CUDA. The
chroma-subsampled and staged paths have their own files
(test_torch_subsampled.py, test_torch_staged.py), as have alpha,
orientation and serving (test_torch_alpha.py, test_torch_orientation.py,
test_torch_serving.py)."""

import numpy as np
import pytest
import torch

import torch_parity as tp
from jxl_oxide_tpu_torch import JxlImage
from jxl_oxide_tpu_torch.device import resolve_device
from torch_parity import STREAMS


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_u8_within_one_lsb_of_jax(name):
    data = STREAMS[name]()
    assert tp.max_lsb(tp.torch_u8(data), tp.jax_u8(data)) <= 1


@pytest.mark.parametrize("name", tp.FIXTURES)
def test_fixture_u8_within_one_lsb_of_reference(name):
    data, ref = tp.fixture(name)
    assert tp.max_lsb(tp.torch_u8(data), ref) <= 1


def test_render_outputs_agree_with_jax():
    """image() and to_u16() of the same render, against the JAX
    package's: float planes within the pipeline tolerance, u16 within
    1 LSB."""
    from jxl_oxide_tpu import JxlImage as JaxImage

    data = STREAMS["xyb_gabor_epf2"]()
    ours = JxlImage.from_bytes(data, device="cpu").render_frame(0)
    ref = JaxImage.from_bytes(data).render_frame(0)
    img = ours.image()
    assert img.shape == (64, 72, 3) and img.dtype == np.float32
    np.testing.assert_allclose(img, np.asarray(ref.image()), atol=2e-5,
                               rtol=0)
    u16 = ours.to_u16()
    assert u16.dtype == np.uint16
    assert tp.max_lsb(u16, ref.to_u16()) <= 1


def _cmyk_modular():
    """CMYK (a Black extra channel): item 17, decoded since the port's
    ninth slice."""
    from encoder import encode_jxl_modular

    rng = np.random.default_rng(0)
    return encode_jxl_modular([rng.integers(0, 256, (32, 32))
                               for _ in range(4)], bit_depth=8,
                              extra_channel_specs=[{"ty": 4}])


def _lf_frame():
    return tp.vardct_stream(64, 64, 1, global_scale=65536, use_lf_frame=True)


def _alpha():
    """An alpha beside a spot colour: item 17, decoded since the port's
    ninth slice."""
    from encoder import encode_jxl_modular

    rng = np.random.default_rng(2)
    return encode_jxl_modular(
        [rng.integers(0, 256, (32, 32)) for _ in range(5)], bit_depth=8,
        extra_alpha=True, spot_colour=(0.0, 1.0, 0.0, 1.0))


def _alpha_dim_shift():
    from encoder import encode_jxl_modular

    rng = np.random.default_rng(4)
    return encode_jxl_modular(
        [rng.integers(0, 256, (32, 32)) for _ in range(3)]
        + [rng.integers(0, 256, (8, 8))], bit_depth=8, extra_alpha=True,
        alpha_dim_shift=2)


@pytest.mark.parametrize("make,item", [
    (_cmyk_modular, "item 17"),
    (_lf_frame, "item 9"),
    (_alpha, "item 17"),
    (_alpha_dim_shift, "item 9"),
])
def test_outside_the_envelope_raises(make, item):
    """Streams that were outside the envelope: LF frames and an alpha at
    a dim_shift (item 9) decode since the port's seventh slice, within 1
    LSB of the JAX package (the alpha exactly); CMYK and a spot colour
    beside an alpha (item 17) since its ninth, bit for bit, every extra
    channel too; the two YCbCr layouts of item 7 since its twelfth
    (test_the_item_7_layouts_decode)."""
    data = make()
    if item == "item 9":
        tp.assert_keyframes_match(data, exact=False)
        return
    tp.assert_keyframes_match(data, exact=True)
    np.testing.assert_array_equal(
        JxlImage.from_bytes(data, device="cpu").render_frame(0)
        .image_all_channels(),
        np.asarray(tp.jax_image(data).render_frame(0).image_all_channels()))


@pytest.mark.parametrize("field,value", [("do_ycbcr", True),
                                         ("jpeg_upsampling", (0, 1, 0))])
def test_the_item_7_layouts_decode(field, value):
    """The two layouts the port refused until its twelfth slice decode as
    the JAX package's: a 4:4:4 YCbCr VarDCT frame (do_ycbcr with no
    subsampling) within 1 LSB, and a chroma-subsampled YCbCr Modular frame
    exactly. Real streams: the single-group VarDCT encoder with
    jpeg_upsampling (0, 0, 0), tools/encoder.py without its asserts."""
    if field == "do_ycbcr":
        data = tp.ycbcr444_stream(64, 64, 5, 0.1, gabor=True, epf_iters=2)
    else:
        data, _ = tp.modular_ycbcr_stream(64, 64, value, 6)
    header = JxlImage.from_bytes(data, device="cpu")._frames[0].header
    assert header.do_ycbcr is True
    assert tuple(header.jpeg_upsampling) == (
        (0, 0, 0) if field == "do_ycbcr" else value)
    got = tp.torch_u8(data)
    if field == "do_ycbcr":
        assert tp.max_lsb(got, tp.jax_u8(data)) <= 1
    else:
        np.testing.assert_array_equal(got, tp.jax_u8(data))


def test_default_device_is_cuda():
    """With no device= the port decodes on CUDA; where there is none it
    raises instead of running on the CPU."""
    data = STREAMS["dct8"]()
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        assert JxlImage.from_bytes(data).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            JxlImage.from_bytes(data)
    with pytest.raises(ValueError):
        resolve_device("mps")
