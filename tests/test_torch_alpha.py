"""Lossy and lossless frames with an alpha channel through the port's entry
point, JxlImage.from_bytes(data, device="cpu").render_frame(0), against
jxl_oxide_tpu on the CPU.

Tolerances: u8 and u16 within 1 LSB of the JAX package (the colour of a
lossy frame goes through einsums that XLA and torch sum in different
orders; tests/test_torch_decode.py), float planes within 2e-5 (the
pipeline tolerance of tests/test_torch_pipeline.py at unit scale); the
alpha channel, and everything of a lossless frame with no filter, bit
for bit (integer samples divided by 2^bits - 1 in IEEE float32 on both
sides).
"""

import numpy as np
import pytest

import torch_parity as tp
from encoder import encode_jxl_modular
from jxl_oxide_tpu_torch import JxlImage
from jxl_oxide_tpu_torch.utils import options as opts


def _rng_alpha(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w)).astype(
        np.int64)


def _modular(seed, **kw):
    rng = np.random.default_rng(seed)
    return encode_jxl_modular(
        [rng.integers(0, 256, (40, 56)) for _ in range(4)], bit_depth=8,
        extra_alpha=True, **kw)


STREAMS = {
    # one group: the alpha is a global modular channel of LfGlobal
    "vardct_128": lambda: tp.vardct_stream(
        128, 128, 3, alpha=_rng_alpha(128, 128, 1), gabor=True, epf_iters=2),
    # several groups: the alpha's sub-streams follow the HF data inside the
    # last pass's sections (tools/fuzz_diff.py:431)
    "vardct_300x260": lambda: tp.tiled_stream(
        300, 260, 4, types=[0], alpha=_rng_alpha(300, 260, 2), gabor=True,
        epf_iters=1),
    "modular": lambda: _modular(3),
    "modular_squeeze": lambda: encode_jxl_modular(
        [np.random.default_rng(4).integers(0, 256, (48, 40))
         for _ in range(4)], bit_depth=8, extra_alpha=True, squeeze=True),
}
LOSSLESS = ("modular", "modular_squeeze")


@pytest.fixture
def device_tail(monkeypatch):
    """The port's device tail on the CPU, for every plane size."""
    monkeypatch.setattr(opts, "device_modular_may_engage", lambda: True)
    monkeypatch.setattr(opts, "DEVICE_TAIL_MIN_SAMPLES", 0)


def _renders(data):
    from jxl_oxide_tpu import JxlImage as JaxImage

    return (JxlImage.from_bytes(data, device="cpu").render_frame(0),
            JaxImage.from_bytes(data).render_frame(0))


def _check(name):
    ours, ref = _renders(STREAMS[name]())
    for a, b in ((ours.to_u8(), ref.to_u8()), (ours.to_u16(), ref.to_u16())):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.shape[-1] == 4
        np.testing.assert_array_equal(a[..., 3], b[..., 3])
        if name in LOSSLESS:
            np.testing.assert_array_equal(a, b)
        else:
            assert tp.max_lsb(a, b) <= 1
    img, want = ours.image(), np.asarray(ref.image())
    assert img.shape == want.shape and img.dtype == np.float32
    np.testing.assert_array_equal(img[..., 3], want[..., 3])
    np.testing.assert_allclose(img, want, atol=2e-5, rtol=0)
    np.testing.assert_allclose(ours.image_all_channels(),
                               np.asarray(ref.image_all_channels()),
                               atol=2e-5, rtol=0)


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_alpha_matches_jax(name):
    _check(name)


def test_modular_alpha_device_tail_matches_jax(device_tail):
    """The same with the port's Modular tail on the device (forced on the
    CPU; it takes frames with transforms): the alpha is one more slot of
    the device tail."""
    name = "modular_squeeze"
    data = STREAMS[name]()
    host = tp.torch_host_stage(data)
    assert host.channels is None  # the device tail will run
    _check(name)


def test_alpha_host_stage_decodes_the_ec():
    """The VarDCT host stage hands the alpha's integer samples to the
    device stage, as the JAX package's _host_stage_fast does."""
    from jxl_oxide_tpu import JxlImage as JaxImage
    from jxl_oxide_tpu.serving import _host_stage_fast

    alpha = _rng_alpha(300, 260, 2)
    data = tp.tiled_stream(300, 260, 4, types=[0], alpha=alpha)
    host = tp.torch_host_stage(data)
    (ours,) = host.extra
    np.testing.assert_array_equal(ours, alpha)
    jax_alpha = _host_stage_fast(JaxImage.from_bytes(data), 0)[3]
    np.testing.assert_array_equal(ours / np.float32(255), jax_alpha)


def test_u8_has_four_channels_exactly_with_alpha():
    plain = tp.vardct_stream(32, 40, 5)
    with_alpha = tp.vardct_stream(32, 40, 5, alpha=_rng_alpha(32, 40, 6))
    assert JxlImage.from_bytes(plain, device="cpu").render_frame(
        0).to_u8().shape == (32, 40, 3)
    r = JxlImage.from_bytes(with_alpha, device="cpu").render_frame(0)
    assert r.to_u8().shape == (32, 40, 4)
    assert r.image_all_channels().shape == (32, 40, 4)
    assert len(r.extra) == 1 and len(r.planes) == 3


@pytest.mark.parametrize("name", ["flagship_alpha_1024", "modular_alpha_512"])
def test_alpha_fixture_matches_reference(name):
    data, ref = tp.fixture(name)
    got = tp.torch_u8(data)
    assert got.shape == ref.shape == (*ref.shape[:2], 4)
    np.testing.assert_array_equal(got[..., 3], ref[..., 3])
    assert tp.max_lsb(got, ref) <= 1


def _alpha_dim_shift():
    rng = np.random.default_rng(7)
    chans = [rng.integers(0, 256, (32, 32)) for _ in range(3)]
    return encode_jxl_modular(chans + [rng.integers(0, 256, (16, 16))],
                              bit_depth=8, extra_alpha=True,
                              alpha_dim_shift=1)


def _alpha_and_spot():
    rng = np.random.default_rng(8)
    return encode_jxl_modular(
        [rng.integers(0, 256, (32, 32)) for _ in range(5)], bit_depth=8,
        extra_alpha=True, spot_colour=(1.0, 0.0, 0.0, 0.5))


def _float_alpha():
    rng = np.random.default_rng(9)
    chans = [rng.integers(0, 256, (32, 32)) for _ in range(3)]
    halves = rng.random((32, 32)).astype(np.float16).view(np.uint16)
    return encode_jxl_modular(
        chans + [halves.astype(np.int64)], bit_depth=8,
        extra_channel_specs=[{"ty": 0, "bits": 16, "float_exp_bits": 5}])


@pytest.mark.parametrize("make,item", [
    (_alpha_dim_shift, "item 9"),
    (_alpha_and_spot, "item 17"),
    (_float_alpha, "item 17"),
])
def test_out_of_envelope_alpha_raises(make, item):
    """Alphas that were outside the envelope: an alpha at a dim_shift
    (item 9) decodes since the port's seventh slice, its colour within 1
    LSB of the JAX package, its alpha bit for bit; an alpha beside a spot
    colour and a float alpha (item 17) since its ninth, bit for bit,
    every extra channel too."""
    data = make()
    if item == "item 9":
        tp.assert_keyframes_match(data, exact=False)
        return
    tp.assert_keyframes_match(data, exact=True)
    np.testing.assert_array_equal(
        JxlImage.from_bytes(data, device="cpu").render_frame(0)
        .image_all_channels(),
        np.asarray(tp.jax_image(data).render_frame(0).image_all_channels()))


def test_not_ported_outputs_name_their_items():
    """The outputs that were not ported: render_frame_cropped (item 14,
    since the port's ninth slice) cuts the alpha with the colour, and
    Render.stream (item 9b) writes to_u8()'s samples."""
    data = STREAMS["vardct_128"]()
    img = JxlImage.from_bytes(data, device="cpu")
    full = img.render_frame(0).to_u8()
    crop = img.render_frame_cropped(0, (3, 5, 40, 30)).to_u8()
    np.testing.assert_array_equal(crop, full[5:35, 3:43])
    assert crop.shape == (30, 40, 4)
    want = full.reshape(-1)
    buf = np.zeros(want.size, np.uint8)
    assert img.render_frame(0).stream().write_to_buffer(buf) == want.size
    np.testing.assert_array_equal(buf, want)
