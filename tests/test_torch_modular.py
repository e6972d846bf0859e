"""Lossless Modular frames in the port against the JAX package, on the CPU.

- The channel slots after the two host stages (bit for bit, sample lane
  included), and `decode_modular_frame`'s channel arrays with the device
  tail on both sides: the port's forced on the CPU by patching
  utils/options.py (`device_modular_may_engage`, DEVICE_TAIL_MIN_SAMPLES),
  the JAX package's by JXL_TPU_DEVICE_MODULAR=1. The transform cases are
  those of tests/test_squeeze.py test_device_modular_tail_bit_exact, the
  palette case included.
- A default squeeze pyramid (both axes, in place and not) through the
  port's ModularImage.finish on its device tail, against the JAX
  package's device tail and its host tail.
- The decode end to end, to_u8 / to_u16 and the float planes: exact for
  lossless frames with no filter, within 1e-5 (tests/test_api.py:590) for
  filtered or XYB planes and 1 LSB in u8/u16; and the committed Modular
  fixtures against their references.
- The envelope: greyscale Modular streams and an alpha beside a spot
  colour raise, naming their ROADMAP items; the gate and the sample lane
  follow the decode's device.
"""

import types

import numpy as np
import pytest
import torch

import torch_parity as tp
from encoder import encode_jxl_modular
from jxl_oxide_tpu_torch import JxlImage
from jxl_oxide_tpu_torch.ops.cuda import squeeze as sq
from jxl_oxide_tpu_torch.render.render import device_stage, host_stage
from jxl_oxide_tpu_torch.utils import options as opts


def _chans(seed, h=40, w=56, bits=8):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 1 << bits, (h, w), dtype=np.int64)
            for _ in range(3)]


def _palette_stream():
    rng = np.random.default_rng(41)
    pal = rng.integers(0, 256, (1, 7), dtype=np.int64)
    idx = rng.integers(-2, 7 + 4, (24, 24))
    return encode_jxl_modular(
        [pal, idx], bit_depth=8, grayscale=True, image_size=(24, 24),
        palette_spec=dict(nb_colours=7, nb_deltas=2, d_pred=0))


# tests/test_squeeze.py:213-237, plus a multi-group frame
TRANSFORMS = {
    "squeeze": lambda: encode_jxl_modular(_chans(1), squeeze=True),
    "rct9": lambda: encode_jxl_modular(_chans(2), rct=True, rct_type=9),
    "rct28": lambda: encode_jxl_modular(_chans(3), rct=True, rct_type=28),
    "rct35": lambda: encode_jxl_modular(_chans(4), rct=True, rct_type=35),
    "rct13": lambda: encode_jxl_modular(_chans(5), rct=True, rct_type=13),
    "squeeze_rct": lambda: encode_jxl_modular(_chans(6), squeeze=True,
                                              rct=True),
    "squeeze16": lambda: encode_jxl_modular(_chans(7, bits=16),
                                            bit_depth=16, squeeze=True),
    "palette": _palette_stream,
    "groups_squeeze_rct": lambda: encode_jxl_modular(
        _chans(8, 300, 280), squeeze=True, rct=True),
}


@pytest.fixture
def device_tail(monkeypatch):
    """The port's device tail on the CPU, for every plane size."""
    monkeypatch.setattr(opts, "device_modular_may_engage", lambda: True)
    monkeypatch.setattr(opts, "DEVICE_TAIL_MIN_SAMPLES", 0)


def _jax_frame(data):
    from jxl_oxide_tpu import JxlImage as JaxImage

    img = JaxImage.from_bytes(data)
    return img._frames[0]


def _torch_frame(data):
    return JxlImage.from_bytes(data, device="cpu")._frames[0]


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_channels_match_jax_with_the_device_tail(name, device_tail,
                                                 monkeypatch):
    from jxl_oxide_tpu.models import modular as jmodular

    data = TRANSFORMS[name]()
    monkeypatch.setenv("JXL_TPU_DEVICE_MODULAR", "1")
    # the JAX host stage's slots: snapshot before the frame's own finish
    # (the last one; group sub-images finish first)
    seen = []
    finish = jmodular.ModularImage.finish

    def snapshot(self):
        seen.append([s.arr.copy() for s in self.slots])
        return finish(self)

    monkeypatch.setattr(jmodular.ModularImage, "finish", snapshot)
    want = _jax_frame(data).decode_modular_frame()
    jax_slots = seen[-1]

    calls = []
    kernel = sq.inv_squeeze_cuda

    def counting(avg, res, horizontal):
        calls.append(horizontal)
        return kernel(avg, res, horizontal)

    monkeypatch.setattr(sq, "inv_squeeze_cuda", counting)
    modular = _torch_frame(data).decode_modular_sections()
    ours = [s.arr for s in modular.slots]
    assert [a.dtype for a in ours] == [a.dtype for a in jax_slots]
    for o, j in zip(ours, jax_slots):
        np.testing.assert_array_equal(o, j)
    assert modular.device_tail_selected()
    got = modular.finish()
    assert len(got) == len(want)
    for o, j in zip(got, want):
        np.testing.assert_array_equal(o, np.asarray(j))
    if "squeeze" in name:
        assert calls, "no squeeze went through the kernel's wrapper"


@pytest.mark.parametrize("name", ["squeeze_rct", "palette"])
def test_device_tail_keeps_planes_on_the_device(name, device_tail):
    """finish(to_device=True) hands back tensors and writes nothing into
    the host buffers; the values are the host tail's."""
    data = TRANSFORMS[name]()
    host = _torch_frame(data).decode_modular_frame()
    modular = _torch_frame(data).decode_modular_sections()
    before = [a.copy() for a in modular.image_channels]
    planes = modular.finish(to_device=True)
    assert all(isinstance(p, torch.Tensor) and p.dtype == torch.int32
               for p in planes)
    for p, h in zip(planes, host):
        np.testing.assert_array_equal(p.numpy(), h)
    for a, b in zip(modular.image_channels, before):
        np.testing.assert_array_equal(a, b)


def _pyramid(mod, shapes, seed):
    """A ModularImage of `mod` whose slots are the default squeeze pyramid
    of random planes of `shapes` (tools/measure_modular_device.py
    build_squeeze_case, on three channels: the chroma pair squeezes first,
    not in place, then all three in place)."""
    rng = np.random.default_rng(seed)
    chans = [mod.ChannelInfo(w, h) for h, w in shapes]
    squeeze = mod.Squeeze()
    squeeze.set_default_params(chans, 0)
    parents = [rng.integers(-(1 << 10), 1 << 10, s).astype(np.int32)
               for s in shapes]
    slots = [mod.Slot(p) for p in parents]
    squeeze.check([mod.ChannelInfo(w, h) for h, w in shapes], 0, slots, [])
    img = object.__new__(mod.ModularImage)
    img.header = types.SimpleNamespace(transforms=[squeeze])
    img.slots = slots
    img.image_channels = parents
    img.bit_depth = 16
    img.finished = False
    return img, squeeze


@pytest.mark.parametrize("shapes", [[(96, 80)] * 3, [(72, 130)] * 3])
def test_default_squeeze_pyramid_matches_jax(shapes, device_tail,
                                             monkeypatch):
    from jxl_oxide_tpu.models import modular as jmod
    from jxl_oxide_tpu_torch.models import modular as tmod

    jimg, jsq = _pyramid(jmod, shapes, 5)
    img, tsq = _pyramid(tmod, shapes, 5)
    for j, t in zip(jimg.slots, img.slots):
        np.testing.assert_array_equal(j.arr, t.arr)
    steps = [(sp.horizontal, sp.in_place) for sp in tsq.sp]
    assert {h for h, _ in steps} == {True, False}
    assert {p for _, p in steps} == {True, False}

    monkeypatch.setenv("JXL_TPU_DEVICE_MODULAR", "1")
    want_dev = [a.copy() for a in jimg._finish_device()]
    jhost, _ = _pyramid(jmod, shapes, 5)
    for tr in reversed(jhost.header.transforms):
        tr.inverse(jhost.slots, 16)
    assert img.device_tail_selected()
    got = img.finish()
    for o, d, h in zip(got, want_dev, jhost.image_channels):
        np.testing.assert_array_equal(o, d)
        np.testing.assert_array_equal(o, h)


# (stream, lossless with no filter, so exact in u8/u16)
END_TO_END = {
    "rgb8": (lambda: encode_jxl_modular(_chans(11, 48, 64), squeeze=True,
                                        rct=True), True),
    "rgb16": (lambda: encode_jxl_modular(_chans(12, 40, 56, 16),
                                         bit_depth=16, squeeze=True), True),
    "ycbcr444": (lambda: encode_jxl_modular(_chans(13, 48, 40),
                                            do_ycbcr=True), True),
    "xyb": (lambda: encode_jxl_modular(_chans(14, 64, 64), xyb=True,
                                       squeeze=True), False),
    "gabor_epf2": (lambda: encode_jxl_modular(
        _chans(15, 64, 72), squeeze=True, rct=True, gabor=True,
        epf_iters=2), False),
    "epf3": (lambda: encode_jxl_modular(_chans(16, 48, 56), epf_iters=3),
             False),
    "float16": (lambda: encode_jxl_modular(
        [np.random.default_rng(17 + c).random((32, 40)).astype(np.float16)
         .view(np.uint16).astype(np.int64) for c in range(3)],
        bit_depth=16, float_exp_bits=5), False),
}


@pytest.mark.parametrize("name", sorted(END_TO_END))
@pytest.mark.parametrize("tail", ["host", "device"])
def test_decode_matches_jax(name, tail, monkeypatch):
    from jxl_oxide_tpu import JxlImage as JaxImage

    if tail == "device":
        monkeypatch.setattr(opts, "device_modular_may_engage", lambda: True)
        monkeypatch.setattr(opts, "DEVICE_TAIL_MIN_SAMPLES", 0)
    make, exact = END_TO_END[name]
    data = make()
    ours = JxlImage.from_bytes(data, device="cpu").render_frame(0)
    ref = JaxImage.from_bytes(data).render_frame(0)
    img = ours.image()
    np.testing.assert_allclose(img, np.asarray(ref.image()), atol=1e-5,
                               rtol=0)
    for a, b in ((ours.to_u8(), ref.to_u8()), (ours.to_u16(), ref.to_u16())):
        assert a.dtype == b.dtype
        if exact:
            np.testing.assert_array_equal(a, b)
        else:
            assert tp.max_lsb(a, b) <= 1


def test_host_and_device_tails_render_alike(device_tail, monkeypatch):
    data = END_TO_END["gabor_epf2"][0]()
    ours = JxlImage.from_bytes(data, device="cpu")
    frame = ours._frames[0]
    host = host_stage(frame)
    assert host.channels is None
    dev = device_stage(host, ours.device)
    monkeypatch.setattr(opts, "DEVICE_TAIL_MIN_SAMPLES", 1 << 40)
    host = host_stage(frame)
    assert host.channels is not None
    ref = device_stage(host, ours.device)
    for a, b in zip([*dev.color, *dev.extra], [*ref.color, *ref.extra]):
        assert torch.equal(a, b)


def test_render_frame_twice_decodes_afresh():
    """A second render of the same image decodes the frame again: the
    host tail transforms the ModularImage's buffers in place."""
    data = END_TO_END["rgb8"][0]()
    img = JxlImage.from_bytes(data, device="cpu")
    first = img.render_frame(0).to_u8()
    np.testing.assert_array_equal(img.render_frame(0).to_u8(), first)
    np.testing.assert_array_equal(first, tp.jax_u8(data))


@pytest.mark.parametrize("name", tp.MODULAR_FIXTURES)
def test_fixture_reference_is_the_jax_decode(name):
    data, ref = tp.fixture(name)
    assert ref.dtype == np.uint8 and ref.shape[2] == 3
    np.testing.assert_array_equal(tp.jax_u8(data), ref)
    assert tp.max_lsb(tp.torch_u8(data), ref) == 0


@pytest.mark.parametrize("name,size,filters,device_tail_on_cuda", [
    ("modular_1024", 1024, (True, 2), True),
    ("modular_xyb_512", 512, (False, 0), False),
])
def test_fixtures_take_their_tails(name, size, filters, device_tail_on_cuda,
                                   monkeypatch):
    """modular_1024 is as large as the gate: on CUDA it decodes wide and
    its tail (one horizontal squeeze, the YCoCg RCT) runs on the device,
    with gaborish and 2 EPF passes; modular_xyb_512 keeps the host tail.
    The CUDA device is stood in for by patching the selection."""
    data = tp.fixture(name)[0]
    img = JxlImage.from_bytes(data, device="cpu")
    header = img._frames[0].header
    rf = header.restoration_filter
    assert (img.width, img.height) == (size, size)
    assert (rf.gab.enabled, rf.epf.iters if rf.epf.enabled else 0) == filters
    assert img.image_header.metadata.xyb_encoded == (name == "modular_xyb_512")
    on_cpu = host_stage(img._frames[0])
    assert on_cpu.channels is not None
    monkeypatch.setattr(opts, "device_modular_may_engage", lambda: True)
    host = tp.torch_host_stage(data)
    assert (host.channels is None) == device_tail_on_cuda
    if device_tail_on_cuda:
        assert [s.arr.shape for s in host.modular.slots] == [
            (1024, 512), (1024, 512), (1024, 1024), (1024, 1024)]
        assert all(s.arr.dtype == np.int32 for s in host.modular.slots)


def test_gate_follows_the_decode_device():
    assert opts.get_decode_device() == torch.device("cpu")
    assert not opts.device_modular_may_engage()
    with opts.use_decode_device("cpu"):
        assert not opts.device_modular_may_engage()
    with opts.use_decode_device(torch.device("cuda", 0)):
        assert opts.device_modular_may_engage()
        assert opts.get_decode_device() == torch.device("cuda", 0)
    assert not opts.device_modular_may_engage()
    assert opts.DEVICE_TAIL_MIN_SAMPLES == 1 << 20


def _cmyk():
    """CMYK: three colour channels and a Black extra channel (greyscale
    decodes since item 15, tests/test_torch_color_live.py)."""
    rng = np.random.default_rng(21)
    return encode_jxl_modular([rng.integers(0, 256, (32, 32))
                               for _ in range(4)], bit_depth=8,
                              extra_channel_specs=[{"ty": 4}])


def _alpha():
    """Alpha and a spot colour (one alpha alone: test_torch_alpha.py)."""
    rng = np.random.default_rng(22)
    return encode_jxl_modular(
        [rng.integers(0, 256, (32, 32)) for _ in range(5)], bit_depth=8,
        extra_alpha=True, spot_colour=(1.0, 0.5, 0.0, 1.0))


@pytest.mark.parametrize("make,item", [(_cmyk, "item 17"),
                                       (_alpha, "item 17")])
def test_outside_the_modular_envelope_raises(make, item):
    """CMYK and a spot colour beside an alpha were outside the envelope
    (item 17) until the port's ninth slice: they decode now, bit for bit
    the JAX package's, every extra channel too
    (tests/test_torch_extra_channels.py has the other kinds)."""
    data = make()
    img = tp.assert_keyframes_match(data, exact=True)
    assert img._frames[0].header.encoding.name == "MODULAR"
    np.testing.assert_array_equal(
        img.render_frame(0).image_all_channels(),
        np.asarray(tp.jax_image(data).render_frame(0).image_all_channels()))
