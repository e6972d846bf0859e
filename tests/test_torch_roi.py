"""Region-of-interest decode in the port (set_image_region,
render_frame_cropped, a cropped render_loading_frame), on the CPU, against
jxl_oxide_tpu's own region renders and against the crop of the port's
full render: VarDCT 4:4:4 on the fused program and forced onto the
staged path, 4:2:0 and 4:2:2 on the fused subsampled program, an EXIF
orientation of 6, and Modular with and without a squeeze (a squeezed
frame decodes whole, then is cut).

Tolerances: u8 within 1 LSB of the JAX package's region render, and
equal to the crop of the port's own full render (tests/test_vardct_
roundtrip.py:1003, tests/test_api.py:1146-1163 hold the JAX package to
the same); extra channels exact; the rect programs' host inputs bit for
bit. The sections decoded are counted (`_pass_group_jobs`, set by both
packages' section selection).
"""

import numpy as np
import pytest

import torch_parity as tp
from encoder import encode_jxl_modular
from encoder_vardct import encode_jxl_vardct
from jxl_oxide_tpu_torch import JxlImage
from jxl_oxide_tpu_torch.render import roi as troi
from jxl_oxide_tpu_torch.render import vardct as tvardct


def _modular(squeeze):
    rng = np.random.default_rng(9)
    small = rng.integers(0, 256, (4, 320 // 8, 376 // 8))
    planes = [np.kron(p, np.ones((8, 8), np.int64)) for p in small]
    return encode_jxl_modular(planes, bit_depth=8, extra_alpha=True,
                              squeeze=squeeze, gabor=True, epf_iters=1)


# name -> stream maker; the staged case is the 4:4:4 stream with both
# packages' dense plans capped
STREAMS = {
    "444": lambda: encode_jxl_vardct(tp.smooth_rgb(520, 600, 3), gabor=True,
                                     epf_iters=2),
    "420": lambda: tp.ycbcr_stream(512, 512, tp.CHROMA["420"], seed=3,
                                   density=0.1, gabor=True, epf_iters=2),
    "422": lambda: tp.ycbcr_stream(512, 528, tp.CHROMA["422"], seed=4,
                                   density=0.1, gabor=True, epf_iters=2),
    "orient6": lambda: encode_jxl_vardct(tp.smooth_rgb(384, 520, 14),
                                         gabor=True, epf_iters=2,
                                         orientation=6),
    "modular": lambda: _modular(False),
    "modular_squeeze": lambda: _modular(True),
}
# display-space regions: across the first groups (the whole-plane program
# on these sizes), inside one later group (a 256^2 rect program), on the
# right and bottom edges, and one that overhangs them (clamped)
REGIONS = {
    "inner": (37, 101, 200, 150),
    "rect": (300, 280, 60, 50),
    "edge": (-70, -40, 70, 40),
    "overhang": (-30, -20, 60, 50),
}
# the cases: every region on 4:4:4 and Modular, two on the other layouts
CASES = ([(n, r) for n in ("444", "modular") for r in sorted(REGIONS)]
         + [(n, r) for n in ("420", "422", "orient6", "modular_squeeze")
            for r in ("rect", "overhang")])


def _region(img, name):
    """REGIONS[name] on the image's display size (negative offsets count
    from the right and bottom edges)."""
    left, top, w, h = REGIONS[name]
    return (left + img.width if left < 0 else left,
            top + img.height if top < 0 else top, w, h)


@pytest.fixture
def staged(monkeypatch):
    """Both packages' dense plans capped: every VarDCT frame takes the
    staged path, whose output the crop then cuts."""
    from jxl_oxide_tpu.render import vardct as jvardct

    monkeypatch.setattr(jvardct, "DENSE_PLAN_MAX_ENTRIES", 0)
    monkeypatch.setattr(tvardct, "DENSE_PLAN_MAX_ENTRIES", 0)


def _check_region(data, region):
    """The port's render_frame_cropped of `region` against the JAX
    package's and against the crop of the port's full render; returns
    both images (port, JAX)."""
    ours = JxlImage.from_bytes(data, device="cpu")
    ref = tp.jax_image(data)
    full = ours.render_frame(0)
    full_u8, full_all = full.to_u8(), full.image_all_channels()
    img = JxlImage.from_bytes(data, device="cpu")
    r = img.render_frame_cropped(0, region)
    b = ref.render_frame_cropped(0, region)
    u8, want = r.to_u8(), b.to_u8()
    left, top, w, h = region
    crop = full_u8[top:top + h, left:left + w]
    assert u8.shape == want.shape == crop.shape, (u8.shape, want.shape)
    assert tp.max_lsb(u8, want) <= 1
    np.testing.assert_array_equal(u8, crop)
    allc = r.image_all_channels()
    np.testing.assert_array_equal(allc[..., 3:], np.asarray(
        b.image_all_channels())[..., 3:])
    np.testing.assert_array_equal(
        allc, full_all[top:top + h, left:left + w])
    return img, ref


@pytest.mark.parametrize("name,region", CASES)
def test_region_matches_jax_and_full_crop(name, region, monkeypatch):
    data = STREAMS[name]()
    img = JxlImage.from_bytes(data, device="cpu")
    rects = []
    run = tvardct.VardctFrameState.run_device_pipeline

    def seen(self, hf_global, device, rect=None):
        rects.append(rect)
        return run(self, hf_global, device, rect)

    monkeypatch.setattr(tvardct.VardctFrameState, "run_device_pipeline",
                        seen)
    ours, ref = _check_region(data, _region(img, region))
    # the same sections decoded as the JAX package's selection
    assert (getattr(ours._frames[0], "_pass_group_jobs", None)
            == getattr(ref._frames[0], "_pass_group_jobs", None))
    if not name.startswith("modular") and region in ("rect", "edge"):
        # the full render, then the region's rect program
        assert rects[0] is None and rects[1] is not None


@pytest.mark.parametrize("region", ["rect", "edge"])
def test_region_on_the_staged_path(region, staged):
    data = STREAMS["444"]()
    img = JxlImage.from_bytes(data, device="cpu")
    _check_region(data, _region(img, region))


@pytest.mark.parametrize("name", ["444", "420", "modular"])
def test_sections_outside_the_region_are_not_decoded(name):
    """An inner region decodes only the pass groups that meet it, padded;
    a squeezed frame, which mixes samples across the plane, decodes
    all."""
    data = STREAMS[name]()
    img = JxlImage.from_bytes(data, device="cpu")
    header = img._frames[0].header
    img.render_frame_cropped(0, REGIONS["inner"])
    assert 0 < img._frames[0]._pass_group_jobs < header.num_groups
    want = sum(troi.group_intersects(img._frames[0], g, REGIONS["inner"])
               for g in range(header.num_groups))
    assert img._frames[0]._pass_group_jobs == want
    sq = JxlImage.from_bytes(STREAMS["modular_squeeze"](), device="cpu")
    sq.render_frame_cropped(0, REGIONS["inner"])
    assert (sq._frames[0]._pass_group_jobs
            == sq._frames[0].header.num_groups)


def test_set_image_region_and_render_frame_cropped():
    """set_image_region crops every later render (render_frame,
    render_frame_cropped's own region aside, which leaves it as it
    was); a region render is cached under its region, apart from the
    full canvas."""
    data = STREAMS["444"]()
    img = JxlImage.from_bytes(data, device="cpu")
    inner, later = REGIONS["inner"], REGIONS["rect"]
    img.set_image_region(*inner)
    a = img.render_frame(0).to_u8()
    b = img.render_frame_cropped(0, later).to_u8()
    assert img._image_region == inner
    np.testing.assert_array_equal(img.render_frame(0).to_u8(), a)
    assert a.shape == (inner[3], inner[2], 3)
    assert b.shape == (later[3], later[2], 3)
    assert set(img._keyframe_cache) == {(0, inner), (0, later)}
    ref = tp.jax_image(data)
    ref.set_image_region(*inner)
    assert tp.max_lsb(a, ref.render_frame(0).to_u8()) <= 1


def test_cached_full_canvas_serves_a_region(monkeypatch):
    """A full canvas in the keyframe cache serves any later region: no
    frame renders again."""
    from jxl_oxide_tpu_torch.render import context

    data = STREAMS["444"]()
    img = JxlImage.from_bytes(data, device="cpu")
    full = img.render_frame(0).to_u8()
    calls = []
    real = context.render_frame
    monkeypatch.setattr(context, "render_frame",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    left, top, w, h = REGIONS["rect"]
    got = img.render_frame_cropped(0, REGIONS["rect"]).to_u8()
    np.testing.assert_array_equal(got, full[top:top + h, left:left + w])
    assert calls == [] and list(img._keyframe_cache) == [0]


def test_loading_render_with_a_region():
    """A stream fed in pieces with a region set: each loading render is
    cut to the region, within 1 LSB of the JAX package's (the frame
    renders whole, as there), and the last equals render_frame's."""
    from jxl_oxide_tpu import JxlImage as JaxImage

    data = STREAMS["444"]()
    frame = JxlImage.from_bytes(data, device="cpu")._frames[0]
    toc = frame.toc
    cuts = [frame.start_byte + e.offset + e.size for e in (
        toc.entry_for("lf_group", 0), toc.entry_for("group_pass", 4, 0))]
    cuts.append(len(data))
    ours, ref = JxlImage(device="cpu"), JaxImage()
    for img in (ours, ref):
        img.set_image_region(*REGIONS["inner"])
    prev = 0
    for cut in cuts:
        ours.feed_bytes(data[prev:cut])
        ref.feed_bytes(data[prev:cut])
        prev = cut
        a = ours.render_loading_frame().to_u8()
        b = ref.render_loading_frame().to_u8()
        assert a.shape == (150, 200, 3)
        assert tp.max_lsb(a, b) <= 1
    np.testing.assert_array_equal(a, ours.render_frame(0).to_u8())


@pytest.mark.parametrize("name", ["444", "420", "422"])
@pytest.mark.parametrize("region", ["rect", "edge"])
def test_rect_program_inputs_bit_identical(name, region):
    """Both packages pick the same device rect and hand its fused
    program (4:4:4 or subsampled) the same key and inputs."""
    from jxl_oxide_tpu.render import roi as jroi

    data = STREAMS[name]()
    js, jh = tp.jax_host(data)
    ts, th = tp.torch_host(data)
    reg = _region(JxlImage.from_bytes(data, device="cpu"), region)
    rect = troi.device_rect(ts.frame, ts, reg)
    assert rect is not None and rect == jroi.device_rect(js.frame, js, reg)
    if ts.subsampled:
        (jkey, _, jin) = js.fused_subsampled_program_parts(jh, rect=rect)
        (tkey, _, tin) = ts.fused_subsampled_program_parts(th, rect=rect)
    else:
        (jkey, _, jin), (tkey, _, tin) = (js.fused_program_parts(jh, rect),
                                          ts.fused_program_parts(th, rect))
    assert jkey == tkey
    for j, t in zip(jin, tin):
        for a, b in zip(j if isinstance(j, tuple) else (j,),
                        t if isinstance(t, tuple) else (t,)):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(np.asarray(a), np.asarray(b))


def test_device_rect_covers_the_padded_region():
    """The rect is group-aligned and holds the region with DEVICE_RECT_PAD
    around it inside the plane; a region that covers most of the plane
    takes the whole-plane program."""
    data = STREAMS["444"]()
    ts, _ = tp.torch_host(data)
    gd = ts.frame.header.group_dim
    for left, top, w, h in (REGIONS["rect"], (530, 480, 70, 40)):
        x0, y0, x1, y1 = troi.device_rect(ts.frame, ts, (left, top, w, h))
        assert x0 % gd == 0 and y0 % gd == 0
        pad = troi.DEVICE_RECT_PAD
        assert x0 <= max(0, left - pad) and y0 <= max(0, top - pad)
        assert x1 >= min(ts.width_rounded, left + w + pad)
        assert y1 >= min(ts.height_rounded, top + h + pad)
    assert troi.device_rect(ts.frame, ts, (0, 0, 600, 520)) is None


@pytest.mark.parametrize("name", tp.ROI_FIXTURES)
def test_roi_fixture_matches_reference(name):
    """Each committed fixture's regions (<name>_roi.npz): render_frame_
    cropped, and set_image_region + render_frame, within 1 LSB of the JAX
    package's region render and equal to the crop of the port's full
    render; flagship_1024's loading render with a region set too."""
    data, _ = tp.fixture(name)
    ref = np.load(f"{tp.TESTDATA}/{name}_roi.npz")
    full = JxlImage.from_bytes(data, device="cpu").render_frame(0).to_u8()
    for r, region in enumerate(ref["regions"].tolist()):
        left, top, w, h = region
        img = JxlImage.from_bytes(data, device="cpu")
        got = img.render_frame_cropped(0, region).to_u8()
        assert tp.max_lsb(got, ref[f"u8_{r}"]) <= 1
        np.testing.assert_array_equal(got, full[top:top + h,
                                                left:left + w])
        img.set_image_region(*region)
        np.testing.assert_array_equal(img.render_frame(0).to_u8(), got)
    if "loading_u8" in ref:
        img = JxlImage(device="cpu")
        img.set_image_region(*ref["regions"][0].tolist())
        img.feed_bytes(data[:int(ref["loading_cut"])])
        assert tp.max_lsb(img.render_loading_frame().to_u8(),
                          ref["loading_u8"]) <= 1
