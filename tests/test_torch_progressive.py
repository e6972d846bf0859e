"""Progressive and partial decode in the port (api.py
render_loading_frame, render/render.py partial_host_stage, the
ProgressiveCache of render/vardct.py, render/context.py
composite_partial) against the JAX package, on the CPU.

Each stream is fed in pieces to jxl_oxide_tpu.JxlImage() and to
jxl_oxide_tpu_torch.JxlImage(device="cpu"); after each piece both render
the loading frame or both raise the same error, the u8 renders agree
(within 1 LSB where a filter runs, exactly where none does), and the
sections decoded agree and never decrease. The last loading render equals
the port's one-shot render_frame bit for bit. The 1024^2 fixtures are
held against the JAX package's loading renders committed beside them
(tools/make_torch_port_fixtures.py `write_progressive`).
"""

import numpy as np
import pytest

import torch_parity as tp
from encoder import encode_jxl_modular
from encoder_vardct import encode_jxl_vardct
from jxl_oxide_tpu import JxlImage as JaxImage
from jxl_oxide_tpu_torch import JxlImage
from jxl_oxide_tpu_torch.ops.cuda import squeeze as sq_wrapper
from jxl_oxide_tpu_torch.render import context as torch_context
from jxl_oxide_tpu_torch.render import render as torch_render
from jxl_oxide_tpu_torch.render import vardct as tvmod
from jxl_oxide_tpu_torch.utils import options as opts
from jxl_oxide_tpu_torch.utils.errors import JxlEofError

PASSES3 = dict(gabor=True, epf_iters=2, num_passes=3, pass_shifts=[2, 1],
               pass_downsample=[(4, 0), (2, 1)])


def textured(h: int, w: int, seed: int, **kw) -> bytes:
    """A VarDCT stream of smooth colour under seeded noise: every group
    carries HF coefficients, in every pass."""
    rng = np.random.default_rng(seed)
    rgb = 0.8 * tp.smooth_rgb(h, w, seed) + 0.2 * rng.random((h, w, 3))
    return encode_jxl_vardct(rgb.astype(np.float32), **kw)


def sections(img) -> int:
    """The sections decoded by every frame's ProgressiveCache."""
    return sum(f._progressive_cache.sections_decoded() for f in img._frames
               if getattr(f, "_progressive_cache", None) is not None)


def loading_render(img):
    """(u8, None) of img.render_loading_frame(), or (None, the error's
    class name)."""
    try:
        return img.render_loading_frame().to_u8(), None
    except Exception as e:  # both packages' errors, compared by name
        return None, type(e).__name__


def even_cuts(data: bytes, pieces: int) -> list[int]:
    step = -(-len(data) // pieces)
    return [min(len(data), step * (k + 1)) for k in range(pieces)]


def feed_both(data: bytes, cuts, exact: bool):
    """Feed `data` up to each of `cuts` to both packages and hold the
    loading renders and the section counts together. Returns the port's
    JxlImage, its last render, and how many cuts rendered."""
    ref, ours = JaxImage(), JxlImage(device="cpu")
    prev, last, rendered, u8 = 0, 0, 0, None
    for cut in cuts:
        for img in (ref, ours):
            img.feed_bytes(data[prev:cut])
        prev = cut
        want, want_err = loading_render(ref)
        u8, err = loading_render(ours)
        assert err == want_err, (cut, err, want_err)
        if want is not None:
            rendered += 1
            if exact:
                np.testing.assert_array_equal(u8, want, err_msg=str(cut))
            else:
                assert tp.max_lsb(u8, want) <= 1, cut
        count = sections(ours)
        assert count == sections(ref), cut
        assert count >= last, cut
        last = count
    return ours, u8, rendered


def toc_end(frame, kind, *index) -> int:
    """Byte offset in the stream of the end of one TOC section."""
    e = frame.toc.entry_for(kind, *index)
    return frame.start_byte + e.offset + e.size


def assert_final_is_one_shot(data: bytes, u8, keyframe: int = 0) -> None:
    one = JxlImage.from_bytes(data, device="cpu").render_frame(keyframe)
    np.testing.assert_array_equal(u8, one.to_u8())


def test_vardct_gabor_epf2_in_pieces():
    data = textured(512, 512, 40, gabor=True, epf_iters=2)
    ours, u8, rendered = feed_both(data, even_cuts(data, 7), exact=False)
    assert rendered >= 4
    assert ours._frames[0].header.num_groups == 4
    assert_final_is_one_shot(data, u8)


def test_three_passes_in_pieces():
    """The 3-pass recipe of the passes3_1024 fixture at 512^2: each group's
    passes add up in pass order across calls."""
    data = textured(512, 512, 41, **PASSES3)
    ours, u8, rendered = feed_both(data, even_cuts(data, 9), exact=False)
    assert rendered >= 6
    # 1 LF group and 4 groups x 3 passes, each decoded once
    assert sections(ours) == 13
    assert_final_is_one_shot(data, u8)


def test_cut_before_hf_global_renders_pure_lf():
    """Up to the end of the last LF group: no HfGlobal, so no group
    decodes and the render is the LF alone (zero dequant maps)."""
    data = textured(512, 512, 42, **PASSES3)
    frame = JxlImage.from_bytes(data, device="cpu")._frames[0]
    cut = toc_end(frame, "lf_group", frame.header.num_lf_groups - 1)
    ours, u8, rendered = feed_both(data, [cut, len(data)], exact=False)
    assert rendered == 2
    cache = ours._frames[0]._progressive_cache
    assert cache.released and cache.sections_decoded() == 13
    # at the cut alone: LF only
    img = JxlImage(device="cpu")
    img.feed_bytes(data[:cut])
    pure_lf = img.render_loading_frame().to_u8()
    cache = img._frames[0]._progressive_cache
    assert cache.hf_global is None and cache.sections_decoded() == 1
    assert tp.max_lsb(pure_lf, u8) > 1  # the HF is missing
    assert_final_is_one_shot(data, u8)


def test_ycbcr420_in_pieces():
    """A 4:2:0 multi-group stream (the fused subsampled program)."""
    data = tp.ycbcr_stream(512, 512, tp.CHROMA["420"], seed=43,
                           gabor=True, epf_iters=1)
    ours, u8, rendered = feed_both(data, even_cuts(data, 6), exact=False)
    assert rendered >= 3
    assert ours._frames[0].header.num_groups > 1
    assert_final_is_one_shot(data, u8)


@pytest.fixture
def device_tail(monkeypatch):
    """The Modular device tail on the CPU (its plain versions), as the
    decode's gate picks it on CUDA; the squeeze wrapper calls counted."""
    monkeypatch.setattr(opts, "device_modular_may_engage", lambda: True)
    calls = []
    real = sq_wrapper.inv_squeeze_cuda

    def see(avg, res, horizontal):
        calls.append(tuple(avg.shape))
        return real(avg, res, horizontal)

    monkeypatch.setattr(sq_wrapper, "inv_squeeze_cuda", see)
    return calls


def test_modular_1024_snapshot_takes_the_device_tail(device_tail):
    """modular_1024 (16 groups, squeeze + RCT, 2 EPF passes) at its
    committed cuts: each loading render finishes a snapshot through the
    device tail (K9's plain version here), within 1 LSB of the JAX
    package's loading render, with the same sections; the last equals the
    one-shot decode."""
    data, _ = tp.fixture("modular_1024")
    ref = np.load(f"{tp.TESTDATA}/modular_1024_progressive.npz")
    img = JxlImage(device="cpu")
    prev = 0
    for k, cut in enumerate(ref["cuts"]):
        img.feed_bytes(data[prev:cut])
        prev = cut
        before = len(device_tail)
        u8 = img.render_loading_frame().to_u8()
        assert len(device_tail) - before >= 1, k
        assert tp.max_lsb(u8, ref["u8"][k]) <= 1, k
        assert sections(img) == ref["sections"][k]
    assert_final_is_one_shot(data, u8)


def test_modular_squeeze_in_pieces_live(device_tail, monkeypatch):
    """A multi-group squeezed Modular stream, the device tail's gate
    lowered so that it finishes each snapshot, against a live JAX decode
    (lossless, unfiltered: exactly)."""
    monkeypatch.setattr(opts, "DEVICE_TAIL_MIN_SAMPLES", 1 << 14)
    chans = tp.smooth_rgb(300, 520, 44)
    planes = [np.round(chans[..., c] * 255).astype(np.int64)
              for c in range(3)]
    data = encode_jxl_modular(planes, bit_depth=8, squeeze=True, rct=True)
    ours, u8, rendered = feed_both(data, even_cuts(data, 6), exact=True)
    assert rendered >= 4 and device_tail
    np.testing.assert_array_equal(
        u8, np.stack([p.astype(np.uint8) for p in planes], -1))
    assert_final_is_one_shot(data, u8)


def test_cropped_frame_at_an_offset_in_pieces():
    """A frame of several groups cropped onto a larger canvas at (7, 11):
    the partial frame composites at its offset (the counterpart of
    tests/test_api.py::test_progressive_render_cropped_frame_offsets)."""
    rng = np.random.default_rng(45)
    chans = [rng.integers(0, 256, (280, 300), dtype=np.int64)
             for _ in range(3)]
    data = encode_jxl_modular(chans, bit_depth=8, image_size=(300, 320),
                              crop=(7, 11, 300, 280))
    ours, u8, rendered = feed_both(data, even_cuts(data, 5), exact=True)
    assert rendered >= 3
    want = np.zeros((300, 320, 3), dtype=np.uint8)
    want[11:291, 7:307] = np.stack([c.astype(np.uint8) for c in chans], -1)
    np.testing.assert_array_equal(u8, want)
    assert_final_is_one_shot(data, u8)


def test_animation_cut_inside_its_last_frame():
    """anim_blend_epf_512: cut inside its last frame, the two complete
    frames composite (slot 1 saved), then the partial one blends over
    the slot; the whole stream's render is keyframe 2."""
    data, _ = tp.fixture("anim_blend_epf_512")
    last = JxlImage.from_bytes(data, device="cpu")._frames[-1]
    start = last.start_byte + last.data_start
    cuts = [start + (len(data) - start) // 2, len(data)]
    ours, u8, rendered = feed_both(data, cuts, exact=False)
    assert rendered == 2
    assert_final_is_one_shot(data, u8, keyframe=2)


def test_completed_keyframes_are_reused_by_render_frame(monkeypatch):
    """Keyframes composited by render_loading_frame land in the keyframe
    cache: render_frame then renders nothing (tests/test_api.py::
    test_progressive_render_reused_by_render_frame)."""
    data, _ = tp.fixture("anim_blend_epf_512")
    img = JxlImage(device="cpu")
    img.feed_bytes(data)
    last = img.render_loading_frame().to_u8()
    assert sorted(img._keyframe_cache) == [0, 1, 2]

    def boom(*args, **kwargs):
        raise AssertionError("render_frame rendered a cached keyframe")

    monkeypatch.setattr(torch_context.RenderContext, "add_frame", boom)
    monkeypatch.setattr(torch_render, "render_frame", boom)
    np.testing.assert_array_equal(img.render_frame(2).to_u8(), last)
    for k in range(2):
        assert img.render_frame(k).to_u8().shape == last.shape


def test_cached_planes_never_return_to_the_pool_mid_feed():
    """A loading frame's coefficient planes stay with its cache until the
    frame is complete: a one-shot decode of another stream of the same
    geometry in between (whose planes go back to the plane pool) must not
    be handed them, and later sections still land in them."""
    a = textured(512, 512, 46, **PASSES3)
    b = textured(512, 512, 47, **PASSES3)
    img = JxlImage(device="cpu")
    cut = len(a) // 2
    img.feed_bytes(a[:cut])
    img.render_loading_frame()
    state = img._frames[0]._progressive_cache.vardct_state
    mine = {id(p) for p in state.coeff_planes}
    for _ in range(2):
        other = JxlImage.from_bytes(b, device="cpu")
        other.render_frame(0)
        other_state = torch_render.host_stage(other._frames[0]).state
        assert not mine & {id(p) for p in other_state.coeff_planes}
        other_state.trim_coeff_planes()
    assert state.coeff_planes is not None
    img.feed_bytes(a[cut:])
    assert_final_is_one_shot(a, img.render_loading_frame().to_u8())


def test_a_cached_state_that_turns_staged_still_filters(monkeypatch):
    """A cached state renders on the fused path (which filters inside its
    program), then, with the plan cap lowered, on the staged path: the
    render tail must filter it, as on a fresh image."""
    data = textured(512, 512, 48, gabor=True, epf_iters=2)
    frame = JxlImage.from_bytes(data, device="cpu")._frames[0]
    cuts = [toc_end(frame, "lf_group", 0), toc_end(frame, "group_pass", 1, 0)]
    staged = []
    real = tvmod.VardctFrameState._run_staged

    def see(self, *args):
        staged.append(self.filters_applied)
        return real(self, *args)

    monkeypatch.setattr(tvmod.VardctFrameState, "_run_staged", see)
    img = JxlImage(device="cpu")
    img.feed_bytes(data[:cuts[0]])
    img.render_loading_frame()
    assert not staged
    img.feed_bytes(data[cuts[0]:cuts[1]])
    monkeypatch.setattr(tvmod, "DENSE_PLAN_MAX_ENTRIES", 0)
    got = img.render_loading_frame().to_u8()
    assert staged == [False]
    fresh = JxlImage(device="cpu")
    fresh.feed_bytes(data[:cuts[1]])
    np.testing.assert_array_equal(got, fresh.render_loading_frame().to_u8())


def test_single_section_frame_renders_once_complete():
    """A frame of one TOC section has no partial form: both packages raise
    JxlEofError until it is complete (the one-shot host stage)."""
    data = tp.vardct_stream(64, 72, 49, gabor=True, epf_iters=1)
    ours, u8, rendered = feed_both(data, even_cuts(data, 4), exact=False)
    assert rendered >= 1 and ours._frames[0].toc.is_single_entry
    assert_final_is_one_shot(data, u8)


def test_nothing_to_render_raises_eof():
    data = tp.vardct_stream(64, 64, 50)
    img = JxlImage(device="cpu")
    with pytest.raises(JxlEofError):
        img.render_loading_frame()
    img.feed_bytes(data[:12])
    with pytest.raises(JxlEofError):
        img.render_loading_frame()


def test_lf_frame_stream_in_pieces():
    """An LF frame, then a filtered frame on it: the LF frame composites
    into its slot when complete, and the loading main frame renders on
    that slot. Its HF is all zero (8x8 blocks of one colour), so half of
    its groups render the whole image. The JAX package renders the loading
    frame with no LF, and its cached state then renders the complete frame
    so too, 255 LSB off: the port departs from it there (ROADMAP Queue 3),
    and this pins the reference's behaviour on the same input."""
    data = tp.vardct_stream(512, 512, 51, use_lf_frame=True, gabor=True,
                            epf_iters=2)
    main = JxlImage.from_bytes(data, device="cpu")._frames[-1]
    cut = toc_end(main, "group_pass", 1, 0)
    one = JxlImage.from_bytes(data, device="cpu").render_frame(0).to_u8()
    assert tp.max_lsb(tp.jax_u8(data), one) <= 1
    img, ref = JxlImage(device="cpu"), JaxImage()
    # its LF group and two of four groups, then all four
    for piece, count in ((data[:cut], 1 + 2), (data[cut:], 1 + 4)):
        img.feed_bytes(piece)
        ref.feed_bytes(piece)
        u8 = img.render_loading_frame().to_u8()
        assert tp.max_lsb(u8, one) <= 1
        assert tp.max_lsb(ref.render_loading_frame().to_u8(), one) == 255
        assert sections(img) == sections(ref) == count
    assert_final_is_one_shot(data, u8)


def _squeezed_modular() -> bytes:
    planes = [np.random.default_rng(52).integers(0, 256, (300, 520))
              for _ in range(4)]
    return encode_jxl_modular(planes, bit_depth=8, extra_alpha=True,
                              squeeze=True)


def _vardct_alpha() -> bytes:
    alpha = np.random.default_rng(53).integers(0, 256, (300, 260))
    return tp.tiled_stream(300, 260, 54, types=[0], alpha=alpha,
                           gabor=True, epf_iters=1)


@pytest.mark.parametrize("make", [_squeezed_modular, _vardct_alpha],
                         ids=["modular_squeeze", "vardct_alpha"])
def test_render_frame_between_loading_renders(make):
    """A loading render, the rest of the stream, render_frame(0), then a
    loading render again: render_frame resumes the frame's cache (as the
    JAX package's add_frame does), so the one-shot path and the loading
    path never decode into each other's LfGlobal. Held against the JAX
    package at each step; the renders of the whole stream equal a fresh
    one-shot decode bit for bit, alpha included."""
    data = make()
    cut = len(data) // 2
    got = {}
    for name, img in (("jax", JaxImage()), ("ours", JxlImage(device="cpu"))):
        img.feed_bytes(data[:cut])
        loading = img.render_loading_frame().to_u8()
        img.feed_bytes(data[cut:])
        whole = img.render_frame(0).to_u8()
        got[name] = (loading, whole, img.render_loading_frame().to_u8())
    exact = make is _squeezed_modular
    for want, u8 in zip(got["jax"], got["ours"]):
        assert u8.shape[-1] == 4
        if exact:
            np.testing.assert_array_equal(u8, want)
        else:
            assert tp.max_lsb(u8, want) <= 1
    for u8 in got["ours"][1:]:
        assert_final_is_one_shot(data, u8)
