"""LF (DC) frames in the port (render/context.py LF slots, the LF override
of render/vardct.py's fused and staged paths, api.py's dependency cone)
against jxl_oxide_tpu, on the CPU.

An LF frame renders at 8^lf_level downsampling and goes to LF slot
lf_level - 1; the frame that sets use_lf_frame takes those planes as
its pre-dequantized LF (identity scale, no LF CfL, no smoothing,
edge-padded; vardct/mod.rs:176-205). The streams are
tests/test_oracle.py:299-303's four at 96^2.

Tolerances: u8 within 1 LSB and float32 within 2e-5 of the JAX package
(tests/torch_parity.py assert_keyframes_match); the port's fused and
staged paths on one frame within 2e-5 (tests/test_torch_staged.py).
"""

import numpy as np
import pytest
import torch

import torch_parity as tp
from jxl_oxide_tpu_torch import JxlImage
from jxl_oxide_tpu_torch.headers.frame import FrameType
from jxl_oxide_tpu_torch.render import context as torch_context
from jxl_oxide_tpu_torch.render import vardct as tvmod

LF_KWARGS = [
    dict(use_lf_frame=True),
    dict(use_lf_frame=True, lf_levels=2),
    dict(use_lf_frame=True, gabor=True, epf_iters=2),
    dict(use_lf_frame=True, xyb=True),
]
IDS = ["lf", "chain_2", "gabor_epf2", "xyb"]


def lf_stream(kw, h=96, w=96, seed=30) -> bytes:
    return tp.vardct_stream(h, w, seed, **kw)


@pytest.mark.parametrize("kw", LF_KWARGS, ids=IDS)
def test_fused_path_matches_jax(kw):
    data = lf_stream(kw)
    img = tp.assert_keyframes_match(data, exact=False)
    kinds = [f.header.frame_type for f in img._frames]
    levels = kw.get("lf_levels", 1)
    assert kinds == [FrameType.LF_FRAME] * levels + [FrameType.REGULAR]
    assert img._frames[-1].header.flags.use_lf_frame


@pytest.mark.parametrize("kw", LF_KWARGS, ids=IDS)
def test_staged_path_matches_jax(kw, monkeypatch):
    """Both packages forced onto their staged paths (the dense plan cap
    at 0, as the JAX package's own tests force it)."""
    from jxl_oxide_tpu.render import vardct as jvmod

    monkeypatch.setattr(jvmod, "DENSE_PLAN_MAX_ENTRIES", 0)
    monkeypatch.setattr(tvmod, "DENSE_PLAN_MAX_ENTRIES", 0)
    staged = []
    real = tvmod.VardctFrameState._run_staged

    def see(self, *args):
        staged.append(self.lf_override is not None)
        return real(self, *args)

    monkeypatch.setattr(tvmod.VardctFrameState, "_run_staged", see)
    tp.assert_keyframes_match(lf_stream(kw, seed=31), exact=False)
    # the LF frames and the main frame all staged; the main frame (and a
    # chain's level-1 LF frame) with the override
    assert len(staged) == kw.get("lf_levels", 1) + 1
    assert staged[-1] and sum(staged) == kw.get("lf_levels", 1)


def _main_state(data):
    """The port's host stage of the main frame, its LF slot filled by
    rendering the stream's LF frames through a RenderContext."""
    from jxl_oxide_tpu_torch.render.render import host_stage

    img = JxlImage.from_bytes(data, device="cpu")
    ctx = torch_context.RenderContext(img.image_header, "cpu")
    for frame in img._frames[:-1]:
        ctx.add_frame(frame)
    main = img._frames[-1]
    main._lf_frame_planes = ctx.lf_frames[main.header.lf_level]
    host = host_stage(main)
    assert host.state.lf_override is not None
    return host


@pytest.mark.parametrize("kw", LF_KWARGS, ids=IDS)
def test_staged_called_directly_equals_fused(kw):
    """`_run_staged` on the main frame's host stage, called directly, then
    the render tail, against the fused program on the same host stage:
    the same LF override reaches both."""
    from jxl_oxide_tpu_torch.render.render import render_vardct_tail

    host = _main_state(lf_stream(kw, seed=32))
    state = host.state
    fused = state._run_fused(host.hf_global, "cpu")
    assert state.filters_applied
    state.filters_applied = False
    staged = state._run_staged(host.hf_global, "cpu")
    h, w = fused[0].shape
    tail = render_vardct_tail(state, [p[:h, :w] for p in staged])
    for f, t in zip(fused, tail):
        np.testing.assert_allclose(f.numpy(), t.numpy(), atol=2e-5, rtol=0)


def test_override_is_edge_padded_on_the_device():
    """An LF frame smaller than the frame's LF grid: the override repeats
    its last row, then its last column, as the JAX package pads it."""
    host = _main_state(lf_stream(LF_KWARGS[0], h=72, w=88, seed=33))
    state = host.state
    lh, lw = state.lf_shapes[0]
    src = [torch.arange(float((lh - 2) * (lw - 3))).reshape(lh - 2, lw - 3)
           + c for c in range(3)]
    state.lf_override = src
    out = state.padded_lf_override()
    for c in range(3):
        want = np.zeros((lh, lw), np.float32)
        s = src[c].numpy()
        want[:lh - 2, :lw - 3] = s
        want[lh - 2:, :lw - 3] = s[-1:]
        want[:, lw - 3:] = want[:, lw - 4:lw - 3]
        np.testing.assert_array_equal(out[c].numpy(), want)
    # a larger LF frame is cut to the grid
    state.lf_override = [torch.ones(lh + 5, lw + 1) for _ in range(3)]
    assert all(tuple(p.shape) == (lh, lw)
               for p in state.padded_lf_override())


def test_cone_holds_the_lf_chain_and_releases_its_slots(monkeypatch):
    """The main frame's cone holds both LF frames of a chain; the LF
    frames render inline (never on the cone's threads, which would need
    the slot first) and each LF slot is released after its last reader."""
    from jxl_oxide_tpu_torch import api

    data = lf_stream(LF_KWARGS[1], seed=34)
    img = JxlImage.from_bytes(data, device="cpu")
    cone, seeds = img._dependency_cone(2)
    assert cone == [0, 1, 2] and not seeds
    prerendered = []
    real = api.JxlImage._render_cone_frames

    def see(self, cone):
        out = real(self, cone)
        prerendered.extend(out)
        return out

    monkeypatch.setattr(api.JxlImage, "_render_cone_frames", see)
    released = []
    real_release = torch_context.RenderContext.release_lf_frame

    def release(self, level):
        released.append(level)
        return real_release(self, level)

    monkeypatch.setattr(torch_context.RenderContext, "release_lf_frame",
                        release)
    img.render_frame(0)
    # frame 0 (the level-2 LF frame) is the only one that reads no slot
    assert prerendered == []
    assert sorted(released) == [0, 1]


def test_lf_frame_1024_fixture():
    """The committed lf_frame_1024 (an LF frame, then the main frame on
    its LF, gaborish + 2 EPF passes: the fused 4:4:4 program with the LF
    override) and lf_chain_xyb_512 (a two-level XYB chain): their
    references are the JAX decodes, and the port is within 1 LSB."""
    for name, frames in (("lf_frame_1024", 2), ("lf_chain_xyb_512", 3)):
        data, ref = tp.fixture(name)
        img = JxlImage.from_bytes(data, device="cpu")
        assert img.num_frames == frames and img.num_keyframes == 1
        assert tp.max_lsb(img.render_frame(0).to_u8(), ref) <= 1
    rf = JxlImage.from_bytes(tp.fixture("lf_frame_1024")[0],
                             device="cpu")._frames[1].header\
        .restoration_filter
    assert rf.gab.enabled and rf.epf.iters == 2


def test_progressive_and_partial_decode_still_raise():
    """Progressive and partial decode (ROADMAP Queue 1 item 9b) are ported
    since the eighth slice (tests/test_torch_progressive.py): on an LF
    stream render_loading_frame composites the LF frame into its slot
    and renders the main frame on it, as render_frame does, and
    Render.stream writes its samples. ROI (item 14) is ported since the
    ninth slice: a frame that sets use_lf_frame decodes whole, then is
    cut."""
    img = JxlImage.from_bytes(lf_stream(LF_KWARGS[0], seed=35),
                              device="cpu")
    loading = img.render_loading_frame().to_u8()
    np.testing.assert_array_equal(loading, img.render_frame(0).to_u8())
    buf = np.zeros(loading.size, np.uint8)
    assert img.render_frame(0).stream().write_to_buffer(buf) == buf.size
    np.testing.assert_array_equal(buf, loading.reshape(-1))
    np.testing.assert_array_equal(
        img.render_frame_cropped(0, (5, 3, 8, 9)).to_u8(),
        loading[3:12, 5:13])
