"""The port's serving API (jxl_oxide_tpu_torch/serving.py) on the CPU:
decode_batch, decode_iter and decode_batch_stacked against the JAX
package's (tests/test_api.py:1547-1700), and the stacked path against the
port's own per-image decode.

Tolerances: against JAX, u8 within 1 LSB and f32 within 2e-5 (the
per-image tolerances of tests/test_torch_decode.py), alpha bit for bit;
stacked against the port's per-image decode, bit for bit (the same ops on
a stack of one). The stacked program's dispatched aten op count does not
grow with the stack (a TorchDispatchMode counter): no stage loops over
the images.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import torch_parity as tp
from encoder import encode_jxl_modular
from jxl_oxide_tpu_torch import (
    JxlImage,
    decode_batch,
    decode_batch_stacked,
    decode_iter,
)
from jxl_oxide_tpu_torch import serving
from jxl_oxide_tpu_torch.ops.vardct_pipeline import stack_inputs, upload_inputs


def _alpha(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w)).astype(
        np.int64)


def _mixed_streams():
    """Four same-geometry 4:4:4 streams, two with alpha, two 4:2:0
    streams, a Modular stream (per-image path) and an orientation-6
    stream (per-image path)."""
    rng = np.random.default_rng(7)
    streams = [tp.vardct_stream(64, 64, i, epf_iters=1,
                                alpha=_alpha(64, 64, i) if i % 2 else None)
               for i in range(4)]
    streams += [tp.ycbcr_stream(64, 64, tp.CHROMA["420"], seed=s,
                                gabor=True, epf_iters=2) for s in (1, 2)]
    streams.append(encode_jxl_modular(
        [rng.integers(0, 255, (48, 48)) for _ in range(3)]))
    streams.append(tp.vardct_stream(40, 72, 9, orientation=6))
    return streams


@pytest.fixture(scope="module")
def streams():
    return _mixed_streams()


def _jax_serving():
    from jxl_oxide_tpu import serving as js

    return js


def _close(got, ref, output):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        b = np.asarray(b)
        assert a.shape == b.shape
        if a.shape[-1] == 4:
            np.testing.assert_array_equal(a[..., 3], b[..., 3])
        if output == "u8":
            assert tp.max_lsb(a, b) <= 1
        else:
            np.testing.assert_allclose(a, b, atol=2e-5, rtol=0)


@pytest.mark.parametrize("output", ["u8", "f32"])
def test_decode_batch_matches_jax(streams, output):
    got = decode_batch(streams, output=output, num_workers=2, device="cpu")
    _close(got, _jax_serving().decode_batch(streams, output=output,
                                            num_workers=2), output)


def test_decode_iter_matches_jax(streams):
    got = list(decode_iter(iter(streams), output="u8", num_workers=2,
                           window=1, device="cpu"))
    ref = list(_jax_serving().decode_iter(iter(streams), output="u8",
                                          num_workers=2, window=1))
    _close(got, ref, "u8")


@pytest.mark.parametrize("output", ["u8", "f32"])
def test_decode_batch_stacked_matches_jax(streams, output):
    got = decode_batch_stacked(streams, output=output, num_workers=2,
                               device="cpu")
    _close(got, _jax_serving().decode_batch_stacked(
        streams, output=output, num_workers=2), output)


@pytest.mark.parametrize("output", ["u8", "f32", "device"])
def test_stacked_equals_per_image(streams, output):
    """Bit for bit the port's per-image decode (decode_batch), in input
    order, shapes included; "device" gives tensors on the decode
    device."""
    got = decode_batch_stacked(streams, output=output, num_workers=2,
                               device="cpu")
    ref = decode_batch(streams, output=output, num_workers=2, device="cpu")
    for a, b in zip(got, ref):
        if output == "device":
            assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
            assert torch.equal(a, b)
        else:
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_render_output_and_empty_input(streams):
    got = decode_batch_stacked(streams[:2], output="render", device="cpu")
    assert [r.to_u8().shape for r in got] == [(64, 64, 3), (64, 64, 4)]
    assert decode_batch([], device="cpu") == []
    with pytest.raises(ValueError):
        decode_batch(streams, output="png", device="cpu")


def test_stacked_fast_envelope_engages():
    """_host_stage_fast accepts an in-envelope stream (an output-equality
    test cannot tell the stacked path from the per-image one), with and
    without alpha; out-of-envelope streams return None or raise."""
    for alpha in (None, _alpha(128, 128, 3)):
        data = tp.vardct_stream(128, 128, 7, epf_iters=1, alpha=alpha)
        out = serving._host_stage_fast(JxlImage.from_bytes(data,
                                                           device="cpu"), 0)
        assert out is not None
        state, hf_global, _, got_alpha = out
        assert (got_alpha is None) == (alpha is None)
        assert state.fused_program_parts(hf_global) is not None
    orient = tp.vardct_stream(40, 72, 9, orientation=6)
    assert serving._host_stage_fast(
        JxlImage.from_bytes(orient, device="cpu"), 0) is None
    modular = encode_jxl_modular([np.zeros((8, 8), np.int64)] * 3)
    assert serving._host_stage_fast(
        JxlImage.from_bytes(modular, device="cpu"), 0) is None


def _groups(monkeypatch, streams, **kw):
    """Run decode_batch_stacked; returns the stacks it decoded, each as
    the input indices of its images, and the per-image indices."""
    stacks, per_image = [], []
    decode_stack = serving._decode_stack
    per_image_decode = serving.decode_batch

    def recording(chunk, key, output):
        stacks.append([streams.index(id_map[id(c[0])]) for c in chunk])
        return decode_stack(chunk, key, output)

    id_map = {}
    from_bytes = JxlImage.from_bytes

    def remembering(data, **kwargs):
        img = from_bytes(data, **kwargs)
        id_map[id(img)] = data
        return img

    def slow(ss, **kwargs):
        per_image.extend(streams.index(s) for s in ss)
        return per_image_decode(ss, **kwargs)

    monkeypatch.setattr(serving, "_decode_stack", recording)
    monkeypatch.setattr(serving, "decode_batch", slow)
    monkeypatch.setattr(JxlImage, "from_bytes", staticmethod(remembering))
    got = decode_batch_stacked(streams, num_workers=2, device="cpu", **kw)
    ref = per_image_decode(streams, num_workers=2, device="cpu")
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    return sorted(stacks), sorted(per_image)


def test_groups_split_alpha_subsampling_and_envelope(monkeypatch, streams):
    """Alpha and non-alpha streams of one program key form separate
    stacks, the 4:2:0 pair a third; Modular and orientation 6 go per
    image."""
    stacks, per_image = _groups(monkeypatch, streams)
    assert stacks == [[0, 2], [1, 3], [4, 5]]
    assert per_image == [6, 7]


def test_max_stack_chunks(monkeypatch):
    streams = [tp.vardct_stream(64, 64, i, epf_iters=1) for i in range(5)]
    stacks, per_image = _groups(monkeypatch, streams, max_stack=2)
    assert stacks == [[0, 1], [2, 3], [4]] and per_image == []


def test_mixed_colour_metadata_do_not_share_a_stack(monkeypatch):
    """XYB and plain sRGB streams of one program key take separate colour
    tails (tests/test_api.py test_decode_batch_stacked_mixed_color_metadata)."""
    streams = [tp.vardct_stream(64, 64, 20 + i, xyb=bool(i % 2))
               for i in range(4)]
    stacks, _ = _groups(monkeypatch, streams)
    assert stacks == [[0, 2], [1, 3]]
    _close(decode_batch_stacked(streams, num_workers=2, device="cpu"),
           _jax_serving().decode_batch_stacked(streams, num_workers=2), "u8")


def _sparse_stream(big: int) -> bytes:
    """A 64x264 all-DCT8 stream (two groups) with a sparse lattice of
    small coefficients and one coefficient of magnitude `big`."""
    from encoder_vardct import encode_jxl_vardct_tiled

    h, w = 64, 264
    bh, bw = h // 8, w // 8
    coeff = np.zeros((3, h, w), np.int64)
    coeff[:, 1::8, 2::8] = 5
    coeff[0, 1, 2] = big
    lf = np.random.default_rng(1).integers(-20, 21, (3, bh, bw))
    return encode_jxl_vardct_tiled(h, w, np.zeros((bh, bw), np.int64),
                                   np.ones((bh, bw), np.int64), coeff, lf)


def test_mixed_input_dtypes_do_not_share_a_stack(monkeypatch):
    """Two streams of one program key whose sparse values upload as i8
    and as i16 (a coefficient of 200): np.stack would promote the pair,
    so they form separate stacks."""
    streams = [_sparse_stream(7), _sparse_stream(200), _sparse_stream(9)]
    parts = [tp.torch_parts(s) for s in streams]
    assert parts[0][0] == parts[1][0] == parts[2][0]
    dtypes = [serving._dtype_key(p[2]) for p in parts]
    assert dtypes[0] == dtypes[2] != dtypes[1]
    stacks, _ = _groups(monkeypatch, streams)
    assert stacks == [[0, 2], [1]]


def test_stacked_program_op_count_does_not_grow():
    """The stacked 4:4:4 program (mixed types, per-tile CfL, LF smoothing,
    gaborish, EPF 0-2) and the stacked subsampled program dispatch as many
    aten ops for 4 images as for 1."""
    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    cases = {
        "444": tp.STREAMS["tiled_cfl_smooth_epf3"](),
        "420": tp.ycbcr_stream(64, 64, tp.CHROMA["420"], seed=3, gabor=True,
                               epf_iters=2),
    }
    for name, data in cases.items():
        state, hf_global = tp.torch_host(data)
        parts = (state.fused_subsampled_program_parts(hf_global)
                 if state.subsampled else state.fused_program_parts(hf_global))
        key, make_fn, inputs = parts
        fn = make_fn("cpu")
        counts, outs = {}, {}
        for n in (1, 4):
            placed = upload_inputs(stack_inputs([inputs] * n), "cpu")
            Count.n = 0
            with Count():
                outs[n] = fn.stacked(*placed)
            counts[n] = Count.n
        assert counts[4] == counts[1] > 100, (name, counts)
        for j in range(4):
            assert torch.equal(outs[4][j], outs[1][0])


def _animation(seed: int, blend) -> bytes:
    """Three 24x32 random frames with an alpha, each after the first
    blended with `blend` (tests/test_oracle.py:340-356)."""
    rng = np.random.default_rng(seed)
    frames = [[rng.integers(0, 256, (24, 32)) for _ in range(4)]
              for _ in range(3)]
    return encode_jxl_modular(frames[0], bit_depth=8, extra_alpha=True,
                              animation_frames=frames, animation_blend=blend)


def test_animations_go_per_image_and_single_frames_still_stack(monkeypatch):
    """Multi-frame streams among flagship-recipe streams: the guard sends
    them down the per-image path (before any host stage: they composite),
    and the single-frame VarDCT streams still form one stack."""
    streams = [tp.vardct_stream(64, 64, 21, gabor=True, epf_iters=2),
               _animation(1, True),
               tp.vardct_stream(64, 64, 22, gabor=True, epf_iters=2),
               _animation(2, False)]
    for i, data in enumerate(streams):
        img = JxlImage.from_bytes(data, device="cpu")
        fast = serving._host_stage_fast(img, 0)
        assert (fast is None) == (img.num_frames > 1), i
    stacks, per_image = _groups(monkeypatch, streams)
    assert stacks == [[0, 2]] and per_image == [1, 3]


@pytest.mark.parametrize("k", [0, 1, 2])
def test_decode_batch_frame_k_is_render_frame_k(k):
    """decode_batch(frame=k) and decode_batch_stacked(frame=k) give each
    stream's keyframe k; keyframe k of a single-frame stream does not
    exist, and keyframe 0 of it is not taken for keyframe k."""
    streams = [_animation(3, True), _animation(4, 3)]
    want = [JxlImage.from_bytes(d, device="cpu").render_frame(k).to_u8()
            for d in streams]
    for fn in (decode_batch, decode_batch_stacked):
        got = fn(streams, frame=k, output="u8", num_workers=2, device="cpu")
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    single = tp.vardct_stream(64, 64, 23)
    assert serving._host_stage_fast(
        JxlImage.from_bytes(single, device="cpu"), k) is None or k == 0
    if k:
        with pytest.raises(IndexError):
            decode_batch_stacked([single], frame=k, device="cpu")


def _recompose(header, change):
    """Make a parsed single-frame header one that does not cover the
    canvas as it is (the in-repo encoders write no such VarDCT frame)."""
    import dataclasses

    if change == "offset":
        header.have_crop, header.x0, header.y0 = True, 8, 4
    elif change == "negative_offset":
        header.have_crop, header.x0, header.y0 = True, -8, 0
    elif change == "size":
        header.width -= 16
    elif change == "patches":
        header.flags = dataclasses.replace(
            header.flags, value=header.flags.value | 0x2)
    else:
        header.is_last = False


@pytest.mark.parametrize("change", ["offset", "negative_offset", "size",
                                    "patches", "not_last"])
def test_frames_that_composite_are_not_stacked(change):
    """A single-frame VarDCT stream whose frame is cropped (an offset, or
    a sample size other than the image's), is patched or is not the last
    frame composites onto the canvas; the stacked program returns
    frame-sized planes, so _host_stage_fast returns None
    (jxl_oxide_tpu/serving.py:146-161)."""
    img = JxlImage.from_bytes(tp.vardct_stream(64, 64, 24), device="cpu")
    assert serving._host_stage_fast(img, 0) is not None
    _recompose(img._frames[0].header, change)
    assert serving._host_stage_fast(img, 0) is None


@pytest.mark.parametrize("change", ["offset", "negative_offset"])
def test_cropped_single_frames_go_per_image(monkeypatch, change):
    """A cropped single-frame VarDCT stream beside one that stacks: it
    goes down the per-image path, and its result is the canvas with the
    frame at its offset, not the frame."""
    streams = [tp.vardct_stream(64, 64, s, gabor=True, epf_iters=2)
               for s in (25, 26, 27)]
    frame_u8 = JxlImage.from_bytes(streams[1], device="cpu").render_frame(
        0).to_u8()
    from_bytes = JxlImage.from_bytes

    def cropping(data, **kwargs):
        img = from_bytes(data, **kwargs)
        if data is streams[1]:
            _recompose(img._frames[0].header, change)
        return img

    monkeypatch.setattr(JxlImage, "from_bytes", staticmethod(cropping))
    stacks, per_image = _groups(monkeypatch, streams)
    assert stacks == [[0, 2]] and per_image == [1]
    got = decode_batch_stacked(streams, num_workers=2, device="cpu")[1]
    assert got.shape == frame_u8.shape
    x0, y0 = (8, 4) if change == "offset" else (-8, 0)
    np.testing.assert_array_equal(
        got[max(0, y0):64 + min(0, y0), max(0, x0):64 + min(0, x0)],
        frame_u8[max(0, -y0):64 - max(0, y0), max(0, -x0):64 - max(0, x0)])


@pytest.mark.parametrize("change", ["upsampling", "noise", "splines",
                                    "use_lf_frame", "lf_level",
                                    "ec_upsampling", "ec_dim_shift"])
def test_features_and_lf_frames_are_not_stacked(change):
    """A single-frame VarDCT stream with frame upsampling, noise, splines,
    an LF frame, or an alpha upsampled (EC upsampling, dim_shift) renders
    those in the per-image path only; the stacked program would drop
    them. No in-repo VarDCT encoder writes them, so the parsed header is
    changed by hand: _host_stage_fast returns None
    (jxl_oxide_tpu/serving.py:121-125, 146-157)."""
    import dataclasses

    data = tp.vardct_stream(64, 64, 40, gabor=True, epf_iters=2,
                            alpha=_alpha(64, 64, 41))
    img = JxlImage.from_bytes(data, device="cpu")
    assert serving._host_stage_fast(img, 0) is not None
    header = img._frames[0].header
    bits = {"noise": 0x1, "splines": 0x10, "use_lf_frame": 0x20}
    if change in bits:
        header.flags = dataclasses.replace(
            header.flags, value=header.flags.value | bits[change])
    elif change == "upsampling":
        header.upsampling = 2
    elif change == "lf_level":
        header.lf_level = 1
    elif change == "ec_upsampling":
        header.ec_upsampling = [2]
    else:
        img.image_header.metadata.ec_info[0].dim_shift = 1
    assert serving._host_stage_fast(img, 0) is None


def _feature_streams():
    """Three flagship-like VarDCT streams (one program key) between a
    Modular stream with splines, noise and x2 upsampling (the
    features_up2_1024 recipe at 64^2) and an LF-frame stream."""
    from test_torch_features import splines_stream

    flag = [tp.vardct_stream(64, 64, s, gabor=True, epf_iters=2)
            for s in (42, 43, 44)]
    return [flag[0], splines_stream(64, 64, 2, noise=True), flag[1],
            tp.vardct_stream(64, 64, 45, use_lf_frame=True, gabor=True,
                             epf_iters=2), flag[2]]


def test_mixed_feature_batches_equal_per_image(monkeypatch):
    """decode_batch and decode_batch_stacked over the mix: the flagship
    streams stack, the feature and LF streams go per image, and every
    result equals its own render_frame(0).to_u8()."""
    streams = _feature_streams()
    per_image = [JxlImage.from_bytes(d, device="cpu").render_frame(0).to_u8()
                 for d in streams]
    for got in (decode_batch(streams, num_workers=2, device="cpu"),
                decode_batch_stacked(streams, num_workers=2, device="cpu")):
        for a, b in zip(got, per_image):
            np.testing.assert_array_equal(a, b)
    stacks, routed = _groups(monkeypatch, streams)
    assert stacks == [[0, 2, 4]] and routed == [1, 3]


@pytest.mark.parametrize("change", ["spot", "float", "depth", "second_ec",
                                    "unchanged"])
def test_extra_channels_other_than_one_alpha_go_per_image(change):
    """_host_stage_fast stacks one full-resolution integer alpha only (the
    JAX package's ec_ok, jxl_oxide_tpu/serving.py:119-126): a spot
    colour, a float alpha, another kind or a second extra channel would
    pass through the stacked program as if it were that alpha. No
    in-repo VarDCT encoder writes them, so the parsed image header is
    changed by hand."""
    import dataclasses

    from jxl_oxide_tpu_torch.headers.image import ExtraChannelType

    img = JxlImage.from_bytes(tp.vardct_stream(64, 64, 46, epf_iters=1,
                                               alpha=_alpha(64, 64, 47)),
                              device="cpu")
    ec = img.image_header.metadata.ec_info
    if change == "spot":
        ec[0].ty = ExtraChannelType.SPOT_COLOUR
    elif change == "float":
        ec[0].bit_depth = dataclasses.replace(
            ec[0].bit_depth, bits_per_sample=16, exp_bits=5)
    elif change == "depth":
        ec[0].ty = ExtraChannelType.DEPTH
    elif change == "second_ec":
        ec.append(dataclasses.replace(ec[0]))
    out = serving._host_stage_fast(img, 0)
    assert (out is not None) == (change == "unchanged")


def test_extra_channel_streams_in_a_stacked_batch():
    """decode_batch_stacked over VarDCT streams that stack beside Modular
    streams with a spot colour, an f16 alpha, two alphas and CMYK: each
    result equals its own render_frame(0).to_u8()."""
    from test_torch_extra_channels import (
        cmyk,
        f16_alpha,
        spot,
        two_alphas_blend,
    )

    streams = [tp.vardct_stream(64, 64, 48, epf_iters=1,
                                alpha=_alpha(64, 64, 49)),
               spot(), f16_alpha(),
               tp.vardct_stream(64, 64, 50, epf_iters=1,
                                alpha=_alpha(64, 64, 51)),
               two_alphas_blend(), cmyk()]
    got = decode_batch_stacked(streams, num_workers=2, device="cpu")
    for data, a in zip(streams, got):
        img = JxlImage.from_bytes(data, device="cpu")
        np.testing.assert_array_equal(
            a, img.render_frame(0).to_u8())
