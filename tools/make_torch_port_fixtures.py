"""Write the committed test streams of the PyTorch/CUDA port and their
reference decodes.

Runs with JAX (the streams come from the in-repo encoders, which import
jxl_oxide_tpu). For each stream it writes, into jxl_oxide_tpu_torch/
testdata/:
  <name>.jxl   the codestream
  <name>.npz   {"u8": jxl_oxide_tpu's render_frame(0).to_u8()}, compressed;
               for a stream of several keyframes, every keyframe's
               [K, H, W, C] (not for the STREAM_ONLY names: the serving
               phase of chip_smoke.py holds those against the port's own
               per-image decode, and animation_4f_blend against its
               seeded input frames)
  flagship_1024_requests.npz
               flagship_1024 rendered by jxl_oxide_tpu under each of
               REQUESTS (request_color_encoding): "u8_<name>" for each,
               "u16_<name>" for the HDR ones (REQUESTS_U16); written with
               the name "flagship_1024_requests"
  <name>_progressive.npz
               for each of PROGRESSIVE, the stream fed to one
               jxl_oxide_tpu JxlImage up to each of four cuts from its
               frame's TOC (`progressive_cuts`), with the loading render
               after each: "cuts" (byte offsets in the .jxl), "u8"
               [4, H, W, C] (render_loading_frame().to_u8()) and
               "sections" (its ProgressiveCache's sections_decoded());
               written with the name "<name>_progressive"

  ec_mix_1024.npz, ec_blend_premul_512.npz
               besides "u8", "extra": every extra channel of
               image_all_channels() (float32, [.., H, W, E]; per keyframe
               for the animation)
  generate_fixture.json
               the SHA-256 of the JAX CLI's generate-fixture output for
               each of GENERATE_FIXTURE; written with the name
               "generate_fixture"
  <name>_roi.npz
               for each of ROI, jxl_oxide_tpu's render_frame_cropped(0,
               region).to_u8() for each of its regions (`roi_regions`):
               "regions" [R, 4] (display-space left, top, width, height)
               and "u8_<r>"; for flagship_1024 also the loading render at
               its third progressive cut with the first region set
               ("loading_cut", "loading_u8"); written with the name
               "<name>_roi"

The port's chip smoke test and its CPU tests decode the .jxl files with
jxl_oxide_tpu_torch and compare with the .npz references; a machine
without JAX needs nothing else.

    JAX_PLATFORMS=cpu python tools/make_torch_port_fixtures.py [NAME...]
"""

from __future__ import annotations

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(REPO, "jxl_oxide_tpu_torch", "testdata")
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))
sys.path.insert(0, os.path.join(REPO, "tests"))


def smooth_rgb(h, w, seed=0, block=8):
    """bench.py::_smooth_rgb: piecewise-constant 8x8 random colour."""
    rng = np.random.default_rng(seed)
    small = rng.random((h // block + 1, w // block + 1, 3)).astype(np.float32)
    img = np.kron(small, np.ones((block, block, 1), dtype=np.float32))[:h, :w]
    return np.clip(img, 0, 1)


# every transform type except the three largest (DCT128+ tiles leave
# few positions at 512^2) and DCT8 filler; the mix keeps the dense plan
# under DENSE_PLAN_MAX_ENTRIES
MIXED_TYPES = ("DCT8", "DCT2", "DCT4", "HORNUSS", "DCT16", "DCT32",
               "DCT16X8", "DCT8X16", "DCT4X8", "DCT8X4", "AFV0", "AFV1",
               "AFV2", "AFV3", "DCT32X16", "DCT8X32")
# with the 64-px transforms added, a 1024x1030 frame's dense plan has
# more than DENSE_PLAN_MAX_ENTRIES (96) entries: the staged path
STAGED_TYPES = MIXED_TYPES + ("DCT64", "DCT64X32", "DCT32X64")


def mixed_512():
    """A 512^2 multi-group stream with mixed transform types, gaborish and
    a 2-pass EPF over a random sharpness grid (bench.py's
    vardct_mixed_epf2 recipe, widened to more types).
    encode_jxl_vardct_mixed is capped at 256^2, so the multi-group tiled
    encoder writes it."""
    from encoder_vardct import encode_jxl_vardct_tiled
    from test_parallel import _random_varblock_grid

    from jxl_oxide_tpu.models.vardct import TransformType as T

    rng = np.random.default_rng(5)
    mh = mw = 512
    bh, bw = mh // 8, mw // 8
    sel, mul = _random_varblock_grid(
        bh, bw, rng, [getattr(T, n) for n in MIXED_TYPES]
    )
    coeff = rng.integers(-15, 16, (3, mh, mw)).astype(np.int64)
    coeff[rng.random((3, mh, mw)) < 0.95] = 0
    lf_q = rng.integers(-60, 61, (3, bh, bw)).astype(np.int64)
    sharp = rng.integers(0, 8, (bh, bw)).astype(np.int64)
    return encode_jxl_vardct_tiled(mh, mw, sel, mul, coeff, lf_q, gabor=True,
                                   epf_iters=2, sharpness=sharp)


def ycbcr_stream(h, w, ups, seed, density, **kw):
    """bench.py's vardct_420 recipe (bench.py:87-111) at any size and
    chroma layout: all DCT8, per-channel coefficient planes at each
    channel's stored size with `density` non-zero, random LF. Frames of
    one 256-px group take the single-group encoder."""
    from encoder_vardct import encode_jxl_vardct_420, encode_jxl_vardct_tiled

    from jxl_oxide_tpu.models.vardct import TransformType as T
    from jxl_oxide_tpu.models.vardct import jpeg_shifts

    rng = np.random.default_rng(seed)
    bh, bw = h // 8, w // 8
    sel = np.full((bh, bw), int(T.DCT8), dtype=np.int64)
    mul = np.ones((bh, bw), dtype=np.int64)
    coeff, lf = [], []
    for hs, vs in jpeg_shifts(ups):
        sh = (h >> vs, w >> hs)
        cp = np.zeros(sh, dtype=np.int64)
        m = rng.random(sh) < density
        cp[m] = rng.integers(-10, 11, int(m.sum()))
        coeff.append(cp)
        lf.append(rng.integers(-60, 61, (bh >> vs, bw >> hs)).astype(np.int64))
    if h <= 256 and w <= 256:
        return encode_jxl_vardct_420(h, w, coeff, lf, jpeg_upsampling=ups,
                                     **kw)
    return encode_jxl_vardct_tiled(h, w, sel, mul, coeff, lf,
                                   jpeg_upsampling=ups, **kw)


def with_ycbcr_444(stream: bytes) -> bytes:
    """`stream`, a bare codestream of one non-XYB VarDCT frame that is not
    YCbCr, spliced into a 4:4:4 YCbCr frame: the frame header's do_ycbcr
    bit (after the flags U64, tools/encoder_vardct.py:1090-1091) set and
    three 2-bit jpeg_upsampling fields of 0 inserted after it. The frame
    header and the TOC are parsed with the port's own parser; the bits
    before the TOC's first zero padding move by 6, the padding is
    written anew, and the TOC's sizes and every section keep their bytes
    (they start on a byte boundary). No in-repo encoder writes a 4:4:4
    YCbCr frame of several groups: encode_jxl_vardct_tiled sets do_ycbcr
    only for subsampled layouts (encoder_vardct.py:1066)."""
    from jxl_oxide_tpu_torch import JxlImage
    from jxl_oxide_tpu_torch.headers.frame import Encoding, FrameHeader, Toc
    from jxl_oxide_tpu_torch.io.bitstream import Bitstream

    img = JxlImage.from_bytes(stream, device="cpu")
    assert img.num_frames == 1 and not img.image_header.metadata.xyb_encoded
    fr = img._frames[0]
    assert fr.header.encoding == Encoding.VARDCT and not fr.header.do_ycbcr
    start = fr.start_byte * 8
    bs = Bitstream(stream, start)
    bs.read_bool()       # all_default
    bs.read_bits(2)      # frame_type
    bs.read_bits(1)      # encoding
    bs.read_u64()        # flags
    at = bs.pos          # do_ycbcr
    bs = Bitstream(stream, start)
    FrameHeader.parse(bs, img.image_header)
    end = bs.pos         # the TOC's permutation bit
    toc = Toc.parse(Bitstream(stream, end), fr.header, fr.start_byte)
    bits = [(stream[i >> 3] >> (i & 7)) & 1 for i in range(end + 1)]
    assert bits[at] == 0 and bits[end] == 0, "do_ycbcr set or TOC permuted"
    bits[at:at + 1] = [1] + [0] * 6
    bits += [0] * (-len(bits) % 8)
    head = bytes(sum(b << k for k, b in enumerate(bits[i:i + 8]))
                 for i in range(0, len(bits), 8))
    out = head + stream[-(-(end + 1) // 8):]
    spliced = JxlImage.from_bytes(out, device="cpu")._frames[0]
    assert spliced.header.do_ycbcr
    assert tuple(spliced.header.jpeg_upsampling) == (0, 0, 0)
    assert [e.size for e in spliced.toc.entries] == [
        e.size for e in toc.entries]
    return out


def ycbcr444_tiled(h, w, seed, density, **kw):
    """The 4:4:4 layout of ycbcr_stream above 256^2, where the
    multi-group encoder (which takes skip_lf_smoothing) writes it as a
    frame that is not YCbCr, spliced into a YCbCr one
    (`with_ycbcr_444`)."""
    assert h > 256 or w > 256, "ycbcr_stream's single-group encoder"
    return with_ycbcr_444(ycbcr_stream(h, w, (0, 0, 0), seed, density,
                                       **kw))


def unchecked_modular_encoder(module=None):
    """The Modular encoder `module` (default tools/encoder.py; the port's
    copy jxl_oxide_tpu_torch/encoders/encoder.py too) compiled without
    its asserts (optimize=1), the file itself unchanged: its
    encode_jxl_modular refuses a chroma-subsampled YCbCr frame only by
    the scope assert (tools/encoder.py:720-722) and the equal-shapes
    assert (741), and writes one when they are stripped. A module of its
    own, so the checked encoder stays as it is."""
    import types

    if module is None:
        import encoder as module
    mod = types.ModuleType(module.__name__ + "_unchecked")
    mod.__file__, mod.__package__ = module.__file__, module.__package__
    with open(module.__file__) as f:
        exec(compile(f.read(), module.__file__, "exec", optimize=1),
             mod.__dict__)
    return mod


def modular_ycbcr(h, w, ups, seed, **kw):
    """A lossless chroma-subsampled YCbCr Modular stream: smooth_u8(h, w,
    seed)'s planes as [Cb, Y, Cr] in stream order, each decimated by its
    channel's shifts of `ups` (every other sample kept, as the frame's
    ceil-sized channel holds), through `unchecked_modular_encoder`.
    Returns (stream, the coded planes)."""
    from jxl_oxide_tpu.models.vardct import jpeg_shifts

    planes = [p[::1 << vs, ::1 << hs] for p, (hs, vs)
              in zip(smooth_u8(h, w, seed), jpeg_shifts(ups))]
    data = unchecked_modular_encoder().encode_jxl_modular(
        planes, bit_depth=8, do_ycbcr=True, jpeg_upsampling=ups,
        image_size=(h, w), **kw)
    return data, planes


def staged_1030():
    """A 1024x1030 (HxW) multi-group stream whose dense plan overflows:
    random varblocks of STAGED_TYPES, about 2 % non-zero coefficients,
    gaborish and 2 EPF passes over a random sharpness grid. The non-zero
    coefficients lie in the low-frequency quarter (each side) of their
    varblock, as a natural image's do: the in-repo encoder codes a block
    up to its last non-zero coefficient, so uniformly spread ones would
    cost whole 64x64 blocks and a stream over 2 MB. W % 8 != 0, and the
    staged path filters at the sample size, so its EPF passes run on
    planes with W % 4 != 0."""
    from encoder_vardct import encode_jxl_vardct_tiled
    from test_parallel import _random_varblock_grid

    from jxl_oxide_tpu.models.vardct import TransformType as T

    rng = np.random.default_rng(6)
    h, w = 1024, 1030
    bh, bw = -(-h // 8), -(-w // 8)
    sel, mul = _random_varblock_grid(
        bh, bw, rng, [getattr(T, n) for n in STAGED_TYPES]
    )
    low = np.zeros((8 * bh, 8 * bw), dtype=bool)
    for y, x in zip(*np.nonzero(sel >= 0)):
        tw, th = T.SELECT_SIZE[int(sel[y, x])]
        low[8 * y : 8 * y + 2 * th, 8 * x : 8 * x + 2 * tw] = True
    coeff = rng.integers(-15, 16, (3, 8 * bh, 8 * bw)).astype(np.int64)
    coeff[~(low & (rng.random(coeff.shape) < 0.32))] = 0
    lf_q = rng.integers(-60, 61, (3, bh, bw)).astype(np.int64)
    sharp = rng.integers(0, 8, (bh, bw)).astype(np.int64)
    return encode_jxl_vardct_tiled(h, w, sel, mul, coeff, lf_q, gabor=True,
                                   epf_iters=2, sharpness=sharp)


def smooth_u8(h, w, seed):
    """smooth_rgb as three 8-bit integer planes (lossless Modular input)."""
    img = np.round(smooth_rgb(h, w, seed) * 255).astype(np.int64)
    return [img[:, :, c] for c in range(3)]


def smooth_alpha(h, w, seed):
    """A seeded smooth 8-bit alpha: the first plane of smooth_u8."""
    return smooth_u8(h, w, seed)[0]


def flagship_alpha(seed, alpha_seed):
    """The flagship recipe (encode_jxl_vardct of smooth_rgb(1024, 1024,
    seed), gaborish, 2 EPF passes) with a 1024^2 alpha channel.
    encode_jxl_vardct takes alpha only up to 256^2, so the multi-group
    tiled encoder writes the stream, from the quantized coefficients that
    the JAX host stage decodes out of the flagship recipe's stream: the
    colour decodes as the recipe's does (all DCT8, global scale 512)."""
    from encoder_vardct import encode_jxl_vardct, encode_jxl_vardct_tiled

    from jxl_oxide_tpu import JxlImage
    from jxl_oxide_tpu.models.vardct import TransformType as T
    from jxl_oxide_tpu.serving import _host_stage_fast

    h = w = 1024
    plain = encode_jxl_vardct(smooth_rgb(h, w, seed=seed), gabor=True,
                              epf_iters=2)
    state, _, _, _ = _host_stage_fast(JxlImage.from_bytes(plain), 0)
    bh, bw = h // 8, w // 8
    sel = np.full((bh, bw), int(T.DCT8), dtype=np.int64)
    mul = np.ones((bh, bw), dtype=np.int64)
    coeff = np.stack([np.asarray(p, np.int64) for p in state.coeff_planes])
    lf_q = np.stack([np.asarray(p, np.int64) for p in state.lf_quant_planes])
    return encode_jxl_vardct_tiled(h, w, sel, mul, coeff, lf_q,
                                   global_scale=512, gabor=True, epf_iters=2,
                                   alpha=smooth_alpha(h, w, alpha_seed))


def animation_4f_frames():
    """The input frames of bench.py's animation_4f_blend case
    (bench.py:207-218), unchanged: seed 7, 512^2, four frames of three
    8-bit planes, each a small random walk from the one before."""
    rng = np.random.default_rng(7)
    frames = [[rng.integers(0, 200, (512, 512), dtype=np.int64)
               for _ in range(3)]]
    for _ in range(3):
        frames.append([np.clip(c + rng.integers(-8, 9, c.shape), 0, 255)
                       for c in frames[-1]])
    return frames


def anim_blend_epf_512():
    """Three 512^2 frames of smooth colour and a smooth alpha, each after
    the first blended over slot 1 with its alpha (animation_blend=True:
    BlendMode Blend, every frame saved to slot 1), gaborish + 2 EPF
    passes on every frame."""
    from encoder import encode_jxl_modular

    frames = [smooth_u8(512, 512, 30 + 2 * k)
              + [smooth_alpha(512, 512, 31 + 2 * k)] for k in range(3)]
    return encode_jxl_modular(frames[0], bit_depth=8, extra_alpha=True,
                              animation_frames=frames, animation_blend=True,
                              gabor=True, epf_iters=2)


def patch_alpha_256():
    """A reference-only frame (colour and alpha) saved to slot 0, and a
    256^2 keyframe that patches a 100x90 rect of it over itself with
    BlendAbove (PatchBlendMode 4) on colour and alpha: the recipe of
    tests/test_oracle.py:416-436 at 256^2, smooth content."""
    from encoder import encode_jxl_modular

    base = smooth_u8(256, 256, 40) + [smooth_alpha(256, 256, 41)]
    ref = smooth_u8(256, 256, 42) + [smooth_alpha(256, 256, 43)]
    spec = dict(ref_idx=0, x0=16, y0=24, width=100, height=90, x=60, y=70,
                mode=4, ec_modes=[4], clamp=False)
    return encode_jxl_modular(base, bit_depth=8, extra_alpha=True,
                              reference_patch=(ref, spec))


# streams committed without a reference (.npz): the other members of the
# serving phase's alpha group (each 1024^2 alpha costs about 1 MB: the
# in-repo encoder spends 8 bits a sample), the second members of the
# flagship and 4:2:2 stacks of the cuda serving test, and
# animation_4f_blend, whose keyframes are its seeded input frames
STREAM_ONLY = ("flagship_alpha_1024_s1", "flagship_alpha_1024_s2",
               "flagship_alpha_1024_s3", "flagship_1024_s1",
               "ycbcr422_256_s1", "animation_4f_blend")


def grey_squeeze():
    """One 8-bit grey plane, squeezed, gaborish + 2 EPF passes. 2048 wide:
    the default squeeze of one channel halves its width, and a squeezed
    half of 1024 x 1024 samples is what the Modular device tail's gate
    asks for (2^20; models/modular.py `_device_tail_worthwhile`), so the
    squeeze runs on the card. At 1024 x 1024 both halves hold 2^19 and
    the host tail runs. LZ77 runs (lz77_rle) code the runs of zero
    residuals in the 8x8 blocks: 0.21 MB against 2.1 MB without them, the
    same image."""
    from encoder import encode_jxl_modular

    plane = np.concatenate([smooth_u8(1024, 1024, 30)[0],
                            smooth_u8(1024, 1024, 34)[0]], axis=1)
    return encode_jxl_modular([plane], bit_depth=8, grayscale=True,
                              squeeze=True, gabor=True, epf_iters=2,
                              lz77_rle=True)


def modular_wp_256():
    """bench.py's modular_wp case (bench.py:180-205), unchanged: a grey
    256^2 plane coded with the weighted predictor through a custom MA
    tree."""
    from encoder import encode_jxl_modular
    from test_roundtrip import _RefWp

    rng = np.random.default_rng(13)
    wp_h = wp_w = 256
    a = rng.integers(0, 32, (wp_h, wp_w)).astype(np.int64) * 8
    wp_state = _RefWp(wp_w)
    toks = []
    for y in range(wp_h):
        for x in range(wp_w):
            W = int(a[y, x - 1]) if x > 0 else (int(a[y - 1, 0]) if y > 0
                                                else 0)
            N = int(a[y - 1, x]) if y > 0 else W
            NW = int(a[y - 1, x - 1]) if (x > 0 and y > 0) else W
            NE = int(a[y - 1, x + 1]) if (y > 0 and x + 1 < wp_w) else N
            NN = int(a[y - 2, x]) if y >= 2 else N
            pred = (wp_state.predict(N, NW, NE, W, NN) + 3) >> 3
            v = int(a[y, x]) - pred
            toks.append((v << 1) if v >= 0 else (-(v << 1) - 1))
            wp_state.record(int(a[y, x]))
    return encode_jxl_modular([a], bit_depth=8, grayscale=True,
                              custom_tree=([0, 6, 0, 0, 0], 1,
                                           lambda _c: list(toks)))


def xyb_hdr(size, relative):
    """Lossless XYB Modular mastered at 4000 nits (tone_mapping), gaborish
    + 2 EPF passes: rendered to sRGB, the colour tail tone-maps it
    (BT.2408), with relative_to_max_display through the peak-detecting
    leg. LZ77 runs keep the 1024^2 stream at 0.17 MB (3.16 MB without)."""
    from encoder import encode_jxl_modular

    return encode_jxl_modular(
        smooth_u8(size, size, 31), bit_depth=8, xyb=True,
        tone_mapping=(4000.0, 0.0, relative, 0.0), gabor=True, epf_iters=2,
        lz77_rle=True)


def icc_p3_512():
    """RGB Modular with an embedded ICC profile that an enum expresses:
    Display P3, perceptual intent, synthesized by jxl_oxide_tpu."""
    from encoder import encode_jxl_modular

    from jxl_oxide_tpu.color.synthesize import colour_encoding_to_icc
    from jxl_oxide_tpu.headers.image import (
        ColourEncoding,
        Primaries,
        RenderingIntent,
    )

    icc = colour_encoding_to_icc(ColourEncoding(
        primaries=Primaries.P3, rendering_intent=RenderingIntent.PERCEPTUAL))
    return encode_jxl_modular(smooth_u8(512, 512, 35), bit_depth=8,
                              embed_icc=icc, lz77_rle=True)


def feature_splines(seed: int) -> list:
    """Eight seeded splines across a 1024^2 frame (full-resolution
    coordinates): four control points each, low-frequency colour DCTs and
    a narrow constant sigma (sigma_dct[0] = 12: about 3.2 px after the
    channel weight and quant_adjust 2). With upsampling 2 the planes are
    512^2 and only what falls in the top-left quarter is drawn
    (spline.rs:209-218): the last two splines start beyond it."""
    rng = np.random.default_rng(seed)
    splines = []
    for i in range(8):
        lo, hi = (20, 490) if i < 6 else (530, 1000)
        pts = [tuple(int(v) for v in rng.integers(lo, hi, 2))]
        for _ in range(3):
            x, y = pts[-1]
            nxt = (int(np.clip(x + rng.integers(-90, 91), lo, hi)),
                   int(np.clip(y + rng.integers(-90, 91), lo, hi)))
            pts.append(nxt if nxt != pts[-1] else (nxt[0] + 1, nxt[1]))
        xyb_dct = np.zeros((3, 32), dtype=np.int64)
        xyb_dct[:, :3] = rng.integers(-40, 41, (3, 3))
        xyb_dct[1, 0] = rng.integers(20, 60)
        sigma_dct = np.zeros(32, dtype=np.int64)
        sigma_dct[0] = 12
        splines.append(dict(points=pts, xyb_dct=xyb_dct, sigma_dct=sigma_dct))
    return splines


def features_up2_1024():
    """The shape of a low-bitrate stream: a 512^2 Modular frame upsampled
    x2 to 1024^2, gaborish and 2 EPF passes at 512^2, then splines and
    photon noise at sample resolution, LZ77 runs.

    One 1024^2 group (group_size_shift 3): tools/encoder.py cuts an
    upsampled frame into groups of the image's size, not the frame's
    sample size, so with smaller groups its TOC does not match the frame
    that decoders read (at 256^2 groups both decoders refuse the stream;
    at 512^2 they misread it). The noise field's groups are the frame's
    group_dim over the full-resolution frame: one group of 1024^2."""
    from encoder import encode_jxl_modular

    return encode_jxl_modular(
        smooth_u8(512, 512, 50), bit_depth=8, image_size=(1024, 1024),
        upsampling=2, group_size_shift=3, gabor=True, epf_iters=2,
        noise_lut=[0.2, 0.3, 0.4, 0.5, 0.5, 0.4, 0.3, 0.2],
        splines_spec=(feature_splines(51), 2), lz77_rle=True)


def requested_encodings(image) -> dict:
    """The encodings flagship_1024 is rendered to, name -> ColourEncoding,
    built from `image`, a headers.image module (the JAX package's, or the
    port's copy: their classes do not compare equal across packages)."""
    ce, prim, tf = image.ColourEncoding, image.Primaries, image.TransferFunction
    return {
        "pq": ce(primaries=prim.BT2100, tf=tf.PQ),
        "hlg": ce(primaries=prim.BT2100, tf=tf.HLG),
        "bt709": ce(tf=tf("bt709")),
        # gamma 2.2: the coded exponent is 1/2.2, in units of 1e-7
        "gamma22": ce(tf=tf("gamma", gamma=4545455, gamma_inverted=True)),
        "p3_perceptual": ce(primaries=prim.P3,
                            rendering_intent=image.RenderingIntent.PERCEPTUAL),
        "grey": ce(colour_space=image.ColourSpace.GREY),
    }


REQUESTS = ("pq", "hlg", "bt709", "gamma22", "p3_perceptual", "grey")
# the requests whose u16 render is committed too
REQUESTS_U16 = ("pq", "hlg")


def write_requests() -> None:
    """flagship_1024_requests.npz from the committed flagship_1024.jxl."""
    from jxl_oxide_tpu import JxlImage
    from jxl_oxide_tpu.headers import image

    with open(os.path.join(OUT_DIR, "flagship_1024.jxl"), "rb") as f:
        data = f.read()
    out = {}
    for name, enc in requested_encodings(image).items():
        img = JxlImage.from_bytes(data)
        img.request_color_encoding(enc)
        r = img.render_frame(0)
        out[f"u8_{name}"] = r.to_u8()
        if name in REQUESTS_U16:
            out[f"u16_{name}"] = r.to_u16()
    np.savez_compressed(
        os.path.join(OUT_DIR, "flagship_1024_requests.npz"), **out)
    print("flagship_1024_requests: "
          + ", ".join(f"{k} {v.shape}" for k, v in out.items()))


def smooth_f16(h, w, seed):
    """A smooth float field in [0, 1] as the integer bit patterns of its
    f16 samples (a float extra channel's samples)."""
    field = smooth_rgb(h, w, seed)[:, :, 0]
    return np.float16(field).view(np.uint16).astype(np.int64)


def ec_mix_1024():
    """Every extra-channel kind on the Modular device tail: smooth colour,
    an 8-bit alpha, a spot colour (red at solidity 0.5), an f16 alpha and
    a named depth channel, squeezed, gaborish + 2 EPF passes, LZ77 runs.
    The unsqueezed 1024^2 planes open the device tail's gate (K9 on the
    squeezed channel), K1 runs on the colour, the f16 alpha leaves the
    tail as int32 tensors, and the spot colour mixes in after the
    filters."""
    from encoder import encode_jxl_modular

    return encode_jxl_modular(
        smooth_u8(1024, 1024, 60)
        + [smooth_alpha(1024, 1024, 61), smooth_alpha(1024, 1024, 62),
           smooth_f16(1024, 1024, 63), smooth_alpha(1024, 1024, 64)],
        bit_depth=8, extra_alpha=True, spot_colour=(1.0, 0.0, 0.0, 0.5),
        extra_channel_specs=[{"ty": 0, "bits": 16, "float_exp_bits": 5},
                             {"ty": 1, "name": "depth"}],
        squeeze=True, gabor=True, epf_iters=2, lz77_rle=True)


def ec_blend_premul_512():
    """Three 512^2 frames with an alpha and an associated (premultiplied)
    second alpha, each after the first blended over slot 1 with alpha
    channel 1: the colour takes the premultiplied blend, the first alpha
    mixes as an alpha; gaborish + 2 EPF passes on every frame (K1 2 a
    frame), LZ77 runs."""
    from encoder import encode_jxl_modular

    frames = [smooth_u8(512, 512, 65 + 3 * k)
              + [smooth_alpha(512, 512, 66 + 3 * k),
                 smooth_alpha(512, 512, 67 + 3 * k)] for k in range(3)]
    return encode_jxl_modular(
        frames[0], bit_depth=8, extra_alpha=True,
        extra_channel_specs=[{"ty": 0, "alpha_associated": True}],
        animation_frames=frames,
        animation_blend={"mode": 2, "alpha_channel": 1},
        gabor=True, epf_iters=2, lz77_rle=True)


# the fixtures whose references carry every extra channel
EXTRA_CHANNELS = ("ec_mix_1024", "ec_blend_premul_512")
# the streams whose region renders are committed (<name>_roi.npz)
ROI = ("flagship_1024", "ycbcr420_1024", "orient6_512x384", "modular_1024",
       "ycbcr444_1024", "modular_420_1024")


def roi_regions(width: int, height: int) -> list:
    """Display-space regions of a width x height image: one across the
    first groups, one inside a later group where the image holds it (else
    one more inside), and one on the right and bottom edges."""
    second = ((600, 600, 90, 90) if width >= 700 and height >= 700
              else (200, 300, 90, 90))
    return [(37, 101, 200, 150), second, (width - 70, height - 40, 70, 40)]


def write_roi(name: str) -> None:
    """<name>_roi.npz from the committed <name>.jxl."""
    from jxl_oxide_tpu import JxlImage

    with open(os.path.join(OUT_DIR, f"{name}.jxl"), "rb") as f:
        data = f.read()
    img = JxlImage.from_bytes(data)
    regions = roi_regions(img.width, img.height)
    out = {"regions": np.asarray(regions, np.int64)}
    for r, region in enumerate(regions):
        out[f"u8_{r}"] = JxlImage.from_bytes(data).render_frame_cropped(
            0, region).to_u8()
    if name == "flagship_1024":
        cut = progressive_cuts(img._frames[0])[2]
        loading = JxlImage()
        loading.set_image_region(*regions[0])
        loading.feed_bytes(data[:cut])
        out["loading_cut"] = np.int64(cut)
        out["loading_u8"] = loading.render_loading_frame().to_u8()
    np.savez_compressed(os.path.join(OUT_DIR, f"{name}_roi.npz"), **out)
    print(f"{name}_roi: regions {regions}"
          + (f", loading render at byte {cut}" if "loading_u8" in out
             else ""))


# the streams whose loading renders are committed (<name>_progressive.npz)
PROGRESSIVE = ("flagship_1024", "passes3_1024", "modular_1024")


def progressive_cuts(frame) -> list[int]:
    """Four byte offsets into a one-frame bare codestream, from its frame's
    TOC (`frame` is either package's Frame): the end of the last LF group
    (before HfGlobal: a pure-LF render of a VarDCT frame); HfGlobal and
    the first half of pass 0's groups; the end of pass 0 with several
    passes, else all groups but the last; the whole stream."""
    header, toc = frame.header, frame.toc
    groups = header.num_groups

    def end(kind, *index):
        e = toc.entry_for(kind, *index)
        return frame.start_byte + e.offset + e.size

    third = (end("group_pass", groups - 1, 0) if header.passes.num_passes > 1
             else end("group_pass", groups - 2, 0))
    return [end("lf_group", header.num_lf_groups - 1),
            end("group_pass", groups // 2 - 1, 0), third,
            frame.start_byte + frame.total_bytes]


def write_progressive(name: str) -> None:
    """<name>_progressive.npz from the committed <name>.jxl: the JAX
    package's loading render at each of progressive_cuts, fed in order to
    one JxlImage."""
    from jxl_oxide_tpu import JxlImage

    with open(os.path.join(OUT_DIR, f"{name}.jxl"), "rb") as f:
        data = f.read()
    assert data[:2] == b"\xff\x0a", "a bare codestream"
    cuts = progressive_cuts(JxlImage.from_bytes(data)._frames[0])
    img = JxlImage()
    u8, sections = [], []
    prev = 0
    for cut in cuts:
        img.feed_bytes(data[prev:cut])
        prev = cut
        u8.append(img.render_loading_frame().to_u8())
        sections.append(img._frames[0]._progressive_cache.sections_decoded())
    np.savez_compressed(
        os.path.join(OUT_DIR, f"{name}_progressive.npz"),
        cuts=np.asarray(cuts, np.int64), u8=np.stack(u8),
        sections=np.asarray(sections, np.int64))
    print(f"{name}_progressive: cuts {cuts}, sections {sections}")


def jbrd_box_444(exif_len: int, xmp_len: int, comment: bytes,
                 tail: bytes) -> bytes:
    """A jbrd box (header + brotli-compressed data stream) for a
    3-component sequential JPEG: tests/test_jbr.py make_jbrd_box_color_420
    with components R, G and B, an Exif and an XMP APP1 marker, a comment
    and tail data. The box
    carries no sampling factors; the frame's jpeg_upsampling (all 0 here)
    makes it 4:4:4. Markers: APP1 (Exif), APP1 (XMP), COM, DQT, SOF0,
    DHT, SOS, EOI."""
    from encoder import BitWriter
    from test_jbr import (
        AC_COUNTS,
        AC_VALUES,
        DC_COUNTS,
        DC_VALUES,
        _write_huffman_code,
        brotli_compress,
    )

    w = BitWriter()
    w.write_bool(False)  # is_gray
    for m in (0xE1, 0xE1, 0xFE, 0xDB, 0xC0, 0xC4, 0xDA, 0xD9):
        w.write(m - 0xC0, 6)
    # app markers: type U32(0, 1, 2 + u(1), 4 + u(2)), then length - 1;
    # Exif (type 2) and XMP (type 3) lengths cover the marker's length
    # bytes, its identifier and the payload (jbr expected_exif_len)
    for ty, n in ((2, exif_len + 3 + 6), (3, xmp_len + 3 + 29)):
        w.write(2, 2)
        w.write(ty - 2, 1)
        w.write(n - 1, 16)
    com = (2 + len(comment)).to_bytes(2, "big") + comment
    w.write(len(com) - 1, 16)
    w.write(1, 2)  # num_quant_tables - 1 = 1 (luma + chroma)
    for idx, last in ((0, False), (1, True)):
        w.write(0, 1)       # precision 0
        w.write(idx, 2)     # table index
        w.write_bool(last)
    w.write(2, 2)  # comp_type = 2 -> ids R, G, B: an RGB JPEG, as the
    for q_idx in (0, 1, 1):  # frame is (do_ycbcr false)
        w.write(q_idx, 2)
    w.write(1, 2)  # num_huff = 4: U32 selector 1, u(3) = 2
    w.write(2, 3)
    _write_huffman_code(w, False, 0, False, DC_COUNTS, DC_VALUES)
    _write_huffman_code(w, True, 0, False, AC_COUNTS, AC_VALUES)
    _write_huffman_code(w, False, 1, False, DC_COUNTS, DC_VALUES)
    _write_huffman_code(w, True, 1, True, AC_COUNTS, AC_VALUES)
    # one scan of 3 components, ss=0 se=63
    w.write(2, 2)
    w.write(0, 6)
    w.write(63, 6)
    w.write(0, 4)
    w.write(0, 4)
    for comp, tbl in ((0, 0), (1, 1), (2, 1)):
        w.write(comp, 2)
        w.write(tbl, 2)  # ac table
        w.write(tbl, 2)  # dc table
    w.write(0, 2)  # last_needed_pass
    w.write(0, 2)  # no reset points
    w.write(0, 2)  # no extra zero runs
    w.write(1, 2)  # tail_data_length: 1 + u(8)
    w.write(len(tail) - 1, 8)
    w.write_bool(False)  # no padding bits
    w.zero_pad_to_byte()
    return w.to_bytes() + brotli_compress(com + tail)


# the 4-byte TIFF offset, then a little-endian TIFF header and an empty
# IFD
JBRD_EXIF = ((0).to_bytes(4, "big") + b"II*\x00\x08\x00\x00\x00"
             + b"\x00\x00" + b"\x00\x00\x00\x00")
JBRD_XMP = b'<x:xmpmeta xmlns:x="adobe:ns:meta/">jbrd fixture</x:xmpmeta>'
JBRD_GAIN_MAP = bytes(range(256)) * 3


def jbrd_container_256() -> bytes:
    """A container whose jxlc codestream could have come from a 4:4:4
    colour JPEG: encode_jxl_vardct_mixed at 256^2, every block DCT8, Raw
    quant matrices over 1/2040 (DequantMatrixSet.parse then reads them as
    the JPEG's quant tables), integer chroma-from-luma factors, non-XYB,
    no adaptive LF smoothing, no filters. Beside it: an Exif box, a
    brob-wrapped XMP box, a jhgm gain map and the jbrd box
    (`jbrd_box_444`) that rebuilds the JPEG from the frame."""
    from encoder_vardct import encode_jxl_vardct_mixed
    from test_jbr import brotli_compress

    rng = np.random.default_rng(70)
    h = w = 256
    bh, bw = h // 8, w // 8
    coeff = np.zeros((3, h, w), dtype=np.int64)
    live = rng.random((3, h, w)) < 0.15
    coeff[live] = rng.integers(-9, 10, int(live.sum()))
    # a JPEG's coefficient block has no DC in the HF planes
    coeff[:, ::8, ::8] = 0
    lf_q = rng.integers(-40, 41, (3, bh, bw))
    qmat = rng.integers(6, 40, (3, 8, 8))
    cfl = (rng.integers(-12, 13, (h // 64, w // 64)),
           rng.integers(-12, 13, (h // 64, w // 64)))
    codestream = encode_jxl_vardct_mixed(
        h, w, np.zeros((bh, bw), dtype=np.int64),
        np.ones((bh, bw), dtype=np.int64), coeff, lf_q,
        raw_dct8=(1.0 / 2040.0, qmat), cfl_grids=cfl)

    def box(ty: bytes, content: bytes) -> bytes:
        return (8 + len(content)).to_bytes(4, "big") + ty + content

    jbrd = jbrd_box_444(len(JBRD_EXIF) - 4, len(JBRD_XMP),
                        b"made by tools/make_torch_port_fixtures.py",
                        b"\x00TAIL")
    return (b"\x00\x00\x00\x0cJXL \x0d\x0a\x87\x0a"
            + box(b"ftyp", b"jxl \x00\x00\x00\x00jxl ")
            + box(b"Exif", JBRD_EXIF)
            + box(b"brob", b"xml " + brotli_compress(JBRD_XMP))
            + box(b"jhgm", JBRD_GAIN_MAP)
            + box(b"jbrd", jbrd)
            + box(b"jxlc", codestream))


def write_jbrd_reference(data: bytes) -> dict:
    """jbrd_container_256.npz: the JAX package's reconstruct_jpeg()
    bytes, every aux payload and to_u8(), bytes as uint8 arrays. The
    render comes from an image of its own: after reconstruct_jpeg, the
    JAX package's render of this single-section frame raises (its
    decode_vardct_frame has read the frame's one bitstream; ROADMAP
    Queue 3)."""
    from jxl_oxide_tpu import JxlImage

    img = JxlImage.from_bytes(data)
    as_u8 = lambda b: np.frombuffer(b, dtype=np.uint8)  # noqa: E731
    return {"jpeg": as_u8(img.reconstruct_jpeg()),
            "exif": as_u8(img.aux_box(b"Exif")),
            "raw_exif": as_u8(img.raw_exif_data),
            "xmp": as_u8(img.raw_xmp),
            "jhgm": as_u8(img.hdr_gain_map),
            "u8": JxlImage.from_bytes(data).render_frame(0).to_u8()}


# the fixtures chip_smoke.py's phase_frontends runs the CLI on
FRONTENDS = ("flagship_1024", "modular_1024", "animation_4f_blend",
             "jbrd_container_256")


def apng_delays(png: bytes) -> list:
    """(delay_num, delay_den) of each fcTL chunk of an APNG."""
    import struct

    out, pos = [], 8
    while pos < len(png):
        n, tag = struct.unpack(">I4s", png[pos:pos + 8])
        if tag == b"fcTL":
            out.append(list(struct.unpack(">HH", png[pos + 28:pos + 32])))
        pos += 12 + n
    return out


def write_frontends() -> None:
    """frontends.json: the JAX CLI's `info` JSON for each of FRONTENDS
    and the fcTL delays of its APNG of animation_4f_blend."""
    import contextlib
    import io
    import json
    import tempfile

    from jxl_oxide_tpu import cli

    info = {}
    for name in FRONTENDS:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli.main(["info", os.path.join(OUT_DIR,
                                                  f"{name}.jxl")]) == 0
        info[name] = json.loads(buf.getvalue())
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "anim.png")
        assert cli.main(["decode", os.path.join(
            OUT_DIR, "animation_4f_blend.jxl"), "-o", out]) == 0
        with open(out, "rb") as f:
            delays = apng_delays(f.read())
    with open(os.path.join(OUT_DIR, "frontends.json"), "w") as f:
        json.dump({"info": info,
                   "apng_delays": {"animation_4f_blend": delays}}, f,
                  indent=1)
        f.write("\n")
    print(f"frontends.json: info of {list(info)}, delays {delays}")


# the JAX CLI's generate-fixture forms whose output's SHA-256 is committed
# (generate_fixture.json): chip_smoke.py runs the port's generate-fixture
# on the card's host, which has no JAX, and holds its bytes to these
GENERATE_FIXTURE = (
    ["--kind", "modular", "--size", "64x64", "--seed", "0"],
    ["--kind", "modular", "--grayscale", "--size", "256x192", "--seed", "5"],
    ["--kind", "vardct", "--size", "256x192", "--seed", "5"],
)


def write_generate_fixture() -> None:
    """generate_fixture.json: for each of GENERATE_FIXTURE, the arguments
    and the SHA-256 and length of the file the JAX CLI writes."""
    import contextlib
    import hashlib
    import io
    import json
    import tempfile

    from jxl_oxide_tpu import cli

    forms = []
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "g.jxl")
        for args in GENERATE_FIXTURE:
            with contextlib.redirect_stderr(io.StringIO()):
                assert cli.main(["generate-fixture", "-o", out, *args]) == 0
            with open(out, "rb") as f:
                data = f.read()
            forms.append({"args": list(args), "bytes": len(data),
                          "sha256": hashlib.sha256(data).hexdigest()})
    with open(os.path.join(OUT_DIR, "generate_fixture.json"), "w") as f:
        json.dump({"forms": forms}, f, indent=1)
        f.write("\n")
    print(f"generate_fixture.json: {len(forms)} forms")


def fixtures() -> dict:
    """name -> a function that makes the stream."""
    from encoder import encode_jxl_modular
    from encoder_vardct import encode_jxl_vardct

    return {
        # the flagship stream (bench.py:385-387)
        "flagship_1024": lambda: encode_jxl_vardct(
            smooth_rgb(1024, 1024, seed=9), gabor=True, epf_iters=2),
        # a progressive stream: three passes (HF coefficients shifted by 2,
        # then 1, then none), gaborish + 2 EPF passes, 16 groups
        "passes3_1024": lambda: encode_jxl_vardct(
            smooth_rgb(1024, 1024, 56), gabor=True, epf_iters=2,
            num_passes=3, pass_shifts=[2, 1],
            pass_downsample=[(4, 0), (2, 1)]),
        # bench.py vardct_epf3: 3 EPF passes, step 0 included
        "epf3_512": lambda: encode_jxl_vardct(smooth_rgb(512, 512, 2),
                                              epf_iters=3),
        "mixed_512": mixed_512,
        # bench.py vardct_420 (bench.py:87-111), unchanged: 4:2:0 at the
        # flagship's geometry, 20 % non-zero, gaborish + 2 EPF passes
        "ycbcr420_1024": lambda: ycbcr_stream(1024, 1024, (0, 1, 0), 4, 0.2,
                                              gabor=True, epf_iters=2),
        "ycbcr422_256": lambda: ycbcr_stream(256, 256, (0, 2, 0), 8, 0.2,
                                             gabor=True, epf_iters=2),
        # the flagship and 4:2:2 recipes at other seeds: stacked with the
        # fixtures above, two different images in one program
        "flagship_1024_s1": lambda: encode_jxl_vardct(
            smooth_rgb(1024, 1024, seed=27), gabor=True, epf_iters=2),
        "ycbcr422_256_s1": lambda: ycbcr_stream(256, 256, (0, 2, 0), 28, 0.2,
                                                gabor=True, epf_iters=2),
        "staged_1030": staged_1030,
        # lossless Modular at the size where the device tail engages (a
        # transformed plane of 2^20 samples): channel 0 squeezed
        # horizontally, YCoCg RCT, gaborish + 2 EPF passes. About 3 MB:
        # the in-repo encoder spends about 8 bits a sample on any content
        "modular_1024": lambda: encode_jxl_modular(
            smooth_u8(1024, 1024, 10), bit_depth=8, squeeze=True, rct=True,
            gabor=True, epf_iters=2),
        # lossless XYB Modular under the gate (the host tail), no filters
        "modular_xyb_512": lambda: encode_jxl_modular(
            smooth_u8(512, 512, 11), bit_depth=8, xyb=True, squeeze=True),
        # the flagship recipe with an 8-bit alpha: fused 4:4:4 + alpha
        # (the alpha's sub-streams inside the HF sections)
        "flagship_alpha_1024": lambda: flagship_alpha(9, 20),
        # three more 1024^2 alpha streams, other seeds: one stacked group
        # of four with flagship_alpha_1024 in chip_smoke.py's serving phase
        "flagship_alpha_1024_s1": lambda: flagship_alpha(21, 22),
        "flagship_alpha_1024_s2": lambda: flagship_alpha(23, 24),
        "flagship_alpha_1024_s3": lambda: flagship_alpha(25, 26),
        # lossless Modular with an 8-bit alpha (the host tail), no filters
        "modular_alpha_512": lambda: encode_jxl_modular(
            smooth_u8(512, 512, 12) + [smooth_alpha(512, 512, 13)],
            bit_depth=8, extra_alpha=True),
        # EXIF orientation 6 on a non-square frame (coded 512 wide, 384
        # high; displayed 384 x 512), gaborish + 2 EPF passes
        "orient6_512x384": lambda: encode_jxl_vardct(
            smooth_rgb(384, 512, 14), gabor=True, epf_iters=2,
            orientation=6),
        # bench.py animation_4f_blend: four full-canvas Replace keyframes
        # (animation_blend defaults to False: no blending, no slots)
        "animation_4f_blend": lambda: encode_jxl_modular(
            animation_4f_frames()[0], bit_depth=8,
            animation_frames=animation_4f_frames()),
        "anim_blend_epf_512": anim_blend_epf_512,
        "patch_alpha_256": patch_alpha_256,
        # a 77x45 frame cropped onto a 96x64 canvas at (-5, 9), gaborish +
        # 2 EPF passes: EPF on a plane narrower than one 64x64 tile, with
        # W % 4 != 0
        "crop_epf_77x45": lambda: encode_jxl_modular(
            smooth_u8(45, 77, 44), bit_depth=8, image_size=(64, 96),
            crop=(-5, 9, 77, 45), gabor=True, epf_iters=2),
        # colour encodings: greyscale with the squeeze on the device tail
        # and K1 on its plane cloned to three
        "grey_squeeze_2048x1024": grey_squeeze,
        # the modular_alpha_512 recipe with one colour channel (and LZ77
        # runs, as the colour fixtures above): host tail
        "grey_alpha_512": lambda: encode_jxl_modular(
            [smooth_u8(512, 512, 32)[0], smooth_alpha(512, 512, 33)],
            bit_depth=8, grayscale=True, extra_alpha=True, lz77_rle=True),
        "modular_wp_256": modular_wp_256,
        # XYB mastered at 4000 nits: tone-mapped to sRGB, K1 on 1024^2
        "xyb_hdr_1024": lambda: xyb_hdr(1024, False),
        # the same at 256^2, relative to the display's peak (detect_peak)
        "xyb_hdr_peak_256": lambda: xyb_hdr(256, True),
        "icc_p3_512": icc_p3_512,
        # the rest of the render pipeline: splines, noise and x2
        # upsampling of a filtered frame (K1 2, K12 1)
        "features_up2_1024": features_up2_1024,
        # an LF frame, then the main frame on its LF: the fused 4:4:4
        # program with the LF override, gaborish + 2 EPF passes
        "lf_frame_1024": lambda: encode_jxl_vardct(
            smooth_rgb(1024, 1024, 52), gabor=True, epf_iters=2,
            use_lf_frame=True),
        # a two-level LF chain (an LF frame on an LF frame), XYB
        "lf_chain_xyb_512": lambda: encode_jxl_vardct(
            smooth_rgb(512, 512, 53), use_lf_frame=True, lf_levels=2,
            xyb=True),
        # an alpha at a quarter of the resolution (dim_shift 2): K10 x4
        # on the alpha. One 512^2 group: tools/encoder.py lays a shifted
        # channel out over unshifted groups, which decoders refuse once a
        # frame has several
        # every extra-channel kind on the device tail (K9, K1 on the
        # colour, an f16 alpha out of the tail, a spot colour)
        "ec_mix_1024": ec_mix_1024,
        # premultiplied blending over alpha channel 1 (K1 2 a frame)
        "ec_blend_premul_512": ec_blend_premul_512,
        # a container with metadata boxes and a jbrd box: the front ends'
        # aux accessors and JPEG reconstruction
        "jbrd_container_256": jbrd_container_256,
        # wide frames for the sharded decode: one group row and four group
        # columns, so a mesh shards them by COLUMN bands; the flagship
        # recipe (gaborish + 2 EPF passes) and the 4:2:0 recipe of
        # ycbcr420_1024 (the chroma upsample's halo along columns)
        "wide_epf_1024x256": lambda: encode_jxl_vardct(
            smooth_rgb(256, 1024, 80), gabor=True, epf_iters=2),
        "wide_420_1024x256": lambda: ycbcr_stream(256, 1024, (0, 1, 0), 81,
                                                  0.2, gabor=True,
                                                  epf_iters=2),
        # the two layouts of ROADMAP item 7. 4:4:4 YCbCr VarDCT with
        # adaptive LF smoothing (its region renders whole), gaborish + 2
        # EPF passes, 16 groups: the multi-group encoder spliced
        "ycbcr444_1024": lambda: ycbcr444_tiled(
            1024, 1024, 91, 0.2, gabor=True, epf_iters=2,
            skip_lf_smoothing=False),
        # one group, LF smoothing skipped (the single-group encoder's): a
        # region takes the rect program
        "ycbcr444_256": lambda: ycbcr_stream(256, 256, (0, 0, 0), 92, 0.2,
                                             gabor=True, epf_iters=2),
        # lossless 4:2:0 YCbCr Modular, one 1024^2 group: Y's 2^20 samples
        # open the device tail's gate, and K9 runs on the squeeze of
        # channel 0 (Cb, 512^2); gaborish + 2 EPF passes on the upsampled
        # planes, LZ77 runs
        "modular_420_1024": lambda: modular_ycbcr(
            1024, 1024, (0, 1, 0), 90, squeeze=True, gabor=True,
            epf_iters=2, group_size_shift=3, lz77_rle=True)[0],
        "alpha_shift_512": lambda: encode_jxl_modular(
            smooth_u8(512, 512, 54) + [smooth_alpha(128, 128, 55)],
            bit_depth=8, extra_alpha=True, alpha_dim_shift=2,
            group_size_shift=2, lz77_rle=True),
    }


def reference(data: bytes, extra: bool = False) -> dict:
    """The JAX package's keyframe 0, or every keyframe stacked when the
    stream has several: {"u8": to_u8()}, and with `extra` {"extra": the
    extra channels of image_all_channels()}."""
    from jxl_oxide_tpu import JxlImage

    img = JxlImage.from_bytes(data)
    renders = [img.render_frame(k) for k in range(img.num_keyframes)]
    ncolor = len(renders[0].planes)
    out = {"u8": [r.to_u8() for r in renders]}
    if extra:
        out["extra"] = [np.asarray(r.image_all_channels())[..., ncolor:]
                        for r in renders]
    return {k: v[0] if len(v) == 1 else np.stack(v) for k, v in out.items()}


def main(names) -> None:
    """Write the fixtures `names` (all of them when empty). The .npz files
    carry the time they were written, so rewrite only what changed."""
    os.makedirs(OUT_DIR, exist_ok=True)
    makers = fixtures()
    for name in names or [*makers, "flagship_1024_requests",
                          *(f"{n}_progressive" for n in PROGRESSIVE),
                          *(f"{n}_roi" for n in ROI), "frontends",
                          "generate_fixture"]:
        if name == "flagship_1024_requests":
            write_requests()
            continue
        if name == "frontends":
            write_frontends()
            continue
        if name == "generate_fixture":
            write_generate_fixture()
            continue
        if name.endswith("_progressive"):
            write_progressive(name[:-len("_progressive")])
            continue
        if name.endswith("_roi"):
            write_roi(name[:-len("_roi")])
            continue
        data = makers[name]()
        with open(os.path.join(OUT_DIR, f"{name}.jxl"), "wb") as f:
            f.write(data)
        if name in STREAM_ONLY:
            print(f"{name}: {len(data)} B stream")
            continue
        ref = (write_jbrd_reference(data) if name == "jbrd_container_256"
               else reference(data, extra=name in EXTRA_CHANNELS))
        np.savez_compressed(os.path.join(OUT_DIR, f"{name}.npz"), **ref)
        print(f"{name}: {len(data)} B stream, "
              + ", ".join(f"{k} {v.shape}" for k, v in ref.items()))


if __name__ == "__main__":
    main(sys.argv[1:])
