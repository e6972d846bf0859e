"""Shared inputs of the port's parity tests (tests/test_torch_*.py).

Each helper gives the same stream, or the same seeded arrays, to the JAX
package (the reference) and to jxl_oxide_tpu_torch on the CPU; the test
files compare what comes out. Streams come from the in-repo encoders,
used as they are.
"""

from __future__ import annotations

import os
import struct
import sys
import zlib

import numpy as np

from jxl_oxide_tpu_torch.models.vardct import TransformType as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(REPO, "jxl_oxide_tpu_torch", "testdata")
FIXTURES = ("flagship_1024", "epf3_512", "mixed_512", "ycbcr420_1024",
            "ycbcr422_256", "staged_1030")
# the fixtures that take the fused 4:4:4 program
FUSED_FIXTURES = FIXTURES[:3]
# lossless Modular: modular_1024 takes the device tail on CUDA, with
# gaborish and 2 EPF passes; modular_xyb_512 the host tail
MODULAR_FIXTURES = ("modular_1024", "modular_xyb_512")
# the colour fixtures: (name, exact on the CPU, K1 launches, K9 launches on
# the card): grey with its squeeze on the device tail and K1 on its plane
# cloned to three; grey + alpha and bench.py's modular_wp on the host tail;
# XYB mastered at 4000 nits, tone-mapped (at 256^2 relative to its peak);
# an embedded Display P3 profile
COLOR_FIXTURES = (("grey_squeeze_2048x1024", False, 2, 1),
                  ("grey_alpha_512", True, 0, 0),
                  ("modular_wp_256", True, 0, 0),
                  ("xyb_hdr_1024", False, 2, 0),
                  ("xyb_hdr_peak_256", False, 2, 0),
                  ("icc_p3_512", False, 0, 0))
# the render pipeline's fixtures: (name, K1 launches, K12 launches) of one
# decode on the card: splines, noise and x2 upsampling of a filtered
# 512^2 frame; an LF frame under a filtered 1024^2 frame (the fused path's
# LF override); a two-level XYB LF chain; an alpha at dim_shift 2
FEATURE_FIXTURES = (("features_up2_1024", 2, 1), ("lf_frame_1024", 2, 0),
                    ("lf_chain_xyb_512", 0, 0), ("alpha_shift_512", 0, 0))
# the progressive fixtures: (name, K1 launches, least K9 launches) of one
# loading render on the card, fed at the cuts of <name>_progressive.npz
PROGRESSIVE_FIXTURES = (("flagship_1024", 2, 0), ("passes3_1024", 2, 0),
                        ("modular_1024", 2, 1))
# the extra-channel fixtures (their .npz hold "extra" too): (name, K1
# launches, K9 launches of one render_frame on the card, keyframes);
# ec_mix_1024's squeeze runs on the device tail, with an f16 alpha in it
EC_FIXTURES = (("ec_mix_1024", 2, 1, 1), ("ec_blend_premul_512", 6, 0, 3))
# the fixtures whose region renders are committed (<name>_roi.npz)
ROI_FIXTURES = ("flagship_1024", "ycbcr420_1024", "orient6_512x384",
                "modular_1024")
# flagship_1024 under each requested encoding (flagship_1024_requests.npz):
# the u16 bound of the PQ and HLG renders, in LSB of 65535 (measured on the
# CPU: 1; chip_smoke.py holds the card's renders to it)
REQUEST_U16_TOL = 1
# jpeg_upsampling of the chroma layouts 4:2:0, 4:2:2 and 4:4:0
CHROMA = {"420": (0, 1, 0), "422": (0, 2, 0), "440": (0, 3, 0)}
for _p in (os.path.join(REPO, "tools"), REPO):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def smooth_rgb(h: int, w: int, seed: int = 0, block: int = 8) -> np.ndarray:
    """bench.py::_smooth_rgb: piecewise-constant 8x8 random colour."""
    rng = np.random.default_rng(seed)
    small = rng.random((h // block + 1, w // block + 1, 3)).astype(np.float32)
    img = np.kron(small, np.ones((block, block, 1), dtype=np.float32))[:h, :w]
    return np.clip(img, 0, 1)


def vardct_stream(h: int = 64, w: int = 64, seed: int = 0, **kw) -> bytes:
    """A DCT8 VarDCT stream of a smooth random image (encode_jxl_vardct)."""
    from encoder_vardct import encode_jxl_vardct

    return encode_jxl_vardct(smooth_rgb(h, w, seed), **kw)


def tiled_stream(h: int, w: int, seed: int, types, cfl: bool = False,
                 **kw) -> bytes:
    """A multi-group stream with random varblocks of `types`, random
    sparse coefficients and, with cfl, per-64x64-tile chroma-from-luma
    grids (encode_jxl_vardct_tiled)."""
    from encoder_vardct import encode_jxl_vardct_tiled
    from test_parallel import _random_varblock_grid

    rng = np.random.default_rng(seed)
    bh, bw = -(-h // 8), -(-w // 8)
    sel, mul = _random_varblock_grid(bh, bw, rng, list(types))
    coeff = rng.integers(-15, 16, (3, 8 * bh, 8 * bw)).astype(np.int64)
    coeff[rng.random(coeff.shape) < 0.9] = 0
    lf_q = rng.integers(-60, 61, (3, bh, bw)).astype(np.int64)
    if cfl:
        h64, w64 = -(-h // 64), -(-w // 64)
        kw["cfl_grids"] = (
            rng.integers(-40, 41, (h64, w64)).astype(np.int64),
            rng.integers(-40, 41, (h64, w64)).astype(np.int64),
        )
    if kw.get("epf_iters"):
        kw.setdefault("sharpness",
                      rng.integers(0, 8, (bh, bw)).astype(np.int64))
    return encode_jxl_vardct_tiled(h, w, sel, mul, coeff, lf_q, **kw)


# transform types of the mixed streams: the 8x8 specials and DCTs of up to
# 32 px a side, which keep the dense plan well under its 96 entries
MIXED = [T.DCT8, T.DCT2, T.DCT4, T.HORNUSS, T.DCT16, T.DCT32, T.DCT16X8,
         T.DCT8X16, T.DCT4X8, T.DCT8X4, T.AFV0, T.AFV1, T.AFV2, T.AFV3,
         T.DCT32X16, T.DCT8X32]

def ycbcr_stream(h: int, w: int, ups, seed: int = 0, density: float = 0.15,
                 **kw) -> bytes:
    """A chroma-subsampled YCbCr DCT8 stream: bench.py's vardct_420
    recipe at any size and layout (tools/make_torch_port_fixtures.py)."""
    from make_torch_port_fixtures import ycbcr_stream as make

    return make(h, w, ups, seed, density, **kw)


def overflow_stream(h: int = 256, w: int = 262, seed: int = 7,
                    **kw) -> bytes:
    """A multi-group stream of MIXED and the 64-px transforms, the
    staged_1030 fixture's types. Its dense plan has about 40 entries at
    256x262: tests that need the staged path lower the cap."""
    return tiled_stream(h, w, seed, types=MIXED + [T.DCT64, T.DCT64X32,
                                                   T.DCT32X64], **kw)


# the parity streams, made on demand: (xyb or not) x (filters off, gabor +
# EPF 1-2, EPF 0-2) x (constant or per-tile CfL) x (LF smoothing on/off)
STREAMS = {
    "dct8": lambda: vardct_stream(61, 75, 1),
    "xyb_gabor_epf2": lambda: vardct_stream(
        64, 72, 2, xyb=True, gabor=True, epf_iters=2),
    "tiled_cfl_smooth_epf3": lambda: tiled_stream(
        128, 320, 3, types=MIXED, cfl=True, skip_lf_smoothing=False,
        gabor=True, epf_iters=3),
    "two_passes": lambda: vardct_stream(64, 64, 5, num_passes=2),
}


def colour_encoding(image, space: str, prim: str = "srgb", tf: str = "srgb",
                    intent: str = "RELATIVE", white: str = "d65"):
    """A ColourEncoding of `image`, a headers.image module (the JAX
    package's or the port's: their classes do not compare equal across
    packages), by names; tf "gamma" is gamma 2.2 (a coded exponent of
    1/2.2, in units of 1e-7)."""
    TF = image.TransferFunction
    tfv = (TF("gamma", gamma=4545455, gamma_inverted=True) if tf == "gamma"
           else TF(tf))
    return image.ColourEncoding(
        colour_space=getattr(image.ColourSpace, space),
        white_point=image.WhitePoint(white), primaries=image.Primaries(prim),
        tf=tfv, rendering_intent=getattr(image.RenderingIntent, intent))


def epf_inputs(shape, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Planes [3, H, W] and sigma [H, W] on which an EPF pass really
    filters. Values sit near 0.5 with per-row noise amplitudes from 1e-4
    to 1e-1: on uniform noise in [0, 1) every tap weight is 0 and the
    pass is the identity. sigma spans the < 0.3 passthrough (exact zeros
    included) and filtered pixels."""
    rng = np.random.default_rng(seed)
    amp = 10.0 ** rng.uniform(-4, -1, (1, shape[1], 1))
    planes = (0.5 + rng.random(shape) * amp).astype(np.float32)
    sigma = (rng.random(shape[1:]) * 2.0).astype(np.float32)
    sigma[rng.random(shape[1:]) < 0.1] = 0.0
    return planes, sigma


def fixture(name: str) -> tuple[bytes, np.ndarray]:
    """A committed fixture stream and its committed reference u8."""
    with open(os.path.join(TESTDATA, f"{name}.jxl"), "rb") as f:
        data = f.read()
    return data, np.load(os.path.join(TESTDATA, f"{name}.npz"))["u8"]


def jax_host(data: bytes):
    """(VardctFrameState, HfGlobal) of the JAX package's host stage
    (serving._host_stage_fast)."""
    from jxl_oxide_tpu import JxlImage
    from jxl_oxide_tpu.serving import _host_stage_fast

    state, hf_global, _, _ = _host_stage_fast(JxlImage.from_bytes(data), 0)
    return state, hf_global


def torch_host(data: bytes):
    """(VardctFrameState, HfGlobal) of the port's host stage, on the CPU."""
    host = torch_host_stage(data)
    return host.state, host.hf_global


def torch_host_stage(data: bytes):
    """The port's host stage of a one-frame stream's frame, on the CPU
    (render/render.py `host_stage`: the first half of every frame render,
    the device stage the second)."""
    from jxl_oxide_tpu_torch import JxlImage
    from jxl_oxide_tpu_torch.render.render import host_stage

    return host_stage(JxlImage.from_bytes(data, device="cpu")._frames[0])


def jax_parts(data: bytes, rect=None):
    """(key, make_fn, inputs) of the JAX package's fused program."""
    state, hf_global = jax_host(data)
    return state.fused_program_parts(hf_global, rect=rect)


def torch_parts(data: bytes, rect=None):
    """(key, make_fn, inputs) of the port's fused program."""
    state, hf_global = torch_host(data)
    return state.fused_program_parts(hf_global, rect=rect)


def jax_u8(data: bytes) -> np.ndarray:
    from jxl_oxide_tpu import JxlImage

    return JxlImage.from_bytes(data).render_frame(0).to_u8()


def torch_u8(data: bytes) -> np.ndarray:
    from jxl_oxide_tpu_torch import JxlImage

    return JxlImage.from_bytes(data, device="cpu").render_frame(0).to_u8()


def max_lsb(a: np.ndarray, b: np.ndarray) -> int:
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def jax_image(data: bytes):
    """The JAX package's JxlImage of `data`."""
    from jxl_oxide_tpu import JxlImage as JaxImage

    return JaxImage.from_bytes(data)


def assert_keyframes_match(data, exact=True, order=None):
    """Every keyframe of `data` (in `order`, default 0..K-1) from the port
    on the CPU against the JAX package: u8 and the float32 image; alpha
    exactly; exact, or (exact=False: filtered frames, float colour
    transforms) within 1 LSB and 2e-5. Returns the port's JxlImage."""
    from jxl_oxide_tpu_torch import JxlImage

    ref = jax_image(data)
    ours = JxlImage.from_bytes(data, device="cpu")
    assert ours.num_keyframes == ref.num_keyframes
    assert ours.num_frames == ref.num_frames
    for k in order or range(ref.num_keyframes):
        a, b = ours.render_frame(k), ref.render_frame(k)
        u8, want = a.to_u8(), b.to_u8()
        f32, want_f32 = a.image(), np.asarray(b.image())
        if exact:
            np.testing.assert_array_equal(u8, want, err_msg=f"keyframe {k}")
            np.testing.assert_array_equal(f32, want_f32)
        else:
            assert max_lsb(u8, want) <= 1, f"keyframe {k}"
            np.testing.assert_allclose(f32, want_f32, atol=2e-5, rtol=0)
        if u8.shape[-1] == 4:
            np.testing.assert_array_equal(u8[..., 3], want[..., 3])
        assert (a.name, a.duration) == (b.name, b.duration)
    return ours


def read_png(path) -> dict:
    """The chunks of a PNG or APNG written with filter type None: the
    frames' samples ([H, W, C], u8 or u16), the iCCP profile and the
    fcTL delays, decoded with zlib alone."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, frames, cur, delays, icc = 8, [], [], [], None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        assert zlib.crc32(tag + body) == struct.unpack(
            ">I", data[pos + 8 + n:pos + 12 + n])[0]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
        elif tag == b"iCCP":
            icc = zlib.decompress(body[body.index(b"\0") + 2:])
        elif tag == b"fcTL":
            if cur:
                frames.append(b"".join(cur))
                cur = []
            delays.append(struct.unpack(">HH", body[20:24]))
        elif tag == b"IDAT":
            cur.append(body)
        elif tag == b"fdAT":
            cur.append(body[4:])
        pos += 12 + n
    frames.append(b"".join(cur))
    c = {0: 1, 4: 2, 2: 3, 6: 4}[ctype]
    dt = np.dtype(">u2") if depth == 16 else np.dtype(np.uint8)
    out = []
    for raw in frames:
        rows = np.frombuffer(zlib.decompress(raw), np.uint8).reshape(h, -1)
        assert not rows[:, 0].any(), "filter type None"
        out.append(rows[:, 1:].copy().view(dt).reshape(h, w, c)
                   .astype(dt.newbyteorder("=")))
    return {"frames": out, "icc": icc, "delays": delays}
