"""The port's encoders (jxl_oxide_tpu_torch/encoders/, numpy only) against
tools/encoder.py and tools/encoder_vardct.py, byte for byte: the JAX
CLI's three generate-fixture forms at two sizes and seeds, through both
CLIs in process and once through `python -m jxl_oxide_tpu_torch
generate-fixture` in a subprocess; and every recipe of
tools/make_torch_port_fixtures.py at a size of at most 256^2 (the
multi-group encoder's at 64 or 128 x 320, the least it takes: two
groups), the XYB legs included: `_srgb_to_linear` in float32 numpy is
within one ulp of the JAX package's jnp version, and the streams' bytes
are the same.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import torch_parity as tp  # puts tools/ on the path: keep it first
import encoder as tools_enc  # noqa: I001
import encoder_vardct as tools_encv
from jxl_oxide_tpu_torch.encoders import encoder as port_enc
from jxl_oxide_tpu_torch.encoders import encoder_vardct as port_encv
from jxl_oxide_tpu_torch.models.vardct import TransformType as T
from jxl_oxide_tpu_torch.models.vardct import jpeg_shifts
from make_torch_port_fixtures import (
    MIXED_TYPES,
    STAGED_TYPES,
    feature_splines,
    smooth_alpha,
    smooth_f16,
    smooth_rgb,
    smooth_u8,
    unchecked_modular_encoder,
)
from test_parallel import _random_varblock_grid

GF_FORMS = [["--kind", "modular"], ["--kind", "modular", "--grayscale"],
            ["--kind", "vardct"]]
GF_SIZES = [("64x64", 0), ("96x40", 7)]


def _generate(cli, tmp_path, tag, args) -> bytes:
    out = tmp_path / f"{tag}.jxl"
    assert cli.main(["generate-fixture", "-o", str(out), *args]) == 0
    return out.read_bytes()


@pytest.mark.parametrize("size,seed", GF_SIZES)
@pytest.mark.parametrize("form", GF_FORMS, ids=["modular", "grey", "vardct"])
def test_generate_fixture_writes_the_jax_clis_bytes(form, size, seed,
                                                    tmp_path):
    from jxl_oxide_tpu import cli as jax_cli
    from jxl_oxide_tpu_torch import cli as port_cli

    args = [*form, "--size", size, "--seed", str(seed)]
    want = _generate(jax_cli, tmp_path, "jax", args)
    got = _generate(port_cli, tmp_path, "port", args)
    assert len(got) > 0 and got == want


def test_generate_fixture_as_a_module(tmp_path):
    """`python -m jxl_oxide_tpu_torch generate-fixture` in a process of
    its own writes the JAX CLI's file (tests/test_torch_isolation.py
    holds that the port's encoders load no JAX module)."""
    from jxl_oxide_tpu import cli as jax_cli

    args = ["--kind", "vardct", "--size", "48x32", "--seed", "3"]
    out = tmp_path / "module.jxl"
    res = subprocess.run(
        [sys.executable, "-m", "jxl_oxide_tpu_torch", "generate-fixture",
         "-o", str(out), *args], cwd=tmp_path,
        env=dict(os.environ, PYTHONPATH=tp.REPO), capture_output=True,
        text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert out.read_bytes() == _generate(jax_cli, tmp_path, "jax", args)


def _tiled(encv, h, w, seed, types, *, alpha=None, **kw):
    """make_torch_port_fixtures.py's tiled recipes (mixed_512,
    staged_1030, flagship_alpha): random varblocks, sparse coefficients,
    random LF and sharpness."""
    rng = np.random.default_rng(seed)
    bh, bw = h // 8, w // 8
    sel, mul = _random_varblock_grid(bh, bw, rng,
                                     [getattr(T, n) for n in types])
    coeff = rng.integers(-15, 16, (3, h, w)).astype(np.int64)
    coeff[rng.random((3, h, w)) < 0.95] = 0
    lf_q = rng.integers(-60, 61, (3, bh, bw)).astype(np.int64)
    sharp = rng.integers(0, 8, (bh, bw)).astype(np.int64)
    return encv.encode_jxl_vardct_tiled(h, w, sel, mul, coeff, lf_q,
                                        sharpness=sharp, alpha=alpha, **kw)


def _ycbcr(encv, h, w, ups, seed, **kw):
    """make_torch_port_fixtures.py ycbcr_stream: the single-group encoder
    up to 256^2, the multi-group one above."""
    rng = np.random.default_rng(seed)
    bh, bw = h // 8, w // 8
    coeff, lf = [], []
    for hs, vs in jpeg_shifts(ups):
        sh = (h >> vs, w >> hs)
        cp = np.zeros(sh, dtype=np.int64)
        m = rng.random(sh) < 0.2
        cp[m] = rng.integers(-10, 11, int(m.sum()))
        coeff.append(cp)
        lf.append(rng.integers(-60, 61, (bh >> vs, bw >> hs)).astype(np.int64))
    if h <= 256 and w <= 256:
        return encv.encode_jxl_vardct_420(h, w, coeff, lf,
                                          jpeg_upsampling=ups, **kw)
    sel = np.full((bh, bw), int(T.DCT8), dtype=np.int64)
    return encv.encode_jxl_vardct_tiled(
        h, w, sel, np.ones((bh, bw), dtype=np.int64), coeff, lf,
        jpeg_upsampling=ups, **kw)


def _jbrd_codestream(encv):
    """jbrd_container_256's codestream recipe at 64^2: Raw quant matrices
    and integer chroma-from-luma factors."""
    rng = np.random.default_rng(70)
    h = w = 64
    coeff = np.zeros((3, h, w), dtype=np.int64)
    live = rng.random((3, h, w)) < 0.15
    coeff[live] = rng.integers(-9, 10, int(live.sum()))
    coeff[:, ::8, ::8] = 0
    cfl = (rng.integers(-12, 13, (1, 1)), rng.integers(-12, 13, (1, 1)))
    return encv.encode_jxl_vardct_mixed(
        h, w, np.zeros((8, 8), dtype=np.int64), np.ones((8, 8), np.int64),
        coeff, rng.integers(-40, 41, (3, 8, 8)),
        raw_dct8=(1.0 / 2040.0, rng.integers(6, 40, (3, 8, 8))),
        cfl_grids=cfl)


def _wp(enc):
    """modular_wp_256's custom-tree recipe at 32^2 (the weighted
    predictor's tokens from tests/test_roundtrip.py _RefWp)."""
    from test_roundtrip import _RefWp

    rng = np.random.default_rng(13)
    n = 32
    a = rng.integers(0, 32, (n, n)).astype(np.int64) * 8
    wp_state = _RefWp(n)
    toks = []
    for y in range(n):
        for x in range(n):
            W = int(a[y, x - 1]) if x > 0 else (int(a[y - 1, 0]) if y else 0)
            N = int(a[y - 1, x]) if y > 0 else W
            NW = int(a[y - 1, x - 1]) if (x > 0 and y > 0) else W
            NE = int(a[y - 1, x + 1]) if (y > 0 and x + 1 < n) else N
            NN = int(a[y - 2, x]) if y >= 2 else N
            v = int(a[y, x]) - ((wp_state.predict(N, NW, NE, W, NN) + 3) >> 3)
            toks.append((v << 1) if v >= 0 else (-(v << 1) - 1))
            wp_state.record(int(a[y, x]))
    return enc.encode_jxl_modular([a], bit_depth=8, grayscale=True,
                                  custom_tree=([0, 6, 0, 0, 0], 1,
                                               lambda _c: list(toks)))


def _icc(enc):
    from jxl_oxide_tpu_torch.color.synthesize import colour_encoding_to_icc
    from jxl_oxide_tpu_torch.headers.image import (
        ColourEncoding,
        Primaries,
        RenderingIntent,
    )

    icc = colour_encoding_to_icc(ColourEncoding(
        primaries=Primaries.P3, rendering_intent=RenderingIntent.PERCEPTUAL))
    return enc.encode_jxl_modular(smooth_u8(64, 64, 35), bit_depth=8,
                                  embed_icc=icc, lz77_rle=True)


def _subsampled_modular(enc):
    planes = [p[::1 << vs, ::1 << hs] for p, (hs, vs)
              in zip(smooth_u8(64, 72, 71), jpeg_shifts((0, 1, 0)))]
    return unchecked_modular_encoder(enc).encode_jxl_modular(
        planes, bit_depth=8, do_ycbcr=True, jpeg_upsampling=(0, 1, 0),
        image_size=(64, 72), squeeze=True, gabor=True, epf_iters=2)


def _frames(n, seed, alphas=0, size=64):
    return [smooth_u8(size, size, seed + 3 * k)
            + [smooth_alpha(size, size, seed + 3 * k + 1 + a)
               for a in range(alphas)] for k in range(n)]


# fixture name -> its recipe at a small size, given (encoder,
# encoder_vardct)
RECIPES = {
    "flagship_1024": lambda e, v: v.encode_jxl_vardct(
        smooth_rgb(128, 128, 9), gabor=True, epf_iters=2),
    "passes3_1024": lambda e, v: v.encode_jxl_vardct(
        smooth_rgb(128, 128, 56), gabor=True, epf_iters=2, num_passes=3,
        pass_shifts=[2, 1], pass_downsample=[(4, 0), (2, 1)]),
    "epf3_512": lambda e, v: v.encode_jxl_vardct(smooth_rgb(128, 128, 2),
                                                 epf_iters=3),
    "mixed_512": lambda e, v: _tiled(v, 128, 320, 5, MIXED_TYPES,
                                     gabor=True, epf_iters=2),
    "ycbcr420_1024": lambda e, v: _ycbcr(v, 64, 320, (0, 1, 0), 4,
                                         gabor=True, epf_iters=2),
    "ycbcr422_256": lambda e, v: _ycbcr(v, 128, 128, (0, 2, 0), 8,
                                        gabor=True, epf_iters=2),
    "ycbcr444_256": lambda e, v: _ycbcr(v, 128, 128, (0, 0, 0), 92,
                                        gabor=True, epf_iters=2),
    "ycbcr444_1024": lambda e, v: _ycbcr(v, 64, 320, (0, 0, 0), 91,
                                         gabor=True, epf_iters=2,
                                         skip_lf_smoothing=False),
    "staged_1030": lambda e, v: _tiled(v, 128, 320, 6, STAGED_TYPES,
                                       gabor=True, epf_iters=2),
    "modular_1024": lambda e, v: e.encode_jxl_modular(
        smooth_u8(128, 128, 10), bit_depth=8, squeeze=True, rct=True,
        gabor=True, epf_iters=2),
    "modular_420_1024": lambda e, v: _subsampled_modular(e),
    "modular_xyb_512": lambda e, v: e.encode_jxl_modular(
        smooth_u8(64, 64, 11), bit_depth=8, xyb=True, squeeze=True),
    "flagship_alpha_1024": lambda e, v: _tiled(
        v, 64, 320, 20, ["DCT8"], alpha=smooth_alpha(64, 320, 20),
        global_scale=512, gabor=True, epf_iters=2),
    "modular_alpha_512": lambda e, v: e.encode_jxl_modular(
        smooth_u8(64, 64, 12) + [smooth_alpha(64, 64, 13)], bit_depth=8,
        extra_alpha=True),
    "orient6_512x384": lambda e, v: v.encode_jxl_vardct(
        smooth_rgb(48, 64, 14), gabor=True, epf_iters=2, orientation=6),
    "animation_4f_blend": lambda e, v: e.encode_jxl_modular(
        _frames(4, 7)[0], bit_depth=8, animation_frames=_frames(4, 7)),
    "anim_blend_epf_512": lambda e, v: e.encode_jxl_modular(
        _frames(3, 30, 1)[0], bit_depth=8, extra_alpha=True,
        animation_frames=_frames(3, 30, 1), animation_blend=True, gabor=True,
        epf_iters=2),
    "patch_alpha_256": lambda e, v: e.encode_jxl_modular(
        smooth_u8(64, 64, 40) + [smooth_alpha(64, 64, 41)], bit_depth=8,
        extra_alpha=True, reference_patch=(
            smooth_u8(64, 64, 42) + [smooth_alpha(64, 64, 43)],
            dict(ref_idx=0, x0=4, y0=6, width=25, height=22, x=15, y=17,
                 mode=4, ec_modes=[4], clamp=False))),
    "crop_epf_77x45": lambda e, v: e.encode_jxl_modular(
        smooth_u8(45, 77, 44), bit_depth=8, image_size=(64, 96),
        crop=(-5, 9, 77, 45), gabor=True, epf_iters=2),
    "grey_squeeze_2048x1024": lambda e, v: e.encode_jxl_modular(
        [smooth_u8(64, 128, 30)[0]], bit_depth=8, grayscale=True,
        squeeze=True, gabor=True, epf_iters=2, lz77_rle=True),
    "grey_alpha_512": lambda e, v: e.encode_jxl_modular(
        [smooth_u8(64, 64, 32)[0], smooth_alpha(64, 64, 33)], bit_depth=8,
        grayscale=True, extra_alpha=True, lz77_rle=True),
    "modular_wp_256": lambda e, v: _wp(e),
    "xyb_hdr_1024": lambda e, v: e.encode_jxl_modular(
        smooth_u8(64, 64, 31), bit_depth=8, xyb=True,
        tone_mapping=(4000.0, 0.0, False, 0.0), gabor=True, epf_iters=2,
        lz77_rle=True),
    "icc_p3_512": lambda e, v: _icc(e),
    "features_up2_1024": lambda e, v: e.encode_jxl_modular(
        smooth_u8(128, 128, 50), bit_depth=8, image_size=(256, 256),
        upsampling=2, group_size_shift=1, gabor=True, epf_iters=2,
        noise_lut=[0.2, 0.3, 0.4, 0.5, 0.5, 0.4, 0.3, 0.2],
        splines_spec=(feature_splines(51), 2), lz77_rle=True),
    "lf_frame_1024": lambda e, v: v.encode_jxl_vardct(
        smooth_rgb(128, 128, 52), gabor=True, epf_iters=2,
        use_lf_frame=True),
    "lf_chain_xyb_512": lambda e, v: v.encode_jxl_vardct(
        smooth_rgb(128, 128, 53), use_lf_frame=True, lf_levels=2, xyb=True),
    "alpha_shift_512": lambda e, v: e.encode_jxl_modular(
        smooth_u8(128, 128, 54) + [smooth_alpha(32, 32, 55)], bit_depth=8,
        extra_alpha=True, alpha_dim_shift=2, group_size_shift=2,
        lz77_rle=True),
    "ec_mix_1024": lambda e, v: e.encode_jxl_modular(
        smooth_u8(64, 64, 60)
        + [smooth_alpha(64, 64, 61), smooth_alpha(64, 64, 62),
           smooth_f16(64, 64, 63), smooth_alpha(64, 64, 64)],
        bit_depth=8, extra_alpha=True, spot_colour=(1.0, 0.0, 0.0, 0.5),
        extra_channel_specs=[{"ty": 0, "bits": 16, "float_exp_bits": 5},
                             {"ty": 1, "name": "depth"}],
        squeeze=True, gabor=True, epf_iters=2, lz77_rle=True),
    "ec_blend_premul_512": lambda e, v: e.encode_jxl_modular(
        _frames(3, 65, 2)[0], bit_depth=8, extra_alpha=True,
        extra_channel_specs=[{"ty": 0, "alpha_associated": True}],
        animation_frames=_frames(3, 65, 2),
        animation_blend={"mode": 2, "alpha_channel": 1}, gabor=True,
        epf_iters=2, lz77_rle=True),
    "jbrd_container_256": lambda e, v: _jbrd_codestream(v),
    "xyb_gabor_epf2": lambda e, v: v.encode_jxl_vardct(
        smooth_rgb(64, 72, 2), xyb=True, gabor=True, epf_iters=2),
}


@pytest.mark.parametrize("name", list(RECIPES))
def test_recipe_bytes_equal_the_tools_encoders(name):
    want = RECIPES[name](tools_enc, tools_encv)
    got = RECIPES[name](port_enc, port_encv)
    assert len(got) > 0 and got == want


def test_the_encoders_import_no_jax():
    """Besides tests/test_torch_isolation.py's scan: nothing of the JAX
    package in the port encoders' globals."""
    for mod in (port_enc, port_encv):
        assert not [k for k, v in vars(mod).items()
                    if getattr(v, "__module__", "") and str(
                        getattr(v, "__module__", "")).startswith(
                            ("jax", "jxl_oxide_tpu."))]


def test_srgb_to_linear_within_an_ulp_of_the_jax_packages():
    """The XYB leg's sRGB -> linear: float32 numpy against the JAX
    package's jnp, over every 8-bit level and seeded floats. XLA's pow
    and numpy's differ by one ulp on about a fifth of the samples (the
    streams' bytes do not: the quantizer absorbs it, and the XYB recipes
    above are held byte for byte)."""
    from jxl_oxide_tpu.ops.color import srgb_to_linear

    v = np.concatenate([np.arange(256, dtype=np.float32) / 255,
                        np.random.default_rng(0).random(4096).astype(
                            np.float32) * 2 - 0.5])
    np.testing.assert_array_max_ulp(port_encv._srgb_to_linear(v),
                                    np.asarray(srgb_to_linear(v)), maxulp=1)


def test_generate_fixture_matches_the_committed_digests(tmp_path):
    """The port's generate-fixture against generate_fixture.json, the
    SHA-256 of the JAX CLI's output that chip_smoke.py holds the card's
    host to (tools/make_torch_port_fixtures.py GENERATE_FIXTURE)."""
    import hashlib
    import json

    from jxl_oxide_tpu_torch import cli as port_cli

    with open(os.path.join(tp.TESTDATA, "generate_fixture.json")) as f:
        forms = json.load(f)["forms"]
    assert len(forms) == 3
    for k, form in enumerate(forms):
        data = _generate(port_cli, tmp_path, f"form{k}", form["args"])
        assert len(data) == form["bytes"]
        assert hashlib.sha256(data).hexdigest() == form["sha256"]
