"""Patches in the port (render/features.py parsing, render/context.py
blending) against the JAX package, on the CPU: a reference-only frame
saved to a slot and patched into the keyframe with every PatchBlendMode,
with and without an alpha channel, and the committed patch_alpha_256
fixture. Patched frames are unfiltered Modular: exact in u8 and in the
float32 image, alpha included.
"""

import numpy as np
import pytest

import torch_parity as tp
from encoder import encode_jxl_modular
from jxl_oxide_tpu_torch import JxlImage


def mode_stream(mode: int) -> bytes:
    """tests/test_oracle.py:416-436: a 32^2 image with an alpha, and a
    reference-only frame (colour and alpha) whose 12x9 rect at (2, 4) is
    patched in at (5, 6) with `mode` on colour and alpha, clamped for odd
    modes."""
    rng = np.random.default_rng(510 + mode)
    h = w = 32
    base = [rng.integers(0, 256, (h, w), dtype=np.int64) for _ in range(3)]
    alpha = rng.integers(0, 256, (h, w), dtype=np.int64)
    ref = [rng.integers(0, 256, (h, w), dtype=np.int64) for _ in range(3)]
    ref_alpha = rng.integers(0, 256, (h, w), dtype=np.int64)
    spec = dict(ref_idx=0, x0=2, y0=4, width=12, height=9, x=5, y=6,
                mode=mode, ec_modes=[mode], clamp=bool(mode & 1))
    return encode_jxl_modular(base + [alpha], bit_depth=8, extra_alpha=True,
                              reference_patch=(ref + [ref_alpha], spec))


@pytest.mark.parametrize("mode", range(8), ids=[
    "none", "replace", "add", "mul", "blend_above", "blend_below",
    "muladd_above", "muladd_below"])
def test_patch_modes_with_alpha(mode):
    img = tp.assert_keyframes_match(mode_stream(mode))
    assert (img.num_frames, img.num_keyframes) == (2, 1)
    assert img._frames[0].header.frame_type.value == 2  # reference-only


@pytest.mark.parametrize("mode", [1, 2], ids=["replace", "add"])
def test_patch_without_alpha(mode):
    """tests/test_features.py:115-160: Replace and Add of a reference-only
    frame's rect, no extra channel; checked against the expected pixels
    as well."""
    rng = np.random.default_rng(3 if mode == 1 else 4)
    hi, size = (256, 32) if mode == 1 else (100, 24)
    base = [rng.integers(0, hi, (size, size)) for _ in range(3)]
    ref = [rng.integers(0, hi, (size, size)) for _ in range(3)]
    spec = (dict(ref_idx=0, x0=2, y0=4, width=10, height=8, x=6, y=5,
                 mode=1) if mode == 1 else
            dict(ref_idx=0, x0=0, y0=0, width=8, height=8, x=4, y=4,
                 mode=2))
    data = encode_jxl_modular(base, bit_depth=8, reference_patch=(ref, spec))
    out = tp.assert_keyframes_match(data).render_frame(0).to_u8()
    if mode == 1:
        want = np.stack([c.astype(np.uint8) for c in base], -1)
        want[5:13, 6:16] = np.stack([c.astype(np.uint8) for c in ref],
                                    -1)[4:12, 2:12]
    else:
        want = np.stack([c.astype(np.float32) / 255.0 for c in base], -1)
        want[4:12, 4:12] += np.stack(
            [c.astype(np.float32) / 255.0 for c in ref], -1)[:8, :8]
        want = np.clip(np.round(want * 255), 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("mode", [4, 7])
def test_patch_parse_matches_jax(mode):
    """The port's Patches.parse reads what the JAX package's reads."""
    data = mode_stream(mode)

    def fields(img):
        fr = img._frames[1]
        fr.parse_lf_global()
        return [(p.ref_idx, p.x0, p.y0, p.width, p.height,
                 [(t.x, t.y, [(b.mode.value, b.alpha_channel, b.clamp)
                              for b in t.blending])
                  for t in p.patch_targets])
                for p in fr.lf_global.patches.patches]

    ours = fields(JxlImage.from_bytes(data, device="cpu"))
    assert ours == fields(tp.jax_image(data))
    assert ours == [(0, 2, 4, 12, 9,
                     [(5, 6, [(mode, 0, bool(mode & 1))] * 2)])]


def test_patch_alpha_256_fixture():
    """The committed fixture (BlendAbove over a reference-only frame,
    colour and alpha): its reference is the JAX decode, and the port
    equals it exactly."""
    data, ref = tp.fixture("patch_alpha_256")
    assert ref.shape == (256, 256, 4)
    np.testing.assert_array_equal(tp.jax_u8(data), ref)
    np.testing.assert_array_equal(tp.torch_u8(data), ref)
