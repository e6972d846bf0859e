"""The colour ops of the port (jxl_oxide_tpu_torch/ops/color.py) and its
colour transforms (color/convert.py) against jxl_oxide_tpu on the CPU, on
seeded inputs.

Tolerances (max |port - JAX|):
  - sRGB, BT.709, gamma, HLG (with its OOTF), the gamut map, the
    matrices: 1e-5;
  - PQ and the BT.2408 tone map: 1e-4, and for values above 1 the same
    bound relative to the value (rtol; the PQ curves raise to the powers
    78.84 and 1/0.1593, so an ulp of a float32 pow on either side moves
    the result by about 1e-4 of itself: measured, float32 torch and
    float32 JAX are each as far from a float64 evaluation of the same
    formulas as they are from each other). The tone map's 1000-nit target
    (the PQ -> HLG leg) at HDR inputs needs rtol 2.5e-4 for that reason.
Inputs span [-0.2, 1.2], and linear HDR values up to 4000/255.
`ColorTransform.build`'s op lists and their data are equal to JAX's over a
grid of sources and targets, and a whole transform's output agrees within
1e-4, or 1e-3 with a PQ leg or a tone map (see `_tolerance`).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import torch_parity as tp
from jxl_oxide_tpu.color import convert as jconvert
from jxl_oxide_tpu.headers import image as jimage
from jxl_oxide_tpu.ops import color as J
from jxl_oxide_tpu_torch.color import convert as tconvert
from jxl_oxide_tpu_torch.headers import image as timage
from jxl_oxide_tpu_torch.ops import color as T

LUM = (0.2126, 0.7152, 0.0722)
HDR_MAX = 4000.0 / 255.0
TIGHT = dict(atol=1e-5, rtol=0)
PQ_TOL = dict(atol=1e-4, rtol=1e-4)


def _planes(seed, lo=-0.2, hi=1.2, n=3, shape=(48, 40)):
    rng = np.random.default_rng(seed)
    return [rng.uniform(lo, hi, shape).astype(np.float32) for _ in range(n)]


def _both(fj, ft, planes, *args):
    """(JAX outputs, port outputs) as lists of numpy arrays."""
    a = fj(*[jnp.asarray(p) for p in planes], *args)
    b = ft(*[torch.from_numpy(p) for p in planes], *args)
    if not isinstance(a, tuple):
        a, b = (a,), (b,)
    return [np.asarray(x) for x in a], [y.numpy() for y in b]


def _close(a, b, **tol):
    for x, y in zip(a, b):
        assert x.shape == y.shape and y.dtype == np.float32
        np.testing.assert_allclose(y, x, equal_nan=True, **tol)


@pytest.mark.parametrize("name", ["linear_to_srgb", "srgb_to_linear",
                                  "linear_to_bt709", "bt709_to_linear",
                                  "hlg_to_linear", "linear_to_hlg"])
@pytest.mark.parametrize("seed", [0, 1])
def test_pointwise_curves(name, seed):
    a, b = _both(getattr(J, name), getattr(T, name), _planes(seed, n=1))
    _close(a, b, **TIGHT)


@pytest.mark.parametrize("gamma", [2.2, 1 / 2.2, 2.6, 1 / 2.6, 0.4545455])
def test_apply_gamma(gamma):
    a, b = _both(J.apply_gamma, T.apply_gamma, _planes(2, n=1), gamma)
    _close(a, b, **TIGHT)


@pytest.mark.parametrize("intensity", [255.0, 1000.0, 4000.0, 10000.0])
@pytest.mark.parametrize("lo,hi", [(-0.2, 1.2), (0.0, HDR_MAX)])
def test_pq_curves(intensity, lo, hi):
    """Forward on the span and on HDR linear values; inverse on the span
    (PQ code values above 1 give NaN on both sides, at the same
    pixels)."""
    planes = _planes(3, lo, hi, n=1)
    _close(*_both(J.linear_to_pq, T.linear_to_pq, planes, intensity),
           **PQ_TOL)
    if hi <= 1.2:
        _close(*_both(J.pq_to_linear, T.pq_to_linear, planes, intensity),
               **PQ_TOL)


@pytest.mark.parametrize("intensity", [300.0, 1000.0, 4000.0])
@pytest.mark.parametrize("fn", ["hlg_oo", "hlg_inverse_oo"])
def test_hlg_ootf(fn, intensity):
    planes = _planes(4, 0.0, 1.2)
    _close(*_both(getattr(J, fn), getattr(T, fn), planes, LUM, intensity),
           **TIGHT)


@pytest.mark.parametrize("saturation", [0.1, 0.3])
@pytest.mark.parametrize("lo,hi", [(-0.2, 1.2), (-1.0, 2.0)])
def test_gamut_map(saturation, lo, hi):
    _close(*_both(J.gamut_map, T.gamut_map, _planes(5, lo, hi), LUM,
                  saturation), **TIGHT)


@pytest.mark.parametrize("target,detect_peak,rtol", [
    (255.0, False, 1e-4), (255.0, True, 1e-4), (1000.0, False, 2.5e-4)])
@pytest.mark.parametrize("lo,hi", [(-0.2, 1.2), (0.0, 1.0),
                                   (0.0, HDR_MAX)])
def test_tone_map_rec2408(target, detect_peak, rtol, lo, hi):
    planes = _planes(6, lo, hi)
    a, b = _both(J.tone_map_rec2408, T.tone_map_rec2408, planes, LUM,
                 4000.0, 0.0, target, detect_peak)
    _close(a, b, atol=1e-4, rtol=rtol)


def test_tone_map_detects_the_peak_once():
    """detect_peak reads the luminance's maximum once: one reduction, one
    readback (the peak of the planes it is given)."""
    planes = [torch.from_numpy(p) for p in _planes(7, 0.0, 0.25)]
    calls = []
    real = torch.amax

    def counting(x, *args, **kwargs):
        calls.append(tuple(x.shape))
        return real(x, *args, **kwargs)

    torch.amax = counting
    try:
        T.tone_map_rec2408(*planes, LUM, 4000.0, 0.0, 255.0, True)
    finally:
        torch.amax = real
    assert calls == [tuple(planes[0].shape)]


def test_pq_scalar_matches():
    for v in (0.0, 1e-6, 0.01, 0.3, 1.0, 2.5, -0.5):
        for it in (255.0, 1000.0, 4000.0):
            assert T._linear_to_pq_scalar(np.float32(v), it) == \
                J._linear_to_pq_scalar(np.float32(v), it)


# -- ColorTransform.build over a grid of sources and targets -----------------

TFS = ("srgb", "linear", "bt709", "pq", "hlg", "dci", "gamma")
PRIMS = ("srgb", "p3", "bt2100")
INTENTS = ("PERCEPTUAL", "RELATIVE")


def _encodings(space):
    if space == "XYB":
        return [("XYB",)]
    prims = PRIMS if space == "RGB" else ("srgb",)
    return [(space, p, tf, i) for p in prims for tf in TFS for i in INTENTS]


TARGETS = _encodings("RGB") + _encodings("GREY")
TONE = {"sdr": None, "hdr": (4000.0, 0.0, False),
        "hdr_peak": (4000.0, 0.0, True)}


def _build(mod, conv, src, dst, tone):
    meta = mod.ImageMetadata()
    tm = None if tone is None else mod.ToneMapping(
        intensity_target=tone[0], min_nits=tone[1],
        relative_to_max_display=tone[2])
    return conv.ColorTransform.build(tp.colour_encoding(mod, *src),
                                     tp.colour_encoding(mod, *dst),
                                     meta.opsin_inverse_matrix, tm)


def _same_data(a, b):
    if isinstance(a, np.ndarray):
        np.testing.assert_array_equal(b, a)
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_data(x, y)
    elif hasattr(a, "__dataclass_fields__"):
        assert type(a).__name__ == type(b).__name__
        _same_data(vars(a), vars(b))
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same_data(a[k], b[k])
    else:
        assert a == b, (a, b)


@pytest.mark.parametrize("tone", list(TONE))
@pytest.mark.parametrize("space,prim", [("XYB", None), ("GREY", None),
                                        ("RGB", "srgb"), ("RGB", "p3"),
                                        ("RGB", "bt2100")])
def test_build_op_lists_match(space, prim, tone):
    """Every (source, target) pair of the grid: the same op kinds with the
    same data, and the same number of planes in."""
    sources = [s for s in _encodings(space) if prim is None or s[1] == prim]
    n = 0
    for src in sources:
        for dst in TARGETS:
            a = _build(jimage, jconvert, src, dst, TONE[tone])
            b = _build(timage, tconvert, src, dst, TONE[tone])
            assert [op.kind for op in b.ops] == [op.kind for op in a.ops], \
                (src, dst)
            assert b.begin_channels == a.begin_channels
            for x, y in zip(a.ops, b.ops):
                _same_data(x.data, y.data)
            n += 1
    assert n == len(sources) * len(TARGETS)


# A whole transform is held at 1e-4, or at 1e-3 (a quarter of a u8 LSB)
# when it has a PQ leg or tone-maps: its matrices cancel near black,
# where an ulp of the difference is a large part of the value, and a
# steep curve after them (x^(1/2.6) of DCI, HLG's square root) lifts that
# to ~2e-5; a PQ leg's 1e-4 of the value (see above), taken through the
# gamut map's division or the tone map's ratio, reaches 2.2e-4 (all
# measured). Each op alone is held at its own tolerance above.
def _tolerance(ops) -> dict:
    pq = any(op.kind == "tone_map" or (
        op.data.get("tf") is not None and op.data["tf"].kind == "pq")
        for op in ops)
    return dict(atol=1e-3, rtol=1e-4) if pq else PQ_TOL


RUN_PAIRS = [
    (("XYB",), dst, tone) for dst in TARGETS[::3] + TARGETS[-14::5]
    for tone in ("sdr", "hdr")
] + [
    (src, dst, "sdr")
    for src in (("RGB", "p3", "pq", "PERCEPTUAL"),
                ("RGB", "bt2100", "hlg", "RELATIVE"),
                ("GREY", "srgb", "gamma", "RELATIVE"),
                ("RGB", "srgb", "bt709", "PERCEPTUAL"),
                ("GREY", "srgb", "hlg", "PERCEPTUAL"))
    for dst in (("RGB", "srgb", "srgb", "RELATIVE"),
                ("RGB", "bt2100", "hlg", "PERCEPTUAL"),
                ("RGB", "p3", "dci", "RELATIVE"),
                ("GREY", "srgb", "pq", "RELATIVE"))
] + [(("RGB", "bt2100", "pq", "PERCEPTUAL"),
      ("RGB", "bt2100", "hlg", "PERCEPTUAL"), "hdr")]


@pytest.mark.parametrize("src,dst,tone", RUN_PAIRS,
                         ids=lambda v: "-".join(v) if isinstance(v, tuple)
                         else v)
def test_transform_runs_match(src, dst, tone):
    """A transform on seeded planes (one plane for a grey source): its
    planes agree with JAX's, one in for grey, out one for a grey target,
    and the tone map's peak read on the port's own planes."""
    a = _build(jimage, jconvert, src, dst, TONE[tone])
    b = _build(timage, tconvert, src, dst, TONE[tone])
    lo, hi = (-0.05, 0.6) if src[0] == "XYB" else (-0.2, 1.2)
    planes = _planes(8, lo, hi, n=a.begin_channels)
    kinds = [op.kind for op in a.ops]
    if "xyz_to_luma" in kinds and "tone_map" in kinds[
            kinds.index("xyz_to_luma"):]:
        # a fault of the reference, kept by the port (ROADMAP Queue 3):
        # the tone map after xyz_to_luma unpacks three planes from one
        with pytest.raises(ValueError):
            a.run(planes)
        with pytest.raises(ValueError):
            b.run([torch.from_numpy(p) for p in planes])
        return
    want = [np.asarray(p) for p in a.run(planes)] if not a.is_noop \
        else planes
    got = [p.numpy() for p in b.run([torch.from_numpy(p) for p in planes])]
    assert len(got) == len(want)
    _close(want, got, **_tolerance(a.ops))
