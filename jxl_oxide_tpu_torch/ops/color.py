"""Color conversion on device, in torch.

Behavioral parity: jxl-color/src/{xyb.rs,ycbcr.rs,tf*.rs,gamut.rs}; the
torch counterparts of jxl_oxide_tpu/ops/color.py: XYB -> mixed LMS, the
3x3 matrix, YCbCr -> RGB, the sRGB, BT.709, gamma, PQ and HLG transfer
functions, the HLG OOTF, the gamut map and the BT.2408 tone map. Each is
written op for op as the JAX function is, with the same float32
constants, so the two agree to an ulp or two.

All functions take/return [.., H, W] float32 tensors (planar): one
image's [H, W] or a stack's [N, H, W].
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "xyb_to_mixed_lms",
    "apply_matrix3",
    "ycbcr_to_rgb",
    "linear_to_srgb",
    "srgb_to_linear",
    "linear_to_bt709",
    "bt709_to_linear",
    "apply_gamma",
    "linear_to_pq",
    "pq_to_linear",
    "hlg_to_linear",
    "linear_to_hlg",
    "hlg_inverse_oo",
    "hlg_oo",
    "gamut_map",
    "tone_map_rec2408",
]


def xyb_to_mixed_lms(x, y, b, opsin_bias, intensity_target: float):
    """XYB -> scaled linear mixed-LMS (xyb.rs:34-60). A following 3x3
    matrix (opsin inverse matrix) yields linear sRGB."""
    ob = np.asarray(opsin_bias, dtype=np.float32)
    cbrt_ob = np.cbrt(ob)
    itscale = float(np.float32(255.0 / intensity_target))
    g_l = y + x - float(cbrt_ob[0])
    g_m = y - x - float(cbrt_ob[1])
    g_s = b - float(cbrt_ob[2])
    out_l = (g_l * g_l * g_l + float(ob[0])) * itscale
    out_m = (g_m * g_m * g_m + float(ob[1])) * itscale
    out_s = (g_s * g_s * g_s + float(ob[2])) * itscale
    return out_l, out_m, out_s


def apply_matrix3(a, b, c, mat):
    """3x3 matrix applied across three planes (convert.rs Matrix op)."""
    m = np.asarray(mat, dtype=np.float32).reshape(3, 3)
    m = [[float(v) for v in row] for row in m]
    oa = m[0][0] * a + m[0][1] * b + m[0][2] * c
    ob = m[1][0] * a + m[1][1] * b + m[1][2] * c
    oc = m[2][0] * a + m[2][1] * b + m[2][2] * c
    return oa, ob, oc


def ycbcr_to_rgb(cb, y, cr):
    """BT.601 YCbCr -> RGB with +128/255 Y offset (ycbcr.rs:40-56). The
    channel slots of a YCbCr frame hold (Cb, Y, Cr)."""
    yy = y + float(np.float32(128.0 / 255.0))
    r = cr * float(np.float32(1.402)) + yy
    g = (
        cb * float(np.float32(-0.114 * 1.772 / 0.587))
        + cr * float(np.float32(-0.299 * 1.402 / 0.587))
        + yy
    )
    b = cb * float(np.float32(1.772)) + yy
    return r, g, b


def _signed_pow(v, f):
    """f(|v|) with v's sign (the reference's copysign convention)."""
    return torch.sign(v) * f(torch.abs(v))


def linear_to_srgb(v):
    def f(a):
        small = a * 12.92
        big = 1.055 * torch.pow(torch.clamp_min(a, 1e-30), 1.0 / 2.4) - 0.055
        return torch.where(a <= 0.0031308, small, big)

    return _signed_pow(v, f)


def srgb_to_linear(v):
    def f(a):
        small = a / 12.92
        big = torch.pow((a + 0.055) / 1.055, 2.4)
        return torch.where(a <= 0.04045, small, big)

    return _signed_pow(v, f)


def linear_to_bt709(v):
    def f(a):
        small = a * 4.5
        big = 1.099 * torch.pow(torch.clamp_min(a, 1e-30), 0.45) - 0.099
        return torch.where(a <= 0.018, small, big)

    return _signed_pow(v, f)


def bt709_to_linear(v):
    def f(a):
        small = a / 4.5
        big = torch.pow((a + 0.099) / 1.099, 1.0 / 0.45)
        return torch.where(a < 0.081, small, big)

    return _signed_pow(v, f)


def apply_gamma(v, gamma: float):
    """v^gamma with sign preservation; 0 at and below 1e-7 (tf.rs:11-98)."""
    def f(a):
        return torch.where(a <= 1e-7, 0.0,
                           torch.pow(torch.clamp_min(a, 1e-30), float(gamma)))

    return _signed_pow(v, f)


# SMPTE ST.2084 (PQ) exact constants
_PQ_M1 = 2610.0 / 16384.0
_PQ_M2 = 2523.0 / 4096.0 * 128.0
_PQ_C1 = 3424.0 / 4096.0
_PQ_C2 = 2413.0 / 4096.0 * 32.0
_PQ_C3 = 2392.0 / 4096.0 * 32.0


def linear_to_pq(v, intensity_target: float):
    y_mult = float(np.float32(intensity_target / 10000.0))

    def f(a):
        a = a * y_mult
        am1 = torch.pow(torch.clamp_min(a, 1e-30), _PQ_M1)
        return torch.pow((_PQ_C1 + _PQ_C2 * am1) / (1.0 + _PQ_C3 * am1),
                         _PQ_M2)

    return _signed_pow(v, f)


def pq_to_linear(v, intensity_target: float):
    y_mult = float(np.float32(10000.0 / intensity_target))

    def f(a):
        am = torch.pow(torch.clamp_min(a, 1e-30), 1.0 / _PQ_M2)
        num = torch.clamp_min(am - _PQ_C1, 0.0)
        den = _PQ_C2 - _PQ_C3 * am
        return torch.pow(num / den, 1.0 / _PQ_M1) * y_mult

    return _signed_pow(v, f)


# BT.2100 HLG constants
_HLG_A = 0.17883277
_HLG_B = 0.28466892
_HLG_C = 0.55991073


def hlg_to_linear(v):
    """HLG inverse OETF (scene-linear, [0,1] domain)."""
    def f(a):
        small = a * a / 3.0
        big = (torch.exp((a - _HLG_C) / _HLG_A) + _HLG_B) / 12.0
        return torch.where(a <= 0.5, small, big)

    return _signed_pow(v, f)


def linear_to_hlg(v):
    def f(a):
        small = torch.sqrt(3.0 * a)
        big = _HLG_A * torch.log(torch.clamp_min(12.0 * a - _HLG_B, 1e-30)) \
            + _HLG_C
        return torch.where(a <= 1.0 / 12.0, small, big)

    return _signed_pow(v, f)


def _luma(r, g, b, luminances):
    lr, lg, lb = (float(np.float32(x)) for x in luminances)
    return r * lr + g * lg + b * lb


def _hlg_gamma(intensity_target: float) -> float:
    return float(1.2 * 1.111 ** np.log2(intensity_target / 1000.0))


def hlg_inverse_oo(r, g, b, luminances, intensity_target: float):
    """HLG inverse OOTF: display-linear -> scene-linear (tf.rs:121-148)."""
    gamma = _hlg_gamma(intensity_target)
    y = _luma(r, g, b, luminances)
    mult = torch.pow(torch.clamp_min(y, 1e-30),
                     float(np.float32((1.0 - gamma) / gamma)))
    return r * mult, g * mult, b * mult


def hlg_oo(r, g, b, luminances, intensity_target: float):
    """HLG forward OOTF: scene-linear -> display-linear (tf.rs:150-172)."""
    gamma = _hlg_gamma(intensity_target)
    y = _luma(r, g, b, luminances)
    mult = torch.pow(torch.clamp_min(y, 1e-30), float(np.float32(gamma - 1.0)))
    return r * mult, g * mult, b * mult


def gamut_map(r, g, b, luminances, saturation_factor: float):
    """Soft gamut mapping toward the luminance axis (gamut.rs):
    desaturates out-of-gamut colours keeping their luminance, then
    clips."""
    y = _luma(r, g, b, luminances)

    # the largest t in [0, 1] with y + t*(v - y) in [0, 1] per channel
    def limit(v):
        d = v - y
        t_hi = torch.where(d > 1e-9, (1.0 - y) / torch.clamp_min(d, 1e-9),
                           1.0)
        t_lo = torch.where(d < -1e-9, (0.0 - y) / torch.clamp_max(d, -1e-9),
                           1.0)
        return torch.clamp_max(torch.minimum(t_hi, t_lo), 1.0)

    t = torch.minimum(torch.minimum(limit(r), limit(g)), limit(b))
    t = torch.clamp(t * (1.0 + saturation_factor), 0.0, 1.0)
    rr = y + (r - y) * t
    gg = y + (g - y) * t
    bb = y + (b - y) * t
    return (torch.clamp(rr, 0.0, 1.0), torch.clamp(gg, 0.0, 1.0),
            torch.clamp(bb, 0.0, 1.0))


def _linear_to_pq_scalar(v: float, intensity_target: float) -> float:
    """Host-side scalar PQ OETF, in float64."""
    a = abs(v) * (intensity_target / 10000.0)
    am1 = max(a, 1e-30) ** _PQ_M1
    e = ((_PQ_C1 + _PQ_C2 * am1) / (1.0 + _PQ_C3 * am1)) ** _PQ_M2
    return float(np.copysign(e, v))


def _rec2408_eetf(y_pq, intensity_target: float, from_range, to_range):
    """BT.2408 EETF on PQ-encoded luminance (tf/rec2408.rs:4-53)."""
    lums = [
        from_range[0] / intensity_target,
        from_range[1] / intensity_target,
        to_range[0] / intensity_target,
        to_range[1] / intensity_target,
    ]
    lums = [_linear_to_pq_scalar(np.float32(v), intensity_target)
            for v in lums]
    diff = lums[1] - lums[0]
    norm = (y_pq - lums[0]) / diff
    min_lum = (lums[2] - lums[0]) / diff
    max_lum = (lums[3] - lums[0]) / diff
    ks = 1.5 * max_lum - 0.5
    one_sub_ks = 1.0 - ks
    t = (norm - ks) / one_sub_ks
    t2 = t * t
    t3 = t2 * t
    spline = (
        (2.0 * t3 - 3.0 * t2 + 1.0) * ks
        + (t3 - 2.0 * t2 + t) * one_sub_ks
        + (-2.0 * t3 + 3.0 * t2) * max_lum
    )
    compressed = torch.where(norm < ks, norm, spline)
    x = 1.0 - compressed
    mapped = (x * x * x * x) * min_lum + compressed
    return mapped * diff + lums[0]


def tone_map_rec2408(r, g, b, luminances, intensity_target: float,
                     min_nits: float, target_display_luminance: float,
                     detect_peak: bool = False):
    """HDR -> SDR luminance tone mapping (convert/tone_map.rs:9-211).
    detect_peak reads the luminance's maximum back to the host once: one
    reduction on the planes' device, one readback (over a whole stack
    when the planes are [N, H, W])."""
    y = _luma(r, g, b, luminances)
    if detect_peak:
        peak = float(torch.amax(y)) * intensity_target
        peak_luminance = min(intensity_target, max(peak, 1.0))
    else:
        peak_luminance = intensity_target
    from_range = (min_nits, peak_luminance)
    to_range = (0.0, target_display_luminance)
    scale = float(np.float32(intensity_target / target_display_luminance))
    y_pq = linear_to_pq(y, intensity_target)
    y_mapped = pq_to_linear(
        _rec2408_eetf(y_pq, intensity_target, from_range, to_range),
        intensity_target,
    )
    ratio = torch.where(
        torch.abs(y) <= 1e-7, y_mapped * scale,
        y_mapped / torch.where(y == 0, 1.0, y) * scale,
    )
    return r * ratio, g * ratio, b * ratio
