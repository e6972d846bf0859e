"""Color conversion on device, in torch: the ops of the port's envelope.

Behavioral parity: jxl-color/src/{xyb.rs,tf*.rs}; the torch counterparts
of jxl_oxide_tpu/ops/color.py for XYB -> mixed LMS, the 3x3 matrix,
YCbCr -> RGB and the sRGB transfer functions. The other transfer
functions, the gamut map and tone mapping are not ported yet (ROADMAP
Queue 1 item 5).

All functions take/return [.., H, W] float32 tensors (planar).
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
