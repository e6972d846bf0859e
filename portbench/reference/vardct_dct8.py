"""Plain reference decode of a DCT8-only 4:4:4 VarDCT frame from what its
stream carries: the quantized coefficients, LF values and EPF sharpness
map that the benchmark's recipe made from the seed (portbench/streams),
never the stream's bytes and nothing the port computed.

It follows the format's decode in its plainest form, one image at a time:
dequantize (the quantization bias, the default DCT8 matrix worked out
here from its distance bands, the global scale), chroma from luma on LF
and HF (the stream's defaults: x += 0 * y, b += 1 * y), each block's DC
set to its LF value, an 8x8 inverse DCT as one matrix product, gaborish
(3x3, clamp to edge) and the EPF passes (mirror at the edges) with each
block's sigma from its sharpness. The streams are not XYB and signal
sRGB, so no colour transform follows.

`decode(inputs, dtype, device, tf32)` returns [H, W, 3]. float64 is the
reference. The control is float32 with `tf32`: the operands of every
product in the linear stages (inverse DCT, gaborish) rounded to TF32's
10-bit mantissa, as a TF32 matrix product or convolution would take
them: the nearest precision below the float32 that the port states.
Every constant is the format's default, written out here; nothing is
imported from the encoders."""

from __future__ import annotations

import math

import numpy as np
import torch

# the format's defaults for a frame that signals none (the streams do not)
QUANT_BIAS = (1.0 - 0.05465007330715401, 1.0 - 0.07005449891748593,
              1.0 - 0.049935103337343655)
QUANT_BIAS_NUMERATOR = 0.145
# DCT8's default quantization weights: per channel (x, y, b) the first
# distance band, then each next band's step (v > 0: times 1 + v, else
# over 1 - v)
DCT8_BANDS = ((3150.0, 0.0, -0.4, -0.4, -0.4, -2.0),
              (560.0, 0.0, -0.3, -0.3, -0.3, -0.3),
              (512.0, -2.0, -1.0, 0.0, -1.0, -2.0))
GABOR_WEIGHTS = (0.115169525, 0.061248592)
EPF_CHANNEL_SCALE = (40.0, 5.0, 3.5)
EPF_SHARP_LUT = (0.0, 1 / 7, 2 / 7, 3 / 7, 4 / 7, 5 / 7, 6 / 7, 1.0)
EPF_QUANT_MUL = 0.46
EPF_PASS0_SIGMA_SCALE = 0.9
EPF_PASS2_SIGMA_SCALE = 6.5
EPF_BORDER_SAD_MUL = 2.0 / 3.0
# taps and distance offsets of the three EPF steps, as (dx, dy)
EPF_TAPS = {
    0: ((0, -2), (-1, -1), (0, -1), (1, -1), (-2, 0), (-1, 0), (1, 0),
        (2, 0), (-1, 1), (0, 1), (1, 1), (0, 2)),
    1: ((0, -1), (0, 1), (-1, 0), (1, 0)),
    2: ((0, -1), (0, 1), (-1, 0), (1, 0)),
}
EPF_DIST = {
    0: ((0, -1), (1, 0), (0, 0), (-1, 0), (0, 1)),
    1: ((0, -1), (0, 0), (0, 1), (-1, 0), (1, 0)),
    2: ((0, 0),),
}


def dct8_matrix(c: int) -> np.ndarray:
    """Channel c's DCT8 dequantization matrix [8, 8] (float64): one over the
    weight that the distance bands give at each frequency (x, y), read at
    the distance sqrt(x^2 + y^2) scaled so that (7, 7) falls just inside
    the last band, interpolated geometrically between bands."""
    p = DCT8_BANDS[c]
    bands = [p[0]]
    for v in p[1:]:
        bands.append(bands[-1] * (1.0 + v if v > 0 else 1.0 / (1.0 - v)))
    n = len(bands)
    scale = (n - 1) / (math.sqrt(2.0) + 1e-6) / 7.0
    out = np.empty((8, 8))
    for y in range(8):
        for x in range(8):
            d = math.hypot(x * scale, y * scale)
            i = int(d)
            out[y, x] = 1.0 / (bands[i] * (bands[i + 1] / bands[i]) ** (d - i))
    return out


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 mantissa bits, to nearest, ties
    to even), as tensor cores read a TF32 operand."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def _idct_basis(dtype, device) -> torch.Tensor:
    """B[x, k] with x = B @ F: the DC row weight 1, the others sqrt(2) cos
    (the inverse of a forward DCT whose F[0] is the block's mean)."""
    x = np.arange(8, dtype=np.float64)[:, None]
    k = np.arange(8, dtype=np.float64)[None, :]
    b = np.cos(np.pi * k * (2.0 * x + 1.0) / 16.0) * math.sqrt(2.0)
    b[:, 0] = 1.0
    return torch.tensor(b, dtype=dtype, device=device)


def _dequant_hf(q: np.ndarray, c: int, consts: dict, dtype,
                device) -> torch.Tensor:
    """Biased dequantization of one channel's blocks [bh, bw, 8, 8]: |q| <= 1
    scales by the channel's quant bias, larger values move toward zero by
    numerator / q; then the DCT8 matrix and 65536 / (global scale * HF
    multiplier, 1 here) times the channel's qm scale."""
    qf = torch.tensor(q, dtype=torch.float64, device=device)
    safe = torch.where(qf == 0, torch.ones_like(qf), qf)
    biased = torch.where(qf.abs() <= 1.0, qf * QUANT_BIAS[c],
                         qf - QUANT_BIAS_NUMERATOR / safe)
    # the matrix is symmetric, so a block's (row, column) layout needs no
    # transpose
    m = torch.tensor(dct8_matrix(c), device=device)
    mul = 65536.0 / consts["global_scale"] * consts["qm"][c]
    return (biased * m * mul).to(dtype)


def _lf(lf_q: np.ndarray, c: int, consts: dict, dtype, device):
    scale = consts["lf_dequant"][c] * 512.0 / (
        consts["global_scale"] * consts["quant_lf"])
    return torch.tensor(lf_q, dtype=torch.float64, device=device).mul(
        scale).to(dtype)


def _idct_blocks(blocks: torch.Tensor, rnd) -> torch.Tensor:
    """[bh, bw, 8, 8] coefficients (rows: vertical frequency) to the
    [8 bh, 8 bw] plane: each block's pixels B F B^T, written as one matrix
    product of the flattened blocks with kron(B, B)^T."""
    b = _idct_basis(blocks.dtype, blocks.device)
    bh, bw = blocks.shape[:2]
    pix = torch.matmul(rnd(blocks.reshape(bh * bw, 64)),
                       rnd(torch.kron(b, b).T))
    return pix.reshape(bh, bw, 8, 8).permute(0, 2, 1, 3).reshape(
        bh * 8, bw * 8)


def _gabor(p: torch.Tensor, rnd) -> torch.Tensor:
    """3x3: the pixel, its 4 sides times w0 and its 4 corners times w1, over
    1 + 4 w0 + 4 w1; the edges clamped."""
    w0, w1 = GABOR_WEIGHTS
    norm = 1 + 4 * w0 + 4 * w1
    q = rnd(torch.nn.functional.pad(p[None, None], (1, 1, 1, 1),
                                    mode="replicate")[0, 0])
    c0, c1, c2 = (rnd(torch.tensor(v / norm, dtype=p.dtype))
                  for v in (1.0, w0, w1))
    side = q[:-2, 1:-1] + q[2:, 1:-1] + q[1:-1, :-2] + q[1:-1, 2:]
    diag = q[:-2, :-2] + q[:-2, 2:] + q[2:, :-2] + q[2:, 2:]
    return c0 * q[1:-1, 1:-1] + c1 * side + c2 * diag


def _mirror(n: int, pad: int, device) -> torch.Tensor:
    """Indices of a length-n axis padded by `pad` with the edge sample
    repeated (reflecting again where pad > n)."""
    i = torch.arange(-pad, n + pad, device=device) % (2 * n)
    return torch.where(i < n, i, 2 * n - 1 - i)


def _epf_pass(planes: torch.Tensor, sigma: torch.Tensor, step: int,
              step_mul: float) -> torch.Tensor:
    """One EPF pass over [3, H, W] with per-pixel sigma [H, W]: every tap's
    weight falls linearly with the channel-scaled sum of absolute
    differences around the pixel and the tap, over sigma; pixels on an
    8x8 block's border scale that by the border multiplier; sigma < 0.3
    leaves the pixel as it is."""
    _, h, w = planes.shape
    pad = 3
    dev = planes.device
    p = planes[:, _mirror(h, pad, dev)][:, :, _mirror(w, pad, dev)]

    def at(dx, dy):
        return p[:, pad + dy: pad + dy + h, pad + dx: pad + dx + w]

    yy = torch.arange(h, device=dev)[:, None] % 8
    xx = torch.arange(w, device=dev)[None, :] % 8
    border = (yy == 0) | (yy == 7) | (xx == 0) | (xx == 7)
    mul = torch.where(border, step_mul * EPF_BORDER_SAD_MUL, step_mul)
    active = sigma >= 0.3
    inv = torch.where(active, mul / torch.where(active, sigma, 1.0), 0.0)
    k = 6.6 * (1.0 / math.sqrt(2.0) - 1.0)
    cs = torch.tensor(EPF_CHANNEL_SCALE, dtype=planes.dtype,
                      device=dev)[:, None, None]
    total = planes.clone()
    weights = torch.ones_like(sigma)
    for kx, ky in EPF_TAPS[step]:
        dist = sum((at(kx + ix, ky + iy) - at(ix, iy)).abs()
                   for ix, iy in EPF_DIST[step])
        wt = torch.clamp(1.0 + k * (cs * dist).sum(0) * inv, min=0.0)
        weights = weights + wt
        total = total + wt * at(kx, ky)
    return torch.where(active, total / weights, planes)


def _epf(planes: torch.Tensor, sigma: torch.Tensor, iters: int):
    if iters == 3:
        planes = _epf_pass(planes, sigma, 0, EPF_PASS0_SIGMA_SCALE)
    if iters >= 1:
        planes = _epf_pass(planes, sigma, 1, 1.0)
    if iters >= 2:
        planes = _epf_pass(planes, sigma, 2, EPF_PASS2_SIGMA_SCALE)
    return planes


def _sigma(inputs: dict, h: int, w: int, dtype, device) -> torch.Tensor:
    """Per-pixel EPF sigma: quant_mul * 65536 / global scale / HF multiplier
    (1 in these streams) * the sharpness table at each block's sharpness
    (0 unless the inputs give one)."""
    bh, bw = -(-h // 8), -(-w // 8)
    sharp = inputs.get("sharpness")
    sharp = (np.zeros((bh, bw), dtype=np.int64) if sharp is None
             else np.asarray(sharp))
    lut = np.asarray(EPF_SHARP_LUT, dtype=np.float64)
    blocks = EPF_QUANT_MUL * 65536.0 / inputs["global_scale"] * lut[sharp]
    s = np.repeat(np.repeat(blocks, 8, 0), 8, 1)[:h, :w]
    return torch.tensor(s, dtype=dtype, device=device)


def decode(inputs: dict, dtype=torch.float64, device="cpu",
           tf32: bool = False) -> torch.Tensor:
    """The frame's pixels, [H, W, 3] in `dtype` on `device`; `tf32` (with
    float32) rounds the linear stages' operands as TF32 products would."""
    if tf32 and dtype != torch.float32:
        raise ValueError("tf32 rounds float32 operands")
    rnd = tf32_round if tf32 else (lambda x: x)
    h, w = inputs["height"], inputs["width"]
    if inputs["layout"] != "444_cfl":
        raise ValueError(f"unknown layout {inputs['layout']!r}")
    deq = [_dequant_hf(inputs["q"][c], c, inputs, dtype, device)
           for c in range(3)]
    lf = [_lf(inputs["lf_q"][c], c, inputs, dtype, device) for c in range(3)]
    deq[2] = deq[2] + deq[1]
    lf[2] = lf[2] + lf[1]
    planes = []
    for c in range(3):
        deq[c][..., 0, 0] = lf[c]
        planes.append(_idct_blocks(deq[c], rnd))
    x = torch.stack([p[:h, :w] for p in planes])
    if inputs["gabor"]:
        x = torch.stack([_gabor(x[c], rnd) for c in range(3)])
    if inputs["epf_iters"]:
        x = _epf(x, _sigma(inputs, h, w, dtype, device), inputs["epf_iters"])
    return x.permute(1, 2, 0)
