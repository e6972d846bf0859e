"""The render tails of a frame, on the device.

VarDCT: the device planes of render/vardct.py decode_vardct_planes ->
chroma upsample -> crop -> gaborish -> EPF. The fused programs upsample
and filter inside the program (state.chroma_upsampled,
state.filters_applied), so on their planes the tail only crops; the
staged path's planes take every step here.

Modular: the original channels of the frame's ModularImage -> floats
(integer samples, lossless XYB, or float samples on the host) ->
gaborish -> EPF at the frame's constant sigma.

Extra channels (the port's envelope: one integer alpha) convert with
their own bit depth and are never filtered (`extra_channel_planes`), on
both paths.

Behavioral parity: jxl-render/src/render.rs (render_frame), image.rs
(upsample_jpeg, convert_modular_xyb) and jxl-image lib.rs
(integer-sample parsing); jxl_oxide_tpu/render/render.py::render_frame.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.filters import apply_epf, apply_gabor, sigma_map_from_blocks
from ..utils.trace import traced

__all__ = ["extra_channel_planes", "render_modular_tail",
           "render_vardct_tail"]


def _parse_float_samples(arr: np.ndarray, bit_depth) -> np.ndarray:
    """Float samples stored as integers -> float32 on the host (the float
    branch of jxl_oxide_tpu/render/render.py _parse_integer_samples,
    jxl-image lib.rs:458-487)."""
    bits = bit_depth.bits_per_sample
    exp_bits = bit_depth.exp_bits
    if bits == 32 and exp_bits == 8:
        return arr.astype(np.uint32).view(np.float32).astype(np.float32)
    mantissa_bits = bits - exp_bits - 1
    u = arr.astype(np.int64) & ((1 << bits) - 1)
    sign = (u >> (bits - 1)) & 1
    exp = (u >> mantissa_bits) & ((1 << exp_bits) - 1)
    mant = u & ((1 << mantissa_bits) - 1)
    bias = (1 << (exp_bits - 1)) - 1
    val = np.ldexp(
        1.0 + mant / (1 << mantissa_bits), (exp - bias).astype(np.int32)
    )
    val = np.where(exp == 0, np.ldexp(mant / (1 << mantissa_bits), 1 - bias), val)
    return np.where(sign == 1, -val, val).astype(np.float32)


def _upload(chans: list, device) -> torch.Tensor:
    """The three colour channels as one [3, h, w] tensor on `device`:
    tensors stay where they are; host arrays go up in one copy in their
    own integer type (i16 from the narrow lane stays i16)."""
    if isinstance(chans[0], torch.Tensor):
        return torch.stack(chans[:3])
    return torch.from_numpy(np.stack(chans[:3])).to(device)


def integer_samples_to_float(planes: torch.Tensor, bits: int) -> torch.Tensor:
    """Integer samples -> [0, 1] float32 (jxl-image lib.rs:458-487): an
    IEEE float32 division by 2^bits - 1, bit for bit the JAX package's
    numpy division. The divisor is a tensor on the planes' device: a
    Python scalar divisor makes torch's CUDA division multiply by its
    reciprocal, which can differ by an ulp."""
    div = torch.tensor(float(np.float32((1 << bits) - 1)),
                       dtype=torch.float32, device=planes.device)
    return planes.to(torch.float32) / div


def extra_channel_planes(chans: list, ec_info: list, device) -> list:
    """[h, w] float32 planes on `device` of a frame's extra channels, from
    their integer samples (numpy arrays or tensors), each converted with
    its own bit depth (jxl-render image.rs:507-508). No filter touches
    them. The envelope (api.py `_check_envelope`) admits integer samples
    only."""
    out = []
    for chan, info in zip(chans, ec_info):
        t = chan if isinstance(chan, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(chan))
        out.append(integer_samples_to_float(
            t.to(device), info.bit_depth.bits_per_sample))
    return out


@traced("Render frame")
def render_modular_tail(frame, chans: list, device) -> tuple[list, list]:
    """(color, extra) on `device` from the original channels of a Modular
    frame (numpy arrays after the host tail, int32 tensors on the device
    after the device tail): three [h, w] float32 colour planes, filtered as
    the frame says, and one plane per extra channel, unfiltered."""
    header = frame.header
    meta = frame.image_header.metadata
    bit_depth = meta.bit_depth
    h, w = header.sample_height(), header.sample_width()
    if meta.xyb_encoded:
        # convert_modular_xyb (image.rs:148-188): stream order [y, x, b],
        # b += y, output [x*m_x, y*m_y, b*m_b] with m/128 scaling, in
        # float64 and then rounded to float32, as the JAX package does
        y, x, b = _upload(chans, device).to(torch.float64).unbind(0)
        b = b + y
        m_x, m_y, m_b = (m / 128.0 for m in frame.lf_global.lf_dequant)
        color = [(x * m_x).to(torch.float32), (y * m_y).to(torch.float32),
                 (b * m_b).to(torch.float32)]
    elif bit_depth.is_float:
        color = list(torch.from_numpy(np.stack([
            _parse_float_samples(np.asarray(c), bit_depth) for c in chans[:3]
        ])).to(device).unbind(0))
    else:
        color = list(integer_samples_to_float(
            _upload(chans, device), bit_depth.bits_per_sample).unbind(0))
    extra = extra_channel_planes(
        chans[frame.lf_global.gmodular.extra_channel_from:], meta.ec_info,
        color[0].device)

    rf = header.restoration_filter
    if rf.gab.enabled:
        color = apply_gabor(color, rf.gab.weights)
    if rf.epf.enabled:
        sigma = torch.full((h, w), float(np.float32(rf.epf.sigma_for_modular)),
                           dtype=torch.float32, device=color[0].device)
        out = apply_epf(color, sigma, rf.epf)
        color = [out[0], out[1], out[2]]
    return color, extra


def _upsample2x_triangle(plane: torch.Tensor, axis: int,
                         size: int) -> torch.Tensor:
    """JPEG chroma 2x upsample with the 0.25/0.75 triangle filter
    (filter/ycbcr.rs apply_jpeg_upsampling_single): out[2j] leans on the
    previous sample, out[2j+1] on the next, edges clamped, cut to `size`
    along `axis`. Written multiply-then-add, as the JAX package's render
    tail writes it: it does not round as ops/vardct_pipeline.py
    _triangle_up2 does."""
    p = torch.movedim(plane.to(torch.float32), axis, 0)
    prev = torch.cat([p[:1], p[:-1]], dim=0)
    nxt = torch.cat([p[1:], p[-1:]], dim=0)
    a = 0.25 * prev + 0.75 * p
    b = 0.75 * p + 0.25 * nxt
    out = torch.stack([a, b], dim=1).reshape(
        (2 * p.shape[0],) + tuple(p.shape[1:]))
    return torch.movedim(out, 0, axis).narrow(axis, 0, size)


@traced("Render frame")
def render_vardct_tail(state, planes: list) -> list:
    """Three [h, w] float32 planes at the frame's sample size from the
    cropped device planes of one VarDCT frame (still YCbCr for a YCbCr
    frame), on the planes' device."""
    header = state.header
    h, w = header.sample_height(), header.sample_width()
    color = list(planes)

    # YCbCr chroma upsampling (image.rs upsample_jpeg); the fused
    # subsampled program has upsampled already, so the shapes skip it
    if header.do_ycbcr:
        ups = header.jpeg_upsampling
        hscale = any(v in (1, 2) for v in ups)
        vscale = any(v in (1, 3) for v in ups)
        for i in range(3):
            # channel i is stored h-subsampled iff ups[i] in (0, 3) and any
            # channel sets hscale; v-subsampled iff ups[i] in (0, 2)
            # (param.rs from_jpeg_upsampling)
            hs = hscale and ups[i] not in (1, 2)
            vs = vscale and ups[i] not in (1, 3)
            p = color[i]
            if hs and p.shape[1] < w:
                p = _upsample2x_triangle(p, 1, w)
            if vs and p.shape[0] < h:
                p = _upsample2x_triangle(p, 0, h)
            color[i] = p

    color = [p if tuple(p.shape) == (h, w) else p[:h, :w] for p in color]

    rf = header.restoration_filter
    if state.filters_applied:
        return color
    if rf.gab.enabled:
        color = apply_gabor(color, rf.gab.weights)
    if rf.epf.enabled:
        # the frame-wide per-pixel sigma (the JAX package's
        # render/render.py _assemble_epf_sigma)
        sigma = torch.from_numpy(sigma_map_from_blocks(
            state._sigma_blocks_grid(), h, w)).to(color[0].device)
        out = apply_epf(color, sigma, rf.epf)
        color = [out[0], out[1], out[2]]
    return color
