"""The render tail of a VarDCT frame: the device planes of
render/vardct.py decode_vardct_planes -> chroma upsample -> crop ->
gaborish -> EPF.

Behavioral parity: jxl-render/src/render.rs (render_frame) and
image.rs upsample_jpeg; the VarDCT half of
jxl_oxide_tpu/render/render.py::render_frame's tail. The fused programs
upsample and filter inside the program (state.chroma_upsampled,
state.filters_applied), so on their planes the tail only crops; the
staged path's planes take every step here.
"""

from __future__ import annotations

import torch

from ..ops.filters import apply_epf, apply_gabor, sigma_map_from_blocks
from ..utils.trace import traced

__all__ = ["render_vardct_tail"]


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
