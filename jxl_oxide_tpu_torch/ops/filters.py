"""Restoration filters in plain torch: gaborish and one edge-preserving
filter (EPF) pass.

Behavioral parity: jxl-render/src/filter/{gabor.rs,epf.rs} and
filter/impls/generic/{gabor.rs,epf.rs}; the torch counterparts of
jxl_oxide_tpu/ops/filters.py, with the same operation order. Boundary
semantics:
  - gaborish: clamp-to-edge (generic/gabor.rs edge handling)
  - EPF: symmetric mirror (util.rs:376-386 `mirror`), which repeats the
    edge sample: torch's "reflect" does not, so the mirror index is
    written out (`mirror_index`), reflecting more than once on planes
    narrower than the pad.

`epf_step` is the plain version of the hand-written CUDA kernel
(csrc/epf.cu). Every EPF pass of a decode goes through `apply_epf`, which
calls the kernel's wrapper `ops.cuda.epf.epf_step_cuda` (the plain
version only for tensors on the CPU), looked up on that module at each
call so that a measurement can wrap it in one place.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["gabor", "epf_step", "mirror_index", "EPF_NEG_K",
           "_EPF_KERNEL", "_EPF_DIST", "PAD", "sigma_map_from_blocks",
           "apply_gabor", "apply_epf"]

_EPF_KERNEL = {
    0: ((0, -2), (-1, -1), (0, -1), (1, -1), (-2, 0), (-1, 0), (1, 0),
        (2, 0), (-1, 1), (0, 1), (1, 1), (0, 2)),
    1: ((0, -1), (0, 1), (-1, 0), (1, 0)),
    2: ((0, -1), (0, 1), (-1, 0), (1, 0)),
}
_EPF_DIST = {
    0: ((0, -1), (1, 0), (0, 0), (-1, 0), (0, 1)),
    1: ((0, -1), (0, 0), (0, 1), (-1, 0), (1, 0)),
    2: ((0, 0),),
}
PAD = 3
# 6.6 * (1/sqrt(2) - 1), rounded as the JAX package rounds it (float32)
EPF_NEG_K = np.float32(6.6) * (np.float32(1.0 / np.sqrt(2.0)) - np.float32(1.0))


def gabor(plane: torch.Tensor, weights: tuple, prepad_rows: int = 0,
          prepad_cols: int = 0) -> torch.Tensor:
    """3x3 self-correlation smoothing (gabor.rs:8-121) of one channel,
    [H, W] or a stack [N, H, W] of one channel of N images.

    weights = (w0, w1): side and diagonal weights; kernel is
    [[w1 w0 w1], [w0 1 w0], [w1 w0 w1]] / (1 + 4*w0 + 4*w1),
    clamp-to-edge boundary.

    prepad_rows=1 (or prepad_cols=1): `plane` already carries one extra
    row (column) on each side, real halo data from a neighbouring shard
    (parallel/sharded.py); only the other dimension is clamped here, and
    the output drops the halo (jxl_oxide_tpu/ops/filters.py:38-45).
    """
    w0, w1 = weights
    h, w = plane.shape[-2:]
    if prepad_rows:
        assert prepad_rows == 1 and not prepad_cols
        pads, h = (1, 1, 0, 0), h - 2
    elif prepad_cols:
        assert prepad_cols == 1
        pads, w = (0, 0, 1, 1), w - 2
    else:
        pads = (1, 1, 1, 1)
    p = F.pad(plane.reshape(-1, 1, *plane.shape[-2:]), pads,
              mode="replicate")
    p = p.reshape(*plane.shape[:-2], h + 2, w + 2)
    c = p[..., 1:-1, 1:-1]
    n = p[..., :-2, 1:-1]
    s = p[..., 2:, 1:-1]
    w = p[..., 1:-1, :-2]
    e = p[..., 1:-1, 2:]
    nw = p[..., :-2, :-2]
    ne = p[..., :-2, 2:]
    sw = p[..., 2:, :-2]
    se = p[..., 2:, 2:]
    total = c + (n + s + w + e) * w0 + (nw + ne + sw + se) * w1
    return total * float(np.float32(1.0 / (1.0 + 4.0 * w0 + 4.0 * w1)))


def mirror_index(n: int, pad: int, device) -> torch.Tensor:
    """Source indices of a length-n axis padded by `pad` on each side with
    numpy's "symmetric" mode (edge sample repeated, reflecting again when
    pad > n). Same rule as `mirror` in csrc/epf_math.cuh."""
    i = torch.arange(-pad, n + pad, device=device) % (2 * n)
    return torch.where(i < n, i, 2 * n - 1 - i)


def _symmetric_pad(planes: torch.Tensor, pad_rows: int,
                   pad_cols: int) -> torch.Tensor:
    h, w = planes.shape[-2:]
    rows = mirror_index(h, pad_rows, planes.device)
    cols = mirror_index(w, pad_cols, planes.device)
    return planes[..., rows, :][..., cols]


def epf_step(planes: torch.Tensor, sigma: torch.Tensor, step: int,
             channel_scale: tuple, step_multiplier: float,
             border_sad_mul: float, prepad_rows: int = 0,
             prepad_cols: int = 0) -> torch.Tensor:
    """One EPF pass over the 3 color planes (impls/generic/epf.rs).

    planes: [3, H, W] float32, or a stack [N, 3, H, W] of N images;
    sigma: [H, W] (or [N, H, W]) per-pixel sigma, expanded from the
    per-8x8-block grid. Returns the filtered planes in the planes' shape.
    A stack is one set of ops over the leading axis, whatever N is, and
    each image's result is that of its own pass bit for bit (every op is
    elementwise or a gather within the image).

    prepad_rows=PAD (or prepad_cols=PAD): `planes` carries PAD real halo
    rows (columns) from neighbouring shards on each side; only the other
    dimension is mirrored here, sigma stays [H, W], and the output is
    [..., 3, H, W] (jxl_oxide_tpu/ops/filters.py:95-108). The step
    multiplier pattern is in the band's own coordinates, which is right
    where band bases are multiples of 8 (whole groups).
    """
    if prepad_rows:
        assert prepad_rows == PAD and not prepad_cols
        padded = _symmetric_pad(planes, 0, PAD)
        planes = planes[..., PAD:-PAD, :]
    elif prepad_cols:
        assert prepad_cols == PAD
        padded = _symmetric_pad(planes, PAD, 0)
        planes = planes[..., PAD:-PAD]
    else:
        padded = _symmetric_pad(planes, PAD, PAD)
    h, w = planes.shape[-2:]

    def shift(pc, dx, dy):
        return pc[..., PAD + dy : PAD + dy + h, PAD + dx : PAD + dx + w]

    # step multiplier pattern: border rows (y%8 in {0,7}) scale everything;
    # otherwise border columns (x%8 in {0,7}) scale (epf.rs:29-43).
    dev = planes.device
    yy = torch.arange(h, device=dev)[:, None] % 8
    xx = torch.arange(w, device=dev)[None, :] % 8
    border = (yy == 0) | (yy == 7) | (xx == 0) | (xx == 7)
    sm_border = float(np.float32(step_multiplier * border_sad_mul))
    sm_plain = float(np.float32(step_multiplier))
    sm = torch.where(
        border,
        torch.tensor(sm_border, dtype=torch.float32, device=dev),
        torch.tensor(sm_plain, dtype=torch.float32, device=dev),
    )
    neg_inv_sigma = (float(EPF_NEG_K) / sigma) * sm

    center = planes
    sum_weights = torch.ones(sigma.shape, dtype=torch.float32, device=dev)
    sum_channels = [center[..., c, :, :].clone() for c in range(3)]
    cs = [float(np.float32(v)) for v in channel_scale]
    for kx, ky in _EPF_KERNEL[step]:
        dist = torch.zeros(sigma.shape, dtype=torch.float32, device=dev)
        for c in range(3):
            acc = torch.zeros(sigma.shape, dtype=torch.float32, device=dev)
            pc = padded[..., c, :, :]
            for ix, iy in _EPF_DIST[step]:
                a = shift(pc, kx + ix, ky + iy)
                b = shift(pc, ix, iy)
                acc = acc + torch.abs(a - b)
            dist = dist + cs[c] * acc
        weight = torch.clamp_min(1.0 + dist * neg_inv_sigma, 0.0)
        sum_weights = sum_weights + weight
        for c in range(3):
            sum_channels[c] = (sum_channels[c]
                               + weight * shift(padded[..., c, :, :], kx, ky))

    filtered = torch.stack(sum_channels, dim=-3) / sum_weights[..., None, :, :]
    # sigma < 0.3: passthrough (epf.rs:64-69)
    keep = sigma < 0.3
    return torch.where(keep[..., None, :, :], center, filtered)


def sigma_map_from_blocks(sigma_blocks: np.ndarray, h: int, w: int) -> np.ndarray:
    """Expand the per-8x8-block sigma grid to a per-pixel [h, w] map."""
    m = np.repeat(np.repeat(sigma_blocks, 8, axis=0), 8, axis=1)
    return np.ascontiguousarray(m[:h, :w]).astype(np.float32)


def apply_gabor(planes, weights3) -> list:
    """Gaborish on the 3 color planes with per-channel weights; each plane
    [H, W], or [N, H, W] for a stack."""
    return [gabor(p, tuple(w)) for p, w in zip(planes, weights3)]


def apply_epf(planes, sigma: torch.Tensor, epf_params) -> torch.Tensor:
    """Full EPF: steps selected by iters (filter/epf.rs:45-88), each one
    pass of the kernel's wrapper. planes: a [3, H, W] tensor or three
    [H, W] planes with sigma [H, W], or a stack [N, 3, H, W] with sigma
    [N, H, W] (one launch per pass for the whole stack); sigma float32 on
    the planes' device."""
    from .cuda import epf as kernel

    x = planes if isinstance(planes, torch.Tensor) else torch.stack(
        list(planes))
    cs = tuple(epf_params.channel_scale)
    bsm = float(epf_params.border_sad_mul)
    if epf_params.iters == 3:
        x = kernel.epf_step_cuda(x, sigma, 0, cs,
                                 float(epf_params.pass0_sigma_scale), bsm)
    if epf_params.iters >= 1:
        x = kernel.epf_step_cuda(x, sigma, 1, cs, 1.0, bsm)
    if epf_params.iters >= 2:
        x = kernel.epf_step_cuda(x, sigma, 2, cs,
                                 float(epf_params.pass2_sigma_scale), bsm)
    return x
