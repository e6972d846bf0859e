"""Device-side VarDCT decode pipeline in torch.

Behavioral parity: jxl-render/src/vardct/mod.rs (dequant_hf_varblock,
chroma_from_luma_{lf,hf}, adaptive_lf_smoothing, copy_lf_dequant,
transform_with_lf); the torch counterparts of
jxl_oxide_tpu/ops/vardct_pipeline.py's single-device programs with the
same constructor arguments and the same operation order:
  - build_fused_pipeline: 4:4:4 frames;
  - build_fused_pipeline_subsampled (and its per-channel part,
    build_fused_pipeline_1ch): chroma-subsampled YCbCr frames, with the
    triangle chroma upsample before the filters;
  - build_fused_pipeline_sharded and
    build_fused_pipeline_subsampled_sharded: the same programs over a
    decode mesh (parallel/), each shard a band of whole groups on its own
    device, halos exchanged between neighbours;
  - dequant_plane, cfl_plane, cfl_lf, gather_blocks, scatter_blocks and
    transform_buckets: the staged path that render/vardct.py takes when
    a dense plan overflows.
Each fused stage is a whole-plane tensor op; per-varblock raggedness is
resolved by the host-built dense plan (render/vardct.py dense_plan), so
every shape is fixed per program key. Every EPF pass goes through the
hand-written CUDA kernel on a CUDA device (ops/filters.py apply_epf; on a
mesh, ops/cuda/epf.py epf_step_bands on each band).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.trace import count, device_span
from .filters import apply_epf, gabor
from .varblock import inverse_varblock_batch

__all__ = [
    "adaptive_lf_smoothing",
    "dense_transform_channels",
    "build_fused_pipeline",
    "build_fused_pipeline_subsampled",
    "build_fused_pipeline_1ch",
    "build_fused_pipeline_sharded",
    "build_fused_pipeline_subsampled_sharded",
    "dequant_plane",
    "cfl_plane",
    "cfl_lf",
    "gather_blocks",
    "scatter_blocks",
    "transform_buckets",
    "stack_inputs",
    "upload_inputs",
]


def _f32(v) -> float:
    """A constant rounded to float32, as JAX rounds a weakly typed one."""
    return float(np.float32(v))


def _bias(coeff, qb, qbn: float):
    """Dequant bias (vardct/mod.rs:443-541): |q| <= 1 -> q * qb, else
    q - qbn / q, on the float32 quantized coefficients."""
    q = coeff.to(torch.float32)
    safe_q = torch.where(q == 0.0, torch.ones((), device=q.device), q)
    return torch.where(torch.abs(q) <= 1.0, q * qb, q - qbn / safe_q)


def _sparse_to_dense(coeff, shape):
    """The dense int32 planes of a stack of sparse uploads: per image
    (flat_idx [S] i32 — or u16 index DELTAS, which arrive as an int16 view
    and are rebuilt by a cumsum — and values [S] i8/i16/i32), ascending-
    unique, padded with out-of-bounds indices; the pair stacked to [B, S].
    Returns [B, *shape]. torch has no "drop" scatter mode: each image's
    pads are redirected to one spare slot past its plane."""
    c_idx, c_val = coeff
    if c_idx.dtype == torch.int16:
        c_idx = torch.cumsum(c_idx.to(torch.int32) & 0xFFFF, -1) - 1
    n = int(np.prod(shape))
    b = c_idx.shape[0]
    c_idx = torch.where(c_idx < n, c_idx.to(torch.int64),
                        torch.full((), n, device=c_idx.device))
    c_idx = c_idx + torch.arange(b, device=c_idx.device)[:, None] * (n + 1)
    dense = torch.zeros((b * (n + 1),), dtype=torch.int32,
                        device=c_idx.device)
    dense.index_put_((c_idx.reshape(-1),), c_val.reshape(-1).to(torch.int32))
    return dense.reshape(b, n + 1)[:, :n].reshape(b, *shape)


def adaptive_lf_smoothing(lf_x, lf_y, lf_b, lf_scale):
    """Self-guided LF smoothing (generic/mod.rs:10-105).

    Interior pixels get a 3x3 weighted average gated by the per-channel
    quantization step (lf_scale = 512 * m_lf / (global_scale * quant_lf));
    borders are left untouched. torch.roll wraps at the edges like
    jnp.roll; the interior mask hides the wrapped values. Planes are
    [H, W], or [B, H, W] for a stack of B images (the rolls and the mask
    act on the last two axes).
    """
    scale_self = 0.052262735
    scale_side = 0.2034514
    scale_diag = 0.03348292

    def wa(img):
        side = (
            torch.roll(img, 1, dims=-1)
            + torch.roll(img, -1, dims=-1)
            + torch.roll(img, 1, dims=-2)
            + torch.roll(img, -1, dims=-2)
        )
        diag = (
            torch.roll(img, (1, 1), dims=(-2, -1))
            + torch.roll(img, (1, -1), dims=(-2, -1))
            + torch.roll(img, (-1, 1), dims=(-2, -1))
            + torch.roll(img, (-1, -1), dims=(-2, -1))
        )
        return img * scale_self + side * scale_side + diag * scale_diag

    planes = [lf_x, lf_y, lf_b]
    was = [wa(p) for p in planes]
    gap = torch.full(lf_x.shape, 0.5, dtype=torch.float32, device=lf_x.device)
    for p, w, s in zip(planes, was, lf_scale):
        gap = torch.maximum(gap, torch.abs(w - p) / float(s))
    gap_scale = torch.clamp_min(3.0 - 4.0 * gap, 0.0)

    h, w_ = lf_x.shape[-2:]
    yy = torch.arange(h, device=lf_x.device)[:, None]
    xx = torch.arange(w_, device=lf_x.device)[None, :]
    interior = (yy > 0) & (yy < h - 1) & (xx > 0) & (xx < w_ - 1)
    out = []
    for p, w in zip(planes, was):
        smoothed = (w - p) * gap_scale + p
        out.append(torch.where(interior, smoothed, p))
    return tuple(out)


def _sep_apply_4d(x4, Bv, Bh_, C, ny, v0, nx, h0):
    """Separable per-tile 2-D transform over a dense region given in the
    4-D view [C, ny, v0, Wr] (Wr = nx*h0): a vertical within-tile einsum
    over the full width, one [C, Hr, Wr] transpose, and the same
    horizontally (float32 throughout; TF32 is off on the card).

    Bv: [v0, v0] vertical basis (out_row <- coeff_row),
    Bh_: [h0, h0] horizontal basis (out_col <- coeff_col).
    """
    Hr, Wr = ny * v0, nx * h0
    v = torch.einsum("yj,cbjw->cbyw", Bv, x4).reshape(C, Hr, Wr)
    vt = v.transpose(1, 2).reshape(C, nx, h0, Hr)
    h = torch.einsum("xj,cbjh->cbxh", Bh_, vt).reshape(C, Wr, Hr)
    return h.transpose(1, 2)


def _tile_dct_in_order(x, av, ah, C, ny, th, nx, tw):
    """The forward DCT of every th x tw tile of x [C, ny*th, nx*tw] (the LF
    tiles of the multi-block types): per output, the products summed in
    index order as separate elementwise ops, vertically then horizontally.
    Unlike a matmul, whose library may sum in another order for another
    tensor size (on the card a K = 4 product of a whole plane and of a
    band of it differ in the last bit), every output is then the same sum
    whatever the plane's size, so a shard band's transform equals the
    whole plane's bit for bit. The tiles are LF samples, 1/64 of the
    pixels, and th, tw <= 32."""
    t = x.reshape(C, ny, th, nx, tw)
    v = None
    for k in range(th):
        term = av[:, k].reshape(1, 1, th, 1, 1) * t[:, :, k:k + 1]
        v = term if v is None else v + term
    h = None
    for j in range(tw):
        term = ah[:, j].reshape(1, 1, 1, 1, tw) * v[..., j:j + 1]
        h = term if h is None else h + term
    return h.reshape(C, ny * th, nx * tw)


def _entry_constants(entries, matrices, lf_shape, device):
    """Host-built constants of every plan entry, uploaded once: the tiled
    dequant matrix, DCT bases, corner mask, LF-embedding scale and the
    low-rank factors of the 8x8 specials. JAX baked these into the program
    at jit time; the torch program keeps them on the device per key."""
    from ..models.vardct import TransformType as _T
    from .dct import dct_basis_forward, dct_basis_inverse
    from .varblock import scale_f_map, special_lowrank_factors

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    BH, BW = lf_shape
    consts = []
    for sel, oy, ox in entries:
        tw, th = _T.SELECT_SIZE[sel]
        h0, w0 = th * 8, tw * 8
        ny = (BH - oy) // th
        nx = (BW - ox) // tw
        if ny <= 0 or nx <= 0:
            consts.append(None)
            continue
        Wr = nx * w0
        k = {"mat4": dev(np.tile(np.asarray(matrices[sel], np.float32),
                                 (1, 1, nx)))}
        lowrank = None
        if th * tw == 1 and sel != _T.DCT8:
            lowrank = special_lowrank_factors(sel, max_rank=20)
        k["separable"] = sel == _T.DCT8 or th * tw > 1 or lowrank is not None
        if k["separable"]:
            corner = np.zeros((h0, Wr), dtype=bool)
            corner[:th, :] = np.tile((np.arange(Wr) % w0 < tw)[None, :],
                                     (th, 1))
            k["corner"] = dev(corner)
            if th * tw > 1:
                k["av"] = dev(dct_basis_forward(th))
                k["ah"] = dev(dct_basis_forward(tw))
                k["sf4"] = dev(np.tile(scale_f_map(th, tw), (1, nx)))
            if lowrank is not None:
                vs, hs = lowrank
                k["lowrank"] = [(dev(vs[q]), dev(hs[q]))
                                for q in range(vs.shape[0])]
            else:
                k["bv"] = dev(dct_basis_inverse(h0))
                k["bh"] = dev(dct_basis_inverse(w0))
        consts.append(k)
    return consts


def dense_transform_channels(biased, lf_planes, kx_map, kb_map, code_grid,
                             mul_grid, entries, matrices, global_scale,
                             qm_scale, consts=None):
    """All varblock inverse transforms as DENSE per-(type, residue-offset)
    passes (jxl_oxide_tpu/ops/vardct_pipeline.py::dense_transform_channels),
    over a stack of B images that share one plan's entries.

    Varblock types partition the 8x8-block grid, so for each entry
    (dct_select, oy, ox) the plane is retiled at that block offset with
    pure reshapes, ALL aligned positions run through one batched inverse
    transform, and only tiles whose anchor in `code_grid` carries this
    entry's id contribute (masked input, then an in-place add into the
    output). Separable types and the low-rank 8x8 specials run as dense
    einsums over the plane; DCT8x4 (rank 64) takes the batched-tile
    layout through inverse_varblock_batch. The stack is folded into the
    channel axis of every transform (the B x C planes are transformed
    alike), and each image keeps its own anchors, multipliers and CfL
    maps, so the op sequence is the same for any B.

    biased:   [B, C, H, W] f32 (dequant bias already applied)
    lf_planes:[B, C, BH, BW] f32 dequantized+smoothed LF (DC source)
    kx_map/kb_map: [B, H, W] CfL factor maps, Python floats (constant
    correlation grids) or None (no CfL)
    code_grid:[B, BH, BW] int, entry id at each varblock anchor, -1 elsewhere
    mul_grid: [B, BH, BW] f32 hf_mul at anchors
    entries:  tuple of (dct_select, oy, ox)
    matrices: {sel: [C, h, w]} dequant matrix constants
    consts:   _entry_constants(...) for these entries (built if None)
    Returns [B, C, H, W].
    """
    from ..models.vardct import TransformType as _T

    B, C, H, W = biased.shape
    BH, BW = code_grid.shape[-2:]
    BC = B * C
    device = biased.device
    if consts is None:
        consts = _entry_constants(entries, matrices, (BH, BW), device)
    out = torch.zeros((B, C, H, W), dtype=torch.float32, device=device)
    qm = torch.tensor(np.asarray(qm_scale, dtype=np.float32), device=device)
    gs = float(np.float32(65536.0 / global_scale))

    for eid, (sel, oy, ox) in enumerate(entries):
        k = consts[eid]
        if k is None:
            continue
        tw, th = _T.SELECT_SIZE[sel]   # x-span, y-span in 8px blocks
        h0, w0 = th * 8, tw * 8
        ny = (BH - oy) // th
        nx = (BW - ox) // tw
        ys, xs = oy * 8, ox * 8
        Hr, Wr = ny * h0, nx * w0
        region4 = biased[:, :, ys:ys + Hr, xs:xs + Wr].reshape(
            B, C, ny, h0, Wr)
        mul_b = mul_grid[:, oy:oy + ny * th:th, ox:ox + nx * tw:tw]
        scale = (gs * qm)[None, :, None, None] / mul_b[:, None]
        scale4 = torch.repeat_interleave(scale, w0, dim=-1)  # [B, C, ny, Wr]
        deq = (region4 * k["mat4"][None, :, None]) * scale4[:, :, :, None, :]
        if kx_map is not None:
            if isinstance(kx_map, float):
                kx4 = float(np.float32(kx_map))
                kb4 = float(np.float32(kb_map))
            else:
                kx4 = kx_map[:, ys:ys + Hr, xs:xs + Wr].reshape(
                    B, ny, h0, Wr)
                kb4 = kb_map[:, ys:ys + Hr, xs:xs + Wr].reshape(
                    B, ny, h0, Wr)
            deq = torch.stack([
                deq[:, 0] + kx4 * deq[:, 1],
                deq[:, 1],
                deq[:, 2] + kb4 * deq[:, 1],
            ], dim=1)

        # anchor mask applied to the transform INPUT: every transform is
        # linear, so zeroed tiles produce zeroed pixels
        anchors = code_grid[:, oy:oy + ny * th:th, ox:ox + nx * tw:tw] == eid
        am4 = torch.repeat_interleave(anchors, w0, dim=-1)   # [B, ny, Wr]
        if k["separable"]:
            if th * tw == 1:
                # 1x1 types: the LF sample IS the DC input slot
                lf_a = lf_planes[:, :, oy:oy + ny, ox:ox + nx]
                lf4 = torch.repeat_interleave(lf_a, w0, dim=-1)[
                    :, :, :, None, :]
            else:
                # multi-block DCTnxm: embed fwd-DCT of the LF tile into
                # the low corner (transform_common.rs:11-77), all dense
                lf5 = lf_planes[:, :, oy:oy + ny * th, ox:ox + nx * tw]
                lf_c = _tile_dct_in_order(
                    lf5.reshape(BC, ny * th, nx * tw), k["av"], k["ah"], BC,
                    ny, th, nx, tw)
                lf_c4 = lf_c.reshape(BC, ny, th, nx * tw) / k["sf4"][None,
                                                                    None]
                lf4 = torch.nn.functional.pad(
                    lf_c4.reshape(BC, ny, th, nx, tw),
                    (0, w0 - tw, 0, 0, 0, h0 - th),
                ).reshape(B, C, ny, h0, Wr)
            am = am4[:, None, :, None, :]
            deq = torch.where(
                am & k["corner"][None, None, None], lf4,
                torch.where(am, deq, torch.zeros((), device=device)))
            deq = deq.reshape(BC, ny, h0, Wr)
            if "lowrank" in k:
                # non-separable special as a sum of Kronecker terms
                terms = k["lowrank"]
                pix = _sep_apply_4d(deq, terms[0][0], terms[0][1],
                                    BC, ny, h0, nx, w0)
                for vq, hq in terms[1:]:
                    pix = pix + _sep_apply_4d(deq, vq, hq, BC, ny, h0, nx,
                                              w0)
            else:
                pix = _sep_apply_4d(deq, k["bv"], k["bh"], BC, ny, h0, nx,
                                    w0)
        else:
            # DCT8x4: batched-tile layout (inputs pre-masked, incl. the
            # LF/DC values of non-anchor tiles)
            zero = torch.zeros((), device=device)
            deq = torch.where(am4[:, None, :, None, :], deq, zero)
            tiles = deq.reshape(BC, ny, h0, nx, w0).permute(0, 1, 3, 2, 4)
            lf_t = torch.where(anchors[:, None],
                               lf_planes[:, :, oy:oy + ny, ox:ox + nx], zero)
            pix = inverse_varblock_batch(
                tiles.reshape(BC * ny * nx, h0, w0),
                lf_t.reshape(BC * ny * nx, 1, 1),
                sel,
            ).reshape(BC, ny, nx, h0, w0).permute(0, 1, 3, 2, 4).reshape(
                BC, Hr, Wr)

        out[:, :, ys:ys + Hr, xs:xs + Wr].add_(pix.reshape(B, C, Hr, Wr))
    return out


def _sigma_map(sigma_blocks, H, W):
    """Per-pixel [B, H, W] sigma from the per-8x8-block grids [B, BH, BW]."""
    s = torch.repeat_interleave(sigma_blocks, 8, dim=-2)
    return torch.repeat_interleave(s, 8, dim=-1)[..., :H, :W].contiguous()


def _filter_tail(out, sigma_blocks, gabor_weights, epf_params, embed, crop):
    """The end of both fused programs on a stack of [B, 3, H, W] planes:
    gaborish, the EPF passes (one kernel launch per pass for the whole
    stack), then embed (ROI rect placed into a zero canvas at its frame
    position) and crop."""
    B, _, H, W = out.shape
    if gabor_weights is not None:
        out = torch.stack([
            gabor(out[:, c], tuple(gabor_weights[c])) for c in range(3)
        ], dim=1)
    if epf_params is not None:
        out = apply_epf(out, _sigma_map(sigma_blocks, H, W), epf_params)
    if embed is not None:
        fh, fw, oy, ox = embed
        full = torch.zeros((B, 3, fh, fw), dtype=torch.float32,
                           device=out.device)
        full[:, :, oy:oy + out.shape[2], ox:ox + out.shape[3]] = out
        out = full
    if crop is not None:
        out = out[:, :, : crop[0], : crop[1]]
    return out


def _lead(x):
    """One image's program input as a stack of one (a sparse pair, pair
    by pair)."""
    if isinstance(x, (tuple, list)):
        return tuple(a[None] for a in x)
    return x[None]


def _one_image(stacked):
    """The one-image form of a stacked program: the same ops on a stack of
    one image. `.stacked` is the program itself."""
    def program(*inputs):
        return stacked(*[_lead(x) for x in inputs])[0]

    program.stacked = stacked
    return program


def build_fused_pipeline(plane_shape, lf_shape, entries,
                         matrices, quant_bias, quant_bias_numerator,
                         global_scale, qm_scale, lf_scale,
                         skip_smoothing: bool,
                         cfl_lf_k=(0.0, 1.0), cfl_colour_factor=84,
                         cfl_base=(0.0, 1.0),
                         gabor_weights=None, epf_params=None,
                         sparse_coeff_n: int | None = None,
                         crop=None, embed=None, cfl_const: bool = False,
                         device=None):
    """The whole per-frame device pipeline as one callable on torch
    tensors: LF dequant/CfL/smoothing -> HF dequant -> HF CfL -> dense
    inverse transforms -> gaborish -> EPF -> embed/crop.

    Same constructor arguments as the JAX builder, plus `device` (default
    cuda, see device.resolve_device); the callable takes the
    `fused_program_parts` inputs as tensors on that device
    (upload_inputs) and returns [3, H, W] float32 planes there. Its
    `.stacked` takes the inputs of B images that share this program's key,
    each stacked on a leading axis (stack_inputs), and returns [B, 3, H,
    W]: the same op sequence for any B (the one-image form is a stack of
    one), with one EPF launch per pass for the whole stack.
    """
    from ..device import resolve_device

    device = resolve_device(device)
    H, W = plane_shape
    consts = _entry_constants(entries, matrices, lf_shape, device)
    qb = torch.tensor(np.asarray(quant_bias, dtype=np.float32),
                      device=device)[:, None, None]
    qbn = float(np.float32(quant_bias_numerator))
    kx0, kb0 = (float(np.float32(v)) for v in cfl_lf_k)

    def transform(coeff, lf_quant, lf_scale_arr, x_grid, b_grid,
                  code_grid, mul_grid):
        if sparse_coeff_n is not None:
            coeff = _sparse_to_dense(coeff, (3, H, W))
        # --- LF: dequant + CfL + smoothing ---
        lf_planes = lf_quant.to(torch.float32) * lf_scale_arr[:, :, None,
                                                              None]
        lf_planes = torch.stack([
            lf_planes[:, 0] + kx0 * lf_planes[:, 1],
            lf_planes[:, 1],
            lf_planes[:, 2] + kb0 * lf_planes[:, 1],
        ], dim=1)
        if not skip_smoothing:
            sm = adaptive_lf_smoothing(
                lf_planes[:, 0], lf_planes[:, 1], lf_planes[:, 2], lf_scale
            )
            lf_planes = torch.stack(list(sm), dim=1)

        # --- HF CfL factor maps from per-64x64 grids, expanded on device
        # (all-zero correlation grids collapse to scalar factors) ---
        if cfl_const:
            kx_map = float(cfl_base[0])
            kb_map = float(cfl_base[1])
        else:
            cf = float(np.float32(cfl_colour_factor))
            kx_map = (float(np.float32(cfl_base[0]))
                      + x_grid.to(torch.float32) / cf)
            kb_map = (float(np.float32(cfl_base[1]))
                      + b_grid.to(torch.float32) / cf)
            kx_map = kx_map.repeat_interleave(64, -2).repeat_interleave(
                64, -1)[:, :H, :W]
            kb_map = kb_map.repeat_interleave(64, -2).repeat_interleave(
                64, -1)[:, :H, :W]

        biased = _bias(coeff, qb, qbn)
        return dense_transform_channels(
            biased, lf_planes, kx_map, kb_map,
            code_grid, mul_grid.to(torch.float32), entries, matrices,
            global_scale, qm_scale, consts=consts,
        )

    def pipeline(coeff, lf_quant, lf_scale_arr, x_grid, b_grid,
                 sigma_blocks, code_grid, mul_grid):
        with device_span("Transform", lf_quant.device):
            out = transform(coeff, lf_quant, lf_scale_arr, x_grid, b_grid,
                            code_grid, mul_grid)
        with device_span("Filters", out.device):
            return _filter_tail(out, sigma_blocks, gabor_weights, epf_params,
                                embed, crop)

    return _one_image(pipeline)


def _triangle_up2(p, axis: int):
    """JPEG chroma 2x triangle upsample along one axis, clamp-to-edge
    (filter/ycbcr.rs apply_jpeg_upsampling_single): out[2j] leans on the
    previous sample, out[2j+1] on the next. `axis` may count from the end
    (-1, -2), which leading stack axes leave in place.

    Written adds-first with one exact *0.25 at the end ((prev + 3p)/4
    with 3p = (p+p)+p), as the JAX package writes it: adds followed by a
    power-of-two multiply cannot contract to FMA, so the result is the
    same bit for bit on every backend. Eager torch ops never contract;
    a fused kernel would have to keep this order itself."""
    p0 = torch.movedim(p, axis, 0)
    prev = torch.cat([p0[:1], p0[:-1]], dim=0)
    nxt = torch.cat([p0[1:], p0[-1:]], dim=0)
    p3 = (p0 + p0) + p0
    a = (prev + p3) * 0.25
    b = (p3 + nxt) * 0.25
    out = torch.stack([a, b], dim=1).reshape(
        (2 * p0.shape[0],) + tuple(p0.shape[1:]))
    return torch.movedim(out, 0, axis)


def build_fused_pipeline_1ch(plane_shape, lf_shape, entries, matrices,
                             quant_bias: float, quant_bias_numerator: float,
                             global_scale, qm_scale: float, lf_scale: float,
                             device=None):
    """Single-channel program of a chroma-subsampled frame: LF dequant ->
    dequant bias -> dense inverse transforms at the channel's stored
    geometry (no CfL across channels; the filters run after the chroma
    upsample, image.rs:448-486).

    entries: ((sel, oy, ox), ...); matrices: {sel: [h, w]} this channel.
    fn(coeff [H, W] int, lf_quant [LH, LW], code_grid, mul_grid)
    -> [H, W] f32 on `device`; fn.stacked takes and returns the same with
    a leading stack axis.
    """
    from ..device import resolve_device

    device = resolve_device(device)
    mats3 = {sel: np.asarray(m)[None] for sel, m in matrices.items()}
    consts = _entry_constants(entries, mats3, lf_shape, device)
    qb, qbn = _f32(quant_bias), _f32(quant_bias_numerator)
    lf_s = _f32(lf_scale)

    def pipeline(coeff, lf_quant, code_grid, mul_grid):
        lf_plane = lf_quant.to(torch.float32) * lf_s
        out = dense_transform_channels(
            _bias(coeff, qb, qbn)[:, None], lf_plane[:, None], None, None,
            code_grid, mul_grid.to(torch.float32), entries, mats3,
            global_scale, (qm_scale,), consts=consts,
        )
        return out[:, 0]

    return _one_image(pipeline)


def build_fused_pipeline_subsampled(
    plane_shapes, lf_shapes, full_shape, entries3, matrices3,
    quant_bias, quant_bias_numerator,
    global_scale, qm_scale, lf_scale,
    gabor_weights=None, epf_params=None,
    sparse_coeff_n=None,
    crop=None, embed=None, device=None,
):
    """One program for a chroma-subsampled (do_ycbcr, 4:2:0/4:2:2/4:4:0)
    VarDCT frame: each channel's build_fused_pipeline_1ch at its stored
    geometry, then the triangle chroma upsample (horizontal, then
    vertical, while the channel is short) and the restoration filters at
    full resolution. No CfL (the reference skips LF and HF CfL for
    subsampled frames, vardct/mod.rs:184,355) and no adaptive LF smoothing
    (subsampled streams set skip_adaptive_lf_smoothing).

    plane_shapes/lf_shapes: per-channel [x, y, b] stored geometries;
    full_shape: (Hr, Wr) rounded full resolution; entries3/matrices3/
    qm_scale/lf_scale/quant_bias: per-channel plans and constants.
    sparse_coeff_n: per-channel tuple of sparse upload sizes (None
    entries = dense upload for that channel).

    fn(c0, l0, code0, mul0, c1, l1, code1, mul1, c2, l2, code2, mul2,
    sigma_blocks) -> [3, crop_h, crop_w] f32 full-resolution planes on
    `device` (still YCbCr; the BT.601 conversion comes after); fn.stacked
    takes B images' inputs stacked on a leading axis and returns [B, 3,
    crop_h, crop_w], with the same op sequence for any B."""
    Hr, Wr = full_shape
    chans = [
        build_fused_pipeline_1ch(
            plane_shapes[c], lf_shapes[c], entries3[c], matrices3[c],
            quant_bias[c], quant_bias_numerator, global_scale, qm_scale[c],
            lf_scale[c], device=device,
        ).stacked
        for c in range(3)
    ]

    def transform(*args):
        planes = []
        for c in range(3):
            coeff, lf_quant, code_grid, mul_grid = args[4 * c : 4 * c + 4]
            if sparse_coeff_n is not None and sparse_coeff_n[c] is not None:
                coeff = _sparse_to_dense(coeff, plane_shapes[c])
            outc = chans[c](coeff, lf_quant, code_grid, mul_grid)
            while outc.shape[-1] < Wr:
                outc = _triangle_up2(outc, -1)
            while outc.shape[-2] < Hr:
                outc = _triangle_up2(outc, -2)
            planes.append(outc[:, :Hr, :Wr])
        return torch.stack(planes, dim=1)

    def pipeline(*args):
        with device_span("Transform", args[1].device):
            out = transform(*args)
        with device_span("Filters", out.device):
            return _filter_tail(out, args[12], gabor_weights, epf_params,
                                embed, crop)

    return _one_image(pipeline)


# -- the sharded programs ---------------------------------------------------


def _smooth_local(lf_bands, lf_scale, mesh, vloc_lf: int, last_shard: int,
                  lh_valid: int, lw_valid: int, shard_dim: str) -> list:
    """Adaptive LF smoothing on the LF bands [3, lh_loc, lw] (rows) or
    [3, lh, lw_loc] (cols) of this process's shards: adaptive_lf_smoothing's
    arithmetic in the same operand order, with the 1-px neighbourhood
    across a shard boundary from the neighbour and the interior mask in
    GLOBAL coordinates (borders keep the unsmoothed value,
    generic/mod.rs:10-105; jxl_oxide_tpu/ops/vardct_pipeline.py:444-492)."""
    from ..parallel.sharded import halo_pad_cols, halo_pad_rows

    by_rows = shard_dim == "rows"
    halo_pad = halo_pad_rows if by_rows else halo_pad_cols
    padded = halo_pad(lf_bands, 1, mesh, vloc_lf, last_shard)
    scale_self = 0.052262735
    scale_side = 0.2034514
    scale_diag = 0.03348292
    out = []
    for s, lf, pb in zip(mesh.local, lf_bands, padded):
        p = torch.nn.functional.pad(
            pb[None], (1, 1, 0, 0) if by_rows else (0, 0, 1, 1),
            mode="replicate")[0]
        c = p[:, 1:-1, 1:-1]
        side = (p[:, 1:-1, :-2] + p[:, 1:-1, 2:] + p[:, :-2, 1:-1]
                + p[:, 2:, 1:-1])
        diag = (p[:, :-2, :-2] + p[:, :-2, 2:] + p[:, 2:, :-2]
                + p[:, 2:, 2:])
        was = c * scale_self + side * scale_side + diag * scale_diag
        gap = torch.full(lf.shape[1:], 0.5, dtype=torch.float32,
                         device=lf.device)
        for ch in range(3):
            gap = torch.maximum(gap, torch.abs(was[ch] - lf[ch])
                                / float(lf_scale[ch]))
        gap_scale = torch.clamp_min(3.0 - 4.0 * gap, 0.0)
        h, w = lf.shape[1:]
        yy = torch.arange(h, device=lf.device)[:, None]
        xx = torch.arange(w, device=lf.device)[None, :]
        if by_rows:
            yy = yy + s * h
        else:
            xx = xx + s * w
        interior = ((yy > 0) & (yy < lh_valid - 1) & (xx > 0)
                    & (xx < lw_valid - 1))
        out.append(torch.stack([
            torch.where(interior, (was[ch] - lf[ch]) * gap_scale + lf[ch],
                        lf[ch])
            for ch in range(3)
        ]))
    return out


def _sharded_filter_tail(bands, sigma_blocks, mesh, gabor_weights,
                         epf_params, vloc: int, last_shard: int,
                         by_rows: bool) -> list:
    """Gaborish after a 1-px halo, then each EPF pass after a fresh halo
    (the next pass's neighbourhood across a boundary is the previous
    pass's output, as in the sequential whole-plane passes), on the bands
    [3, h, w] of this process's shards (jxl_oxide_tpu/ops/
    vardct_pipeline.py:603-638). Each EPF pass is K1 on the bands with an
    8-px halo (ops/cuda/epf.py epf_step_bands)."""
    from ..parallel.sharded import halo_pad_cols, halo_pad_rows
    from .cuda import epf as kernel

    halo_pad = halo_pad_rows if by_rows else halo_pad_cols
    dim = -2 if by_rows else -1
    if gabor_weights is not None:
        padded = halo_pad(bands, 1, mesh, vloc, last_shard)
        bands = [torch.stack([
            gabor(p[c], tuple(gabor_weights[c]),
                  prepad_rows=1 if by_rows else 0,
                  prepad_cols=0 if by_rows else 1)
            for c in range(3)]) for p in padded]
    if epf_params is None:
        return bands
    h, w = bands[0].shape[-2:]
    sigmas = halo_pad([_sigma_map(sb, h, w)[None] for sb in sigma_blocks],
                      kernel.BAND_HALO, mesh, vloc, last_shard)
    sigmas = [s_[0] for s_ in sigmas]
    cs = tuple(epf_params.channel_scale)
    bsm = float(epf_params.border_sad_mul)
    steps = []
    if epf_params.iters == 3:
        steps.append((0, float(epf_params.pass0_sigma_scale)))
    if epf_params.iters >= 1:
        steps.append((1, 1.0))
    if epf_params.iters >= 2:
        steps.append((2, float(epf_params.pass2_sigma_scale)))
    for step, mult in steps:
        bands = kernel.epf_step_bands(bands, sigmas, step, cs, mult, bsm,
                                      mesh, vloc, last_shard, dim)
    return bands


def _join(mesh, bands, by_rows: bool, crop):
    """The bands joined on this process's home device (every shard's,
    across processes too), then cut to the frame."""
    from ..parallel.sharded import join_bands

    out = join_bands(mesh, bands, -2 if by_rows else -1)
    if crop is not None:
        out = out[:, : crop[0], : crop[1]]
    return out


def _device_groups(mesh) -> dict:
    """This process's shards grouped by device, in mesh order: device ->
    positions in mesh.local. The transforms of one group run as one
    stack, which also gives their matmuls the whole plane's sizes where
    the bands tile it on one device: cuBLAS may sum a product of another
    size in another order."""
    groups: dict = {}
    for k, s in enumerate(mesh.local):
        groups.setdefault(mesh.devices[s], []).append(k)
    return groups


def build_fused_pipeline_sharded(
    mesh, local_plane_shape, local_lf_shape, entries,
    matrices, quant_bias, quant_bias_numerator,
    global_scale, qm_scale, lf_scale,
    skip_smoothing: bool,
    vloc: int, vloc_lf: int, lf_valid: tuple,
    last_shard: int,
    cfl_lf_k=(0.0, 1.0), cfl_colour_factor=84,
    cfl_base=(0.0, 1.0),
    gabor_weights=None, epf_params=None,
    sparse_coeff_n: int | None = None,
    crop=None, cfl_const: bool = False,
    shard_dim: str = "rows",
):
    """The fused 4:4:4 program over a decode mesh (jxl_oxide_tpu/ops/
    vardct_pipeline.py:495-675, there under shard_map): bands of whole
    groups, rows for tall frames and columns for wide ones, one per shard,
    each on its shard's device. Shapes are LOCAL: the sharded dimension
    is padded to n_shards * loc with loc a multiple of the group size, so
    no varblock crosses a band boundary and band bases keep every
    transform's residues. `last_shard` holds the valid image edge at
    local offset `vloc` (`vloc_lf` on the LF grid); later shards carry
    only padding.

    fn(shards): `shards` lists, for each of this process's shards in mesh
    order, its 8 inputs on its device (coeff [3, Hl, Wl] int or the sparse
    pair (idx [S] i32, val [S]) with ascending out-of-bounds pads, lf_quant
    [3, LHl, LWl], lf_scale_arr [3], x_grid/b_grid, sigma_blocks,
    code_grid and mul_grid of the band). Returns [3, crop_h, crop_w]
    float32 on the mesh's home device: the bands joined there, then cut."""
    Hl, Wl = local_plane_shape
    lh_valid, lw_valid = lf_valid
    by_rows = shard_dim == "rows"
    devices = _device_groups(mesh)
    consts = {d: _entry_constants(entries, matrices, local_lf_shape, d)
              for d in devices}
    qb = {d: torch.tensor(np.asarray(quant_bias, dtype=np.float32),
                          device=d)[:, None, None] for d in devices}
    qbn = _f32(quant_bias_numerator)
    kx0, kb0 = (_f32(v) for v in cfl_lf_k)
    cf = _f32(cfl_colour_factor)

    def band_lf(coeff, lf_quant, lf_scale_arr):
        if sparse_coeff_n is not None:
            coeff = _sparse_to_dense(
                tuple(a[None] for a in coeff), (3, Hl, Wl))[0]
        lf = lf_quant.to(torch.float32) * lf_scale_arr[:, None, None]
        lf = torch.stack([lf[0] + kx0 * lf[1], lf[1], lf[2] + kb0 * lf[1]])
        return coeff, lf

    def group_transform(coeff, lf, x_grid, b_grid, code_grid, mul_grid):
        """The dense transforms of the stacked bands of one device."""
        if cfl_const:
            kx_map = float(cfl_base[0])
            kb_map = float(cfl_base[1])
        else:
            kx_map = _f32(cfl_base[0]) + x_grid.to(torch.float32) / cf
            kb_map = _f32(cfl_base[1]) + b_grid.to(torch.float32) / cf
            kx_map = kx_map.repeat_interleave(64, -2).repeat_interleave(
                64, -1)[:, :Hl, :Wl]
            kb_map = kb_map.repeat_interleave(64, -2).repeat_interleave(
                64, -1)[:, :Hl, :Wl]
        dev = coeff.device
        return dense_transform_channels(
            _bias(coeff, qb[dev], qbn), lf, kx_map, kb_map, code_grid,
            mul_grid.to(torch.float32), entries, matrices, global_scale,
            qm_scale, consts=consts[dev])

    def pipeline(shards):
        coeffs, lfs = zip(*[band_lf(*x[:3]) for x in shards])
        lfs = list(lfs)
        if not skip_smoothing:
            lfs = _smooth_local(lfs, lf_scale, mesh, vloc_lf, last_shard,
                                lh_valid, lw_valid, shard_dim)
        bands = [None] * len(shards)
        for ks in devices.values():
            out = group_transform(
                torch.stack([coeffs[k] for k in ks]),
                torch.stack([lfs[k] for k in ks]),
                *[torch.stack([shards[k][i] for k in ks])
                  for i in (3, 4, 6, 7)])
            for k, band in zip(ks, out.unbind(0)):
                bands[k] = band
        bands = _sharded_filter_tail(bands, [x[5] for x in shards], mesh,
                                     gabor_weights, epf_params, vloc,
                                     last_shard, by_rows)
        return _join(mesh, bands, by_rows, crop)

    return pipeline


def build_fused_pipeline_subsampled_sharded(
    mesh, local_plane_shapes, local_lf_shapes, local_full_shape,
    entries3, matrices3,
    quant_bias, quant_bias_numerator,
    global_scale, qm_scale, lf_scale,
    vloc: int, last_shard: int,
    gabor_weights=None, epf_params=None,
    crop=None, shard_dim: str = "rows",
):
    """build_fused_pipeline_subsampled over a decode mesh (jxl_oxide_tpu/
    ops/vardct_pipeline.py:797-939): each channel's stored plane shards at
    its own band size (loc >> shift; group bands stay whole in every
    channel's coordinates). The triangle chroma upsample runs HORIZONTAL
    then VERTICAL in both layouts, the single-device program's order (2-D
    triangle roundings do not commute across axis order); along the
    sharded axis it takes ONE stored-resolution halo sample from the
    neighbour (clamp-to-edge is the 1-wide mirror the halo gives at the
    valid edges), along the other it is local. The full-resolution filter
    tail is the 4:4:4 program's.

    local_* shapes are per shard; vloc/last_shard give the valid image
    edge at full resolution (each channel's is vloc >> shift). fn(shards):
    for each of this process's shards, its 13 inputs on its device (per
    channel dense coeff, lf_quant, code_grid, mul_grid; then the
    full-resolution sigma block grid). Returns [3, crop_h, crop_w] on the
    home device (still YCbCr)."""
    from ..parallel.sharded import halo_pad_cols, halo_pad_rows

    Hl, Wl = local_full_shape
    by_rows = shard_dim == "rows"
    halo_pad = halo_pad_rows if by_rows else halo_pad_cols
    devices = _device_groups(mesh)
    chans = [
        {d: build_fused_pipeline_1ch(
            local_plane_shapes[c], local_lf_shapes[c], entries3[c],
            matrices3[c], quant_bias[c], quant_bias_numerator,
            global_scale, qm_scale[c], lf_scale[c], device=d).stacked
         for d in devices}
        for c in range(3)
    ]

    def up2_sharded(bands, vloc_c):
        """Triangle 2x upsample along the SHARDED axis: a 1-sample halo,
        then the upsampled halo sliced off."""
        padded = halo_pad([b[None] for b in bands], 1, mesh, vloc_c,
                          last_shard)
        if by_rows:
            return [_triangle_up2(p[0], -2)[2:-2, :] for p in padded]
        return [_triangle_up2(p[0], -1)[:, 2:-2] for p in padded]

    def pipeline(shards):
        planes = []
        for c in range(3):
            outc = [None] * len(shards)
            for d, ks in devices.items():
                coeff, lf_quant, code_grid, mul_grid = (
                    torch.stack([shards[k][i] for k in ks])
                    for i in range(4 * c, 4 * c + 4))
                out = chans[c][d](coeff, lf_quant, code_grid, mul_grid)
                for k, band in zip(ks, out.unbind(0)):
                    outc[k] = band
            if by_rows:
                while outc[0].shape[-1] < Wl:
                    outc = [_triangle_up2(b, -1) for b in outc]
                while outc[0].shape[-2] < Hl:
                    outc = up2_sharded(outc, vloc // (Hl // outc[0].shape[-2]))
            else:
                while outc[0].shape[-1] < Wl:
                    outc = up2_sharded(outc, vloc // (Wl // outc[0].shape[-1]))
                while outc[0].shape[-2] < Hl:
                    outc = [_triangle_up2(b, -2) for b in outc]
            planes.append([b[:Hl, :Wl] for b in outc])
        bands = [torch.stack([planes[c][k] for c in range(3)])
                 for k in range(len(shards))]
        bands = _sharded_filter_tail(bands, [x[12] for x in shards], mesh,
                                     gabor_weights, epf_params, vloc,
                                     last_shard, by_rows)
        return _join(mesh, bands, by_rows, crop)

    return pipeline


# -- the staged path's stages (render/vardct.py _run_staged) ---------------


def dequant_plane(raw_plane, dmap, quant_bias: float,
                  quant_bias_numerator: float):
    """HF coefficient dequantization over a whole coefficient plane:
    the dequant bias, times the host-built per-position multiplier map
    (matrix value x 65536 / (global_scale * hf_mul) * qm_scale)."""
    return _bias(raw_plane, _f32(quant_bias),
                 _f32(quant_bias_numerator)) * dmap


def cfl_plane(coeff_x, coeff_y, coeff_b, kx_map, kb_map):
    """Chroma-from-luma: x += kx*y, b += kb*y with per-64x64-tile factors
    expanded to full-resolution maps on the host (vardct/mod.rs:570-607)."""
    return coeff_x + kx_map * coeff_y, coeff_b + kb_map * coeff_y


def cfl_lf(lf_x, lf_y, lf_b, kx: float, kb: float):
    """LF chroma-from-luma with scalar factors (vardct/mod.rs:544-567)."""
    return lf_x + _f32(kx) * lf_y, lf_b + _f32(kb) * lf_y


def _flat_index(idx, n: int):
    """int64 flat indices with jnp's rule: an index in [-n, 0) counts from
    the end; `inside` marks those within [-n, n)."""
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    return idx, (idx >= 0) & (idx < n)


def gather_blocks(plane, idx):
    """plane.ravel()[idx] with idx [n, h, w] integer; an index outside the
    plane reads 0 (jnp.take's "fill" mode, written out)."""
    flat = plane.reshape(-1)
    idx, inside = _flat_index(idx, flat.numel())
    got = torch.take(flat, torch.where(inside, idx, 0))
    return torch.where(inside, got, torch.zeros((), dtype=flat.dtype,
                                                device=flat.device))


def scatter_blocks(plane, idx, values):
    """plane.ravel()[idx] = values as a new plane; a write outside the
    plane is dropped (the "drop" mode, written out: it lands in a spare
    slot past the plane)."""
    flat = plane.reshape(-1)
    n = flat.numel()
    idx, inside = _flat_index(idx.reshape(-1), n)
    out = torch.cat([flat, flat.new_zeros(1)])
    out.index_put_((torch.where(inside, idx, n),),
                   values.reshape(-1).to(out.dtype))
    return out[:n].reshape(plane.shape)


def transform_buckets(coeff_plane, lf_plane, out_plane, buckets):
    """Apply all varblock inverse transforms for one channel.

    buckets: list of (dct_select, coeff_idx [n,H,W], lf_idx [n,bh,bw],
    out_idx [n,H,W]) index tensors into the flattened planes, on the
    planes' device. Each bucket is one batched transform."""
    for sel, coeff_idx, lf_idx, out_idx in buckets:
        coeffs = gather_blocks(coeff_plane, coeff_idx)
        lf = gather_blocks(lf_plane, lf_idx)
        pixels = inverse_varblock_batch(coeffs, lf, sel)
        out_plane = scatter_blocks(out_plane, out_idx, pixels)
    return out_plane


_ALIGN = 16


def _flatten(inputs):
    flat = []
    for x in inputs:
        if isinstance(x, torch.Tensor):
            flat.append(x)
        elif isinstance(x, (tuple, list)):
            flat.append(tuple(np.ascontiguousarray(a) for a in x))
        else:
            flat.append(np.ascontiguousarray(x))
    return flat


def stack_inputs(per_image):
    """The program inputs of B images that share a program key (each a
    `fused_program_parts` input list) as one list of stacked numpy
    arrays, input by input; a sparse (index, value) pair stacks pair by
    pair. The key fixes every input's shape and the grouping its dtype."""
    out = []
    for xs in zip(*per_image):
        if isinstance(xs[0], (tuple, list)):
            out.append(tuple(np.stack(a) for a in zip(*xs)))
        else:
            out.append(np.stack(xs))
    return out


def upload_inputs(inputs, device):
    """The fused program's host inputs (numpy arrays, the sparse pair as a
    tuple) as tensors on `device`, moved by ONE host-to-device copy: all
    arrays are packed into one (pinned, on CUDA) byte buffer, copied with
    non_blocking=True, and sliced back into typed views on the device.
    uint16 index deltas travel as an int16 view. An input that is a
    tensor already (an LF frame's planes, render/vardct.py) stays where it
    is; it must be on `device`. The arrays are copied into the staging
    buffer before this returns, so the caller may write into them while
    the copy to the card is in flight (a loading frame's cached planes
    take later sections); the caching host allocator keeps the staging
    block until that copy is done. The staging buffer's size counts as
    `bytes` of the open span (`Upload`) while recording."""
    device = torch.device(device)
    flat = _flatten(inputs)
    for x in flat:
        if isinstance(x, torch.Tensor) and (
                x.device.type != device.type
                or None not in (x.device.index, device.index)
                and x.device.index != device.index):
            raise ValueError(f"program input on {x.device}, not {device}")
    arrays = [a for x in flat if not isinstance(x, torch.Tensor)
              for a in (x if isinstance(x, tuple) else (x,))]
    offsets = []
    total = 0
    for a in arrays:
        offsets.append(total)
        total += -(-a.nbytes // _ALIGN) * _ALIGN
    pin = device.type == "cuda"
    staging = torch.empty(max(total, 1), dtype=torch.uint8, pin_memory=pin)
    count(bytes=staging.numel())
    host = staging.numpy()
    for a, off in zip(arrays, offsets):
        host[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
    dev = staging.to(device, non_blocking=True)
    views = []
    for a, off in zip(arrays, offsets):
        np_dt = np.int16 if a.dtype == np.uint16 else a.dtype
        t_dt = torch.from_numpy(np.zeros(0, dtype=np_dt)).dtype
        views.append(
            dev[off:off + a.nbytes].view(t_dt).reshape(a.shape)
        )
    out = []
    k = 0
    for x in flat:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, tuple):
            out.append(tuple(views[k:k + len(x)]))
            k += len(x)
        else:
            out.append(views[k])
            k += 1
    return out
