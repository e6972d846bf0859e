"""The render tails of a frame, on the device.

VarDCT: the device planes of render/vardct.py decode_vardct_planes ->
chroma upsample -> crop -> gaborish -> EPF. The fused programs upsample
and filter inside the program (state.chroma_upsampled,
state.filters_applied), so on their planes the tail only crops; the
staged path's planes take every step here.

Modular: the original channels of the frame's ModularImage -> floats
(integer samples, lossless XYB, or float samples, converted where the
samples are: on the card after the device tail) -> chroma upsample of a
chroma-subsampled YCbCr frame (`upsample_chroma`, each channel converted
at its own size) -> crop -> gaborish -> EPF at the frame's constant
sigma, on full-resolution planes. A greyscale frame has one
colour plane: the filters run on it cloned to three planes, as the JAX
package runs them, and plane 0 is kept (the EPF's distance sums the
three channels in order, so the clone keeps it bit for bit).

Extra channels (any number, any kind: alpha, spot colour, depth, the
Black of CMYK, ...) convert with their own bit depth, integer or float,
and are never filtered (`extra_channel_planes`), on both paths: a VarDCT
frame's come from the GlobalModular image beside its HF data.

`render_frame` renders one frame of any kind (keyframe, reference-only,
cropped) to a FrameRender of frame-sized planes on the device: the host
entropy stage (`host_stage`), then the device stage (`device_stage`).
With a ProgressiveCache (render/vardct.py) it renders a loading frame
(api.py `render_loading_frame`): `partial_host_stage` decodes only the
sections complete since the last call into the cached state, and the
device stage runs on what has arrived (missing groups decode as zero
HF, a missing HfGlobal as pure LF, a Modular frame finishes a snapshot
of its channels). Under a decode region (render/roi.py, api.py
`set_image_region`) a one-shot render decodes only the sections that
meet the region, and a VarDCT frame's fused program computes only the
group-aligned rect around it (`device_rect`); the planes keep the
frame's size, zero outside the rect. Under a decode mesh (parallel/)
the VarDCT device stage runs sharded and the rect is ignored (the frame
renders whole and is cut later), and the Modular device tail runs in row
bands.
Colour stays as coded (YCbCr for a YCbCr frame, XYB for an XYB image):
the colour transform runs at compositing (render/context.py) or at the
end (api.py `_postprocess`).

Behavioral parity: jxl-render/src/render.rs (render_frame), image.rs
(upsample_jpeg, convert_modular_xyb) and jxl-image lib.rs
(integer-sample parsing); jxl_oxide_tpu/render/render.py::render_frame.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..headers.frame import Encoding
from ..io.bitstream import Bitstream
from ..ops.filters import apply_epf, apply_gabor, sigma_map_from_blocks
from ..utils.options import use_decode_device
from ..utils.trace import span, traced

__all__ = ["FrameRender", "HostStage", "ModularHostStage",
           "apply_frame_upsampling", "coefficient_host_stage",
           "device_stage", "extra_channel_planes",
           "host_stage", "partial_host_stage", "render_frame",
           "render_modular_tail", "render_vardct_tail",
           "upsample_chroma", "upsample_ec_to_color"]


@dataclass
class FrameRender:
    """One rendered frame before blending (jxl_oxide_tpu/render/render.py
    FrameRender): float32 [h, w] planes at the frame's sample size on the
    decode device, colour as coded, then one plane per extra channel."""

    color: list
    extra: list
    frame: object
    # colour already in the signalled encoding (render/context.py
    # `_convert_color_for_record`): the final colour tail skips it
    ct_done: bool = False
    # the extra channels were brought to the colour channels' resolution
    # for patches (`upsample_ec_to_color`): what remains of their factor
    # is the frame's
    ec_at_color_res: bool = False
    # `apply_frame_upsampling` ran
    upsampled: bool = False


@dataclass
class HostStage:
    """What the host entropy stage of a VarDCT frame hands to the device
    stage."""

    state: object       # render.vardct.VardctFrameState
    hf_global: object   # render.vardct.HfGlobal
    frame: object
    # the samples (numpy) of every extra channel, in ec_info order
    extra: list = field(default_factory=list)
    # a loading frame's cached state (`partial_host_stage`): later
    # sections write into its planes, so the device stage keeps them
    resumable: bool = False
    # the plane rect (x0, y0, x1, y1) the fused program computes under a
    # decode region (render/roi.py `device_rect`), or None
    rect: tuple | None = None


@dataclass
class ModularHostStage:
    """What the host stage of a Modular frame hands to the device stage:
    the frame's ModularImage, and its original channels when the host ran
    the inverse transforms (None when the device tail will)."""

    modular: object     # models.modular.ModularImage
    channels: list | None
    frame: object


def _upload(chans: list, device) -> torch.Tensor:
    """The colour channels `chans` (one or three) as one [c, h, w] tensor
    on `device`: tensors stay where they are; host arrays go up in one
    copy in their own integer type (i16 from the narrow lane stays
    i16)."""
    if isinstance(chans[0], torch.Tensor):
        return torch.stack(chans)
    return torch.from_numpy(np.stack(chans)).to(device)


def integer_samples_to_float(planes: torch.Tensor, bits: int) -> torch.Tensor:
    """Integer samples -> [0, 1] float32 (jxl-image lib.rs:458-487): an
    IEEE float32 division by 2^bits - 1, bit for bit the JAX package's
    numpy division. The divisor is a tensor on the planes' device: a
    Python scalar divisor makes torch's CUDA division multiply by its
    reciprocal, which can differ by an ulp."""
    div = torch.tensor(float(np.float32((1 << bits) - 1)),
                       dtype=torch.float32, device=planes.device)
    return planes.to(torch.float32) / div


def float_samples_to_float(samples: torch.Tensor, bit_depth) -> torch.Tensor:
    """Float samples stored as integers -> float32, on the samples' device
    (the float branch of jxl_oxide_tpu/render/render.py
    _parse_integer_samples, jxl-image lib.rs:458-487), bit for bit the JAX
    package's numpy: sign, exponent and mantissa are cut from the low
    `bits` bits in int64, the value is built in float64 (the power of two
    from its exponent bits, exact) and rounded once to float32. 32-bit
    samples with 8 exponent bits are float32 bit patterns."""
    bits = bit_depth.bits_per_sample
    exp_bits = bit_depth.exp_bits
    u = samples.to(torch.int64) & ((1 << bits) - 1)
    if bits == 32 and exp_bits == 8:
        # the low 32 bits as a signed int32, then reinterpreted
        return (u - ((u >> 31) << 32)).to(torch.int32).view(torch.float32)
    mantissa_bits = bits - exp_bits - 1
    sign = (u >> (bits - 1)) & 1
    exp = (u >> mantissa_bits) & ((1 << exp_bits) - 1)
    mant = (u & ((1 << mantissa_bits) - 1)).to(torch.float64) / float(
        1 << mantissa_bits)
    bias = (1 << (exp_bits - 1)) - 1

    def pow2(e):
        # 2^e as float64 from its exponent field: exact, where a pow or
        # ldexp on the card need not be
        return ((e + 1023) << 52).view(torch.float64)

    val = torch.where(exp == 0, mant * pow2(torch.full_like(exp, 1 - bias)),
                      (1.0 + mant) * pow2(exp - bias))
    return torch.where(sign == 1, -val, val).to(torch.float32)


def samples_to_float(samples: torch.Tensor, bit_depth) -> torch.Tensor:
    """Integer samples of `bit_depth` (integer or float) -> float32."""
    if bit_depth.is_float:
        return float_samples_to_float(samples, bit_depth)
    return integer_samples_to_float(samples, bit_depth.bits_per_sample)


def extra_channel_planes(chans: list, ec_info: list, device) -> list:
    """[h, w] float32 planes on `device` of a frame's extra channels, from
    their samples (numpy arrays, or int32 tensors from the device tail),
    each converted with its own bit depth, integer or float (jxl-render
    image.rs:507-508). No filter touches them."""
    out = []
    for chan, info in zip(chans, ec_info):
        t = chan if isinstance(chan, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(chan))
        out.append(samples_to_float(t.to(device), info.bit_depth))
    return out


@traced("Render frame")
def render_modular_tail(frame, chans: list, device) -> tuple[list, list]:
    """(color, extra) on `device` from the original channels of a Modular
    frame (numpy arrays after the host tail, int32 tensors on the device
    after the device tail): the frame's colour planes (three, or one for
    greyscale) as [h, w] float32, filtered as the frame says, and one plane
    per extra channel, unfiltered."""
    header = frame.header
    meta = frame.image_header.metadata
    bit_depth = meta.bit_depth
    h, w = header.sample_height(), header.sample_width()
    # colour is the first 1 or 3 channels; an alpha follows
    color_chans = chans[:header.encoded_color_channels]
    if meta.xyb_encoded:
        # convert_modular_xyb (image.rs:148-188): stream order [y, x, b],
        # b += y, output [x*m_x, y*m_y, b*m_b] with m/128 scaling, in
        # float64 and then rounded to float32, as the JAX package does
        y, x, b = _upload(color_chans, device).to(torch.float64).unbind(0)
        b = b + y
        m_x, m_y, m_b = (m / 128.0 for m in frame.lf_global.lf_dequant)
        color = [(x * m_x).to(torch.float32), (y * m_y).to(torch.float32),
                 (b * m_b).to(torch.float32)]
    elif len({tuple(c.shape) for c in color_chans}) > 1:
        # chroma-subsampled YCbCr: each channel at its own size, then
        # upsampled to the frame's (render/render.py:151-152, 176-192 of
        # the JAX package), before the filters
        color = upsample_chroma(header, [
            samples_to_float(_upload([c], device)[0], bit_depth)
            for c in color_chans])
        color = [p[:h, :w] for p in color]
    else:
        color = list(samples_to_float(_upload(color_chans, device),
                                      bit_depth).unbind(0))
    extra = extra_channel_planes(
        chans[frame.lf_global.gmodular.extra_channel_from:], meta.ec_info,
        color[0].device)

    rf = header.restoration_filter
    gray_cloned = (rf.gab.enabled or rf.epf.enabled) and len(color) < 3
    if gray_cloned:
        # the JAX package's render_frame (render/render.py:205-227)
        color = [color[0]] * 3
    if rf.gab.enabled:
        color = apply_gabor(color, rf.gab.weights)
    if rf.epf.enabled:
        sigma = torch.full((h, w), float(np.float32(rf.epf.sigma_for_modular)),
                           dtype=torch.float32, device=color[0].device)
        out = apply_epf(color, sigma, rf.epf)
        color = [out[0], out[1], out[2]]
    if gray_cloned:
        color = list(color[:1])
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


def upsample_chroma(header, color: list) -> list:
    """YCbCr chroma upsampling of a frame's three colour planes
    (image.rs upsample_jpeg; jxl_oxide_tpu/render/render.py:176-192):
    each subsampled plane 2x horizontally, then 2x vertically, cut to the
    frame's sample size. Planes already at that size (a fused program
    upsampled them) and frames that are not YCbCr pass as they are."""
    if not header.do_ycbcr:
        return color
    h, w = header.sample_height(), header.sample_width()
    ups = header.jpeg_upsampling
    hscale = any(v in (1, 2) for v in ups)
    vscale = any(v in (1, 3) for v in ups)
    out = []
    for i, p in enumerate(color):
        # channel i is stored h-subsampled iff ups[i] in (0, 3) and any
        # channel sets hscale; v-subsampled iff ups[i] in (0, 2)
        # (param.rs from_jpeg_upsampling)
        if hscale and ups[i] not in (1, 2) and p.shape[1] < w:
            p = _upsample2x_triangle(p, 1, w)
        if vscale and ups[i] not in (1, 3) and p.shape[0] < h:
            p = _upsample2x_triangle(p, 0, h)
        out.append(p)
    return out


@traced("Render frame")
def render_vardct_tail(state, planes: list) -> list:
    """Three [h, w] float32 planes at the frame's sample size from the
    cropped device planes of one VarDCT frame (still YCbCr for a YCbCr
    frame), on the planes' device."""
    header = state.header
    h, w = header.sample_height(), header.sample_width()
    # the fused subsampled program has upsampled already, so the shapes
    # skip it
    color = upsample_chroma(header, list(planes))
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


@traced("Host entropy stage")
def host_stage(frame) -> HostStage | ModularHostStage:
    """Headers of the frame's sections plus the C++ entropy decode: into
    whole-frame coefficient planes and the extra channels for a VarDCT
    frame (jxl_oxide_tpu/serving.py `_host_stage_fast`), into the Modular
    channel slots for a Modular frame, whose inverse transforms run here
    when the gate keeps them on the host. The gate reads the decode
    device of the caller's context (utils/options.py)."""
    if frame.header.encoding == Encoding.MODULAR:
        return _modular_host_stage(frame)
    return _vardct_host_stage(frame)


def _modular_host_stage(fr) -> ModularHostStage:
    return _host_tail_if_selected(fr.decode_modular_sections(), fr)


def _host_tail_if_selected(modular, fr) -> ModularHostStage:
    """The inverse transforms on the host unless the gate keeps them for
    the device stage."""
    chans = None
    if not modular.device_tail_selected():
        with span("Modular tail"):
            chans = modular.finish()
    return ModularHostStage(modular, chans, fr)


def coefficient_host_stage(frame) -> HostStage:
    """The host entropy stage of a VarDCT frame for JPEG reconstruction
    (jbr/ `reconstruct_jpeg`; the counterpart of jxl_oxide_tpu/render/
    vardct.py `decode_vardct_frame(frame, keep_coeffs=True)`, without its
    device pipeline): every section decodes into a state whose quantized
    coefficient and LF-quant planes ([x, y, b]) are its own, never taken
    from or given back to the plane pool, and stay; no device stage runs.
    A render before or after is unaffected:
    each host stage parses the frame's LfGlobal afresh."""
    if frame.header.encoding != Encoding.VARDCT:
        raise ValueError("not a VarDCT frame")
    return _vardct_host_stage(frame, keep_coeffs=True)


def _vardct_host_stage(fr, keep_coeffs: bool = False) -> HostStage:
    from .roi import device_rect, frame_supports_roi, get_decode_region
    from .vardct import HfGlobal, VardctFrameState, parse_lf_group

    header = fr.header
    # each call decodes afresh: a single-section frame reads its groups
    # from the bitstream its LfGlobal parse leaves behind
    fr.lf_global = None
    lf_global = fr.parse_lf_global()
    gmod = lf_global.gmodular
    roi = None if keep_coeffs else get_decode_region()
    if roi is not None and not frame_supports_roi(fr):
        roi = None
    # a VarDCT frame's modular image holds its extra channels only; their
    # sub-streams follow the LF and HF data of the sections (jxl-frame
    # pass_group.rs:139)
    modular = gmod.modular
    if modular is not None:
        mlf_groups, pass_groups = modular.prepare_groups(fr.pass_shifts)
    else:
        mlf_groups, pass_groups = {}, [{}]

    state = VardctFrameState(fr, pooled=not keep_coeffs)
    if fr.toc.is_single_entry:
        bs = fr._single_bs
        state.place_lf_group(0, parse_lf_group(
            bs, fr.image_header, header, lf_global, 0, mlf_groups.get(0)
        ))
        hf_global = HfGlobal(bs, fr.image_header, header, lf_global)
        for p in range(header.passes.num_passes):
            state.decode_pass_group_hf(bs, hf_global, p, 0)
            fr._decode_pass_group(bs, p, 0, _pass_sub(pass_groups, p, 0),
                                  gmod)
    else:
        hf_global = _decode_vardct_sections(fr, state, lf_global,
                                            (mlf_groups, pass_groups),
                                            roi=roi)
    extra = []
    if modular is not None and not keep_coeffs:
        extra = list(modular.finish()[gmod.extra_channel_from:])
    rect = device_rect(fr, state, roi) if roi is not None else None
    return HostStage(state, hf_global, fr, extra, rect=rect)


def _pass_sub(pass_groups, p: int, g: int):
    return pass_groups[p].get(g) if p < len(pass_groups) else None


def _decode_vardct_sections(fr, state, lf_global, groups, hf_global=None,
                            take=None, roi=None):
    """The sections of a multi-section VarDCT frame into `state`, with
    the native batches: its LF groups, then HfGlobal (unless `hf_global`
    is given), then its pass groups, each group's passes in order. With
    `take` (a loading frame's `ProgressiveCache.take`), only the sections
    it takes, and HfGlobal only once complete. With `roi` (a coded-space
    decode region, render/roi.py), only the groups that meet it, as
    jxl_oxide_tpu/render/vardct.py decode_vardct_frame selects them; the
    pass groups decoded are counted in fr._pass_group_jobs. Returns the
    HfGlobal, or None while it has not arrived (no pass group decodes
    then)."""
    from .roi import group_intersects, lf_group_intersects
    from .vardct import (
        HfGlobal,
        _decode_lf_groups_batch,
        _decode_pass_groups_batch,
        parse_lf_group,
    )

    header = fr.header
    gmod = lf_global.gmodular
    mlf_groups, pass_groups = groups
    lf_jobs = [i for i in range(header.num_lf_groups)
               if (take is None or take(("lf_group", i)))
               and (roi is None or lf_group_intersects(fr, i, roi))]
    if lf_jobs:
        done = _decode_lf_groups_batch(fr, state, lf_global, lf_jobs,
                                       mlf_groups)
        for lf_idx in (i for i in lf_jobs if i not in done):
            bs = Bitstream(
                fr.section_bytes(fr.toc.entry_for("lf_group", lf_idx)))
            state.place_lf_group(lf_idx, parse_lf_group(
                bs, fr.image_header, header, lf_global, lf_idx,
                mlf_groups.get(lf_idx)))
        # the bucket plans follow the LF groups present
        state._bucket_cache = {}
    if hf_global is None and (take is None
                              or fr.section_complete("hf_global")):
        bs = Bitstream(fr.section_bytes(fr.toc.entry_for("hf_global")))
        hf_global = HfGlobal(bs, fr.image_header, header, lf_global)
    if hf_global is None:
        return None
    by_group: dict[int, list] = {}
    for g in range(header.num_groups):
        if roi is not None and not group_intersects(fr, g, roi):
            continue
        # a pass group needs its LF group's varblock grid, and the passes
        # of a group add up in order: each is taken after the one before
        after = ("lf_group", header.lf_group_idx_from_group_idx(g))
        for p in range(header.passes.num_passes):
            key = ("group_pass", g, p)
            if take is None or take(key, after):
                by_group.setdefault(g, []).append((p, g))
            after = key
    fr._pass_group_jobs = sum(len(v) for v in by_group.values())
    leftover = _decode_pass_groups_batch(
        fr, state, hf_global, by_group, pass_groups, gmod) if by_group else []
    for jobs in leftover:
        for p, g in jobs:
            bs = Bitstream(
                fr.section_bytes(fr.toc.entry_for("group_pass", g, p)))
            state.decode_pass_group_hf(bs, hf_global, p, g)
            fr._decode_pass_group(bs, p, g, _pass_sub(pass_groups, p, g),
                                  gmod)
    return hf_global


def partial_host_stage(frame, cache) -> HostStage | ModularHostStage:
    """The host stage of a loading frame, resumable through `cache` (a
    render.vardct.ProgressiveCache, which parses the frame's LfGlobal once
    and keeps it); each call decodes only the sections complete since the
    last (jxl_oxide_tpu/render/vardct.py _decode_vardct_progressive,
    render/frame.py _decode_modular_progressive). A single-section frame
    takes the one-shot `host_stage`, which raises JxlEofError until the
    frame is complete (the JAX package's gate, `cache is not None and not
    frame.toc.is_single_entry`)."""
    if frame.toc.is_single_entry:
        return host_stage(frame)
    return _resumable_host_stage(frame, cache)


@traced("Host entropy stage")
def _resumable_host_stage(frame, cache) -> HostStage | ModularHostStage:
    if frame.header.encoding == Encoding.MODULAR:
        # the render finishes a copy: the decoded buffers stay as they
        # are for the sections to come (its device tail uploads the copy)
        return _host_tail_if_selected(
            frame.decode_new_modular_sections(cache).snapshot(), frame)
    return _vardct_resumable_host_stage(frame, cache)


def _vardct_resumable_host_stage(fr, cache) -> HostStage:
    """The new sections of a loading VarDCT frame into the cached state
    (`_decode_vardct_sections` with the cache's `take`). A section that is
    not complete is skipped and decodes on a later call."""
    from .vardct import VardctFrameState

    lf_global = cache.start(fr)
    if cache.vardct_state is None:
        cache.vardct_state = VardctFrameState(fr)
    cache.hf_global = _decode_vardct_sections(
        fr, cache.vardct_state, lf_global, cache.groups_prepared,
        cache.hf_global, lambda key, after=None: cache.take(fr, key, after))
    gmod = lf_global.gmodular
    extra = []
    if gmod.modular is not None:
        # finish a copy, so that later sections decode into the original
        extra = list(gmod.modular.snapshot().finish()[
            gmod.extra_channel_from:])
    return HostStage(cache.vardct_state, cache.hf_global, fr, extra,
                     resumable=True)


@traced("Frame device stage")
def device_stage(host, device) -> FrameRender:
    """The device stage on the host stage's output. VarDCT: the fused
    4:4:4 program, the fused subsampled program or the staged path, then
    the render tail. Modular: the inverse transforms on the device when
    the host did not run them, then the render tail. The colour planes
    stay as coded (no YCbCr -> RGB, no colour transform)."""
    frame = host.frame
    meta = frame.image_header.metadata
    if isinstance(host, ModularHostStage):
        chans = host.channels
        if chans is None:
            with use_decode_device(device), span("Modular tail"):
                chans = host.modular.finish(to_device=True)
        color, extra = render_modular_tail(frame, chans, device)
    else:
        from .vardct import decode_vardct_planes

        state = host.state
        color = decode_vardct_planes(state, host.hf_global, device,
                                     host.rect)
        if not host.resumable:
            # a cached state's planes still take later sections: handing
            # them to the plane pool now would let another decode zero
            # and fill them
            state.trim_coeff_planes()
        color = render_vardct_tail(state, color)
        extra = extra_channel_planes(host.extra, meta.ec_info,
                                     color[0].device)
    return FrameRender(color=list(color), extra=list(extra), frame=frame)


def render_frame(frame, device, cache=None) -> FrameRender:
    """Decode and filter one frame on `device` (jxl_oxide_tpu/render/
    render.py render_frame): planes at the frame's sample size, before
    blending and before the colour transform. With `cache` (a
    render.vardct.ProgressiveCache), from what has arrived of the frame
    (`partial_host_stage`). Without one, a complete frame that loading
    renders began resumes from the cache they left (`resume_cache`, as
    the JAX package's add_frame and cone pass the frame's cache). A
    complete frame releases the cache it rendered from."""
    if cache is None:
        cache = resume_cache(frame)
    with use_decode_device(device):
        if cache is None:
            return device_stage(host_stage(frame), device)
        fr = device_stage(partial_host_stage(frame, cache), device)
        if frame.is_complete:
            # no section is left to land in the cached planes
            cache.release()
        return fr


def resume_cache(frame):
    """The ProgressiveCache a complete frame resumes from: the one its
    loading renders left, until released. Only the sections not yet
    decoded then decode. An incomplete frame gets none: its render_frame
    raises as before instead of rendering a partial keyframe."""
    cache = getattr(frame, "_progressive_cache", None)
    if cache is None or cache.released or not frame.is_complete:
        return None
    return cache


def _ec_factor(header, meta, i: int) -> int:
    """Total EC upsampling factor to full resolution: ec_upsampling <<
    dim_shift (render.rs:110-118 upsampling_factor)."""
    return (
        header.ec_upsampling[i] if i < len(header.ec_upsampling) else 1
    ) << meta.ec_info[i].dim_shift


def upsample_ec_to_color(fr: FrameRender) -> None:
    """Bring the extra channels to the colour channels' (sample)
    resolution before patch blending (render.rs:183, image.rs:487-513
    ec_to_color_only: each channel upsamples by its factor over the
    frame's; jxl_oxide_tpu/render/render.py upsample_ec_to_color). With
    patches the EC upsampling is therefore two-stage (EC -> colour here,
    colour -> full in `apply_frame_upsampling`), which rounds differently
    from the one-shot EC -> full upsample of a frame without patches, as
    the reference does."""
    if fr.ec_at_color_res:
        return
    from ..ops.upsample import upsample_nonseparable

    header = fr.frame.header
    meta = fr.frame.image_header.metadata
    th, tw = header.sample_height(), header.sample_width()
    for i, p in enumerate(fr.extra):
        if tuple(p.shape) == (th, tw):
            continue
        factor = _ec_factor(header, meta, i) // header.upsampling
        fr.extra[i] = upsample_nonseparable(p, factor, meta)[:th, :tw]
    fr.ec_at_color_res = True


def apply_frame_upsampling(fr: FrameRender) -> None:
    """Frame and EC non-separable upsampling to the full frame size, after
    the features (render.rs:149 upsample_nonseparable; features run at
    sample resolution in full-resolution coordinates, clipped). Once per
    frame render (jxl_oxide_tpu/render/render.py apply_frame_upsampling)."""
    if fr.upsampled:
        return
    fr.upsampled = True
    from ..ops.upsample import upsample_nonseparable

    header = fr.frame.header
    meta = fr.frame.image_header.metadata
    target_h, target_w = header.sample_height(1), header.sample_width(1)
    with span("Upsampling"):
        if header.upsampling > 1:
            fr.color = [
                upsample_nonseparable(p, header.upsampling, meta)[
                    :target_h, :target_w]
                for p in fr.color
            ]
        for i, p in enumerate(fr.extra):
            if tuple(p.shape) == (target_h, target_w):
                continue
            # the remaining factor: the whole EC factor, or the frame's
            # where patches staged the EC at colour resolution already
            factor = (header.upsampling if fr.ec_at_color_res
                      else _ec_factor(header, meta, i))
            fr.extra[i] = upsample_nonseparable(p, factor, meta)[
                :target_h, :target_w]
