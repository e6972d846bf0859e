"""Render context: frame sequencing, reference slots, blending, patches.

Behavioral parity: jxl-render/src/lib.rs (RenderContext) and blend.rs
(blend_single and the patch kernels); the torch counterpart of
jxl_oxide_tpu/render/context.py, which composites in host numpy. Here
canvases, reference slots and keyframes are [H, W] float32 tensors on
the decode device, and nothing is read back.

Each blend is written as separate torch ops in the order of the JAX
package's numpy expressions (no fused or in-place forms that would
round differently), so a canvas equals the reference's bit for bit when
the frames do. Torch tensors are mutable where jax arrays are not: a
canvas saved to a slot is cloned, a base read from a slot is cloned
before a blend writes into it, and a patch reads the destination alpha
as a view, with the colour channels blended before the alpha.

The feature pass runs on each frame's planes at sample resolution, in
the reference's order (render.rs render_features): patches, splines,
noise; then the frame and EC upsampling (render/render.py), then the
colour transform before blending. LF frames render, upsample and go to
the LF slot of their level, for the frames that set use_lf_frame. A
loading frame composites through the same steps in `composite_partial`,
which leaves the slots and the keyframe counters as they are.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..headers.frame import BlendMode, FrameType
from ..utils.alloc import release_alloc, track_alloc
from ..utils.errors import JxlNotSupportedError
from ..utils.trace import span
from .render import (
    FrameRender,
    apply_frame_upsampling,
    render_frame,
    upsample_ec_to_color,
)

__all__ = ["KeyframeRender", "RenderContext", "planes_bytes"]


@dataclass
class KeyframeRender:
    """A composited keyframe: colour and extra channel planes at the image
    size, on the decode device."""

    color: list
    extra: list
    frame: object
    name: str = ""
    duration: int = 0
    # colour already in the signalled encoding (blend.rs:219 carries the
    # new frame's ct_done onto the composited canvas)
    ct_done: bool = False


def planes_bytes(value) -> int:
    """Bytes of a plane list, or of a (colour, extra) slot value."""
    if value is None:
        return 0
    planes = (list(value[0]) + list(value[1]) if isinstance(value, tuple)
              else list(value))
    return sum(p.numel() * p.element_size() for p in planes)


def _recip(mixed: torch.Tensor) -> torch.Tensor:
    """where(mixed > 0, 1 / where(mixed == 0, 1, mixed), 0), as numpy
    evaluates it: two wheres and an IEEE division of a tensor (torch's
    `1.0 / t` is reciprocal(t) * 1.0)."""
    one = torch.ones((), dtype=mixed.dtype, device=mixed.device)
    safe = torch.where(mixed == 0, one, mixed)
    return torch.where(mixed > 0.0, one / safe, torch.zeros_like(mixed))


def _blend_planes(base, new, mode, x0, y0, base_alpha, new_alpha, clamp,
                  premultiplied, is_alpha_channel):
    """One channel blend (blend.rs:550-680). base is image-sized, new is
    frame-sized placed at (x0, y0). Writes into base."""
    ih, iw = base.shape
    fh, fw = new.shape
    # intersect the frame's rect with the canvas
    sx0, sy0 = max(0, -x0), max(0, -y0)
    dx0, dy0 = max(0, x0), max(0, y0)
    w = min(fw - sx0, iw - dx0)
    h = min(fh - sy0, ih - dy0)
    if w <= 0 or h <= 0:
        return
    nv = new[sy0:sy0 + h, sx0:sx0 + w]
    bview = base[dy0:dy0 + h, dx0:dx0 + w]

    if mode == BlendMode.REPLACE:
        bview.copy_(nv)
    elif mode == BlendMode.ADD:
        bview += nv
    elif mode == BlendMode.MUL:
        s = torch.clamp(nv, 0.0, 1.0) if clamp else nv
        bview *= s
    elif mode == BlendMode.BLEND:
        na = (new_alpha[sy0:sy0 + h, sx0:sx0 + w]
              if new_alpha is not None else None)
        ba = (base_alpha[dy0:dy0 + h, dx0:dx0 + w]
              if base_alpha is not None else torch.zeros_like(bview))
        if is_alpha_channel:
            # MixAlpha (blend.rs mix_alpha): a_out = na + ba * (1 - na)
            nval = torch.clamp(nv, 0.0, 1.0) if clamp else nv
            bview.copy_(nval + bview * (1.0 - nval))
        elif na is None:
            bview.copy_(nv)
        else:
            na = torch.clamp(na, 0.0, 1.0) if clamp else na
            if premultiplied:
                bview.copy_(nv + bview * (1.0 - na))
            else:
                recip = _recip(1.0 - (1.0 - na) * (1.0 - ba))
                bview.copy_((na * nv + ba * bview * (1.0 - na)) * recip)
    elif mode == BlendMode.MUL_ADD:
        na = (new_alpha[sy0:sy0 + h, sx0:sx0 + w]
              if new_alpha is not None else None)
        if is_alpha_channel:
            pass  # Skip (blend.rs MulAdd alpha channel)
        elif na is None:
            bview += nv
        else:
            na = torch.clamp(na, 0.0, 1.0) if clamp else na
            bview += na * nv
    else:
        raise JxlNotSupportedError(f"blend mode {mode}")


class RenderContext:
    """Sequences the frames of one image, keeping the reference slots."""

    def __init__(self, image_header, device):
        self.image_header = image_header
        self.device = torch.device(device)
        # the canvas lives in coded space; orientation applies at output
        self.width = image_header.size.width
        self.height = image_header.size.height
        self.reference = [None] * 4  # saved (colour, extra) plane lists
        # LF slots: slot l holds the colour planes of the LF frame of
        # level l + 1, read by the frames of lf_level l that set
        # use_lf_frame
        self.lf_frames = [None] * 4
        # noise-seed counters (features/noise.rs frame visibility); they
        # follow from the headers alone, so a cone render sets them for
        # each frame it renders (api.py `_render_keyframe`)
        self._frame_counter = 0
        self._num_prev_keyframes = 0
        self._last_keyframe_idx: int | None = None

    # -- tracked slots (jxl-grid alloc_tracker.rs: a release per save) -----

    def set_reference(self, slot: int, value) -> None:
        release_alloc(planes_bytes(self.reference[slot]))
        track_alloc(planes_bytes(value))
        self.reference[slot] = value

    def release_slot(self, slot: int) -> None:
        self.set_reference(slot, None)

    def set_lf_frame(self, level: int, planes) -> None:
        release_alloc(planes_bytes(self.lf_frames[level]))
        track_alloc(planes_bytes(planes))
        self.lf_frames[level] = planes

    def release_lf_frame(self, level: int) -> None:
        self.set_lf_frame(level, None)

    def _attach_lf_planes(self, frame) -> None:
        """Hand a use_lf_frame frame the LF planes of its level: the
        VarDCT paths take them as its pre-dequantized LF
        (render/vardct.py `lf_override`)."""
        header = frame.header
        if not header.flags.use_lf_frame:
            return
        lf_planes = self.lf_frames[header.lf_level]
        if lf_planes is None:
            raise JxlNotSupportedError(
                f"use_lf_frame with empty LF slot {header.lf_level}")
        frame._lf_frame_planes = lf_planes

    def add_frame(self, frame, fr: FrameRender | None = None
                  ) -> KeyframeRender | None:
        """Render (unless `fr` is given) and composite one frame, in
        codestream order. Returns the keyframe render of a keyframe.

        An LF frame (render/lib.rs LF slots) renders at its 8^lf_level
        downsampling, upsamples, and goes to slot lf_level - 1; it may
        itself use the next level's LF frame."""
        header = frame.header
        self._attach_lf_planes(frame)
        if fr is None:
            # a frame that loading renders began resumes from its cache
            fr = render_frame(frame, self.device)
        # the frame object outlives this render: let go of the slot's
        # device planes
        frame._lf_frame_planes = None
        if header.frame_type == FrameType.LF_FRAME:
            with span("LF frame"):
                apply_frame_upsampling(fr)
                self.set_lf_frame(header.lf_level - 1, list(fr.color))
            self._frame_counter += 1
            return None
        kf = self._blend(fr, frame)
        if header.can_reference:
            # the slot outlives this frame's canvas, which a later blend or
            # the keyframe cache may hold
            self.set_reference(header.save_as_reference, (
                [p.clone() for p in kf.color], [p.clone() for p in kf.extra]))
        if not header.is_keyframe:
            self._frame_counter += 1
            return None
        self._num_prev_keyframes += 1
        self._last_keyframe_idx = self._frame_counter
        self._frame_counter += 1
        return kf

    def composite_partial(self, fr: FrameRender, frame) -> KeyframeRender:
        """Composite a loading (partly decoded) frame through the real
        blend path, its offsets and BlendingInfo against the saved slots,
        without saving a slot or counting a keyframe (jxl_oxide_tpu/
        render/context.py composite_partial; jxl-render/src/lib.rs:723-894,
        image.rs:788-845)."""
        return self._blend(fr, frame)

    def _blend(self, fr: FrameRender, frame) -> KeyframeRender:
        """Features, frame upsampling, the colour transform before
        blending, then the blend onto the canvas: what a frame adds to the
        image, with no slot or counter touched."""
        with span("Composite"):
            self._apply_features(fr, frame)
            apply_frame_upsampling(fr)
            self._convert_color_for_record(fr, frame)
            canvas_color, canvas_extra = self._composite(fr, frame)
        header = frame.header
        return KeyframeRender(color=canvas_color, extra=canvas_extra,
                              frame=frame, name=header.name,
                              duration=header.duration, ct_done=fr.ct_done)

    def _apply_features(self, fr: FrameRender, frame) -> None:
        """Patches, then splines, then noise, on the frame's planes at
        sample resolution (render.rs render_features). Splines and noise
        touch three colour planes only, as in the reference."""
        lf_global = frame.lf_global
        if lf_global is None or not (lf_global.patches or lf_global.splines
                                     or lf_global.noise):
            return
        header = frame.header
        # the features write into the frame's planes: own them
        fr.color = [p.clone() for p in fr.color]
        fr.extra = [p.clone() for p in fr.extra]
        base_corr = None
        if lf_global.vardct is not None:
            cc = lf_global.vardct.lf_chan_corr
            base_corr = (cc.base_correlation_x, cc.base_correlation_b)
        if lf_global.patches is not None:
            # patch blending needs the extra channels at the colour
            # channels' (sample) resolution first (render.rs:183)
            upsample_ec_to_color(fr)
            self._apply_patches(fr, lf_global.patches)
        if lf_global.splines is not None and len(fr.color) == 3:
            from .features import render_spline

            render_spline(fr.color, lf_global.splines, base_corr,
                          header.width, header.height)
        if lf_global.noise is not None and len(fr.color) == 3:
            from .features import render_noise

            is_kf = header.is_keyframe
            visible = self._num_prev_keyframes + (1 if is_kf else 0)
            if is_kf:
                invisible = 0
            elif self._last_keyframe_idx is None:
                invisible = 1 + self._frame_counter
            else:
                invisible = self._frame_counter - self._last_keyframe_idx
            render_noise(fr.color, header, visible, invisible, base_corr,
                         lf_global.noise.lut)

    def _convert_color_for_record(self, fr: FrameRender, frame) -> None:
        """The colour transform before blending and recording when
        save_before_ct is false (render.rs:151, image.rs:807
        composite_preprocess, util.rs:311-375 convert_color_for_record):
        a blending frame of a YCbCr or XYB image composites in the
        signalled space; sets fr.ct_done so the final tail skips it."""
        header = frame.header
        meta = self.image_header.metadata
        skip_blending = (not header.frame_type.is_normal
                         or header.resets_canvas)
        if (fr.ct_done or header.save_before_ct
                or (header.is_last and skip_blending)):
            return
        from ..headers.image import ColourEncoding, ColourSpace

        if header.do_ycbcr:
            # xyb_encoded is false here (do_ycbcr implies a non-XYB image)
            from ..ops.color import ycbcr_to_rgb

            rgb = list(ycbcr_to_rgb(fr.color[0], fr.color[1], fr.color[2]))
            # a grey image keeps the red plane (util.rs:311-375, as the
            # JAX package's render/context.py does)
            fr.color = (rgb[:1] if meta.colour_encoding.colour_space
                        == ColourSpace.GREY else rgb)
            fr.ct_done = True
        elif meta.xyb_encoded:
            enc = meta.colour_encoding
            if enc.want_icc or enc.colour_space in (ColourSpace.XYB,
                                                    ColourSpace.UNKNOWN):
                # nothing to convert to (util.rs:332-347)
                return
            from ..color.convert import ColorTransform

            tr = ColorTransform.build(
                ColourEncoding(colour_space=ColourSpace.XYB), enc,
                meta.opsin_inverse_matrix, meta.tone_mapping,
            )
            if not tr.is_noop:
                fr.color = list(tr.run(fr.color))
            fr.ct_done = True

    def _composite(self, fr: FrameRender, frame):
        """Blend the rendered frame onto its base canvas (blend.rs blend);
        returns image-sized (canvas_color, canvas_extra)."""
        header = frame.header
        meta = self.image_header.metadata
        binfo = header.blending_info
        full_replace = (
            binfo.mode == BlendMode.REPLACE
            and not header.have_crop
            and all(e.mode == BlendMode.REPLACE
                    for e in header.ec_blending_info)
        )
        if full_replace and tuple(fr.color[0].shape) == (self.height,
                                                         self.width):
            # the frame's own planes: its render is dropped after this
            return list(fr.color), list(fr.extra)

        # each blended channel takes its base slot, base alpha and
        # premultiplied flag from its own BlendingInfo (blend.rs:218-232,
        # 353-354): colour from binfo, each EC from its ec_blending_info
        def zeros():
            return torch.zeros((self.height, self.width),
                               dtype=torch.float32, device=self.device)

        def base_color(src, ci):
            base = self.reference[src]
            if base is None or not base[0]:
                return zeros()
            planes = base[0]
            return planes[ci if ci < len(planes) else 0].clone()

        def base_extra(src, ei):
            base = self.reference[src]
            if base is None or ei >= len(base[1]):
                return zeros()
            return base[1][ei].clone()

        def base_alpha(src, alpha_idx):
            base = self.reference[src]
            if base is None or alpha_idx >= len(base[1]):
                return None
            return base[1][alpha_idx]

        def alpha_ctx(info):
            """(base alpha, new alpha, premultiplied) of one blend."""
            if not info.mode.use_alpha:
                return None, None, False
            ai = info.alpha_channel
            new_a = fr.extra[ai] if ai < len(fr.extra) else None
            premul = bool(meta.ec_info and ai < len(meta.ec_info)
                          and meta.ec_info[ai].alpha_associated)
            return base_alpha(info.source, ai), new_a, premul

        canvas_color = [base_color(binfo.source, ci)
                        for ci in range(len(fr.color))]
        canvas_extra = [base_extra(header.ec_blending_info[ei].source, ei)
                        for ei in range(len(fr.extra))]
        base_a, new_a, premul = alpha_ctx(binfo)
        for ci, plane in enumerate(fr.color):
            _blend_planes(canvas_color[ci], plane, binfo.mode, header.x0,
                          header.y0, base_a, new_a, binfo.clamp, premul,
                          False)
        for ei, plane in enumerate(fr.extra):
            einfo = header.ec_blending_info[ei]
            base_a, new_a, premul = alpha_ctx(einfo)
            is_alpha = einfo.mode.use_alpha and ei == einfo.alpha_channel
            _blend_planes(canvas_extra[ei], plane, einfo.mode, header.x0,
                          header.y0, base_a, new_a, einfo.clamp, premul,
                          is_alpha)
        return canvas_color, canvas_extra

    # -- patches ------------------------------------------------------------

    def _apply_patches(self, fr: FrameRender, patches) -> None:
        """Blend patch rects from saved reference frames onto the frame's
        planes (blend.rs patch, from_patch_blending_info)."""
        from .features import PatchBlendMode

        meta = self.image_header.metadata
        for patch in patches.patches:
            ref = self.reference[patch.ref_idx]
            if ref is None:
                raise JxlNotSupportedError(
                    f"patch references empty slot {patch.ref_idx}")
            src_planes = list(ref[0]) + list(ref[1])
            dst_planes = list(fr.color) + list(fr.extra)
            ncolor = len(fr.color)
            for target in patch.patch_targets:
                for ci, blending in enumerate(
                        target.blending[:len(dst_planes)]):
                    mode = blending.mode
                    if mode == PatchBlendMode.NONE:
                        continue
                    # blending[0] covers every colour channel; colour
                    # channels come before the alpha they read
                    chans = (list(range(ncolor)) if ci == 0
                             else [ncolor + ci - 1])
                    alpha_idx = ncolor + blending.alpha_channel
                    premul = bool(
                        meta.ec_info
                        and blending.alpha_channel < len(meta.ec_info)
                        and meta.ec_info[
                            blending.alpha_channel].alpha_associated)
                    for ch in chans:
                        _patch_blend_one(
                            dst_planes, src_planes, ch, patch, target, mode,
                            alpha_idx, blending.clamp,
                            is_alpha=(ch == alpha_idx and mode.use_alpha),
                            premultiplied=premul)


def _patch_blend_one(dst_planes, src_planes, ch, patch, target, mode,
                     alpha_idx, clamp, is_alpha, premultiplied):
    """One channel of one patch target (blend.rs patch kernels); writes
    into dst_planes[ch] through a view."""
    from .features import PatchBlendMode as PB

    dst = dst_planes[ch]
    src = src_planes[ch]
    # the source rect in the reference frame, the target in this frame
    sh, sw = src.shape
    dh, dw = dst.shape
    x0, y0 = patch.x0, patch.y0
    w = min(patch.width, sw - x0)
    h = min(patch.height, sh - y0)
    dx0, dy0 = target.x, target.y
    if dx0 < 0 or dy0 < 0:
        sx_off, sy_off = max(0, -dx0), max(0, -dy0)
        x0 += sx_off
        y0 += sy_off
        w -= sx_off
        h -= sy_off
        dx0, dy0 = max(0, dx0), max(0, dy0)
    w = min(w, dw - dx0)
    h = min(h, dh - dy0)
    if w <= 0 or h <= 0:
        return
    s = src[y0:y0 + h, x0:x0 + w]
    d = dst[dy0:dy0 + h, dx0:dx0 + w]

    if mode == PB.REPLACE:
        d.copy_(s)
    elif mode == PB.ADD:
        d += s
    elif mode == PB.MUL:
        d *= torch.clamp(s, 0.0, 1.0) if clamp else s
    else:
        swapped = mode in (PB.BLEND_BELOW, PB.MUL_ADD_BELOW)
        sa_plane = (src_planes[alpha_idx] if alpha_idx < len(src_planes)
                    else None)
        da_plane = (dst_planes[alpha_idx] if alpha_idx < len(dst_planes)
                    else None)
        sa = (sa_plane[y0:y0 + h, x0:x0 + w] if sa_plane is not None
              else torch.zeros_like(s))
        # a view: the colour channels read the alpha before it is blended
        da = (da_plane[dy0:dy0 + h, dx0:dx0 + w] if da_plane is not None
              else torch.zeros_like(d))
        base_s, new_s = (s, d.clone()) if swapped else (d.clone(), s)
        base_a, new_a = (sa, da) if swapped else (da, sa)
        if clamp:
            new_a = torch.clamp(new_a, 0.0, 1.0)
        if mode in (PB.BLEND_ABOVE, PB.BLEND_BELOW):
            if is_alpha:
                d.copy_(new_a + base_a * (1.0 - new_a))
            elif premultiplied:
                d.copy_(new_s + base_s * (1.0 - new_a))
            else:
                recip = _recip(1.0 - (1.0 - new_a) * (1.0 - base_a))
                d.copy_((new_a * new_s + base_a * base_s * (1.0 - new_a))
                        * recip)
        else:  # MulAdd
            if is_alpha:
                d.copy_(base_s)
            else:
                d.copy_(base_s + new_a * new_s)
