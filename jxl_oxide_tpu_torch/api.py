"""Public API facade of the port: JxlImage, Render, pixel output.

Behavioral parity: jxl-oxide/src/lib.rs (JxlImage/Render) and fb.rs
(sample conversion); the torch counterpart of jxl_oxide_tpu/api.py over
the port's envelope. Container and header parsing is a copy of the JAX
package's (host-side); `render_frame(0)` runs the host entropy stage of
one keyframe, then its device stage.
  - VarDCT: the host stage is the sequence of jxl_oxide_tpu/serving.py
    `_host_stage_fast`, its alpha leg included (the frame's modular
    sub-streams decode beside the HF sections); the device stage the
    fused 4:4:4 program, the fused chroma-subsampled program or the staged
    path (render/vardct.py, ops/vardct_pipeline.py) and the render tail.
  - Modular: the host stage decodes the sections (render/frame.py) and
    runs the inverse transforms when the gate keeps them on the host; the
    device stage runs them otherwise (models/modular.py, the squeeze as a
    CUDA kernel), then the render tail (render/render.py).
Then YCbCr -> RGB for YCbCr frames and the color tail; the EPF is a CUDA
kernel on both. An alpha channel passes through unfiltered, and the
render tail applies the EXIF orientation (1-8) before the interleave.
Streams outside the envelope raise JxlNotSupportedError naming the
ROADMAP item that will port them; none decodes through a hidden path.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .color.icc import decode_icc, read_icc
from .device import resolve_device
from .headers.frame import Encoding
from .headers.image import (
    ColourEncoding,
    ColourSpace,
    ExtraChannelType,
    ImageHeader,
)
from .io.bitstream import Bitstream
from .io.container import ContainerParser
from .render.frame import Frame
from .utils.errors import (
    JxlEofError,
    JxlNotSupportedError,
    JxlValidationError,
)
from .utils.options import use_decode_device
from .utils.trace import span, traced

__all__ = ["JxlImage", "Render"]


def _apply_orientation(plane: torch.Tensor, orientation: int) -> torch.Tensor:
    """EXIF orientation 1-8 (region.rs apply_orientation; the JAX package's
    api.py _apply_orientation) on the last two axes of [..., H, W], so a
    stack of images turns as one."""
    if orientation == 1:
        return plane
    if orientation == 2:
        return plane.flip(-1)
    if orientation == 3:
        return plane.flip(-2, -1)
    if orientation == 4:
        return plane.flip(-2)
    t = plane.transpose(-2, -1)
    if orientation == 5:
        return t
    if orientation == 6:
        return t.flip(-1)
    if orientation == 7:
        return t.flip(-2, -1)
    if orientation == 8:
        return t.flip(-2)
    raise JxlValidationError(f"invalid orientation {orientation}")


def _finalize(chans: list, orientation: int, scale: float | None,
              dtype) -> torch.Tensor:
    """Render tail (jxl_oxide_tpu/api.py::_finalize_fn): orientation, then
    interleave [..., H, W] planes to [..., H, W, C], then
    clamp(round(x * scale), 0, scale). torch.round rounds half to even, as
    jnp.round does."""
    img = torch.stack([_apply_orientation(p, orientation) for p in chans],
                      dim=-1)
    if scale is not None:
        img = torch.clamp(torch.round(img * scale), 0, scale).to(dtype)
    return img


@dataclass
class Render:
    """A rendered keyframe in the requested color encoding: three [H, W]
    float32 colour planes and one plane per extra channel, on the decode
    device, in the coded orientation; every pixel output applies
    `orientation`."""

    planes: list        # colour planes after the colour transform
    extra: list         # extra channel planes, unfiltered
    ec_info: list       # ExtraChannelInfo of each extra channel
    orientation: int
    name: str
    duration: int

    def _output_chans(self) -> list:
        """Colour planes + the first ALPHA extra channel, if any,
        un-oriented (jxl_oxide_tpu/api.py Render._output_chans)."""
        chans = list(self.planes)
        for info, ec in zip(self.ec_info, self.extra):
            if info.ty == ExtraChannelType.ALPHA:
                chans.append(ec)
                break
        return chans

    def image_planar(self) -> list:
        """Colour planes with the orientation applied."""
        return [_apply_orientation(p, self.orientation) for p in self.planes]

    def image_all_channels(self) -> np.ndarray:
        """[H, W, C] float32: colour and every extra channel, oriented."""
        return _finalize([*self.planes, *self.extra], self.orientation, None,
                         None).cpu().numpy()

    def image_device(self) -> torch.Tensor:
        """[H, W, C] float32 on the decode device (no host readback):
        colour, then alpha if the image has one, oriented."""
        return _finalize(self._output_chans(), self.orientation, None, None)

    def image(self) -> np.ndarray:
        """[H, W, C] float32 on the host: colour (+ alpha)."""
        return self.image_device().cpu().numpy()

    def to_u8(self) -> np.ndarray:
        """[H, W, C] uint8: colour (+ alpha), oriented."""
        return _finalize(self._output_chans(), self.orientation, 255.0,
                         torch.uint8).cpu().numpy()

    def to_u16(self) -> np.ndarray:
        # no uint16 arithmetic in torch: quantize in int32, narrow on host
        q = _finalize(self._output_chans(), self.orientation, 65535.0,
                      torch.int32)
        return q.cpu().numpy().astype(np.uint16)

    def stream(self):
        raise JxlNotSupportedError(
            "ImageStream is not ported yet (ROADMAP Queue 1 item 9)")


@dataclass
class HostStage:
    """What the host entropy stage of a VarDCT frame hands to the device
    stage."""

    state: object       # render.vardct.VardctFrameState
    hf_global: object   # render.vardct.HfGlobal
    frame: Frame
    # the alpha channel's integer samples (numpy), or None
    alpha: np.ndarray | None = None


@dataclass
class ModularHostStage:
    """What the host stage of a Modular frame hands to the device stage:
    the frame's ModularImage, and its original channels when the host ran
    the inverse transforms (None when the device tail will)."""

    modular: object     # models.modular.ModularImage
    channels: list | None
    frame: Frame


def _not_supported(what: str, item: int):
    return JxlNotSupportedError(
        f"{what} is not ported yet (ROADMAP Queue 1 item {item})"
    )


class JxlImage:
    """JPEG XL decoder over the port's envelope.

    device: where the device stage runs; None means CUDA, and with no
    CUDA device the constructor raises. Pass device="cpu" explicitly to
    run the plain torch versions on the CPU."""

    def __init__(self, device=None, num_threads: int | None = None):
        self.device = resolve_device(device)
        if num_threads is not None:
            from .utils.threads import set_num_threads

            set_num_threads(num_threads)
        self._parser = ContainerParser()
        self._codestream = bytearray()
        self.image_header: ImageHeader | None = None
        self.embedded_icc: bytes | None = None
        self._frames: list[Frame] = []
        self._frames_complete = False
        self._header_bs: Bitstream | None = None

    # -- construction (copy of jxl_oxide_tpu/api.py:339-464) ---------------

    @classmethod
    def from_bytes(cls, data: bytes, **kwargs) -> "JxlImage":
        img = cls(**kwargs)
        img.feed_bytes(data)
        img.finish()
        return img

    @classmethod
    def open(cls, path, **kwargs) -> "JxlImage":
        with open(path, "rb") as f:
            return cls.from_bytes(f.read(), **kwargs)

    def feed_bytes(self, data: bytes) -> None:
        for ev in self._parser.feed(data):
            self._handle_event(ev)
        try:
            self._try_init()
            self._load_frames(tolerate_truncation=True)
        except JxlEofError:
            pass  # headers not complete yet; keep feeding

    def finish(self) -> None:
        for ev in self._parser.finish():
            self._handle_event(ev)
        self._try_init()
        self._load_frames(tolerate_truncation=False)

    def _handle_event(self, ev) -> None:
        # aux boxes (Exif, XMP, jbrd) are not kept: JPEG reconstruction
        # and metadata access are not ported yet (ROADMAP Queue 1 item 14)
        if ev.kind == "codestream":
            self._codestream += ev.data

    def _try_init(self) -> None:
        if self.image_header is not None:
            return
        bs = Bitstream(bytes(self._codestream))
        header = ImageHeader.parse(bs)
        icc = None
        if header.metadata.colour_encoding.want_icc:
            icc = decode_icc(read_icc(bs))
        # commit only once everything needed before frames has parsed
        self.image_header = header
        self.embedded_icc = icc
        self._header_bs = bs

    def _load_frames(self, tolerate_truncation: bool = False) -> None:
        if self._frames_complete or self.image_header is None:
            return
        bs = self._header_bs
        data = bytes(self._codestream)
        # the header bitstream snapshots the buffer; refresh it as new
        # codestream bytes stream in (push-based feed, jxl-oxide lib.rs)
        bs.data = data
        bs._len_bits = len(data) * 8

        # skip the preview frame if present (jxl-oxide lib.rs:384-411)
        if self.image_header.metadata.preview is not None and not getattr(
            self, "_preview_skipped", False
        ):
            save_pos = bs.pos
            try:
                preview = Frame(self.image_header, bs, is_preview=True)
            except JxlEofError:
                bs.pos = save_pos
                if tolerate_truncation:
                    return
                raise JxlValidationError("truncated codestream (preview)")
            end = preview.start_byte + preview.total_bytes
            if end > len(data):
                bs.pos = save_pos
                if tolerate_truncation:
                    return
                raise JxlValidationError("truncated codestream (preview)")
            bs.pos = end * 8
            self._preview_skipped = True
        # feed newly arrived bytes to the currently loading frame
        while True:
            if self._frames and not self._frames[-1].is_complete:
                frame = self._frames[-1]
                end = frame.start_byte + frame.total_bytes
                start = frame.start_byte + frame.data_start
                avail = data[start + len(frame.data) : min(end, len(data))]
                if avail:
                    frame.feed_bytes(avail)
                if not frame.is_complete:
                    if tolerate_truncation:
                        return
                    raise JxlValidationError("truncated codestream")
                bs.pos = end * 8
                if frame.header.is_last:
                    self._frames_complete = True
                    return
            # parse the next frame header
            save_pos = bs.pos
            try:
                frame = Frame(self.image_header, bs)
            except JxlEofError:
                bs.pos = save_pos
                if tolerate_truncation:
                    return
                raise JxlValidationError("truncated codestream")
            self._frames.append(frame)
            end = frame.start_byte + frame.total_bytes
            start = frame.start_byte + frame.data_start
            frame.feed_bytes(data[start : min(end, len(data))])
            if not frame.is_complete:
                if tolerate_truncation:
                    return
                raise JxlValidationError("truncated codestream")
            bs.pos = end * 8
            if frame.header.is_last:
                self._frames_complete = True
                return

    # -- metadata -----------------------------------------------------------

    @property
    def width(self) -> int:
        """Width as displayed: orientations 5-8 swap the coded axes."""
        size = self.image_header.size
        return (size.height if self.image_header.metadata.orientation >= 5
                else size.width)

    @property
    def height(self) -> int:
        size = self.image_header.size
        return (size.width if self.image_header.metadata.orientation >= 5
                else size.height)

    @property
    def num_frames(self) -> int:
        return len(self._frames)

    @property
    def num_keyframes(self) -> int:
        return sum(1 for f in self._frames if f.header.is_keyframe)

    # -- rendering ----------------------------------------------------------

    def _check_envelope(self, keyframe_idx: int) -> Frame:
        """The port's envelope: one keyframe with no features, upsampling
        or LF frame, any EXIF orientation, at most one extra channel (an
        alpha with integer samples at full resolution: the JAX package's
        stacked-serving envelope, jxl_oxide_tpu/serving.py:121-126), and
        an XYB or enum sRGB/linear RGB colour encoding (so three colour
        channels); VarDCT 4:4:4 or chroma-subsampled YCbCr (4:2:0, 4:2:2,
        4:4:0), or Modular (4:4:4 YCbCr included) with integer or float
        samples. Anything else raises JxlNotSupportedError naming the
        ROADMAP item that will port it."""
        meta = self.image_header.metadata
        if keyframe_idx != 0 or self.num_keyframes != 1 or len(self._frames) != 1:
            raise _not_supported("multi-frame streams and animation", 9)
        if len(meta.ec_info) > 1 or any(
                info.ty != ExtraChannelType.ALPHA or info.bit_depth.is_float
                for info in meta.ec_info):
            raise _not_supported(
                "extra channels other than one integer alpha (spot colours, "
                "float alpha and other types)", 17)
        if any(info.dim_shift for info in meta.ec_info):
            raise _not_supported("alpha at a lower resolution (dim_shift)", 9)
        ce = meta.colour_encoding
        if not meta.xyb_encoded and (
            ce.want_icc
            or ce.colour_space != ColourSpace.RGB
            or ce.tf.kind not in ("srgb", "linear")
        ):
            raise _not_supported(
                "colour encodings other than XYB or sRGB/linear RGB enums", 15
            )
        fr = self._frames[0]
        header = fr.header
        subsampled = any(j != 0 for j in header.jpeg_upsampling)
        if header.encoding == Encoding.VARDCT:
            if header.do_ycbcr and not subsampled:
                raise _not_supported("4:4:4 YCbCr VarDCT", 7)
        elif header.do_ycbcr and subsampled:
            raise _not_supported("chroma-subsampled YCbCr Modular frames", 7)
        if (
            header.upsampling != 1
            or any(u != 1 for u in header.ec_upsampling)
            or header.lf_level != 0
            or header.flags.use_lf_frame
            or header.flags.patches
            or header.flags.splines
            or header.flags.noise
            or not header.is_last
            or header.x0 or header.y0
            or header.sample_width() != self.image_header.size.width
            or header.sample_height() != self.image_header.size.height
        ):
            raise _not_supported(
                "upsampling (EC upsampling included), LF frames, "
                "patches/splines/noise and cropped frames", 9
            )
        return fr

    @traced("Host entropy stage")
    def _host_stage(self, keyframe_idx: int = 0):
        """Headers of the frame's sections plus the C++ entropy decode: into
        whole-frame coefficient planes and the alpha channel for a VarDCT
        frame (jxl_oxide_tpu/serving.py `_host_stage_fast`), into the
        Modular channel slots for a Modular frame, whose inverse
        transforms run here when the gate keeps them on the host. Returns a
        HostStage or a ModularHostStage."""
        fr = self._check_envelope(keyframe_idx)
        # the decode's device decides whether the modular tail may leave the
        # host (utils/options.py), for the frame and its group sub-images
        with use_decode_device(self.device):
            if fr.header.encoding == Encoding.MODULAR:
                return self._modular_host_stage(fr)
            return self._vardct_host_stage(fr)

    def _modular_host_stage(self, fr: Frame) -> ModularHostStage:
        modular = fr.decode_modular_sections()
        chans = None
        if not modular.device_tail_selected():
            with span("Modular tail"):
                chans = modular.finish()
        return ModularHostStage(modular, chans, fr)

    def _vardct_host_stage(self, fr: Frame) -> HostStage:
        from .render.vardct import (
            HfGlobal,
            VardctFrameState,
            _decode_lf_groups_batch,
            _decode_pass_groups_batch,
            parse_lf_group,
        )

        header = fr.header
        lf_global = fr.parse_lf_global()
        gmod = lf_global.gmodular
        # a VarDCT frame's modular image holds its extra channels only (the
        # envelope: one alpha); its sub-streams follow the LF and HF data
        # of the sections (jxl-frame pass_group.rs:139)
        modular = gmod.modular
        if modular is not None:
            mlf_groups, pass_groups = modular.prepare_groups(fr.pass_shifts)
        else:
            mlf_groups, pass_groups = {}, [{}]

        def sub_of(p, g):
            return pass_groups[p].get(g) if p < len(pass_groups) else None

        state = VardctFrameState(fr)
        if fr.toc.is_single_entry:
            bs = fr._single_bs
            state.place_lf_group(0, parse_lf_group(
                bs, fr.image_header, header, lf_global, 0, mlf_groups.get(0)
            ))
            hf_global = HfGlobal(bs, fr.image_header, header, lf_global)
            for p in range(header.passes.num_passes):
                state.decode_pass_group_hf(bs, hf_global, p, 0)
                fr._decode_pass_group(bs, p, 0, sub_of(p, 0), gmod)
        else:
            lf_jobs = list(range(header.num_lf_groups))
            done = _decode_lf_groups_batch(fr, state, lf_global, lf_jobs,
                                           mlf_groups)
            for lf_idx in (i for i in lf_jobs if i not in done):
                bs = Bitstream(
                    fr.section_bytes(fr.toc.entry_for("lf_group", lf_idx))
                )
                state.place_lf_group(lf_idx, parse_lf_group(
                    bs, fr.image_header, header, lf_global, lf_idx,
                    mlf_groups.get(lf_idx),
                ))
            bs = Bitstream(fr.section_bytes(fr.toc.entry_for("hf_global")))
            hf_global = HfGlobal(bs, fr.image_header, header, lf_global)
            by_group: dict[int, list] = {}
            for p in range(header.passes.num_passes):
                for g in range(header.num_groups):
                    by_group.setdefault(g, []).append((p, g))
            leftover = _decode_pass_groups_batch(
                fr, state, hf_global, by_group, pass_groups, gmod
            )
            for jobs in leftover:
                for p, g in jobs:
                    bs = Bitstream(
                        fr.section_bytes(fr.toc.entry_for("group_pass", g, p))
                    )
                    state.decode_pass_group_hf(bs, hf_global, p, g)
                    fr._decode_pass_group(bs, p, g, sub_of(p, g), gmod)
        alpha = None
        if modular is not None:
            alpha = modular.finish()[gmod.extra_channel_from]
        return HostStage(state, hf_global, fr, alpha)

    def _color_transform(self):
        from .color.convert import ColorTransform

        meta = self.image_header.metadata
        if meta.xyb_encoded:
            source = ColourEncoding(colour_space=ColourSpace.XYB)
        else:
            source = meta.colour_encoding
        # the image's own encoding; XYB renders to sRGB (a requested
        # target encoding is not ported yet, ROADMAP Queue 1 item 15)
        target = meta.colour_encoding if not meta.xyb_encoded else (
            ColourEncoding())
        return ColorTransform.build(
            source, target, meta.opsin_inverse_matrix, meta.tone_mapping
        )

    def _device_stage(self, host) -> list:
        """The device stage on the host stage's output. VarDCT: the fused
        4:4:4 program, the fused subsampled program or the staged path,
        then the render tail. Modular: the inverse transforms on the device
        when the host did not run them, then the render tail. Then YCbCr ->
        RGB for a YCbCr frame and the color tail. Returns the three [H, W]
        float32 colour planes, then one plane per extra channel, on
        self.device."""
        from .ops.color import ycbcr_to_rgb
        from .render.render import extra_channel_planes

        if isinstance(host, ModularHostStage):
            from .render.render import render_modular_tail

            chans = host.channels
            if chans is None:
                float_samples = (
                    self.image_header.metadata.bit_depth.is_float)
                with use_decode_device(self.device), span("Modular tail"):
                    # float samples are converted on the host
                    chans = host.modular.finish(to_device=not float_samples)
            planes, extra = render_modular_tail(host.frame, chans,
                                                self.device)
        else:
            from .render.render import render_vardct_tail
            from .render.vardct import decode_vardct_planes

            state = host.state
            planes = decode_vardct_planes(state, host.hf_global, self.device)
            state.trim_coeff_planes()
            planes = render_vardct_tail(state, planes)
            extra = [] if host.alpha is None else extra_channel_planes(
                [host.alpha], self.image_header.metadata.ec_info,
                planes[0].device)
        if host.frame.header.do_ycbcr:
            planes = list(ycbcr_to_rgb(planes[0], planes[1], planes[2]))
        tr = self._color_transform()
        if not tr.is_noop:
            with span("Transform to requested color encoding"):
                planes = list(tr.run(planes))
        return [*planes, *extra]

    def render_frame(self, keyframe_idx: int = 0) -> Render:
        host = self._host_stage(keyframe_idx)
        chans = self._device_stage(host)
        h = host.frame.header
        meta = self.image_header.metadata
        return Render(planes=chans[:3], extra=chans[3:],
                      ec_info=list(meta.ec_info),
                      orientation=meta.orientation, name=h.name,
                      duration=h.duration)

    def render_frame_cropped(self, *args, **kwargs):
        raise JxlNotSupportedError(
            "region-of-interest decode is not ported yet (ROADMAP Queue 1 "
            "item 14)")
