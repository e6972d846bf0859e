"""Public API facade of the port: JxlImage, Render, pixel output.

Behavioral parity: jxl-oxide/src/lib.rs (JxlImage/Render) and fb.rs
(sample conversion); the torch counterpart of jxl_oxide_tpu/api.py over
every layout it decodes. Container and header parsing is a copy of the JAX
package's (host-side). `render_frame(k)` renders the frames keyframe k
depends on (its dependency cone, on up to 4 threads), each through the
host entropy stage and the device stage (render/render.py), composites
them in order against the reference slots with their blending and
patches (render/context.py, torch ops on the decode device), and caches
the keyframes it composites.
  - VarDCT: the host stage is the sequence of jxl_oxide_tpu/serving.py
    `_host_stage_fast`, its extra channels included (the frame's modular
    sub-streams decode beside the HF sections); the device stage the
    fused 4:4:4 program, the fused chroma-subsampled program or the staged
    path (render/vardct.py, ops/vardct_pipeline.py) and the render tail.
  - Modular: the host stage decodes the sections (render/frame.py) and
    runs the inverse transforms when the gate keeps them on the host; the
    device stage runs them otherwise (models/modular.py, the squeeze as a
    CUDA kernel), then the render tail (render/render.py).
Between the two and the blend, render/context.py runs the frame's
patches, splines and noise at sample resolution (the noise field on the
card as a CUDA kernel, ops/cuda/noise.py), then the frame and EC
upsampling (ops/upsample.py); an LF frame goes to its LF slot for the
frame that uses it.
Then YCbCr -> RGB for YCbCr frames and the color tail (before blending
for a blending frame, render/context.py `_convert_color_for_record`);
the EPF is a CUDA kernel on both. Every frame layout decodes: VarDCT
4:4:4 (XYB, RGB or YCbCr) and chroma-subsampled YCbCr, Modular of
every layout, its chroma upsampled before the filters (render/render.py
`upsample_chroma`). A greyscale frame is one colour plane
(cloned to three for the filters, render/render.py). The colour tail
goes to the requested encoding (`request_color_encoding`,
`request_icc`): an enum or an enum-expressible ICC profile takes the
torch ops on the decode device (color/convert.py), any other profile the
CMS leg on the host (color/cms.py, Pillow's Little CMS; a CMYK source
hands it the Black extra channel too). Extra channels of every kind pass
through unfiltered; `Render` applies the spot colours to every pixel
output, and the EXIF orientation (1-8) before the interleave.
`set_image_region` and `render_frame_cropped` cut renders to a region:
the region, mapped into coded space, selects the sections that decode
(render/roi.py) and the rect the fused VarDCT programs compute, and the
keyframe cache keeps region renders apart from full ones.
`render_loading_frame()` renders what has arrived of a stream fed in
pieces (`feed_bytes`): the complete frames composite in order into one
RenderContext, and the loading frame renders from its complete sections
through a resumable host stage (render/render.py `partial_host_stage`)
and the same device stage, then composites without touching the slots.
`Render.stream()` writes interleaved samples into caller buffers, a row
band at a time (`ImageStream`).
`JxlImage(mesh=...)` decodes over a device mesh (parallel/): the fused
VarDCT programs shard by bands of whole groups with halos between
neighbours, the Modular device tail runs in row bands, and the bands join
on the mesh's home device, the decode device.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextvars
import copy
from dataclasses import dataclass

import numpy as np
import torch

from .color.cms import PilCms
from .color.icc import decode_icc, read_icc
from .device import resolve_device
from .headers.frame import BlendMode, FrameType
from .headers.image import (
    ColourEncoding,
    ColourSpace,
    ExtraChannelType,
    ImageHeader,
)
from .io.bitstream import Bitstream
from .io.container import ContainerParser
from .parallel import use_decode_mesh
from .render.context import KeyframeRender, RenderContext, planes_bytes
from .render.frame import Frame
from .render.render import render_frame
from .render.roi import use_decode_region
from .utils.alloc import (
    AllocTracker,
    release_alloc,
    track_alloc,
    use_tracker,
)
from .utils.errors import (
    JxlEofError,
    JxlError,
    JxlNotSupportedError,
    JxlValidationError,
)
from .utils.options import use_decode_device, use_force_wide
from .utils.trace import span

__all__ = ["ImageStream", "JxlImage", "Render", "clear_program_caches"]


# EXIF orientation 1-8 as the flips of the coded plane (1-4) or of its
# transpose (5-8), on the last two axes
_ORIENT_FLIPS = {1: (), 2: (-1,), 3: (-2, -1), 4: (-2,), 5: (), 6: (-1,),
                 7: (-2, -1), 8: (-2,)}


def _oriented_rows(plane: torch.Tensor, orientation: int, r0: int,
                   r1: int) -> torch.Tensor:
    """Rows [r0, r1) of the oriented plane, cut from the coded plane (or
    its transpose) before the flips: no whole oriented plane is made."""
    if orientation not in _ORIENT_FLIPS:
        raise JxlValidationError(f"invalid orientation {orientation}")
    src = plane.transpose(-2, -1) if orientation >= 5 else plane
    flips = _ORIENT_FLIPS[orientation]
    n = src.shape[-2]
    band = src[..., n - r1:n - r0, :] if -2 in flips else src[..., r0:r1, :]
    return band.flip(flips) if flips else band


def _apply_orientation(plane: torch.Tensor, orientation: int) -> torch.Tensor:
    """EXIF orientation 1-8 (region.rs apply_orientation; the JAX package's
    api.py _apply_orientation) on the last two axes of [..., H, W], so a
    stack of images turns as one."""
    rows = plane.shape[-1] if orientation >= 5 else plane.shape[-2]
    return _oriented_rows(plane, orientation, 0, rows)


def _orient_region_inverse(region, coded_w: int, coded_h: int,
                           orientation: int) -> tuple[int, int, int, int]:
    """A display-space rect (left, top, width, height) mapped into coded
    space, the inverse of the orientation on regions, then clamped to the
    coded plane (region.rs apply_orientation with inverse=true; a copy of
    jxl_oxide_tpu/api.py _orient_region_inverse)."""
    left, top, width, height = region
    o = orientation
    if o == 1:
        r = (left, top, width, height)
    elif o == 2:
        r = (coded_w - left - width, top, width, height)
    elif o == 3:
        r = (coded_w - left - width, coded_h - top - height, width, height)
    elif o == 4:
        r = (left, coded_h - top - height, width, height)
    elif o == 5:
        # display = coded.T: display (y, x) = coded (x, y)
        r = (top, left, height, width)
    elif o == 6:
        # display = coded.T[:, ::-1]: display (y, x) = coded (H-1-x, y)
        r = (top, coded_h - left - width, height, width)
    elif o == 7:
        # display = coded.T[::-1, ::-1]: (y, x) = coded (H-1-x, W-1-y)
        r = (coded_w - top - height, coded_h - left - width, height, width)
    elif o == 8:
        # display = coded.T[::-1, :]: display (y, x) = coded (x, W-1-y)
        r = (coded_w - top - height, left, height, width)
    else:
        raise JxlValidationError(f"invalid orientation {orientation}")
    x, y, w, h = r
    x2, y2 = max(0, x), max(0, y)
    w = max(0, min(x + w, coded_w) - x2)
    h = max(0, min(y + h, coded_h) - y2)
    return x2, y2, w, h


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
    """A rendered keyframe in the requested color encoding: one (grey) or
    three [H, W] float32 colour planes and one plane per extra channel, on
    the decode device, in the coded orientation; every pixel output
    applies the spot colours once (`apply_spot_colors`) and `orientation`,
    and its last axis holds the colour planes, then the first alpha if
    there is one (grey + alpha: [H, W, 2])."""

    planes: list        # colour planes after the colour transform
    extra: list         # extra channel planes, unfiltered
    ec_info: list       # ExtraChannelInfo of each extra channel
    orientation: int
    name: str
    duration: int
    _spot_applied: bool = False

    def apply_spot_colors(self) -> None:
        """Composite the SpotColour extra channels onto the three colour
        planes (features/spot_colors.rs:5-37; jxl_oxide_tpu/api.py
        Render.apply_spot_colors): mix = ec * solidity, then each plane
        = mix * colour + (1 - mix) * plane, in float32 torch ops on the
        planes' device, in that order. Idempotent: every pixel output
        calls it, and it runs once."""
        if self._spot_applied or len(self.planes) != 3:
            return
        self._spot_applied = True
        for info, ec in zip(self.ec_info, self.extra):
            if info.ty != ExtraChannelType.SPOT_COLOUR or not info.spot_colour:
                continue
            *rgb, solidity = (float(np.float32(v)) for v in info.spot_colour)
            mix = ec * solidity
            for c, value in enumerate(rgb):
                self.planes[c] = mix * value + (1.0 - mix) * self.planes[c]

    def _output_chans(self) -> list:
        """Colour planes + the first ALPHA extra channel, if any,
        un-oriented (jxl_oxide_tpu/api.py Render._output_chans)."""
        self.apply_spot_colors()
        chans = list(self.planes)
        for info, ec in zip(self.ec_info, self.extra):
            if info.ty == ExtraChannelType.ALPHA:
                chans.append(ec)
                break
        return chans

    def image_planar(self) -> list:
        """Colour planes with the orientation applied."""
        self.apply_spot_colors()
        return [_apply_orientation(p, self.orientation) for p in self.planes]

    def image_all_channels(self) -> np.ndarray:
        """[H, W, C] float32: colour and every extra channel, oriented."""
        self.apply_spot_colors()
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

    def stream(self) -> "ImageStream":
        """Interleaved samples, spot colours applied, oriented, written
        into caller buffers a row band at a time (fb.rs:170-398
        ImageStream)."""
        return ImageStream(self)


class ImageStream:
    """Interleaved samples of a Render written into caller buffers
    (fb.rs ImageStream::write_to_buffer; jxl_oxide_tpu/api.py
    ImageStream): row-major, x-major, c-minor; colour, then every extra
    channel; spot colours applied (on a copy of the Render: the Render
    itself is left as it was); oriented; u8, u16 or f32 by the buffer's
    dtype; resumable across calls. Each call takes from the planes only
    the row band its samples lie in, quantizes it where the planes are
    (round half to even, clipped, as the JAX package's numpy does) and
    brings it to the host: no call downloads a row it does not write, and
    the whole interleaved image is never built."""

    def __init__(self, render: Render):
        r = copy.copy(render)
        r.planes = list(render.planes)
        r.apply_spot_colors()
        # every extra channel that has its info, as the JAX package zips
        # them
        self._chans = [*r.planes, *(ec for _, ec in zip(r.ec_info, r.extra))]
        self._orientation = r.orientation
        h, w = self._chans[0].shape
        self.height, self.width = (w, h) if r.orientation >= 5 else (h, w)
        self.channels = len(self._chans)
        self._pos = 0

    def _row_band(self, r0: int, r1: int, scale: float | None) -> np.ndarray:
        """Interleaved samples of oriented rows [r0, r1), flattened: f32,
        or quantized to `scale` (u8 or u16 values) before the download."""
        band = torch.stack([_oriented_rows(c, self._orientation, r0, r1)
                            for c in self._chans], dim=-1)
        if scale is None:
            return band.to(torch.float32).cpu().numpy().reshape(-1)
        q = torch.clamp(torch.round(band * scale), 0, scale)
        # no uint16 arithmetic in torch: u16 values travel as int32
        q = q.to(torch.uint8 if scale == 255.0 else torch.int32)
        return q.cpu().numpy().reshape(-1)

    def write_to_buffer(self, buf: np.ndarray) -> int:
        """Fill the 1-D `buf` (uint8, uint16 or float32) with the next
        samples; returns how many (0 at the end of the image)."""
        row_samples = self.width * self.channels
        total = self.height * row_samples
        n = min(buf.size, total - self._pos)
        if n <= 0:
            return 0
        scale = {np.dtype(np.uint8): 255.0,
                 np.dtype(np.uint16): 65535.0}.get(buf.dtype)
        written = 0
        while written < n:
            row = self._pos // row_samples
            off = self._pos - row * row_samples
            need = n - written
            r1 = min(self.height, row + -(-(off + need) // row_samples))
            chunk = self._row_band(row, r1, scale)[off:off + need]
            take = chunk.size
            buf[written:written + take] = chunk
            written += take
            self._pos += take
        return n


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two devices are one: "cuda" names the current card."""
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    return ((a.index if a.index is not None else torch.cuda.current_device())
            == (b.index if b.index is not None
                else torch.cuda.current_device()))


class JxlImage:
    """JPEG XL decoder: every frame layout of the JAX package's.

    device: where the device stage runs; None means CUDA, and with no
    CUDA device the constructor raises. Pass device="cpu" explicitly to
    run the plain torch versions on the CPU. approx_memory_limit bounds
    the decode's tracked allocations (reference slots, retained keyframe
    canvases; the reference's AllocTracker) and the keyframe cache.

    mesh: a decode mesh (parallel.decode_mesh, decode_mesh_multihost).
    Renders then run under it (parallel.use_decode_mesh): VarDCT frames
    through the sharded fused programs, the Modular device tail in row
    bands. The decode device is the mesh's home device (its first shard's
    on this process); a `device=` that disagrees raises."""

    def __init__(self, device=None, num_threads: int | None = None,
                 approx_memory_limit: int | None = None,
                 force_wide_buffers: bool = False, mesh=None):
        if mesh is not None:
            home = mesh.home_device
            if device is not None and not _same_device(
                    torch.device(device), home):
                raise ValueError(f"device {device} is not the mesh's home "
                                 f"device {home}")
            device = home
        self.device = resolve_device(device)
        self._decode_mesh = mesh
        # force_wide_buffers disables the narrow (i16) modular sample
        # lane even when modular_16bit_buffers is set in the header
        # (JxlImageBuilder, lib.rs:199-234; sample.rs:4-36); the output is
        # the same either way
        self._force_wide = bool(force_wide_buffers)
        if num_threads is not None:
            from .utils.threads import set_num_threads

            set_num_threads(num_threads)
        self._tracker = (AllocTracker(approx_memory_limit)
                         if approx_memory_limit else None)
        self._parser = ContainerParser()
        self._codestream = bytearray()
        # aux boxes in stream order: (type, payload, brob-wrapped)
        self._aux_boxes: list[tuple[bytes, bytes, bool]] = []
        self._aux_current: list[bytes] | None = None
        self._aux_type: bytes = b""
        self._aux_brotli = False
        self.image_header: ImageHeader | None = None
        self.embedded_icc: bytes | None = None
        self._frames: list[Frame] = []
        self._frames_complete = False
        self._header_bs: Bitstream | None = None
        # keyframe canvases: a full one under its keyframe index, one
        # rendered under a region under (index, region)
        self._keyframe_cache: dict = {}
        # the display-space region (left, top, width, height) that renders
        # crop to (set_image_region), or None
        self._image_region: tuple[int, int, int, int] | None = None
        self.requested_encoding: ColourEncoding | None = None
        self.requested_icc: bytes | None = None
        # the CMS of ICC legs; constructing it needs no Pillow
        self._cms = PilCms()
        # render_loading_frame: its context, the frames composited into it,
        # and the newest keyframe it composited
        self._progressive_ctx: RenderContext | None = None
        self._progressive_fed = 0
        self._progressive_kf: KeyframeRender | None = None

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
        if ev.kind == "codestream":
            self._codestream += ev.data
        elif ev.kind == "aux_start":
            self._aux_current = []
            self._aux_type = ev.box_type
            self._aux_brotli = bool(ev.brotli)
        elif ev.kind == "aux_data":
            if self._aux_current is not None:
                self._aux_current.append(ev.data)
        elif ev.kind == "aux_end":
            if self._aux_current is not None:
                self._aux_boxes.append((self._aux_type,
                                        b"".join(self._aux_current),
                                        self._aux_brotli))
                self._aux_current = None

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

    @property
    def is_animation(self) -> bool:
        return self.image_header.metadata.animation is not None

    # -- the output colour encoding (jxl_oxide_tpu/api.py:498-566) --------

    def request_color_encoding(self, encoding: ColourEncoding) -> None:
        # keyframes are cached in the signalled encoding (the colour
        # transform to the request runs in _postprocess), so no cache
        # invalidation is needed
        self.requested_encoding = encoding

    def request_icc(self, icc: bytes) -> None:
        """Render into the colour space of the given ICC profile
        (jxl-oxide lib.rs:693-697). Enum-expressible profiles take the
        enum transform on the decode device; anything else runs the CMS
        leg. Raises JxlError if the profile cannot be read at all."""
        # structural validity only: a profile that no enum expresses is
        # still fine, it takes the CMS leg at render time
        if len(icc) < 132 or icc[36:40] != b"acsp":
            raise JxlError("invalid ICC profile")
        self.requested_icc = icc

    def _embedded_enum(self) -> ColourEncoding | None:
        """The enum encoding the embedded ICC profile expresses, or None
        (icc/parse.rs parse_icc)."""
        if not self.embedded_icc:
            return None
        from .color.parse import parse_icc

        try:
            return parse_icc(self.embedded_icc)
        except JxlError:
            return None

    def rendered_icc(self) -> bytes:
        """ICC profile describing render output (lib.rs:547-555): the
        requested profile if one was set, else synthesized from the
        output colour encoding; ICC-described sources keep their
        embedded profile when no CMS is available to convert them."""
        if self.requested_icc is not None:
            return self.requested_icc
        from .color.synthesize import colour_encoding_to_icc

        meta = self.image_header.metadata
        if meta.colour_encoding.want_icc and not meta.xyb_encoded:
            if self._embedded_enum() is not None:
                return colour_encoding_to_icc(
                    self.requested_encoding or ColourEncoding())
            from .color.cms import NullCms, srgb_icc

            if self._cms is None or isinstance(self._cms, NullCms):
                return self.embedded_icc or b""
            return srgb_icc()  # the CMS leg's default target
        return colour_encoding_to_icc(self._output_encoding())

    def _output_encoding(self) -> ColourEncoding:
        """The requested encoding, else the signalled one (sRGB for
        XYB)."""
        if self.requested_encoding is not None:
            return self.requested_encoding
        meta = self.image_header.metadata
        return (meta.colour_encoding if not meta.xyb_encoded
                else ColourEncoding())

    def rendered_cicp(self) -> tuple[int, int, int, int] | None:
        """CICP tag of the render output encoding, if enum-described
        (lib.rs:557-562)."""
        if self.requested_icc is not None:
            return None
        meta = self.image_header.metadata
        enc = self.requested_encoding
        if enc is None:
            if meta.xyb_encoded or meta.colour_encoding.want_icc:
                enc = ColourEncoding()
            else:
                enc = meta.colour_encoding
        return enc.cicp()

    def set_cms(self, cms) -> None:
        self._cms = cms

    # -- aux boxes, JPEG reconstruction (jxl_oxide_tpu/api.py:570-627) ------

    def aux_box(self, box_type: bytes) -> bytes | None:
        """Payload of the first aux box of the given type; a brob-wrapped
        box (the container parser names it by its inner type)
        decompresses transparently (aux_box.rs brob handling), which needs
        the system libbrotlidec (utils/brotli.py)."""
        for ty, payload, is_brotli in self._aux_boxes:
            if ty != box_type:
                continue
            if is_brotli:
                from .utils.brotli import brotli_decompress

                return brotli_decompress(payload)
            return payload
        return None

    @property
    def raw_exif_data(self) -> bytes | None:
        """Exif payload with the 4-byte tiff-offset header stripped
        (aux_box.rs raw_exif)."""
        exif = self.aux_box(b"Exif")
        if exif is None:
            return None
        return exif[4:] if len(exif) >= 4 else b""

    @property
    def raw_xmp(self) -> bytes | None:
        """XMP metadata from the 'xml ' box (aux_box.rs)."""
        return self.aux_box(b"xml ")

    @property
    def hdr_gain_map(self) -> bytes | None:
        """Raw HDR gain map payload ('jhgm' box,
        container/box_header.rs:115)."""
        return self.aux_box(b"jhgm")

    @property
    def jpeg_reconstruction_available(self) -> bool:
        return self.aux_box(b"jbrd") is not None

    def reconstruct_jpeg(self) -> bytes:
        """The original JPEG byte stream, rebuilt from the jbrd box and the
        first frame's quantized coefficients (jxl-oxide lib.rs:860-904).
        Host work only: the coefficients come from the frame's host
        entropy stage (jbr/ `reconstruct_jpeg`), never from the device or
        a render."""
        from .jbr import JpegBitstreamData, reconstruct_jpeg

        jbrd_payload = self.aux_box(b"jbrd")
        if jbrd_payload is None:
            raise JxlError("no jbrd box present")
        jbrd = JpegBitstreamData(jbrd_payload)
        if not self._frames:
            raise JxlError("no frame available")
        exif = self.raw_exif_data or b""
        xmp = self.raw_xmp or b""
        icc = self.embedded_icc or b""
        return reconstruct_jpeg(jbrd, self._frames[0], icc=icc, exif=exif,
                                xmp=xmp)

    def _keyframe_index(self, keyframe_idx: int) -> int:
        """Codestream index of keyframe `keyframe_idx`."""
        kf_indices = self._keyframe_global_indices()
        if not 0 <= keyframe_idx < len(kf_indices):
            raise IndexError(keyframe_idx)
        return kf_indices[keyframe_idx]

    _ct_cache: dict = {}

    @staticmethod
    def _cached_transform(source, target, meta):
        """Memoized ColorTransform (jxl_oxide_tpu/api.py:993-1012; the
        reference caches it on RenderContext, render/lib.rs:57),
        process-wide: images with the same encoding pair share one."""
        from .color.convert import ColorTransform

        key = (repr(source), repr(target), repr(meta.opsin_inverse_matrix),
               repr(meta.tone_mapping))
        tr = JxlImage._ct_cache.get(key)
        if tr is None:
            tr = ColorTransform.build(source, target,
                                      meta.opsin_inverse_matrix,
                                      meta.tone_mapping)
            if len(JxlImage._ct_cache) > 64:
                JxlImage._ct_cache.clear()
            JxlImage._ct_cache[key] = tr
        return tr

    def _color_transform(self):
        """The enum transform of an XYB or enum-encoded image with no
        requested ICC profile (the stacked path's envelope,
        serving.py): to the requested encoding, else to the signalled one
        (sRGB for XYB)."""
        meta = self.image_header.metadata
        if meta.xyb_encoded:
            source = ColourEncoding(colour_space=ColourSpace.XYB)
        else:
            source = meta.colour_encoding
        return self._cached_transform(source, self._output_encoding(), meta)

    @staticmethod
    def _run_cms(tr, color: list) -> list:
        """A CMS transform on the host (color/cms.py works on float32
        numpy planes): the planes go down, through it and back up to their
        device."""
        device = color[0].device
        with span("Transform to requested color encoding"):
            out = tr.transform([p.cpu().numpy() for p in color])
            return [torch.from_numpy(np.ascontiguousarray(p, np.float32))
                    .to(device) for p in out]

    @staticmethod
    def _run_transform(tr, color: list) -> list:
        if tr.is_noop:
            return color
        with span("Transform to requested color encoding"):
            return list(tr.run(color))

    def _final_color(self, color: list, extra: list, frame_header,
                     ct_done: bool) -> list:
        """postprocess_keyframe's colour (render/lib.rs:884-994; the colour
        branches of jxl_oxide_tpu/api.py _postprocess): YCbCr -> RGB, then
        the transform to the output encoding, unless the canvas was
        converted before blending (ct_done, lib.rs:934). `extra` are the
        keyframe's extra channel planes.
          - An embedded ICC profile that an enum expresses takes the enum
            transform to the requested encoding (sRGB by default); any
            other profile, or one with a requested ICC profile, the CMS
            leg on the host, and NullCms keeps the samples as they are. A
            CMYK source hands the CMS its first BLACK extra channel as a
            fourth plane (jxl_oxide_tpu/api.py:1105-1125).
          - An XYB or enum source takes the enum transform to the
            requested encoding, or to the profile a requested ICC
            expresses; a profile no enum expresses renders to sRGB, then
            takes the CMS leg from sRGB to it."""
        if ct_done:
            return list(color)
        color = list(color)
        if frame_header.do_ycbcr:
            from .ops.color import ycbcr_to_rgb

            color = list(ycbcr_to_rgb(color[0], color[1], color[2]))
        meta = self.image_header.metadata
        if meta.colour_encoding.want_icc and not meta.xyb_encoded:
            enum_src = (self._embedded_enum() if self.requested_icc is None
                        else None)
            if enum_src is not None:
                return self._run_transform(self._cached_transform(
                    enum_src, self.requested_encoding or ColourEncoding(),
                    meta), color)
            if self.requested_icc is not None or self._cms is not None:
                black = [ec for info, ec in zip(meta.ec_info, extra)
                         if info.ty == ExtraChannelType.BLACK][:1]
                try:
                    return self._run_cms(self._cms.prepare_transform(
                        self.embedded_icc, self.requested_icc),
                        color + black)
                except JxlNotSupportedError:
                    pass  # NullCms: keep the ICC-described samples
            return color
        if self.requested_icc is None:
            return self._run_transform(self._color_transform(), color)
        from .color.parse import parse_icc

        source = (ColourEncoding(colour_space=ColourSpace.XYB)
                  if meta.xyb_encoded else meta.colour_encoding)
        icc_leg = None
        try:
            target = parse_icc(self.requested_icc)
        except JxlError:
            target = ColourEncoding()  # the sRGB connection space
            icc_leg = self.requested_icc
        color = self._run_transform(
            self._cached_transform(source, target, meta), color)
        if icc_leg is not None and self._cms is not None:
            from .color.cms import srgb_icc

            color = self._run_cms(
                self._cms.prepare_transform(srgb_icc(), icc_leg), color)
        return color

    # -- keyframes: dependency cones, compositing, the cache ----------------
    #
    # render_frame(k) renders only the dependency cone of keyframe k
    # (reference slots and patch sources), releasing each slot after its
    # last reader in the cone: the reference's lazy handle graph
    # (jxl-render/src/lib.rs:284-440, 488-607; jxl_oxide_tpu/api.py
    # 629-910). Keyframes it composites are cached on the device.

    def _keyframe_global_indices(self) -> list[int]:
        return [i for i, f in enumerate(self._frames)
                if f.header.is_keyframe]

    @staticmethod
    def _slot_reads(header) -> set[int]:
        """Reference slots a frame may read: the blend sources of its
        channels, or all four with patches (their sources are in LfGlobal,
        unknown before the decode)."""
        if header.flags.patches:
            return {0, 1, 2, 3}
        binfo = header.blending_info
        full_replace = (
            binfo.mode == BlendMode.REPLACE
            and not header.have_crop
            and all(e.mode == BlendMode.REPLACE
                    for e in header.ec_blending_info)
        )
        if full_replace:
            return set()
        return {binfo.source, *(e.source for e in header.ec_blending_info)}

    def _dependency_cone(self, target: int):
        """Frame indices (ascending) that must render for frame `target`,
        and cached keyframes that seed reference slots, keyed by (writer
        frame index, slot). A frame needs the writers of the slots it
        reads and, with use_lf_frame, the LF frame of the next level. The
        walk stops at a keyframe whose canvas is cached: the slot it saved
        is that canvas. The cached object is pinned here, since the cache
        may evict it while the cone renders."""
        frames = self._frames
        needed = {target}
        seeds: dict[tuple[int, int], KeyframeRender] = {}
        kf_of_frame = {g: k for k, g in
                       enumerate(self._keyframe_global_indices())}
        stack = [target]
        while stack:
            i = stack.pop()
            h = frames[i].header
            if h.flags.use_lf_frame:
                # the LF frame of the next level, the last one before i
                for j in range(i - 1, -1, -1):
                    hj = frames[j].header
                    if (hj.frame_type == FrameType.LF_FRAME
                            and hj.lf_level == h.lf_level + 1):
                        if j not in needed:
                            needed.add(j)
                            stack.append(j)
                        break
            for s in self._slot_reads(h):
                for j in range(i - 1, -1, -1):
                    hj = frames[j].header
                    if hj.can_reference and hj.save_as_reference == s:
                        k = kf_of_frame.get(j)
                        cached = (self._cache_lookup(k)
                                  if k is not None else None)
                        if cached is not None and j not in needed:
                            seeds[(j, s)] = cached
                        elif j not in needed:
                            needed.add(j)
                            stack.append(j)
                        break
        return sorted(needed), seeds

    _KEYFRAME_CACHE_CAP = 8
    # a byte bound on the cached canvases, which live in device memory;
    # with a decode memory limit, half of that limit
    _KEYFRAME_CACHE_MAX_BYTES = 512 << 20

    def _cache_key(self, keyframe_idx: int):
        """The cache key of a keyframe rendered now: its index for the full
        canvas, (index, region) under a region (jxl_oxide_tpu/api.py
        _cache_key keys every entry by the pair)."""
        if self._image_region is None:
            return keyframe_idx
        return (keyframe_idx, self._image_region)

    def _cache_lookup(self, keyframe_idx: int) -> KeyframeRender | None:
        """The cached canvas for the current region, else the full canvas,
        which serves any region (jxl_oxide_tpu/api.py _cache_lookup; one
        render cache serves both in the reference, jxl-render/src/state.rs
        RenderCache)."""
        kf = self._keyframe_cache.get(self._cache_key(keyframe_idx))
        if kf is None and self._image_region is not None:
            kf = self._keyframe_cache.get(keyframe_idx)
        return kf

    def _cache_store(self, key, kf: KeyframeRender) -> None:
        """FIFO keyframe cache, bounded by count and by bytes; the newest
        entry always stays (it is the render being returned)."""
        cache = self._keyframe_cache
        cache[key] = kf
        max_bytes = self._KEYFRAME_CACHE_MAX_BYTES
        if self._tracker is not None:
            max_bytes = min(max_bytes, self._tracker.limit // 2)
        total = sum(self._kf_bytes(v) for v in cache.values())
        while len(cache) > 1 and (len(cache) > self._KEYFRAME_CACHE_CAP
                                  or total > max_bytes):
            old = cache.pop(next(iter(cache)))
            nb = self._kf_bytes(old)
            total -= nb
            release_alloc(nb)

    @staticmethod
    def _kf_bytes(kf: KeyframeRender) -> int:
        return planes_bytes(kf.color) + planes_bytes(kf.extra)

    def _kf_index_of_frame(self, global_idx: int) -> int:
        return sum(1 for i, f in enumerate(self._frames)
                   if f.header.is_keyframe and i < global_idx)

    def _render_cone_frames(self, cone: list[int]) -> dict:
        """Frame renders of the cone, decoded on up to 4 threads when it
        has more than one such frame (the reference's frame pipelining,
        jxl-render/src/lib.rs:488-607); compositing stays in order. A
        frame that sets use_lf_frame needs its LF slot first: it renders
        inline, in RenderContext.add_frame (jxl_oxide_tpu/api.py:844-848).
        Each job runs in a copy of the caller's context, so it sees the
        decode device and the memory tracker: a worker that did not would
        put the Modular tail back on the host."""
        frames = self._frames
        cone = [i for i in cone if not frames[i].header.flags.use_lf_frame]
        if len(cone) <= 1:
            return {}
        device = self.device

        def job(i):
            if device.type != "cuda":
                return render_frame(frames[i], device)
            # a new thread's current CUDA device is the first card
            with torch.cuda.device(device):
                return render_frame(frames[i], device)

        with cf.ThreadPoolExecutor(max_workers=min(4, len(cone))) as ex:
            futs = {i: ex.submit(contextvars.copy_context().run, job, i)
                    for i in cone}
            return {i: fut.result() for i, fut in futs.items()}

    def _render_keyframe(self, keyframe_idx: int) -> KeyframeRender:
        """Keyframe `keyframe_idx` composited, from the cache or from its
        cone; under a region (set_image_region, render_frame_cropped) the
        cone renders with the region mapped into coded space, so its
        frames decode only the sections that meet it (render/roi.py)."""
        cached = self._cache_lookup(keyframe_idx)
        if cached is not None:
            return cached
        target = self._keyframe_index(keyframe_idx)
        cone, seeds = self._dependency_cone(target)
        frames = self._frames
        kf_indices = self._keyframe_global_indices()
        # the last cone frame that reads each slot, and each LF slot (LF
        # slot l is read by the frames of lf_level l that use it)
        last_slot_read: dict[int, int] = {}
        last_lf_read: dict[int, int] = {}
        for i in cone:
            h = frames[i].header
            for s in self._slot_reads(h):
                last_slot_read[s] = i
            if h.flags.use_lf_frame:
                last_lf_read[h.lf_level] = i
        with use_tracker(self._tracker), use_decode_device(self.device), \
                use_decode_mesh(self._decode_mesh), \
                use_decode_region(self._coded_region()), \
                use_force_wide(self._force_wide):
            ctx = RenderContext(self.image_header, self.device)
            # seed events in timeline order: each applies just before the
            # first cone frame after its writer's position
            seed_events = sorted(seeds.items())
            pos = 0
            rendered = self._render_cone_frames(cone)
            for i in cone:
                while pos < len(seed_events) and seed_events[pos][0][0] < i:
                    (_, s), kf = seed_events[pos]
                    ctx.set_reference(s, ([p.clone() for p in kf.color],
                                          [p.clone() for p in kf.extra]))
                    pos += 1
                # the noise seeds' counters follow from the headers: set
                # them for frames the cone skipped
                prev_kfs = [g for g in kf_indices if g < i]
                ctx._frame_counter = i
                ctx._num_prev_keyframes = len(prev_kfs)
                ctx._last_keyframe_idx = prev_kfs[-1] if prev_kfs else None
                kf = ctx.add_frame(frames[i], fr=rendered.pop(i, None))
                if kf is not None:
                    # a retained canvas charges the memory budget
                    track_alloc(self._kf_bytes(kf))
                    self._cache_store(
                        self._cache_key(self._kf_index_of_frame(i)), kf)
                for s in range(4):
                    if (ctx.reference[s] is not None
                            and last_slot_read.get(s, -1) <= i):
                        ctx.release_slot(s)
                    if (ctx.lf_frames[s] is not None
                            and last_lf_read.get(s, -1) <= i):
                        ctx.release_lf_frame(s)
        result = self._cache_lookup(keyframe_idx)
        if result is None:
            raise JxlValidationError(
                "target frame did not produce a keyframe")
        return result

    def _needs_full_frame_postprocess(self) -> bool:
        """Whether the colour tail reads the whole image: tone mapping
        relative to the display's peak detects it over every pixel
        (convert.rs:478-500 detect_peak), so a crop waits until after it
        (jxl_oxide_tpu/api.py _needs_full_frame_postprocess)."""
        tm = self.image_header.metadata.tone_mapping
        return (tm is not None
                and getattr(tm, "relative_to_max_display", False)
                and getattr(tm, "intensity_target", 255.0) > 255.0)

    def _crop(self, planes: list, crop) -> list:
        """The display-space region `crop` of coded-space planes: mapped
        through the inverse orientation, clamped to the planes, copied."""
        if not planes:
            return []
        ch, cw = planes[0].shape
        left, top, width, height = _orient_region_inverse(
            crop, cw, ch, self.image_header.metadata.orientation)
        return [p[top:top + height, left:left + width].clone()
                for p in planes]

    def _postprocess(self, kf: KeyframeRender, crop=None) -> Render:
        """The Render of a composited keyframe (postprocess_keyframe),
        cut to the display-space region `crop` if one is given: before the
        colour tail, whose ops are pointwise, unless it reads the whole
        image (jxl_oxide_tpu/api.py _postprocess). Its planes are never the
        cache's own tensors, which a caller could write into."""
        color, extra = list(kf.color), list(kf.extra)
        late_crop = crop is not None and self._needs_full_frame_postprocess()
        if crop is not None and not late_crop:
            color, extra = self._crop(color, crop), self._crop(extra, crop)
        color = self._final_color(color, extra, kf.frame.header, kf.ct_done)
        if late_crop:
            color, extra = self._crop(color, crop), self._crop(extra, crop)
        cached = {id(p) for p in (*kf.color, *kf.extra)}
        meta = self.image_header.metadata
        return Render(
            planes=[p.clone() if id(p) in cached else p for p in color],
            extra=[p.clone() if id(p) in cached else p for p in extra],
            ec_info=list(meta.ec_info), orientation=meta.orientation,
            name=kf.name, duration=kf.duration)

    def render_frame(self, keyframe_idx: int = 0) -> Render:
        """Keyframe `keyframe_idx`, composited: its dependency cone is
        rendered on the decode device, blended and patched against the
        reference slots, and cached; cut to the region of
        set_image_region, if one is set."""
        return self._postprocess(self._render_keyframe(keyframe_idx),
                                 crop=self._image_region)

    def render_frame_cropped(self, keyframe_idx: int, crop) -> Render:
        """Keyframe `keyframe_idx` cut to the display-space region `crop`
        (left, top, width, height) (jxl-oxide lib.rs render_frame_cropped;
        jxl_oxide_tpu/api.py:914-927): the sections outside it are not
        decoded, and the image-wide region of set_image_region stays as
        it was."""
        saved = self._image_region
        try:
            self._image_region = tuple(crop)
            return self._postprocess(self._render_keyframe(keyframe_idx),
                                     crop=self._image_region)
        finally:
            self._image_region = saved

    def set_image_region(self, left: int, top: int, width: int,
                         height: int) -> None:
        """Crop every later render to this display-space region (jxl-oxide
        set_image_region)."""
        self._image_region = (left, top, width, height)

    def _coded_region(self):
        """The region mapped into coded image coordinates (for the section
        selection), or None."""
        if self._image_region is None:
            return None
        size = self.image_header.size
        return _orient_region_inverse(self._image_region, size.width,
                                      size.height,
                                      self.image_header.metadata.orientation)

    def render_loading_frame(self) -> Render:
        """What has arrived of the stream, rendered (jxl_oxide_tpu/api.py
        render_loading_frame; jxl-render/src/lib.rs:723-894). The complete
        frames composite in order into one RenderContext, once each; a
        keyframe among them lands in the keyframe cache, so a later
        render_frame reuses it. The loading frame then renders from its
        complete sections, each decoded once across calls (its
        ProgressiveCache, render/vardct.py), on the decode device, and
        composites without saving a slot. With no frame loading, the
        newest keyframe is the result. Raises JxlEofError before any frame
        can render, as the JAX package does.

        A loading frame that sets use_lf_frame renders on its LF slot; the
        JAX package renders it, and its cached state then renders the
        complete frame, with no LF (ROADMAP Queue 3). Frames render whole
        and the result is cut to the region of set_image_region, as the
        JAX package's loading render is. Under a mesh the frames render
        on it, the loading frame too."""
        if not self._frames:
            raise JxlEofError("no frame data buffered yet")
        from .render.vardct import ProgressiveCache

        with use_tracker(self._tracker), use_decode_device(self.device), \
                use_decode_mesh(self._decode_mesh), \
                use_force_wide(self._force_wide):
            if self._progressive_ctx is None:
                self._progressive_ctx = RenderContext(self.image_header,
                                                      self.device)
                self._progressive_fed = 0
            ctx = self._progressive_ctx
            while self._progressive_fed < len(self._frames):
                i = self._progressive_fed
                frame = self._frames[i]
                if not frame.is_complete:
                    break
                # a frame rendered while it loaded resumes from its cache
                # there: only the sections not decoded yet decode
                kf = ctx.add_frame(frame)
                if kf is not None:
                    self._progressive_kf = kf
                    # the full canvas, under its index: it serves any
                    # region
                    k = self._kf_index_of_frame(i)
                    if k not in self._keyframe_cache:
                        track_alloc(self._kf_bytes(kf))
                        self._cache_store(k, kf)
                self._progressive_fed += 1

            if self._progressive_fed >= len(self._frames):
                if self._progressive_kf is None:
                    raise JxlEofError("no renderable frame data yet")
                return self._postprocess(self._progressive_kf,
                                         crop=self._image_region)

            i = self._progressive_fed
            frame = self._frames[i]
            cache = getattr(frame, "_progressive_cache", None)
            if cache is None:
                cache = frame._progressive_cache = ProgressiveCache()
            # the LF slot of a use_lf_frame frame, which its VarDCT state
            # takes when it is made (the JAX package's takes none: ROADMAP
            # Queue 3)
            ctx._attach_lf_planes(frame)
            try:
                fr = render_frame(frame, self.device, cache)
            finally:
                frame._lf_frame_planes = None
            return self._postprocess(ctx.composite_partial(fr, frame),
                                     crop=self._image_region)


def clear_program_caches() -> None:
    """Release the port's process-wide caches (jxl_oxide_tpu/api.py
    clear_program_caches): the fused programs (render/vardct.py
    `VardctFrameState._fused_cache`) and decode_batch_stacked's stacked
    ones, the plane pool, the colour transforms, the device tables
    (ops/varblock.py `device_const`), K12's jump tables (ops/cuda/noise.py)
    and the lru_cached host tables of ops/dct.py, ops/upsample.py and
    ops/varblock.py; then, after a garbage collection (device tensors held
    only by reference cycles, such as a dropped image's, come free there),
    the cuBLAS workspaces of the port's matrix products (torch keeps one
    per handle and stream, 32 MiB each on an H100, and the decode threads
    make several) and the CUDA caching allocator's free blocks. A long-running process that decodes many streams of different
    geometries calls it now and then; a decode after it builds what it
    needs again and gives the same output."""
    import gc

    from .ops import dct, upsample, varblock
    from .ops.cuda import noise
    from .render import vardct
    from .serving import decode_batch_stacked

    vardct.VardctFrameState._fused_cache.clear()
    decode_batch_stacked.__dict__.pop("_cache", None)
    with vardct._PLANE_POOL_LOCK:
        vardct._PLANE_POOL.clear()
    JxlImage._ct_cache.clear()
    varblock._CONST_CACHE.clear()
    noise.clear_jump_tables()
    for fn in (dct.dct_basis_forward, dct.dct_basis_inverse,
               upsample._kernels_cached, varblock.scale_f_map,
               varblock.special_lowrank_factors):
        fn.cache_clear()
    gc.collect()
    if torch.cuda.is_initialized():
        torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.empty_cache()
