"""Frame assembly: section buffers, LfGlobal, and the Modular decode path.

Behavioral parity: jxl-frame/src/lib.rs (Frame::parse validation, pass_shifts),
data/lf_global.rs (LfGlobal field order, GlobalModular channel list), and
jxl-render/src/modular.rs (group fan-out, inverse transforms, XYB dequant).

Host-side orchestration. Each TOC section is an independent bitstream decoded
by its own Decoder — the host-parallel grain; group results land in shared
numpy channel buffers that are then batched to the device for the grid math.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..headers.frame import Encoding, FrameHeader, Toc, TocEntry
from ..headers.image import ImageHeader
from ..io.bitstream import Bitstream
from ..models.modular import ChannelInfo, ModularImage
from ..models.modular_ma import MaConfig
from ..utils.errors import JxlEofError, JxlValidationError

__all__ = ["Frame", "LfGlobal", "GlobalModular"]


def _channel_shift_size(w: int, h: int, hshift: int, vshift: int) -> tuple[int, int]:
    return (w + (1 << hshift) - 1) >> hshift, (h + (1 << vshift) - 1) >> vshift


def jpeg_channel_info(w: int, h: int, jpeg_upsampling, idx: int) -> ChannelInfo:
    """Channel geometry under 4:2:0/4:2:2 style jpeg_upsampling
    (jxl-modular param.rs from_jpeg_upsampling)."""
    ups = jpeg_upsampling[idx]
    hscale = any(v in (1, 2) for v in jpeg_upsampling)
    vscale = any(v in (1, 3) for v in jpeg_upsampling)
    hs, vs = {
        0: (hscale, vscale),
        1: (False, False),
        2: (False, vscale),
        3: (hscale, False),
    }[ups]
    width = w
    height = h
    if hscale:
        half = (w + 1) // 2
        width = half if hs else half * 2
    if vscale:
        half = (h + 1) // 2
        height = half if vs else half * 2
    return ChannelInfo(
        width, height, int(hs), int(vs), original_width=w, original_height=h
    )


@dataclass
class GlobalModular:
    ma_config: MaConfig | None
    modular: ModularImage | None
    extra_channel_from: int


@dataclass
class LfGlobal:
    patches: object | None
    splines: object | None
    noise: object | None
    lf_dequant: tuple[float, float, float]
    vardct: object | None
    gmodular: GlobalModular


def parse_lf_global(
    bs: Bitstream,
    image_header: ImageHeader,
    frame_header: FrameHeader,
    allow_partial: bool = False,
) -> LfGlobal:
    from ..models import vardct as vardct_mod
    from ..utils.trace import span
    from .features import NoiseParameters, Patches, Splines

    flags = frame_header.flags
    patches = splines = noise = None
    if flags.patches:
        with span("Decode Patches"):
            patches = Patches.parse(bs, image_header, frame_header)
    if flags.splines:
        with span("Decode Splines"):
            splines = Splines.parse(bs, frame_header)
    if flags.noise:
        noise = NoiseParameters.parse(bs)

    # LfChannelDequantization (jxl-vardct lf.rs:11-16)
    if bs.read_bool():
        lf_dequant = (1.0 / 32.0, 1.0 / 4.0, 1.0 / 2.0)
    else:
        lf_dequant = (bs.read_f16_as_f32(), bs.read_f16_as_f32(), bs.read_f16_as_f32())
    if any(m / 128.0 < 1e-8 for m in lf_dequant):
        raise JxlValidationError("modular dequant weight too small")

    vardct = None
    if frame_header.encoding == Encoding.VARDCT:
        vardct = vardct_mod.LfGlobalVarDct.parse(bs)

    if splines is not None:
        # level-10 conformance limit on estimated spline rasterization
        # work (jxl-frame/src/data/lf_global.rs:133-146): reject before
        # any rendering so a crafted stream can't request unbounded work
        # inside the alloc budget
        base_corr = None
        if vardct is not None:
            corr = vardct.lf_chan_corr
            base_corr = (corr.base_correlation_x, corr.base_correlation_b)
        image_size = frame_header.width * frame_header.height
        estimated_area = splines.estimate_area(base_corr)
        if estimated_area > min(1 << 42, 1024 * image_size + (1 << 32)):
            raise JxlValidationError(
                "too large estimated area for splines"
            )

    gmodular = parse_global_modular(bs, image_header, frame_header, allow_partial)
    return LfGlobal(patches, splines, noise, lf_dequant, vardct, gmodular)


def parse_global_modular(
    bs: Bitstream,
    image_header: ImageHeader,
    frame_header: FrameHeader,
    allow_partial: bool,
) -> GlobalModular:
    meta = image_header.metadata
    num_channels = frame_header.encoded_color_channels + len(meta.ec_info)
    max_nodes = min(
        1 << 22,
        1024 + frame_header.width * frame_header.height * num_channels // 16,
    )
    ma_config = None
    if bs.read_bool():
        ma_config = MaConfig(bs, max_nodes)

    cw = frame_header.sample_width()
    ch = frame_header.sample_height()
    channels: list[ChannelInfo] = []
    if frame_header.encoding == Encoding.MODULAR:
        if frame_header.do_ycbcr:
            for idx in range(3):
                channels.append(
                    jpeg_channel_info(cw, ch, frame_header.jpeg_upsampling, idx)
                )
        else:
            for _ in range(frame_header.encoded_color_channels):
                channels.append(ChannelInfo(cw, ch))
    extra_channel_from = len(channels)
    color_ups_shift = frame_header.upsampling.bit_length() - 1
    for ec_upsampling, ec_info in zip(
        frame_header.ec_upsampling, meta.ec_info
    ):
        ec_ups_shift = ec_upsampling.bit_length() - 1
        if ec_ups_shift + ec_info.dim_shift > 6:
            # jxl-frame/src/lib.rs:185-195: bounds the total EC upsampling
            # work (each unit of shift quadruples the upsample output)
            raise JxlValidationError(
                "cumulative EC upsampling factor is too large"
            )
        ec_shift = ec_ups_shift + ec_info.dim_shift - color_ups_shift
        if ec_shift < 0:
            raise JxlValidationError("EC upsampling < color upsampling")
        w_s, h_s = _channel_shift_size(cw, ch, ec_shift, ec_shift)
        channels.append(
            ChannelInfo(w_s, h_s, ec_shift, ec_shift, original_width=cw, original_height=ch)
        )

    modular = None
    if channels:
        # narrow (i16) sample lane when the header allows it and the
        # caller didn't force wide buffers (jxl-modular sample.rs:4-36;
        # JxlImageBuilder force_wide_buffers). The native decoder has the
        # i16 store path; the Python fallback stays wide.
        from .. import native as _native
        from ..utils import options as _opts

        # the device modular tail computes in i32 (ops/modular_tail.py and
        # the squeeze kernel); decode wide so its results match the host
        # lane bit for bit. Only frames large enough to engage the tail
        # (ModularImage.finish's gate) give up the narrow i16 fast path.
        wide_for_device = (
            _opts.device_modular_may_engage()
            and cw * ch >= _opts.DEVICE_TAIL_MIN_SAMPLES
        )
        narrow = (
            meta.modular_16bit_buffers
            and not meta.bit_depth.is_float
            and not _opts.get_force_wide()
            and _native.available()
            and not wide_for_device
        )
        modular = ModularImage(
            bs,
            channels,
            frame_header.group_dim,
            meta.bit_depth.bits_per_sample,
            ma_config,
            dtype=np.int16 if narrow else np.int32,
        )
        sub = modular.subimage_global()
        sub.decode(bs, 0, allow_partial)
    return GlobalModular(ma_config, modular, extra_channel_from)


class Frame:
    """One frame: header + TOC + per-section bytes + decode state."""

    def __init__(self, image_header: ImageHeader, bs: Bitstream,
                 is_preview: bool = False):
        """Parse frame header + TOC from the codestream bitstream positioned
        at the frame start (zero-padded)."""
        bs.zero_pad_to_byte()
        self.start_byte = bs.pos // 8
        self.image_header = image_header
        header = FrameHeader.parse(bs, image_header, is_preview=is_preview)
        if header.width > (1 << 30) or header.height > (1 << 30):
            raise JxlValidationError("frame too large")
        if header.width * header.height > (1 << 40):
            raise JxlValidationError("frame area too large")
        if header.width == 0 or header.height == 0:
            raise JxlValidationError("zero-sized frame")
        if header.flags.use_lf_frame and header.lf_level >= 4:
            raise JxlValidationError("lf_level out of range")
        self.header = header
        self.toc = Toc.parse(bs, header, self.start_byte)
        # total frame byte span (TOC offsets are relative to frame start)
        data_start = bs.pos // 8 - self.start_byte
        self.data_start = data_start
        self.total_bytes = data_start + self.toc.total_size

        # pass shifts: pass_idx -> (minshift, maxshift)
        passes = header.passes
        pass_shifts: dict[int, tuple[int, int]] = {}
        maxshift = 3
        for downsample, last_pass in zip(passes.downsample, passes.last_pass):
            minshift = downsample.bit_length() - 1
            pass_shifts[last_pass] = (minshift, maxshift)
            maxshift = minshift
        pass_shifts[passes.num_passes - 1] = (0, maxshift)
        self.pass_shifts = pass_shifts

        self.data = bytearray()
        self.lf_global: LfGlobal | None = None

    def feed_bytes(self, data: bytes) -> None:
        self.data += data

    @property
    def is_complete(self) -> bool:
        return len(self.data) >= self.toc.total_size

    def section_bytes(self, entry: TocEntry) -> bytes:
        off = entry.offset - self.data_start
        if off + entry.size > len(self.data):
            raise JxlEofError(f"section {entry.kind} not fully buffered")
        return bytes(self.data[off : off + entry.size])

    def section_complete(self, kind: str, index: int = 0, pass_idx: int = 0) -> bool:
        try:
            entry = self.toc.entry_for(kind, index, pass_idx)
        except (KeyError, IndexError):
            return False
        return entry.offset - self.data_start + entry.size <= len(self.data)

    # ------------------------------------------------------------------

    def parse_lf_global(self) -> LfGlobal:
        if self.lf_global is None:
            entry = self.toc.entry_for("lf_global")
            bs = Bitstream(self.section_bytes(entry))
            self.lf_global = parse_lf_global(bs, self.image_header, self.header)
            if self.toc.is_single_entry:
                self._single_bs = bs  # continue reading subsequent sections
        return self.lf_global

    def decode_modular_frame(self) -> list[np.ndarray]:
        """Full Modular frame decode: LfGlobal + LF groups + pass groups +
        inverse transforms (ModularImage.finish, on the host or written
        back from the device). Returns the original channel arrays."""
        modular = self.decode_modular_sections()
        return modular.finish() if modular is not None else []

    def decode_modular_sections(self):
        """LfGlobal + LF groups + pass groups of a Modular frame, the
        non-progressive decode of jxl_oxide_tpu/render/frame.py
        decode_modular_frame without its inverse transforms; returns the
        frame's ModularImage (None without channels), its slots filled and
        not yet finished. The group sub-images finish here, in place: the
        gate keeps their small planes on the host (a group plane as large
        as the gate finishes on the device and is written back). Each call
        decodes afresh, LfGlobal included: finishing transforms the
        ModularImage's buffers in place. Under a decode region
        (render/roi.py) a multi-section frame that `frame_supports_roi`
        admits decodes only the sections that meet it; the others stay
        zero."""
        if self.header.encoding != Encoding.MODULAR:
            raise ValueError("not a modular frame")
        self.lf_global = None
        lf_global = self.parse_lf_global()
        gmodular = lf_global.gmodular
        modular = gmodular.modular
        header = self.header

        if modular is not None:
            lf_groups, pass_groups = modular.prepare_groups(self.pass_shifts)
        else:
            lf_groups, pass_groups = {}, [{}]

        if self.toc.is_single_entry:
            bs = self._single_bs
            # Single-group frame: remaining streams follow in the same section
            self._decode_lf_group(bs, 0, lf_groups.get(0), gmodular)
            for pass_idx in range(header.passes.num_passes):
                sub = pass_groups[pass_idx].get(0) if pass_idx < len(pass_groups) else None
                self._decode_pass_group(bs, pass_idx, 0, sub, gmodular)
        else:
            # a decode region (render/roi.py) skips the sections that do
            # not meet it, where the frame allows it
            from .roi import (
                frame_supports_roi,
                get_decode_region,
                group_intersects,
                lf_group_intersects,
            )

            roi = get_decode_region()
            take = None
            if roi is not None and frame_supports_roi(self):
                def take(key):
                    if key[0] == "lf_group":
                        return lf_group_intersects(self, key[1], roi)
                    return group_intersects(self, key[1], roi)
            jobs = self._section_jobs(lf_groups, pass_groups, take)
            # the pass-group sections decoded (the JAX package counts them
            # in the same attribute)
            self._pass_group_jobs = sum(
                1 for j in jobs if j[0] == self._decode_pass_group_job)
            self._run_section_jobs(jobs, gmodular)
        return modular

    def _section_jobs(self, lf_groups, pass_groups, take=None) -> list:
        """The section jobs of a multi-section Modular frame: its LF
        groups, then its pass groups in pass order (the HfGlobal section
        of a Modular frame is empty); with `take`, only the sections whose
        key (("lf_group", i) or ("group_pass", g, p)) it takes."""
        header = self.header
        jobs = []
        for lf_idx in range(header.num_lf_groups):
            if take is None or take(("lf_group", lf_idx)):
                entry = self.toc.entry_for("lf_group", lf_idx)
                jobs.append((self._decode_lf_group, entry, lf_idx,
                             lf_groups.get(lf_idx)))
        for pass_idx in range(header.passes.num_passes):
            for g_idx in range(header.num_groups):
                if take is not None and not take(
                        ("group_pass", g_idx, pass_idx)):
                    continue
                sub = (pass_groups[pass_idx].get(g_idx)
                       if pass_idx < len(pass_groups) else None)
                entry = self.toc.entry_for("group_pass", g_idx, pass_idx)
                jobs.append((self._decode_pass_group_job, entry,
                             (pass_idx, g_idx), sub))
        return jobs

    def decode_new_modular_sections(self, cache):
        """The resumable form of decode_modular_sections for a loading
        multi-section frame (jxl_oxide_tpu/render/frame.py
        _decode_modular_progressive): only the sections complete since the
        last call decode, through `_run_section_jobs`, into the
        ModularImage of `cache` (a render.vardct.ProgressiveCache, which
        owns the frame's LfGlobal and group split), returned unfinished.
        The caller finishes a snapshot, never the image itself."""
        if self.header.encoding != Encoding.MODULAR:
            raise ValueError("not a modular frame")
        gmodular = cache.start(self).gmodular
        jobs = self._section_jobs(*cache.groups_prepared,
                                  take=lambda key: cache.take(self, key))
        if jobs:
            self._run_section_jobs(jobs, gmodular)
        return gmodular.modular

    def _decode_pass_group_job(self, bs, key, sub, gmodular) -> None:
        pass_idx, g_idx = key
        self._decode_pass_group(bs, pass_idx, g_idx, sub, gmodular)

    def _section_stream_index(self, fn, key) -> int:
        """Modular sub-stream index (pass_group.rs:156-161, lf_group.rs:82-87)."""
        if fn == self._decode_lf_group:
            return 1 + self.header.num_lf_groups + key
        pass_idx, group_idx = key
        return (
            1
            + 3 * self.header.num_lf_groups
            + 17
            + pass_idx * self.header.num_groups
            + group_idx
        )

    def _run_section_jobs(self, jobs, gmodular) -> None:
        """Decode independent sections. With the native runtime, ALL
        sections go through one C++ call that fans out on a native thread
        pool (no GIL in the hot path — reference per-group pool.scope,
        jxl-render/src/modular.rs:36-130); the Python fallback decodes
        sequentially."""
        from .. import native as _native

        if _native.available():
            from ..utils.threads import num_workers

            prepared = []
            for fn, entry, key, sub in jobs:
                if sub is None or sub.is_empty:
                    continue
                bs = Bitstream(self.section_bytes(entry))
                recursive = ModularImage(
                    bs,
                    sub.infos,
                    self.header.group_dim,
                    self.image_header.metadata.bit_depth.bits_per_sample,
                    gmodular.ma_config,
                    views=sub.views,
                )
                subimg = recursive.subimage_all()
                rec = subimg.native_record(bs, self._section_stream_index(fn, key))
                prepared.append((rec, recursive, subimg))
            if not prepared:
                return
            rets = _native.decode_modular_batch(
                [rec for rec, _, _ in prepared],
                num_workers(len(prepared)),
            )
            first_err = None
            for ret, (_, recursive, subimg) in zip(rets, prepared):
                if ret != 0:
                    if first_err is None:
                        first_err = int(ret)
                    continue
                subimg.partial = False
                recursive.finish()
            if first_err is not None:
                _native.raise_modular_ret(first_err)
            return

        for fn, entry, key, sub in jobs:
            bs = Bitstream(self.section_bytes(entry))
            fn(bs, key, sub, gmodular)

    def _decode_lf_group(self, bs, lf_group_idx, sub, gmodular) -> None:
        """Modular-frame LF group (lf_group.rs mlf_group decode)."""
        if sub is None or sub.is_empty:
            return
        recursive = ModularImage(
            bs,
            sub.infos,
            self.header.group_dim,
            self.image_header.metadata.bit_depth.bits_per_sample,
            gmodular.ma_config,
            views=sub.views,
        )
        stream = 1 + self.header.num_lf_groups + lf_group_idx
        recursive.subimage_all().decode(bs, stream)
        recursive.finish()

    def _decode_pass_group(self, bs, pass_idx, group_idx, sub, gmodular) -> None:
        if sub is None or sub.is_empty:
            return
        recursive = ModularImage(
            bs,
            sub.infos,
            self.header.group_dim,
            self.image_header.metadata.bit_depth.bits_per_sample,
            gmodular.ma_config,
            views=sub.views,
        )
        stream = (
            1
            + 3 * self.header.num_lf_groups
            + 17
            + pass_idx * self.header.num_groups
            + group_idx
        )
        recursive.subimage_all().decode(bs, stream)
        recursive.finish()
