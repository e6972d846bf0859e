"""Frame features: patches (parsing; blending is render/context.py).

Behavioral parity: jxl-frame/src/data/patch.rs; the patch part of
jxl_oxide_tpu/render/features.py. Splines and noise are not ported yet
(ROADMAP Queue 1 item 9a-rest): render/frame.py raises on them.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

from ..coding.entropy import Decoder
from ..io.bitstream import Bitstream, unpack_signed
from ..utils.errors import JxlValidationError

__all__ = ["PatchBlendMode", "PatchBlending", "PatchTarget", "PatchRefData",
           "Patches"]


class PatchBlendMode(enum.Enum):
    NONE = 0
    REPLACE = 1
    ADD = 2
    MUL = 3
    BLEND_ABOVE = 4
    BLEND_BELOW = 5
    MUL_ADD_ABOVE = 6
    MUL_ADD_BELOW = 7

    @property
    def use_alpha(self) -> bool:
        return self.value >= 4


@dataclass
class PatchBlending:
    mode: PatchBlendMode
    alpha_channel: int
    clamp: bool


@dataclass
class PatchTarget:
    x: int
    y: int
    blending: list  # per (color + each EC) channel


@dataclass
class PatchRefData:
    ref_idx: int
    x0: int
    y0: int
    width: int
    height: int
    patch_targets: list


class Patches:
    """Entropy-coded patch list (jxl-frame data/patch.rs)."""

    def __init__(self, patches):
        self.patches: list[PatchRefData] = patches

    @classmethod
    def parse(cls, bs: Bitstream, image_header, frame_header) -> "Patches":
        from ..headers.image import ExtraChannelType

        meta = image_header.metadata
        num_extra = len(meta.ec_info)
        alpha_indices = [
            i for i, info in enumerate(meta.ec_info)
            if info.ty == ExtraChannelType.ALPHA
        ]
        decoder = Decoder(bs, 10)
        decoder.begin(bs)

        max_refs = min(1 << 24, frame_header.width * frame_header.height // 16)
        num_patch_refs = decoder.read_varint(bs, 0)
        if num_patch_refs > max_refs:
            raise JxlValidationError("too many patches")
        max_patches = max_refs * 4

        total = 0
        patches = []
        for _ in range(num_patch_refs):
            ref_idx = decoder.read_varint(bs, 1)
            if ref_idx >= 4:
                raise JxlValidationError("PatchRef index out of bounds")
            x0 = decoder.read_varint(bs, 3)
            y0 = decoder.read_varint(bs, 3)
            width = decoder.read_varint(bs, 2) + 1
            height = decoder.read_varint(bs, 2) + 1
            count = decoder.read_varint(bs, 7) + 1
            total += count
            if total > max_patches:
                raise JxlValidationError("too many patches")
            targets = []
            prev_xy = None
            for _ in range(count):
                if prev_xy is None:
                    x = decoder.read_varint(bs, 4)
                    y = decoder.read_varint(bs, 4)
                else:
                    x = prev_xy[0] + unpack_signed(decoder.read_varint(bs, 6))
                    y = prev_xy[1] + unpack_signed(decoder.read_varint(bs, 6))
                if abs(x) > (1 << 31) or abs(y) > (1 << 31):
                    raise JxlValidationError("patch coord overflow")
                prev_xy = (x, y)
                blending = []
                for _ in range(num_extra + 1):
                    raw_mode = decoder.read_varint(bs, 5)
                    if raw_mode > 7:
                        raise JxlValidationError("invalid patch blend mode")
                    mode = PatchBlendMode(raw_mode)
                    if raw_mode >= 4 and len(alpha_indices) >= 2:
                        alpha_channel = decoder.read_varint(bs, 8)
                    else:
                        alpha_channel = (alpha_indices[0] if alpha_indices
                                         else 0)
                    clamp = (
                        decoder.read_varint(bs, 9) != 0 if raw_mode >= 3
                        else False
                    )
                    blending.append(PatchBlending(mode, alpha_channel, clamp))
                targets.append(PatchTarget(x, y, blending))
            patches.append(
                PatchRefData(ref_idx, x0, y0, width, height, targets)
            )
        decoder.finalize()
        return cls(patches)
