"""ICC profile -> enum colour-encoding detection.

Behavioral parity: jxl-color/src/icc/parse.rs (detect_profile_info,
parse_icc, icc_tf). Recognizes ICC profiles that are exactly expressible
as enum encodings (known TRC curves + primaries/white point within 1e-4),
letting the decoder use the on-device enum transform path instead of an
external CMS. Host-side; a copy of jxl_oxide_tpu/color/parse.py, which the
port may not import.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from ..headers.image import (
    ColourEncoding,
    ColourSpace,
    Customxy,
    Primaries,
    RenderingIntent,
    TransferFunction,
    WhitePoint,
)
from ..utils.errors import JxlError, JxlNotSupportedError
from .convert import (
    ILLUMINANT_D65,
    ILLUMINANT_DCI,
    ILLUMINANT_E,
    PRIMARIES_BT2100,
    PRIMARIES_P3,
    PRIMARIES_SRGB,
)

__all__ = ["IccParseError", "detect_profile_info", "parse_icc", "icc_tf"]


class IccParseError(JxlError):
    pass


# TRC sentinels (KnownIccTrc, parse.rs:165-200)
_TRC_LINEAR = ("linear",)
_TRC_SRGB = ("srgb",)
_TRC_BT709 = ("bt709",)
_TRC_PQ = ("pq",)
_TRC_HLG = ("hlg",)

_BT709_PARAMS = [
    (65536 * 20 + 4) // 9,
    (65536 * 1000 + 549) // 1099,
    (65536 * 99 + 549) // 1099,
    (65536 * 10 + 22) // 45,
    (65536 * 81 + 500) // 1000,
]
_SRGB_PARAMS = [
    (65536 * 24 + 5) // 10,
    (65536 * 1000 + 527) // 1055,
    (65536 * 55 + 527) // 1055,
    (65536 * 100 + 646) // 1292,
    (65536 * 4045 + 50000) // 100000,
]

# tags that imply non-matrix/LUT pipelines we can't express as an enum
_UNSUPPORTED_TAGS = {
    b"chrm", b"clro", b"clrt", b"clot", b"ciis",
    b"lumi", b"meas", b"ncl2", b"resp", b"view",
}


def _trc_from_gamma(g_s15f16: int):
    """parse.rs:196-203: reject gamma <= 1.0 except exact 1.0 (linear)."""
    if g_s15f16 < 65536:
        return None
    if g_s15f16 == 65536:
        return _TRC_LINEAR
    return ("gamma", g_s15f16)


def _trc_to_tf(trc) -> TransferFunction:
    kind = trc[0]
    if kind == "gamma":
        g_1e7 = (trc[1] * 10000000 + 32768) // 65536
        return TransferFunction("gamma", gamma=g_1e7, gamma_inverted=False)
    return {
        "linear": TransferFunction("linear"),
        "srgb": TransferFunction("srgb"),
        "bt709": TransferFunction("bt709"),
        "pq": TransferFunction("pq"),
        "hlg": TransferFunction("hlg"),
    }[kind]


@dataclass
class IccProfileInfo:
    """Parsed fields relevant to enum detection (parse.rs:6-16)."""

    color_space: bytes
    rendering_intent: RenderingIntent
    chad: np.ndarray  # 3x3 float
    wtpt: np.ndarray  # XYZ float
    trc_k: tuple | None
    trc_rgb: tuple | None  # (r, g, b) TRC sentinels
    xyz_rgb: np.ndarray | None  # columns = r/g/b colorant XYZ

    @property
    def is_rgb(self) -> bool:
        return self.color_space == b"RGB "

    @property
    def is_cmyk(self) -> bool:
        return self.color_space == b"CMYK"

    @property
    def is_grayscale(self) -> bool:
        return self.color_space == b"GRAY"

    def trc_color(self) -> TransferFunction | None:
        if self.trc_rgb is None:
            return None
        r, g, b = self.trc_rgb
        if r == g == b:
            return _trc_to_tf(r)
        return None

    def trc_gray(self) -> TransferFunction | None:
        return _trc_to_tf(self.trc_k) if self.trc_k is not None else None

    def primaries(self) -> Primaries | None:
        """Undo chad, normalize colorant XYZ to xy, match known primaries
        (parse.rs:64-127)."""
        if self.xyz_rgb is None:
            return None
        adapted = np.linalg.inv(self.chad) @ self.xyz_rgb
        s = adapted.sum(axis=0)
        prim = np.stack([adapted[0] / s, adapted[1] / s], axis=1)  # [3,2]
        for known, ret in (
            (PRIMARIES_SRGB, Primaries("srgb")),
            (PRIMARIES_P3, Primaries("p3")),
            (PRIMARIES_BT2100, Primaries("bt2100")),
        ):
            if np.all(np.abs(prim - np.asarray(known, np.float32)) < 1e-4):
                return ret
        q = [Customxy(int(x * 1e6 + 0.5), int(y * 1e6 + 0.5)) for x, y in prim]
        return Primaries("custom", *q)

    def white_point(self) -> WhitePoint:
        ill = np.linalg.inv(self.chad) @ self.wtpt
        s = float(ill.sum())
        xy = (float(ill[0] / s), float(ill[1] / s))
        for known, ret in (
            (ILLUMINANT_D65, WhitePoint("d65")),
            (ILLUMINANT_DCI, WhitePoint("dci")),
            (ILLUMINANT_E, WhitePoint("e")),
        ):
            if abs(xy[0] - known[0]) < 1e-4 and abs(xy[1] - known[1]) < 1e-4:
                return ret
        return WhitePoint(
            "custom", Customxy(int(xy[0] * 1e6 + 0.5), int(xy[1] * 1e6 + 0.5))
        )


def _parse_trc_tag(data: bytes):
    """One [rgbk]TRC tag -> TRC sentinel or None (parse.rs:310-400)."""
    if data[:4] == b"para":
        if len(data) < 12:
            return None
        (curve_type,) = struct.unpack_from(">H", data, 8)
        nparams = (len(data) - 12) // 4
        if curve_type == 0:
            if nparams != 1:
                raise IccParseError("invalid parametricCurveType")
            (gamma,) = struct.unpack_from(">i", data, 12)
            return _trc_from_gamma(gamma)
        if curve_type == 3:
            if nparams != 5:
                raise IccParseError("invalid parametricCurveType")
            params = list(struct.unpack_from(">5i", data, 12))
            if params == _BT709_PARAMS:
                return _TRC_BT709
            if params == _SRGB_PARAMS:
                return _TRC_SRGB
            if params[1:] == [65536, 0, 65536, 0]:
                return _trc_from_gamma(params[0])
        return None
    if data[:12] == b"curv\0\0\0\0\0\0\0\0":
        return _TRC_LINEAR
    if data[:12] == b"curv\0\0\0\0\0\0\0\x01" and len(data) >= 14:
        return ("gamma", (data[12] << 16) | (data[13] << 8))
    return None


def detect_profile_info(profile: bytes) -> IccProfileInfo:
    """Parse header + relevant tags of an ICC profile (parse.rs:229-503)."""
    if len(profile) < 128:
        raise IccParseError("profile is too short")
    (size,) = struct.unpack_from(">I", profile, 0)
    if len(profile) != size:
        raise IccParseError("profile size mismatch")

    color_space = profile[0x10:0x14]
    ri_raw = profile[0x43]
    if ri_raw > 3:
        raise IccParseError("invalid rendering intent")
    rendering_intent = RenderingIntent(ri_raw)

    wtpt = np.array([0xF6D6, 0x10000, 0xD32D], np.float64) / 65536.0  # D50
    chad = np.eye(3)
    trcs: list = [None, None, None, None]
    trc_present = [False, False, False, False]
    xyzs: list = [None, None, None]
    cicp = None

    if size >= 0x84:
        (tag_count,) = struct.unpack_from(">I", profile, 0x80)
        if size < 0x84 + 12 * tag_count:
            raise IccParseError("unexpected end of profile in tag list")
        for i in range(tag_count):
            tag, off, tag_size = struct.unpack_from(">4sII", profile, 0x84 + 12 * i)
            if size < off + tag_size:
                raise IccParseError("unexpected end of profile in tag data")
            data = profile[off : off + tag_size]
            if len(data) < 4:
                continue

            if tag[1:] == b"TRC" and tag[0:1] in (b"r", b"g", b"b", b"k"):
                idx = b"rgbk".index(tag[0:1])
                trc_present[idx] = True
                trc = _parse_trc_tag(data)
                if trc is not None:
                    trcs[idx] = trc
            elif tag[1:4] == b"XYZ" and tag[0:1] in (b"r", b"g", b"b"):
                idx = b"rgb".index(tag[0:1])
                if data[:4] != b"XYZ " or len(data) < 20:
                    raise IccParseError("invalid colorant tag")
                xyz = np.array(struct.unpack_from(">3i", data, 8), np.float64)
                _validate_xyz(xyz)
                xyzs[idx] = xyz / 65536.0
            elif tag == b"chad":
                if data[:4] != b"sf32" or len(data) < 44:
                    raise IccParseError("invalid chad tag")
                mat = np.array(
                    struct.unpack_from(">9i", data, 8), np.float64
                ).reshape(3, 3) / 65536.0
                _validate_chad(mat)
                chad = mat
            elif tag == b"wtpt":
                if data[:4] != b"XYZ " or len(data) < 20:
                    raise IccParseError("invalid wtpt tag")
                w = np.array(struct.unpack_from(">3i", data, 8), np.float64)
                _validate_xyz(w)
                wtpt = w / 65536.0
            elif tag == b"cicp":
                # payload after 4-byte signature + 4 reserved bytes
                # (parse.rs:464 reads data[..4], i.e. the signature — the
                # intent is clearly the payload)
                if len(data) >= 12:
                    cicp = data[8:12]
            elif (
                (tag[0:1] in b"AD" and tag[1:3] == b"2B" and tag[3:4] in b"0123")
                or (tag[0:1] == b"B" and tag[1:3] in (b"2A", b"2D")
                    and tag[3:4] in b"0123")
                or (tag[:3] == b"pre" and tag[3:4] in b"012")
                or tag in _UNSUPPORTED_TAGS
            ):
                raise JxlNotSupportedError("unsupported ICC profile")

    override = None
    if cicp is not None and len(cicp) == 4:
        if cicp[1] == 16:
            override = _TRC_PQ
        elif cicp[1] == 18:
            override = _TRC_HLG

    # cicp is authoritative for PQ/HLG: the TRC tags then hold a LUT
    # approximation, so the override applies whenever TRC tags exist
    # (slightly wider than parse.rs:471-487, which needs parseable TRCs)
    trc_rgb = None
    if override and all(trc_present[:3]):
        trc_rgb = (override,) * 3
    elif all(t is not None for t in trcs[:3]):
        trc_rgb = tuple(trcs[:3])
    trc_k = None
    if override and trc_present[3]:
        trc_k = override
    elif trcs[3] is not None:
        trc_k = trcs[3]
    xyz_rgb = None
    if all(x is not None for x in xyzs):
        xyz_rgb = np.stack(xyzs, axis=1)  # columns r/g/b

    return IccProfileInfo(
        color_space=color_space,
        rendering_intent=rendering_intent,
        chad=chad,
        wtpt=wtpt,
        trc_k=trc_k,
        trc_rgb=trc_rgb,
        xyz_rgb=xyz_rgb,
    )


def _validate_xyz(xyz: np.ndarray) -> None:
    s = float(xyz.sum())
    with np.errstate(all="ignore"):
        if not np.all(np.isfinite(xyz / s)):
            raise IccParseError("invalid XYZType")


def _validate_chad(mat: np.ndarray) -> None:
    try:
        inv = np.linalg.inv(mat)
    except np.linalg.LinAlgError:
        raise IccParseError("invalid chad tag") from None
    if not np.all(np.isfinite(inv)):
        raise IccParseError("invalid chad tag")


def parse_icc(profile: bytes) -> ColourEncoding:
    """ICC -> enum colour encoding, or raise (parse.rs:527-560)."""
    info = detect_profile_info(profile)
    if info.is_cmyk:
        raise JxlNotSupportedError("CMYK ICC profile is not enum-expressible")
    if info.is_grayscale:
        tf = info.trc_gray()
        if tf is None:
            raise JxlNotSupportedError("unsupported gray ICC TRC")
        return ColourEncoding(
            colour_space=ColourSpace.GREY,
            white_point=info.white_point(),
            primaries=Primaries("srgb"),
            tf=tf,
            rendering_intent=info.rendering_intent,
        )
    if info.is_rgb:
        tf = info.trc_color()
        primaries = info.primaries()
        if tf is None or primaries is None:
            raise JxlNotSupportedError("unsupported RGB ICC profile")
        return ColourEncoding(
            colour_space=ColourSpace.RGB,
            white_point=info.white_point(),
            primaries=primaries,
            tf=tf,
            rendering_intent=info.rendering_intent,
        )
    raise JxlNotSupportedError("unsupported ICC colour space")


def icc_tf(profile: bytes) -> TransferFunction | None:
    """Transfer function of an enum-expressible ICC, else None."""
    try:
        return parse_icc(profile).tf
    except JxlError:
        return None
