"""ICC v4 profile synthesis from enum colour encodings.

Behavioral parity: jxl-color/src/icc/synthesize.rs (colour_encoding_to_icc)
— builds an mntr profile with desc/cprt/wtpt/chad + parametric or LUT TRC
curves and primaries matrices (Bradford-adapted to D50 PCS), plus a cicp
tag for PQ/HLG. Used by `rendered_icc` and as the enum-side leg of CMS
transforms. Host-side; a copy of jxl_oxide_tpu/color/synthesize.py.
"""

from __future__ import annotations

import struct

import numpy as np

from ..headers.image import ColourEncoding, ColourSpace
from ..utils.errors import JxlNotSupportedError
from .convert import (
    ILLUMINANT_D65,
    adapt_mat,
    illuminant_of,
    primaries_of,
    primaries_to_xyz_mat,
)

__all__ = ["colour_encoding_to_icc"]

ILLUMINANT_D50 = (0.34567, 0.35850)


def _mluc(locale: bytes, strings: list[str]) -> bytes:
    out = bytearray(b"mluc\0\0\0\0")
    out += struct.pack(">I", len(strings))
    out += b"\0\0\0\x0c"
    data = bytearray()
    recs = bytearray()
    for s in strings:
        offset = len(data)
        enc = s.encode("utf-16-be")
        data += enc
        recs += locale
        recs += struct.pack(">I", len(enc))
        recs += struct.pack(">I", 0x10 + len(strings) * 12 + offset)
    return bytes(out + recs + data)


def _xyz_tag(xyz_q: list[int]) -> bytes:
    return b"XYZ \0\0\0\0" + struct.pack(">iii", *xyz_q)


def _para(ty: int, params: list[int]) -> bytes:
    out = bytearray(b"para\0\0\0\0")
    out += struct.pack(">H", ty) + b"\0\0"
    for p in params:
        out += struct.pack(">I", p)
    return bytes(out)


def _curv_lut(lut: np.ndarray) -> bytes:
    out = bytearray(b"curv\0\0\0\0")
    out += struct.pack(">I", len(lut))
    out += np.asarray(lut, dtype=">u2").tobytes()
    return bytes(out)


def _pq_table(n: int) -> np.ndarray:
    """PQ EOTF LUT (tf/pq.rs:432-450)."""
    e = np.arange(n, dtype=np.float64) / (n - 1)
    m1r, m2r = 8192.0 / 1305.0, 32.0 / 2523.0
    c1, c2, c3 = 107.0 / 128.0, 2413.0 / 128.0, 2392.0 / 128.0
    ep = e ** m2r
    num = np.maximum(ep - c1, 0.0)
    den = c2 - ep * c3
    d = (num / den) ** m1r
    return np.clip(d * 65535.0, 0, 65535).astype(np.uint16)


def _hlg_table(n: int) -> np.ndarray:
    """HLG inverse-OETF LUT (tf.rs:174-192)."""
    a, b, c = 0.17883277, 0.28466892, 0.5599107
    out = np.zeros(n, dtype=np.float64)
    half = (n - 1) // 2
    idx = np.arange(half + 1, dtype=np.float64)
    out[: half + 1] = idx * idx / (3.0 * (n - 1) * (n - 1))
    idx2 = np.arange(half + 1, n, dtype=np.float64)
    e = idx2 / (n - 1)
    out[half + 1 :] = (np.exp((e - c) / a) + b) / 12.0
    return np.clip(out * 65535.0, 0, 65535).astype(np.uint16)


def colour_encoding_to_icc(enc: ColourEncoding) -> bytes:
    """Synthesize an ICC v4 profile (synthesize.rs:88-290)."""
    cs = enc.colour_space
    if cs in (ColourSpace.XYB, ColourSpace.UNKNOWN):
        raise JxlNotSupportedError(f"ICC synthesis for {cs}")

    header = bytearray(128)
    header[4:8] = b"jxl "
    header[8:12] = bytes([4, 0x40, 0, 0])
    header[12:16] = b"mntr"
    header[16:20] = b"RGB " if cs == ColourSpace.RGB else b"GRAY"
    header[20:24] = b"XYZ "
    header[24:36] = bytes([7, 0xE7, 0, 4, 0, 22, 0, 0, 0, 0, 0, 0])
    header[36:40] = b"acsp"
    header[40:44] = b"APPL"
    intents = {"PERCEPTUAL": 0, "RELATIVE": 1, "SATURATION": 2, "ABSOLUTE": 3}
    header[0x43] = intents.get(enc.rendering_intent.name, 0)
    header[0x44:0x50] = struct.pack(">iii", 0xF6D6, 0x10000, 0xD32D)
    header[0x50:0x54] = b"jxl "

    tags: list[tuple[bytes, int, int]] = []
    data = bytearray()

    def append(tag_names, payload: bytes):
        offset = len(data)
        for t in tag_names:
            tags.append((t, offset, len(payload)))
        data.extend(payload)
        while len(data) % 4:
            data.append(0)

    tf = enc.tf
    desc = f"{cs.name}_{enc.rendering_intent.name}_{enc.white_point.kind}_" \
           f"{enc.primaries.kind}_{tf.kind}"
    append([b"desc"], _mluc(b"enUS", [desc]))
    append([b"cprt"], _mluc(b"enUS", ["CC0, generated by jxl-oxide-tpu"]))

    from_ill = illuminant_of(enc.white_point)
    chad = np.eye(3)
    if cs == ColourSpace.RGB:
        append([b"wtpt"], _xyz_tag([0xF6D6, 0x10000, 0xD32D]))
        chad = adapt_mat(from_ill, ILLUMINANT_D50)
        payload = bytearray(b"sf32\0\0\0\0")
        for v in chad.reshape(-1):
            payload += struct.pack(">i", int(v * 65536.0 + 0.5))
        append([b"chad"], bytes(payload))
    else:
        x, y = from_ill
        xyz = (x / y, 1.0, (1.0 - x) / y - 1.0)
        append([b"wtpt"], _xyz_tag([int(v * 65536.0 + 0.5) for v in xyz]))

    kind = tf.kind
    if kind == "gamma":
        g = tf.gamma
        if tf.gamma_inverted:
            gamma_q = (65536 * 10000000 + g // 2) // g
        else:
            gamma_q = (g * 65536 + 5000000) // 10000000
        trc = _para(0, [gamma_q])
    elif kind == "bt709":
        trc = _para(3, [
            (65536 * 20 + 4) // 9,
            (65536 * 1000 + 549) // 1099,
            (65536 * 99 + 549) // 1099,
            (65536 * 10 + 22) // 45,
            (65536 * 81 + 500) // 1000,
        ])
    elif kind == "linear":
        trc = b"curv\0\0\0\0\0\0\0\0"
    elif kind == "srgb":
        trc = _para(3, [
            (65536 * 24 + 5) // 10,
            (65536 * 1000 + 527) // 1055,
            (65536 * 55 + 527) // 1055,
            (65536 * 100 + 646) // 1292,
            (65536 * 4045 + 50000) // 100000,
        ])
    elif kind == "pq":
        trc = _curv_lut(_pq_table(4096))
    elif kind == "dci":
        trc = _para(0, [(65536 * 26 + 5) // 10])
    elif kind == "hlg":
        trc = _curv_lut(_hlg_table(4096))
    else:
        raise JxlNotSupportedError(f"ICC synthesis for tf {kind}")

    if kind in ("pq", "hlg"):
        prim_cicp = enc.primaries.cicp()
        tf_cicp = tf.cicp()
        if prim_cicp is not None and tf_cicp is not None:
            cicp = b"cicp\0\0\0\0" + bytes([prim_cicp, tf_cicp, 0, 1])
            append([b"cicp"], cicp)

    if cs == ColourSpace.RGB:
        append([b"rTRC", b"gTRC", b"bTRC"], trc)
        p_xyz = primaries_to_xyz_mat(primaries_of(enc.primaries), from_ill)
        p_pcs = chad @ p_xyz
        q = np.round(p_pcs * 65536.0 + 0.5).astype(np.int64)
        for i, t in enumerate((b"rXYZ", b"gXYZ", b"bXYZ")):
            append([t], _xyz_tag([int(q[0, i]), int(q[1, i]), int(q[2, i])]))
    else:
        append([b"kTRC"], trc)

    data_offset = 128 + 4 + len(tags) * 12
    out = bytearray(header)
    out += struct.pack(">I", len(tags))
    for tag, off, ln in tags:
        out += tag + struct.pack(">II", off + data_offset, ln)
    out += data
    struct.pack_into(">I", out, 0, len(out))
    return bytes(out)
