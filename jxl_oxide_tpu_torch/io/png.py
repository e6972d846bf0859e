"""Minimal PNG writer (8/16-bit, gray/RGB/+alpha, optional ICC/APNG).

A copy of jxl_oxide_tpu/io/png.py (the output capabilities of
jxl-oxide-cli/src/output.rs) on stdlib zlib/struct: every scanline has
filter type None, and an animation is an APNG (acTL, then fcTL/fdAT per
frame). Given the same arrays it writes the same bytes as the JAX
package's writer.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["write_apng", "write_png"]

_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}  # channels -> PNG color type


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def _scanlines(img: np.ndarray) -> bytes:
    """Rows of big-endian samples, each after a filter byte of 0."""
    h = img.shape[0]
    flat = (img.astype(">u2") if img.dtype.itemsize == 2
            else img.astype("u1")).tobytes()
    stride = len(flat) // h
    raw = bytearray()
    for y in range(h):
        raw.append(0)  # filter: None
        raw += flat[y * stride : (y + 1) * stride]
    return bytes(raw)


def _header_chunks(width, height, bit_depth, channels, icc=None) -> bytes:
    out = b"\x89PNG\r\n\x1a\n"
    out += _chunk(
        b"IHDR",
        struct.pack(
            ">IIBBBBB", width, height, bit_depth, _COLOR_TYPE[channels], 0, 0, 0
        ),
    )
    if icc:
        out += _chunk(b"iCCP", b"icc\x00\x00" + zlib.compress(icc))
    return out


def _as_hwc(img) -> np.ndarray:
    img = np.asarray(img)
    return img[:, :, None] if img.ndim == 2 else img


def write_png(path, img, icc: bytes | None = None) -> None:
    """img: [H, W] or [H, W, C] uint8/uint16 array."""
    img = _as_hwc(img)
    h, w, c = img.shape
    out = _header_chunks(w, h, img.dtype.itemsize * 8, c, icc)
    out += _chunk(b"IDAT", zlib.compress(_scanlines(img), 6))
    out += _chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(out)


def write_apng(path, frames, durations_ms, num_loops=0, icc=None) -> None:
    """frames: list of [H, W, C] arrays with equal shape/dtype."""
    imgs = [_as_hwc(f) for f in frames]
    h, w, c = imgs[0].shape
    out = _header_chunks(w, h, imgs[0].dtype.itemsize * 8, c, icc)
    out += _chunk(b"acTL", struct.pack(">II", len(imgs), num_loops))
    seq = 0
    for i, (img, dur) in enumerate(zip(imgs, durations_ms)):
        out += _chunk(
            b"fcTL",
            struct.pack(">IIIIIHHBB", seq, w, h, 0, 0, int(dur), 1000, 0, 0),
        )
        seq += 1
        data = zlib.compress(_scanlines(img), 6)
        if i == 0:
            out += _chunk(b"IDAT", data)
        else:
            out += _chunk(b"fdAT", struct.pack(">I", seq) + data)
            seq += 1
    out += _chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(out)
