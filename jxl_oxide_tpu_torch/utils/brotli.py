"""Brotli decompression via the system libbrotlidec (ctypes).

A copy of jxl_oxide_tpu/utils/brotli.py: it replaces the reference's
brotli-decompressor crate (jxl-jbr/src/lib.rs:28-31) for jbrd data
streams and brob boxes. When the library cannot be loaded it raises a
JxlError that names it; it never returns undecoded bytes.
"""

from __future__ import annotations

import ctypes
import ctypes.util

from .errors import JxlError

__all__ = ["LIBRARY", "available", "brotli_decompress"]

LIBRARY = "libbrotlidec"

_lib = None


def _get_lib():
    global _lib
    if _lib is None:
        name = ctypes.util.find_library("brotlidec") or "libbrotlidec.so.1"
        try:
            lib = ctypes.CDLL(name)
        except OSError as e:
            raise JxlError(
                f"brotli decompression needs the system {LIBRARY}, which "
                f"could not be loaded ({e})") from e
        lib.BrotliDecoderDecompress.restype = ctypes.c_int
        lib.BrotliDecoderDecompress.argtypes = [
            ctypes.c_size_t, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p]
        _lib = lib
    return _lib


def available() -> bool:
    """Whether the system libbrotlidec loads."""
    try:
        _get_lib()
    except JxlError:
        return False
    return True


def brotli_decompress(data: bytes, expected_size: int | None = None,
                      max_size: int = 1 << 28) -> bytes:
    """One-shot decompression with growing output buffer."""
    lib = _get_lib()
    size = expected_size if expected_size else max(4 * len(data), 1 << 16)
    while size <= max_size:
        out = ctypes.create_string_buffer(size)
        out_len = ctypes.c_size_t(size)
        ret = lib.BrotliDecoderDecompress(
            ctypes.c_size_t(len(data)),
            ctypes.c_char_p(data),
            ctypes.byref(out_len),
            out,
        )
        if ret == 1:  # BROTLI_DECODER_RESULT_SUCCESS
            return out.raw[: out_len.value]
        if expected_size:
            break
        size *= 4
    raise JxlError("brotli decompression failed")
