"""Color management system boundary.

Behavioral parity: jxl-color/src/cms.rs (ColorManagementSystem /
PreparedTransform / NullCms) and the jxl-oxide facade's Lcms2 backend
(jxl-oxide/src/lcms2.rs). `PilCms` drives Little CMS 2 through PIL's
ImageCms bindings — the same engine the reference links against — for
arbitrary ICC-to-ICC legs (notably CMYK + embedded profile, BASELINE
config 5). `NullCms` refuses ICC legs, like the reference's fallback.
Host-side; a copy of jxl_oxide_tpu/color/cms.py. Pillow is imported only
when a CMS leg runs, so importing the port does not need it.
"""

from __future__ import annotations

import io

import numpy as np

from ..utils.errors import JxlError, JxlNotSupportedError

__all__ = ["ColorManagementSystem", "NullCms", "PilCms", "srgb_icc"]


class ColorManagementSystem:
    """Interface: prepare a transform between two ICC profiles."""

    def prepare_transform(self, from_icc: bytes, to_icc: bytes | None,
                          intent: int = 0):
        raise NotImplementedError


class NullCms(ColorManagementSystem):
    """Refuses ICC transforms (cms.rs:47-58)."""

    def prepare_transform(self, from_icc, to_icc, intent=0):
        raise JxlNotSupportedError("ICC color transform requires a CMS")


def srgb_icc() -> bytes:
    """A synthesized sRGB profile (used as the default target)."""
    from PIL import ImageCms

    profile = ImageCms.createProfile("sRGB")
    return ImageCms.ImageCmsProfile(profile).tobytes()


class _PilTransform:
    def __init__(self, from_icc: bytes, to_icc: bytes | None, intent: int):
        from PIL import ImageCms

        src = ImageCms.ImageCmsProfile(io.BytesIO(from_icc))
        if to_icc is None:
            dst = ImageCms.ImageCmsProfile(ImageCms.createProfile("sRGB"))
        else:
            dst = ImageCms.ImageCmsProfile(io.BytesIO(to_icc))
        self._src_mode = {
            "RGB ": "RGB", "CMYK": "CMYK", "GRAY": "L",
        }.get(src.profile.xcolor_space, "RGB")
        dst_space = dst.profile.xcolor_space
        self._dst_mode = {
            "RGB ": "RGB", "CMYK": "CMYK", "GRAY": "L",
        }.get(dst_space, "RGB")
        self._transform = ImageCms.buildTransform(
            src, dst, self._src_mode, self._dst_mode,
            renderingIntent=intent,
        )
        self.num_input_channels = len(self._src_mode)
        self.num_output_channels = len(self._dst_mode)

    def transform(self, planes: list) -> list:
        """planes: float [0,1] planar channels. CMYK planes are expected in
        the JPEG XL convention (1.0 = no ink) and inverted for lcms."""
        from PIL import Image, ImageCms

        h, w = planes[0].shape
        n = self.num_input_channels
        if len(planes) < n:
            raise JxlError(
                f"CMS transform needs {n} channels, got {len(planes)}"
            )
        arr = np.stack([np.asarray(p, dtype=np.float32) for p in planes[:n]],
                       axis=-1)
        if self._src_mode == "CMYK":
            arr = 1.0 - arr
        u8 = np.clip(np.round(arr * 255.0), 0, 255).astype(np.uint8)
        img = Image.fromarray(u8.squeeze() if n == 1 else u8, self._src_mode)
        out = ImageCms.applyTransform(img, self._transform)
        out_arr = np.asarray(out, dtype=np.float32) / 255.0
        if out_arr.ndim == 2:
            out_arr = out_arr[:, :, None]
        if self._dst_mode == "CMYK":
            out_arr = 1.0 - out_arr
        return [out_arr[:, :, c] for c in range(out_arr.shape[2])]


class PilCms(ColorManagementSystem):
    """Little CMS 2 via PIL.ImageCms (the reference's lcms2 backend)."""

    def prepare_transform(self, from_icc, to_icc, intent=0):
        return _PilTransform(from_icc, to_icc, intent)
