"""Pillow image plugin of the port.

The torch counterpart of jxl_oxide_tpu/integration.py (jxl-oxide
integration.rs + integration/image.rs): registers the decoder with
Pillow so that `Image.open("x.jxl")` works, animation frames included
(seek/tell), with the ICC profile in `info`. Pillow is imported only
here, when the module is imported; the rest of the port never needs it.

    from jxl_oxide_tpu_torch.integration import register
    register()                 # decodes on CUDA; register(device="cpu")
    from PIL import Image
    im = Image.open("image.jxl")
"""

from __future__ import annotations

from PIL import Image, ImageFile

__all__ = ["JxlImageFile", "register"]

_MAGIC_CODESTREAM = b"\xff\x0a"
_MAGIC_CONTAINER = b"\x00\x00\x00\x0cJXL \x0d\x0a\x87\x0a"


def _accept(prefix: bytes) -> bool:
    return prefix.startswith(_MAGIC_CODESTREAM) or prefix.startswith(
        _MAGIC_CONTAINER
    )


class JxlImageFile(ImageFile.ImageFile):
    """Pillow ImageFile over the port's decoder, on the device given to
    `register` (the class attribute `device`)."""

    format = "JXL"
    format_description = "JPEG XL (jxl-oxide-tpu-torch)"
    device = None

    def _open(self):
        from .api import JxlImage

        self._jxl = JxlImage.from_bytes(self.fp.read(), device=self.device)
        meta = self._jxl.image_header.metadata
        # width and height as displayed: orientations 5-8 swap them
        self._size = (self._jxl.width, self._jxl.height)
        has_alpha = any(info.ty.name == "ALPHA" for info in meta.ec_info)
        if meta.grayscale:
            self._mode = "LA" if has_alpha else "L"
        else:
            self._mode = "RGBA" if has_alpha else "RGB"
        self.n_frames = max(1, self._jxl.num_keyframes)
        self.is_animated = self.n_frames > 1
        self._frame = 0
        icc = self._jxl.embedded_icc
        if icc:
            self.info["icc_profile"] = icc
        if meta.animation is not None:
            self.info["loop"] = meta.animation.num_loops
        self.tile = []
        self._loaded_frame = None

    def seek(self, frame: int) -> None:
        if not 0 <= frame < self.n_frames:
            raise EOFError("no more frames")
        if frame != self._frame:
            self._frame = frame
            self._loaded_frame = None

    def tell(self) -> int:
        return self._frame

    def load(self):
        if self._loaded_frame != self._frame:
            render = self._jxl.render_frame(self._frame)
            arr = render.to_u8()
            if arr.shape[-1] == 1:
                arr = arr[..., 0]
            pil = Image.fromarray(arr, self.mode)
            self.im = pil.im
            self._size = pil.size
            self._loaded_frame = self._frame
            anim = self._jxl.image_header.metadata.animation
            if anim is not None:
                self.info["duration"] = (
                    render.duration * 1000 * anim.tps_denominator
                    / anim.tps_numerator
                )
        return super().load()


def register(device=None) -> None:
    """Install the plugin into Pillow's registry (idempotent); images
    decode on `device` (None: CUDA, which must exist)."""
    JxlImageFile.device = device
    Image.register_open(JxlImageFile.format, JxlImageFile, _accept)
    Image.register_extensions(JxlImageFile.format, [".jxl"])
    Image.register_mime(JxlImageFile.format, "image/jxl")
