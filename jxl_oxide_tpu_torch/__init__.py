"""jxl_oxide_tpu_torch: the PyTorch/CUDA port of jxl_oxide_tpu.

A JPEG XL decoder for an NVIDIA H100: host-side headers and C++ entropy
decode (the same native/src/jxl_host.cpp as the JAX package), then one
torch device program per frame, with the edge-preserving filter as a
hand-written CUDA kernel (csrc/epf.cu). It imports nothing of JAX or of
jxl_oxide_tpu, which stays beside it as the reference.

    JxlImage.from_bytes(data).render_frame(0).to_u8()

decodes on CUDA by default and raises when there is none; pass
device="cpu" to run the plain torch versions on the CPU. A stream fed in
pieces (JxlImage().feed_bytes(piece)) renders what has arrived through
render_loading_frame(); Render.stream() writes samples into caller
buffers; set_image_region() and render_frame_cropped() decode a region.
decode_batch, decode_iter and decode_batch_stacked (serving.py) decode
many streams at once; the last runs same-geometry VarDCT streams as one
stacked program. Every stream the JAX package decodes: any number of
frames, VarDCT (4:4:4 in XYB, RGB or YCbCr, or chroma-subsampled YCbCr)
or lossless Modular (chroma-subsampled YCbCr too), any extra channels,
any colour encoding and EXIF orientation (see ROADMAP.md). The metadata boxes
(raw_exif_data, raw_xmp, hdr_gain_map, aux_box) and reconstruct_jpeg()
are host work; clear_program_caches() releases the cached programs. The
front ends: the CLI (`python -m jxl_oxide_tpu_torch decode x.jxl -o
x.png`, cli.py), the PNG/APNG writer (io/png.py) and the Pillow plugin
(integration.py).
"""

from .api import JxlImage, Render, clear_program_caches
from .serving import decode_batch, decode_batch_stacked, decode_iter
from .utils.errors import JxlError, JxlNotSupportedError

__all__ = ["JxlImage", "Render", "JxlError", "JxlNotSupportedError",
           "clear_program_caches", "decode_batch", "decode_batch_stacked",
           "decode_iter"]
