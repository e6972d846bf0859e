"""Concurrent decode for serving workloads (jxl_oxide_tpu/serving.py).

- `decode_batch` and `decode_iter` overlap per-image decodes on a thread
  pool: the C++ entropy calls go through ctypes and release the GIL, so
  the host stage of one image runs while another's device work is queued.
- `decode_batch_stacked` runs the host stages on the pool, then groups
  the VarDCT streams whose fused programs share a key (and whose colour
  tails, input dtypes and alpha agree) and decodes each group as ONE
  stack: one upload, one op sequence whatever the stack's size (the JAX
  package vmaps the program, serving.py:320; the port writes the stack
  axis into its programs, ops/vardct_pipeline.py), one EPF kernel launch
  per pass, one colour tail and one interleave/quantize. Streams outside
  that envelope (Modular, orientation other than 1, the staged path, ...)
  take the per-image `decode_batch` path.

`output="device"` keeps the results on the card: views of the one
stacked tensor of each group, no readback.

`mesh=` passes through to JxlImage with its other keywords: the
per-image decodes run sharded over it, and the stacks run unsharded on
its home device, as the JAX package's stacked path runs its single-device
programs (jxl_oxide_tpu/serving.py:224-262).
"""

from __future__ import annotations

import collections
import concurrent.futures as _cf
from typing import Iterable, Sequence

import numpy as np
import torch

from .api import JxlImage, _finalize
from .render.render import host_stage
from .utils.errors import JxlNotSupportedError
from .utils.options import use_decode_device
from .utils.trace import span

__all__ = ["decode_batch", "decode_batch_stacked", "decode_iter"]

_OUTPUT_KINDS = ("u8", "f32", "device", "render")


def _decode_one(data: bytes, frame: int, output: str, builder_kwargs):
    img = JxlImage.from_bytes(data, **builder_kwargs)
    r = img.render_frame(frame)
    if output == "render":
        return r
    if output == "device":
        # oriented, alpha-inclusive [H, W, C]; stays on the decode device
        return r.image_device()
    if output == "u8":
        return r.to_u8()
    return r.image()  # "f32"


def decode_batch(streams: Sequence[bytes], *, frame: int = 0,
                 output: str = "u8", num_workers: int = 8,
                 **builder_kwargs) -> list:
    """Decode many independent JXL byte streams concurrently.

    output: "u8" ([H, W, C] uint8, host), "f32" (float32, host),
    "device" ([H, W, C] float32 left on the decode device, no host
    readback), or "render" (the Render object). builder_kwargs pass
    through to JxlImage (device=, num_threads=, mesh=). Results are returned in
    input order; a failed decode raises (the remaining futures are still
    awaited)."""
    if output not in _OUTPUT_KINDS:
        raise ValueError(f"unknown output kind {output!r}")
    streams = list(streams)
    if not streams:
        return []
    if len(streams) == 1 or num_workers <= 1:
        return [_decode_one(d, frame, output, builder_kwargs)
                for d in streams]
    with _cf.ThreadPoolExecutor(max_workers=num_workers) as ex:
        futs = [ex.submit(_decode_one, d, frame, output, builder_kwargs)
                for d in streams]
        return [f.result() for f in futs]


def decode_iter(streams: Iterable[bytes], *, frame: int = 0,
                output: str = "u8", num_workers: int = 8,
                window: int | None = None, **builder_kwargs):
    """Streaming variant: yields decoded results in input order while at
    most `window` (default 2 * num_workers) decodes are in flight, so
    memory stays bounded for arbitrarily long input streams."""
    if output not in _OUTPUT_KINDS:
        raise ValueError(f"unknown output kind {output!r}")
    window = max(1, 2 * num_workers if window is None else window)
    pending: collections.deque = collections.deque()
    with _cf.ThreadPoolExecutor(max_workers=num_workers) as ex:
        for data in streams:
            pending.append(
                ex.submit(_decode_one, data, frame, output, builder_kwargs))
            while len(pending) >= window:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()


def _host_stage_fast(img: JxlImage, frame: int):
    """The host entropy stage of a stream in the stacked envelope:
    (state, hf_global, frame_obj, alpha), alpha the integer samples of the
    image's alpha channel or None; None when the stream takes the
    per-image path. The envelope: a stream of one frame, keyframe 0 asked
    for (jxl_oxide_tpu/serving.py:127-129: a multi-frame stream
    composites, and goes per image), one VarDCT frame inside the port's
    envelope (api.py `_check_envelope`: 4:4:4 or chroma-subsampled)
    whose only extra channel, if any, is one integer alpha at full
    resolution (the JAX package's `ec_ok`), with no upsampling or EC
    upsampling, no LF frame, no splines and no noise, in XYB or an enum
    RGB encoding with no ICC leg (no embedded profile, no requested one:
    jxl_oxide_tpu/serving.py:127-142) and no tone map
    that detects the peak (its peak would be the stack's, not the
    image's), that covers the canvas as it is (no crop
    offset, the image's size, no patches; the stacked program returns
    frame-sized planes and composites nothing, jxl_oxide_tpu/serving.py
    :146-161) and orientation 1: after the fused program the image
    pipeline is then exactly ([YCbCr -> RGB] -> colour transform ->
    interleave -> quantize) with the alpha passed through, all
    pointwise, so it applies to a whole stack at once. Streams outside
    the port's envelope raise JxlNotSupportedError here (the caller
    routes them to the per-image path, which raises it again)."""
    from .headers.frame import Encoding
    from .headers.image import ColourSpace, ExtraChannelType

    if frame != 0 or img.num_keyframes != 1 or img.num_frames != 1:
        return None
    img._check_envelope([0])
    meta = img.image_header.metadata
    # the stacked program passes one full-resolution integer alpha
    # through; any other extra channel goes per image
    # (jxl_oxide_tpu/serving.py:119-126, ec_ok)
    ec_ok = len(meta.ec_info) <= 1 and all(
        info.ty == ExtraChannelType.ALPHA and info.dim_shift == 0
        and not info.bit_depth.is_float for info in meta.ec_info)
    if not ec_ok:
        return None
    enc = meta.colour_encoding
    if (img.requested_icc is not None or enc.want_icc
            or enc.colour_space == ColourSpace.GREY
            or any(op.kind == "tone_map" and op.data["detect_peak"]
                   for op in img._color_transform().ops)):
        return None
    fr = img._frames[0]
    header = fr.header
    size = img.image_header.size
    flags = header.flags
    # the features, upsampling and LF frames of the per-image path
    # (render/context.py) are not in the stacked program: such a stream
    # goes per image (jxl_oxide_tpu/serving.py:121-125, 146-157)
    if (header.upsampling != 1
            or any(u != 1 for u in header.ec_upsampling)
            or header.lf_level != 0
            or flags.use_lf_frame
            or flags.splines
            or flags.noise):
        return None
    if (img.image_header.metadata.orientation != 1
            or header.encoding != Encoding.VARDCT
            or flags.patches
            or not header.is_last
            or header.have_crop or header.x0 or header.y0
            or header.sample_width() != size.width
            or header.sample_height() != size.height):
        return None
    with use_decode_device(img.device):
        host = host_stage(fr)
    return (host.state, host.hf_global, host.frame,
            host.extra[0] if host.extra else None)


def _tail_key(img: JxlImage, fr) -> tuple:
    """What one stack's colour tail depends on beyond the program key:
    the colour metadata (program keys do not cover it), YCbCr and the
    requested encoding."""
    meta = img.image_header.metadata
    return (meta.xyb_encoded, fr.header.do_ycbcr, repr(meta.colour_encoding),
            repr(meta.opsin_inverse_matrix), repr(meta.tone_mapping),
            repr(img.requested_encoding))


def _dtype_key(inputs) -> tuple:
    """Input dtypes are data-dependent (u16 index deltas or i32 indices,
    i8/i16/i32 values, dense i16 or i32 planes), and np.stack promotes a
    mixed pair silently (deltas read as indices decode to garbage), so
    they join the grouping key."""
    return tuple(a.dtype.str for x in inputs
                 for a in (x if isinstance(x, (tuple, list)) else (x,)))


def _decode_stack(chunk, key, output: str) -> list:
    """One group chunk as one stack: (img, state, make_fn, inputs, alpha)
    per image, all sharing one grouping key (`key` its program key); the
    program comes from the chunk's own builder (its first image's
    make_fn). One upload, the stacked program, [YCbCr -> RGB], the colour
    tail, the alpha passed through, one interleave/quantize and one
    readback; returns per-image results in chunk order."""
    from .ops.color import ycbcr_to_rgb
    from .ops.vardct_pipeline import stack_inputs, upload_inputs
    from .render.render import integer_samples_to_float
    from .render.vardct import VardctFrameState

    img0, state0, make_fn0, _, alpha0 = chunk[0]
    device = img0.device
    # one program serves the per-image and the stacked decodes
    fn = VardctFrameState.program(key, make_fn0, device)
    with span("Stacked program inputs"):
        host = stack_inputs([c[3] for c in chunk])
        if alpha0 is not None:
            host.append(np.stack([c[4] for c in chunk]))
    with span("Upload"):
        placed = upload_inputs(host, device)
    with span("Stacked program"):
        n_inputs = len(host) - (alpha0 is not None)
        out = fn.stacked(*placed[:n_inputs])  # [N, 3, h, w]
    planes = [out[:, c] for c in range(3)]
    if state0.frame.header.do_ycbcr:
        # stream channel order is [Cb, Y, Cr]
        planes = list(ycbcr_to_rgb(planes[0], planes[1], planes[2]))
    planes = img0._run_transform(img0._color_transform(), planes)
    if alpha0 is not None:
        bits = img0.image_header.metadata.ec_info[0].bit_depth.bits_per_sample
        planes.append(integer_samples_to_float(placed[-1], bits))
    if output == "u8":
        res = _finalize(planes, 1, 255.0, torch.uint8).cpu().numpy()
    elif output == "f32":
        res = _finalize(planes, 1, None, None).cpu().numpy()
    else:  # "device": one interleave on the card, no readback
        res = _finalize(planes, 1, None, None)
    return [res[j] for j in range(len(chunk))]


def decode_batch_stacked(streams: Sequence[bytes], *, frame: int = 0,
                         output: str = "u8", num_workers: int = 8,
                         max_stack: int = 16, **builder_kwargs) -> list:
    """decode_batch with same-program images STACKED: host entropy stages
    and program inputs fan out on a thread pool (the C++ entropy calls and
    the native sparse extraction release the GIL); then images whose
    fused-program key, colour
    tail, input dtypes and alpha agree run as one stack per chunk of at
    most `max_stack` (a singleton runs as a stack of one: its host stage
    has run already). Streams outside the envelope (`_host_stage_fast`)
    take the per-image decode_batch path, which decodes them afresh.

    output: "u8" / "f32" (host readback) or "device" ([H, W, C] float32
    views of the group's one stacked tensor, left on the decode device);
    "render" runs decode_batch. builder_kwargs (device=, mesh=, ...) pass
    through to JxlImage. Results come back in input order."""
    if output not in ("u8", "f32", "device"):
        return decode_batch(streams, frame=frame, output=output,
                            num_workers=num_workers, **builder_kwargs)
    streams = list(streams)
    results: list = [None] * len(streams)

    def host_stage(i):
        """The stream's host entropy stage and its program inputs; the
        stage's inputs are None for the per-image path."""
        img = JxlImage.from_bytes(streams[i], **builder_kwargs)
        try:
            fast = _host_stage_fast(img, frame)
        except JxlNotSupportedError:  # out of the envelope: per image
            fast = None
        if fast is None:
            return i, img, None
        state, hf_global, fr, alpha = fast
        with span("Fused program inputs"):
            if state.subsampled:
                parts = state.fused_subsampled_program_parts(
                    hf_global, copy_inputs=True)
            else:
                parts = state.fused_program_parts(hf_global)
        # the inputs are copies of the coefficient planes: recycle the
        # planes into the pool for the next image's host stage (a stream
        # whose dense plan overflows decodes afresh on the per-image path)
        state._planes_poolable = parts is not None
        state.trim_coeff_planes()
        return i, img, None if parts is None else (state, fr, alpha, parts)

    with _cf.ThreadPoolExecutor(max_workers=max(1, num_workers)) as ex:
        host_out = list(ex.map(host_stage, range(len(streams))))

    groups: dict = {}
    slow: list = []
    for i, img, fast in host_out:
        if fast is None:
            slow.append(i)
            continue
        state, fr, alpha, (key, make_fn, inputs) = fast
        alpha_bits = (None if alpha is None else img.image_header.metadata
                      .ec_info[0].bit_depth.bits_per_sample)
        gkey = (key, _tail_key(img, fr), _dtype_key(inputs), alpha_bits,
                str(img.device))
        groups.setdefault(gkey, []).append(
            (i, (img, state, make_fn, inputs, alpha)))

    for gkey, members in groups.items():
        for s0 in range(0, len(members), max_stack):
            chunk = members[s0:s0 + max_stack]
            outs = _decode_stack([m for _, m in chunk], gkey[0], output)
            for (i, _), r in zip(chunk, outs):
                results[i] = r

    if slow:
        slow_res = decode_batch([streams[i] for i in slow], frame=frame,
                                output=output, num_workers=num_workers,
                                **builder_kwargs)
        for i, r in zip(slow, slow_res):
            results[i] = r
    return results
