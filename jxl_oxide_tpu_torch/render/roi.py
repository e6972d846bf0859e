"""Region-of-interest decode pushdown (a copy of jxl_oxide_tpu/render/roi.py).

When a decode region is active, the section decoders skip TOC sections
whose groups do not meet the padded region (the reference decodes only
the groups that meet it: jxl-render/src/region.rs and jxl-frame/src/
lib.rs adjust_region), and a VarDCT frame's fused device program computes
only a group-aligned rect around it (`device_rect`). The region is in
CODED image coordinates (api.py maps the display-space crop through the
inverse orientation first) and is padded here for the filter stencils
(1 px gaborish and up to 6 px EPF, jxl-frame/src/lib.rs:626-649).
"""

from __future__ import annotations

import contextlib
import contextvars

__all__ = ["DEVICE_RECT_PAD", "FILTER_PAD", "LF_GROUP_PAD", "device_rect",
           "frame_supports_roi", "get_decode_region", "group_intersects",
           "lf_group_intersects", "use_decode_region"]

# (left, top, width, height) in coded image coordinates, or None
_decode_region: contextvars.ContextVar = contextvars.ContextVar(
    "jxl_torch_decode_region", default=None
)

# the filter stencils' reach: 6 px EPF (3 passes) + 1 px gaborish, rounded
# up
FILTER_PAD = 8


def get_decode_region():
    return _decode_region.get()


@contextlib.contextmanager
def use_decode_region(region):
    token = _decode_region.set(region)
    try:
        yield
    finally:
        _decode_region.reset(token)


def frame_supports_roi(frame) -> bool:
    """Whether the region may select the frame's sections: only when the
    pixels skipped cannot reach the region's. Patches copy any rect
    between frames, noise reads 9 adjacent groups, frame upsampling and LF
    frames change the coordinate scale, and the Modular squeeze mixes
    samples across the plane: those frames decode whole."""
    header = frame.header
    if header.upsampling != 1 or header.lf_level != 0:
        return False
    if header.flags.use_lf_frame or header.flags.noise or header.flags.patches:
        return False
    if any(u != 1 for u in header.ec_upsampling):
        return False
    if header.do_ycbcr and not header.flags.skip_adaptive_lf_smoothing:
        # the fused subsampled program (which takes the rect) needs
        # skip_adaptive_lf_smoothing; other YCbCr frames decode whole
        return False
    lf_global = getattr(frame, "lf_global", None)
    if lf_global is not None and lf_global.gmodular.modular is not None:
        from ..models.modular_transform import Squeeze

        for tr in lf_global.gmodular.modular.header.transforms:
            if isinstance(tr, Squeeze):
                return False
    return True


# the device rect's padding: the rect's edge acts as a plane edge inside
# the fused program (adaptive LF smoothing skips the outermost LF row and
# column, 8 px) and the pixel filters reach another 7 px, so the region
# stays at least 8 + 7 px inside the rect
DEVICE_RECT_PAD = 24


def device_rect(frame, state, region):
    """The group-aligned plane rect (x0, y0, x1, y1) that covers the padded
    region, or None when it covers most of the plane. The fused device
    program then computes only this rect (region.rs pushdown past the host
    stage)."""
    header = frame.header
    left, top, w, h = region
    left -= header.x0
    top -= header.y0
    # the full-resolution plane (plane_shapes[0] is channel x's, smaller
    # than the frame for chroma-subsampled streams)
    ph, pw = state.height_rounded, state.width_rounded
    gd = header.group_dim
    x0 = max(0, left - DEVICE_RECT_PAD) // gd * gd
    y0 = max(0, top - DEVICE_RECT_PAD) // gd * gd
    x1 = min(pw, -(-(left + w + DEVICE_RECT_PAD) // gd) * gd)
    y1 = min(ph, -(-(top + h + DEVICE_RECT_PAD) // gd) * gd)
    if x1 <= x0 or y1 <= y0:
        return None
    if (x1 - x0) * (y1 - y0) * 2 >= pw * ph:
        return None  # most of the plane: not worth a program of its own
    return (x0, y0, x1, y1)


def group_intersects(frame, group_idx: int, region) -> bool:
    """Whether pass group `group_idx` meets the padded region (in frame
    coordinates: the image-space region moved by -x0, -y0)."""
    header = frame.header
    left, top, w, h = region
    left -= header.x0 + FILTER_PAD
    top -= header.y0 + FILTER_PAD
    w += 2 * FILTER_PAD
    h += 2 * FILTER_PAD
    gd = header.group_dim
    gpr = header.groups_per_row
    gx, gy = group_idx % gpr, group_idx // gpr
    x0, y0 = gx * gd, gy * gd
    return not (
        x0 >= left + w or x0 + gd <= left or y0 >= top + h or y0 + gd <= top
    )


# adaptive LF smoothing reads one LF sample (8 px) beyond the region and
# the pixel filters another 7 px, so a skipped neighbouring LF group could
# change the DC near its edge: the LF groups are padded further
LF_GROUP_PAD = FILTER_PAD + 32


def lf_group_intersects(frame, lf_group_idx: int, region) -> bool:
    """The same for LF group `lf_group_idx`, padded by LF_GROUP_PAD."""
    header = frame.header
    left, top, w, h = region
    left -= header.x0 + LF_GROUP_PAD
    top -= header.y0 + LF_GROUP_PAD
    w += 2 * LF_GROUP_PAD
    h += 2 * LF_GROUP_PAD
    lgd = header.lf_group_dim
    lgpr = header.lf_groups_per_row
    gx, gy = lf_group_idx % lgpr, lf_group_idx // lgpr
    x0, y0 = gx * lgd, gy * lgd
    return not (
        x0 >= left + w or x0 + lgd <= left or y0 >= top + h or y0 + lgd <= top
    )
