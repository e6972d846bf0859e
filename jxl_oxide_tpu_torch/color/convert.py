"""Color transform builder: op list between colour encodings.

Behavioral parity: jxl-color/src/convert.rs (ColorTransform::new op-list
construction) and ciexyz.rs (primaries/white-point matrices, Bradford
adaptation). The builder is a copy of jxl_oxide_tpu/color/convert.py
(host-side, tiny 3x3 float math in float64 numpy); the ops execute in
torch on the planes' device (ops/color.py), every op kind of the JAX
package's `_apply_ops`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..headers.image import (
    ColourEncoding,
    ColourSpace,
    OpsinInverseMatrix,
    Primaries,
    RenderingIntent,
    ToneMapping,
    TransferFunction,
    WhitePoint,
)
from ..utils.errors import JxlNotSupportedError

__all__ = ["ColorTransform", "illuminant_of", "primaries_of",
           "primaries_to_xyz_mat", "xyz_to_primaries_mat", "adapt_mat"]

ILLUMINANT_D65 = (0.3127, 0.3290)
ILLUMINANT_E = (1.0 / 3.0, 1.0 / 3.0)
ILLUMINANT_DCI = (0.314, 0.351)
PRIMARIES_SRGB = ((0.639998686, 0.330010138), (0.300003784, 0.600003357),
                  (0.150002046, 0.059997204))
PRIMARIES_BT2100 = ((0.708, 0.292), (0.170, 0.797), (0.131, 0.046))
PRIMARIES_P3 = ((0.680, 0.320), (0.265, 0.690), (0.150, 0.060))

_MAT_BRADFORD = np.array([
    [0.8951, 0.2664, -0.1614],
    [-0.7502, 1.7135, 0.0367],
    [0.0389, -0.0685, 1.0296],
])
_MAT_BRADFORD_INV = np.array([
    [0.9869929, -0.1470543, 0.1599627],
    [0.4323053, 0.5183603, 0.0492912],
    [-0.0085287, 0.0400428, 0.9684867],
])


def illuminant_of(wp: WhitePoint) -> tuple[float, float]:
    if wp.kind == "d65":
        return ILLUMINANT_D65
    if wp.kind == "e":
        return ILLUMINANT_E
    if wp.kind == "dci":
        return ILLUMINANT_DCI
    return wp.custom.as_float()


def primaries_of(p: Primaries):
    if p.kind == "srgb":
        return PRIMARIES_SRGB
    if p.kind == "bt2100":
        return PRIMARIES_BT2100
    if p.kind == "p3":
        return PRIMARIES_P3
    return (p.red.as_float(), p.green.as_float(), p.blue.as_float())


def _illuminant_to_xyz(xy) -> np.ndarray:
    x, y = xy
    return np.array([x / y, 1.0, (1.0 - x) / y - 1.0])


def adapt_mat(from_xy, to_xy) -> np.ndarray:
    """Bradford chromatic adaptation (ciexyz.rs:113-133)."""
    fw = _illuminant_to_xyz(from_xy)
    tw = _illuminant_to_xyz(to_xy)
    if np.allclose(fw, tw):
        return np.eye(3)
    f_lms = _MAT_BRADFORD @ fw
    t_lms = _MAT_BRADFORD @ tw
    scale = np.diag(t_lms / f_lms)
    return _MAT_BRADFORD_INV @ scale @ _MAT_BRADFORD


def primaries_to_xyz_mat(primaries, wp) -> np.ndarray:
    """RGB(primaries) -> XYZ matrix (ciexyz.rs:135-160)."""
    p = np.array(primaries)
    m = np.array([
        [p[0][0], p[1][0], p[2][0]],
        [p[0][1], p[1][1], p[2][1]],
        [1 - p[0][0] - p[0][1], 1 - p[1][0] - p[1][1], 1 - p[2][0] - p[2][1]],
    ])
    w_xyz = _illuminant_to_xyz(wp)
    mul = np.linalg.solve(m, w_xyz)
    return m * mul[None, :]


def xyz_to_primaries_mat(primaries, wp) -> np.ndarray:
    return np.linalg.inv(primaries_to_xyz_mat(primaries, wp))


def luminances_of(primaries, wp) -> tuple[float, float, float]:
    mat = primaries_to_xyz_mat(primaries, wp)
    return tuple(float(v) for v in mat[1])


@dataclass
class _Op:
    kind: str
    data: dict


class ColorTransform:
    """Op list from a source encoding to a target enum encoding.

    Supported sources: XYB, RGB enum, Grey enum. ICC endpoints need an
    external CMS (color/cms.py) and are handled by the caller (api.py
    `_final_color`).
    """

    def __init__(self, ops: list[_Op], begin_channels: int):
        self.ops = ops
        self.begin_channels = begin_channels

    @classmethod
    def build(
        cls,
        source: ColourEncoding,
        target: ColourEncoding,
        oim: OpsinInverseMatrix,
        tone_mapping: ToneMapping | None = None,
    ) -> "ColorTransform":
        intensity_target = (
            tone_mapping.intensity_target if tone_mapping is not None else 255.0
        )
        min_nits = tone_mapping.min_nits if tone_mapping is not None else 0.0
        ops: list[_Op] = []
        begin_channels = 1 if source.colour_space == ColourSpace.GREY else 3

        # identical endpoints: a true no-op — the naive build would pair
        # tf_inv with tf_fwd, burning a pow chain per pixel and losing
        # a ULP on every same-encoding decode (convert.rs short-circuits
        # equal encodings the same way)
        if (
            source.colour_space == target.colour_space
            and source.white_point == target.white_point
            and (source.colour_space == ColourSpace.GREY
                 or source.primaries == target.primaries)
            and source.tf == target.tf
            and source.rendering_intent == target.rendering_intent
        ):
            return cls([], begin_channels)

        # --- source -> linear, tracking current encoding ---
        if source.colour_space == ColourSpace.XYB:
            ops.append(_Op("xyb_to_lms", {
                "opsin_bias": oim.opsin_bias,
                "intensity_target": intensity_target,
            }))
            ops.append(_Op("matrix", {"mat": np.array(oim.inv_mat)}))
            cur_space = ColourSpace.RGB
            cur_wp = WhitePoint.D65
            cur_primaries = Primaries.SRGB
            cur_tf = TransferFunction.LINEAR
            cur_intent = source.rendering_intent
        elif source.colour_space in (ColourSpace.RGB, ColourSpace.GREY):
            prim = (
                primaries_of(source.primaries)
                if source.colour_space == ColourSpace.RGB
                else PRIMARIES_SRGB
            )
            lum = luminances_of(prim, illuminant_of(source.white_point))
            ops.append(_Op("tf_inv", {
                "tf": source.tf,
                "intensity_target": intensity_target,
                "luminances": lum,
                "min_nits": min_nits,
            }))
            cur_space = source.colour_space
            cur_wp = source.white_point
            cur_primaries = source.primaries
            cur_tf = TransferFunction.LINEAR
            cur_intent = source.rendering_intent
        else:
            raise JxlNotSupportedError(
                f"unsupported source colour space {source.colour_space}"
            )

        # --- gamut/space conversion ---
        space_change = (
            cur_space != target.colour_space
            or illuminant_of(cur_wp) != illuminant_of(target.white_point)
            or (
                cur_space == ColourSpace.RGB
                and primaries_of(cur_primaries) != primaries_of(target.primaries)
            )
        )
        if space_change:
            if cur_space == ColourSpace.GREY:
                ops.append(_Op("clip", {}))
            elif cur_intent == RenderingIntent.PERCEPTUAL:
                lum = luminances_of(
                    primaries_of(cur_primaries)
                    if cur_space == ColourSpace.RGB
                    else PRIMARIES_SRGB,
                    illuminant_of(cur_wp),
                )
                ops.append(_Op("gamut_map", {
                    "luminances": lum, "saturation_factor": 0.3,
                }))
            else:
                ops.append(_Op("clip", {}))

            if cur_space == ColourSpace.RGB:
                ops.append(_Op("matrix", {
                    "mat": primaries_to_xyz_mat(
                        primaries_of(cur_primaries), illuminant_of(cur_wp)
                    )
                }))
            elif cur_space == ColourSpace.GREY:
                ops.append(_Op("luma_to_xyz", {
                    "illuminant": illuminant_of(cur_wp),
                }))

            if cur_intent != RenderingIntent.ABSOLUTE:
                ops.append(_Op("matrix", {
                    "mat": adapt_mat(
                        illuminant_of(cur_wp), illuminant_of(target.white_point)
                    )
                }))

            if target.colour_space == ColourSpace.RGB:
                ops.append(_Op("matrix", {
                    "mat": xyz_to_primaries_mat(
                        primaries_of(target.primaries),
                        illuminant_of(target.white_point),
                    )
                }))
            elif target.colour_space == ColourSpace.GREY:
                ops.append(_Op("xyz_to_luma", {}))
            else:
                raise JxlNotSupportedError("unsupported target colour space")

        # --- HDR tone mapping (convert.rs:478-500): map to SDR when the
        # image is HDR-mastered and the target isn't an HDR tf ---
        target_is_hdr = target.tf.kind in ("pq", "hlg")
        if intensity_target > 255.0 and not target_is_hdr:
            lum = luminances_of(
                primaries_of(target.primaries),
                illuminant_of(target.white_point),
            )
            ops.append(_Op("tone_map", {
                "luminances": lum,
                "intensity_target": intensity_target,
                "min_nits": min_nits,
                "target_display_luminance": 255.0,
                "detect_peak": (
                    tone_mapping.relative_to_max_display
                    if tone_mapping is not None
                    else False
                ),
            }))
            if cur_intent == RenderingIntent.PERCEPTUAL:
                ops.append(_Op("gamut_map", {
                    "luminances": lum, "saturation_factor": 0.3,
                }))

        # --- PQ -> HLG: tone map to 1000-nit peak before the inverse OOTF
        # (convert.rs:501-534) ---
        from_pq = (
            source.colour_space != ColourSpace.XYB
            and source.tf.kind == "pq"
        )
        tf_intensity = intensity_target
        if from_pq and target.tf.kind == "hlg":
            lum = luminances_of(
                primaries_of(target.primaries),
                illuminant_of(target.white_point),
            )
            if not (999.0 <= intensity_target <= 1001.0):
                ops.append(_Op("tone_map", {
                    "luminances": lum,
                    "intensity_target": intensity_target,
                    "min_nits": min_nits,
                    "target_display_luminance": 1000.0,
                    "detect_peak": False,
                }))
                ops.append(_Op("hlg_inverse_oo", {
                    "luminances": lum, "intensity_target": 1000.0,
                }))
            if (
                cur_space != ColourSpace.GREY
                and cur_intent == RenderingIntent.PERCEPTUAL
            ):
                ops.append(_Op("gamut_map", {
                    "luminances": lum, "saturation_factor": 0.1,
                }))
            # intensity_target 300 makes the HLG forward tf's inverse OOTF a
            # no-op (gamma == 1), since the OOTF was applied above already
            tf_intensity = 300.0

        # --- linear -> target tf ---
        if target.tf.kind != "linear":
            lum = luminances_of(
                primaries_of(target.primaries),
                illuminant_of(target.white_point),
            )
            ops.append(_Op("tf_fwd", {
                "tf": target.tf,
                "intensity_target": tf_intensity,
                "luminances": lum,
                "min_nits": min_nits,
            }))

        return cls(ops, begin_channels)

    @property
    def is_noop(self) -> bool:
        return not self.ops

    def run(self, planes: list):
        """Apply the op list to planar float32 torch tensors; returns
        planes. Runs eagerly on the planes' device. Every op is pointwise,
        so a plane may be one image's [H, W] or a stack's [N, H, W]
        (serving.py runs one transform over a whole stack)."""
        return self._apply_ops([p.to(torch.float32) for p in planes])

    def _apply_ops(self, planes: list):
        from ..ops import color as C

        planes = list(planes)
        for op in self.ops:
            d = op.data
            if op.kind == "xyb_to_lms":
                x, y, b = planes[:3]
                planes[:3] = C.xyb_to_mixed_lms(
                    x, y, b, d["opsin_bias"], d["intensity_target"]
                )
            elif op.kind == "matrix":
                a, b, c = planes[:3]
                planes[:3] = C.apply_matrix3(a, b, c, d["mat"])
            elif op.kind == "luma_to_xyz":
                # one plane becomes three (the planes are colour only:
                # an alpha rides in Render.extra and is appended last)
                wx, wy = d["illuminant"]
                luma = planes[0]
                luma_div_y = luma / float(np.float32(wy))
                planes = [
                    float(np.float32(wx)) * luma_div_y,
                    luma,
                    float(np.float32(1.0 - wx - wy)) * luma_div_y,
                ]
            elif op.kind == "xyz_to_luma":
                planes = [planes[1]]
            elif op.kind == "clip":
                planes = [torch.clamp(p, 0.0, 1.0) for p in planes]
            elif op.kind == "gamut_map":
                r, g, b = planes[:3]
                planes[:3] = C.gamut_map(
                    r, g, b, d["luminances"], d["saturation_factor"]
                )
            elif op.kind == "tone_map":
                r, g, b = planes[:3]
                planes[:3] = C.tone_map_rec2408(
                    r, g, b, d["luminances"], d["intensity_target"],
                    d["min_nits"], d["target_display_luminance"],
                    d["detect_peak"],
                )
            elif op.kind == "hlg_inverse_oo":
                r, g, b = planes[:3]
                planes[:3] = C.hlg_inverse_oo(
                    r, g, b, d["luminances"], d["intensity_target"]
                )
            elif op.kind in ("tf_fwd", "tf_inv"):
                forward = op.kind == "tf_fwd"
                if d["tf"].kind == "hlg" and len(planes) >= 3:
                    # HLG couples channels through the OOTF (convert.rs
                    # apply_(inverse_)transfer_function, Hlg arm); one
                    # grey plane takes the per-plane curve below
                    r, g, b = planes[:3]
                    if forward:
                        r, g, b = C.hlg_inverse_oo(
                            r, g, b, d["luminances"], d["intensity_target"]
                        )
                        planes[:3] = [C.linear_to_hlg(p) for p in (r, g, b)]
                    else:
                        r, g, b = (C.hlg_to_linear(p) for p in (r, g, b))
                        planes[:3] = C.hlg_oo(
                            r, g, b, d["luminances"], d["intensity_target"]
                        )
                else:
                    planes = [
                        self._apply_tf(p, d, forward=forward) for p in planes
                    ]
            else:
                raise AssertionError(op.kind)
        return planes

    @staticmethod
    def _apply_tf(p, d, forward: bool):
        from ..ops import color as C

        tf: TransferFunction = d["tf"]
        it = d["intensity_target"]
        kind = tf.kind
        if kind == "srgb":
            return C.linear_to_srgb(p) if forward else C.srgb_to_linear(p)
        if kind == "bt709":
            return C.linear_to_bt709(p) if forward else C.bt709_to_linear(p)
        if kind == "linear" or kind == "unknown":
            return p
        if kind == "gamma":
            g = tf.gamma
            if forward:
                return C.apply_gamma(
                    p, g / 1e7 if tf.gamma_inverted else 1e7 / g)
            return C.apply_gamma(p, 1e7 / g if tf.gamma_inverted else g / 1e7)
        if kind == "pq":
            return C.linear_to_pq(p, it) if forward else C.pq_to_linear(p, it)
        if kind == "hlg":
            return C.linear_to_hlg(p) if forward else C.hlg_to_linear(p)
        if kind == "dci":
            # DCI: pure gamma 2.6
            return C.apply_gamma(p, 1.0 / 2.6 if forward else 2.6)
        raise JxlNotSupportedError(f"transfer function {kind}")
