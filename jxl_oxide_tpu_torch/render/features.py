"""Frame features: patches, splines, noise: parsing and rendering.

Behavioral parity: jxl-frame/src/data/{patch.rs,spline.rs,noise.rs}
(parsing) and jxl-render/src/features/{spline.rs,noise.rs} (rendering);
jxl_oxide_tpu/render/features.py. Patch blending is render/context.py.

Splines: the arc samples are serial host work, computed in numpy as the
JAX package computes them; each sample's contribution goes into one
float32 field on the host, which is uploaded once and added once to the
planes on their device.

Noise: the uniform field is the XorShift128+ walk of every group's 8
lanes. On the CPU it is ops/noise.py `noise_field_plain` (numpy, bit for
bit the JAX package's `_noise_field`); on a CUDA device it is K12
(csrc/noise.cu through ops/cuda/noise.py), one thread per (group,
lane). The 5x5 convolution, the LUT and the channel mixing are torch
ops on the planes' device, in the JAX package's order and types (the
LUT's interpolation and the mixing in float64, as numpy promotes them
there).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np
import torch

from ..coding.entropy import Decoder
from ..io.bitstream import Bitstream, unpack_signed
from ..ops.upsample import symmetric_pad2
from ..utils.errors import JxlValidationError
from ..utils.trace import span

__all__ = ["NoiseParameters", "PatchBlendMode", "PatchBlending",
           "PatchTarget", "PatchRefData", "Patches", "QuantSpline", "Splines",
           "noise_field", "render_noise", "render_spline", "spline_field"]


class PatchBlendMode(enum.Enum):
    NONE = 0
    REPLACE = 1
    ADD = 2
    MUL = 3
    BLEND_ABOVE = 4
    BLEND_BELOW = 5
    MUL_ADD_ABOVE = 6
    MUL_ADD_BELOW = 7

    @property
    def use_alpha(self) -> bool:
        return self.value >= 4


@dataclass
class PatchBlending:
    mode: PatchBlendMode
    alpha_channel: int
    clamp: bool


@dataclass
class PatchTarget:
    x: int
    y: int
    blending: list  # per (color + each EC) channel


@dataclass
class PatchRefData:
    ref_idx: int
    x0: int
    y0: int
    width: int
    height: int
    patch_targets: list


class Patches:
    """Entropy-coded patch list (jxl-frame data/patch.rs)."""

    def __init__(self, patches):
        self.patches: list[PatchRefData] = patches

    @classmethod
    def parse(cls, bs: Bitstream, image_header, frame_header) -> "Patches":
        from ..headers.image import ExtraChannelType

        meta = image_header.metadata
        num_extra = len(meta.ec_info)
        alpha_indices = [
            i for i, info in enumerate(meta.ec_info)
            if info.ty == ExtraChannelType.ALPHA
        ]
        decoder = Decoder(bs, 10)
        decoder.begin(bs)

        max_refs = min(1 << 24, frame_header.width * frame_header.height // 16)
        num_patch_refs = decoder.read_varint(bs, 0)
        if num_patch_refs > max_refs:
            raise JxlValidationError("too many patches")
        max_patches = max_refs * 4

        total = 0
        patches = []
        for _ in range(num_patch_refs):
            ref_idx = decoder.read_varint(bs, 1)
            if ref_idx >= 4:
                raise JxlValidationError("PatchRef index out of bounds")
            x0 = decoder.read_varint(bs, 3)
            y0 = decoder.read_varint(bs, 3)
            width = decoder.read_varint(bs, 2) + 1
            height = decoder.read_varint(bs, 2) + 1
            count = decoder.read_varint(bs, 7) + 1
            total += count
            if total > max_patches:
                raise JxlValidationError("too many patches")
            targets = []
            prev_xy = None
            for _ in range(count):
                if prev_xy is None:
                    x = decoder.read_varint(bs, 4)
                    y = decoder.read_varint(bs, 4)
                else:
                    x = prev_xy[0] + unpack_signed(decoder.read_varint(bs, 6))
                    y = prev_xy[1] + unpack_signed(decoder.read_varint(bs, 6))
                if abs(x) > (1 << 31) or abs(y) > (1 << 31):
                    raise JxlValidationError("patch coord overflow")
                prev_xy = (x, y)
                blending = []
                for _ in range(num_extra + 1):
                    raw_mode = decoder.read_varint(bs, 5)
                    if raw_mode > 7:
                        raise JxlValidationError("invalid patch blend mode")
                    mode = PatchBlendMode(raw_mode)
                    if raw_mode >= 4 and len(alpha_indices) >= 2:
                        alpha_channel = decoder.read_varint(bs, 8)
                    else:
                        alpha_channel = (alpha_indices[0] if alpha_indices
                                         else 0)
                    clamp = (
                        decoder.read_varint(bs, 9) != 0 if raw_mode >= 3
                        else False
                    )
                    blending.append(PatchBlending(mode, alpha_channel, clamp))
                targets.append(PatchTarget(x, y, blending))
            patches.append(
                PatchRefData(ref_idx, x0, y0, width, height, targets)
            )
        decoder.finalize()
        return cls(patches)


@dataclass
class QuantSpline:
    quant_points: list
    xyb_dct: np.ndarray  # [3, 32] int
    sigma_dct: np.ndarray  # [32] int
    manhattan_distance: int = 0


class Splines:
    """Quantized centripetal Catmull-Rom splines (data/spline.rs)."""

    def __init__(self, quant_splines, quant_adjust):
        self.quant_splines: list[QuantSpline] = quant_splines
        self.quant_adjust = quant_adjust

    @classmethod
    def parse(cls, bs: Bitstream, frame_header) -> "Splines":
        decoder = Decoder(bs, 6)
        decoder.begin(bs)
        num_pixels = frame_header.width * frame_header.height
        num_splines = decoder.read_varint(bs, 2)
        if num_splines >= min(1 << 24, num_pixels // 4):
            raise JxlValidationError("too many splines")
        num_splines += 1

        start_points = []
        px = decoder.read_varint(bs, 1)
        py = decoder.read_varint(bs, 1)
        start_points.append((px, py))
        for _ in range(num_splines - 1):
            px += unpack_signed(decoder.read_varint(bs, 1))
            py += unpack_signed(decoder.read_varint(bs, 1))
            start_points.append((px, py))

        quant_adjust = unpack_signed(decoder.read_varint(bs, 0))

        splines = []
        acc_points = 0
        max_points = min(1 << 20, num_pixels // 2)
        for start in start_points:
            num_points = decoder.read_varint(bs, 3)
            acc_points += num_points
            if acc_points > max_points:
                raise JxlValidationError("too many spline points")
            points = [start]
            cur = list(start)
            delta = [0, 0]
            manhattan = 0
            for _ in range(num_points):
                delta[0] += unpack_signed(decoder.read_varint(bs, 4))
                delta[1] += unpack_signed(decoder.read_varint(bs, 4))
                manhattan += abs(delta[0]) + abs(delta[1])
                prev = tuple(cur)
                cur[0] += delta[0]
                cur[1] += delta[1]
                if tuple(cur) == prev:
                    raise JxlValidationError(
                        "duplicate consecutive control points")
                points.append(tuple(cur))
            xyb_dct = np.array([
                [unpack_signed(decoder.read_varint(bs, 5)) for _ in range(32)]
                for _ in range(3)
            ])
            sigma_dct = np.array(
                [unpack_signed(decoder.read_varint(bs, 5)) for _ in range(32)]
            )
            splines.append(QuantSpline(points, xyb_dct, sigma_dct, manhattan))
        decoder.finalize()
        return cls(splines, quant_adjust)

    def estimate_area(self, base_correlation_xb=None) -> int:
        """Upper-bound estimate of spline rasterization work
        (jxl-frame/src/data/spline.rs:71-103); checked against the
        level-10 conformance limit before any rendering happens."""
        kx, kb = base_correlation_xb if base_correlation_xb else (0.0, 1.0)
        corr_x = int(np.ceil(abs(kx)))
        corr_b = int(np.ceil(abs(kb)))
        qa = int(self.quant_adjust)

        def div_ceil_qa(dividend: int) -> int:
            if qa >= 0:
                return (8 * dividend + 7 + qa) // (8 + qa)
            return dividend + -(-(dividend * -qa) // 8)

        total_area = 0
        for qs in self.quant_splines:
            color_xyb = [
                sum(div_ceil_qa(abs(int(q))) for q in qs.xyb_dct[c])
                for c in range(3)
            ]
            color_xyb[0] += corr_x * color_xyb[1]
            color_xyb[2] += corr_b * color_xyb[1]
            log_color = max(1 + max(color_xyb), 1).bit_length() - 1
            if (1 << log_color) < 1 + max(color_xyb):  # log2_ceil
                log_color += 1
            width_estimate = 0
            for q in qs.sigma_dct:
                weight = 1 + div_ceil_qa(abs(int(q)))
                width_estimate += weight * weight * log_color
            total_area += width_estimate * qs.manhattan_distance
        return total_area


class NoiseParameters:
    """The noise LUT: 8 values of 10 bits (data/noise.rs)."""

    lut: tuple

    @classmethod
    def parse(cls, bs: Bitstream) -> "NoiseParameters":
        p = cls()
        p.lut = tuple(bs.read_bits(10) / (1 << 10) for _ in range(8))
        return p


# ---------------------------------------------------------------------------
# Spline rendering (jxl-render features/spline.rs)

_SPLINE_CHANNEL_WEIGHTS = (0.0042, 0.075, 0.07, 0.3333)


def _idct_cos(t) -> np.ndarray:
    """cos((t + 0.5) i pi / 32) for i = 1..31: the basis of
    _continuous_idct at t, shared by the four curves of one sample."""
    i = np.arange(1, 32)
    return np.cos(np.multiply.outer(np.asarray(t) + 0.5, i * (np.pi / 32.0)))


def _continuous_idct(dct: np.ndarray, cos_t: np.ndarray) -> np.ndarray:
    """The JAX package's _continuous_idct(dct, t), given _idct_cos(t)."""
    return dct[0] + np.sqrt(2.0) * (cos_t @ dct[1:])


def _erf(x: np.ndarray) -> np.ndarray:
    ax = np.abs(x)
    d1 = ax * 7.77394369e-02 + 2.05260015e-04
    d2 = d1 * ax + 2.32120216e-01
    d3 = d2 * ax + 2.77820801e-01
    d4 = d3 * ax + 1.0
    d5 = d4 * d4
    inv = 1.0 / d5
    res = 1.0 - inv * inv
    return np.where(x < 0, -res, res)


def _upsample_spline_points(points: list) -> np.ndarray:
    s = np.asarray(points, dtype=np.float32)
    if len(s) == 1:
        return s
    first = 2 * s[0] - s[1]
    last = 2 * s[-1] - s[-2]
    ext = np.concatenate([[first], s, [last]])
    out = []
    for i in range(len(ext) - 3):
        p = ext[i : i + 4]
        out.append(p[1])
        t = np.zeros(4)
        for k in range(1, 4):
            t[k] = t[k - 1] + (np.sum((p[k] - p[k - 1]) ** 2)) ** 0.25
        for step in range(1, 16):
            knot = t[1] + (step / 16.0) * (t[2] - t[1])
            a = [
                p[k] + (p[k + 1] - p[k]) * ((knot - t[k]) / (t[k + 1] - t[k]))
                for k in range(3)
            ]
            b = [
                a[k] + (a[k + 1] - a[k]) * ((knot - t[k]) / (t[k + 2] - t[k]))
                for k in range(2)
            ]
            out.append(b[0] + (b[1] - b[0]) * ((knot - t[1]) / (t[2] - t[1])))
    out.append(s[-1])
    return np.asarray(out, dtype=np.float32)


def _arc_samples(points: list):
    ups = _upsample_spline_points(points)
    samples = [(ups[0], 1.0)]
    current = ups[0]
    next_idx = 0
    while next_idx < len(ups):
        prev = current
        arclength = 0.0
        while True:
            if next_idx >= len(ups):
                samples.append((prev, arclength))
                break
            nxt = ups[next_idx]
            d = float(np.hypot(*(nxt - prev)))
            if arclength + d >= 1.0:
                current = prev + (nxt - prev) * ((1.0 - arclength) / d)
                samples.append((current, 1.0))
                break
            arclength += d
            prev = nxt
            next_idx += 1
    return samples


def spline_field(splines: Splines, base_correlations_xb, width: int,
                 height: int, ph: int, pw: int) -> np.ndarray:
    """[3, ph, pw] float32 on the host: every arc sample's
    0.25 * value * sigma * f^2 of every spline, summed in sample order.
    Loop bounds are in full-resolution frame coordinates (width x height,
    spline.rs:209-218), writes clipped to the ph x pw plane (try_get_mut
    -> break): with upsampling > 1 only the plane's top-left region is
    hit, as in the JAX package's render_spline. The arithmetic is the
    JAX package's, sample by sample and element by element."""
    field_arr = np.zeros((3, ph, pw), dtype=np.float32)
    corr = base_correlations_xb if base_correlations_xb else (0.0, 1.0)
    qa = float(splines.quant_adjust)
    inv_qa = 1.0 / (1.0 + qa / 8.0) if qa >= 0 else 1.0 - qa / 8.0

    for qs in splines.quant_splines:
        xyb_dct = np.zeros((3, 32))
        for c in range(3):
            xyb_dct[c] = qs.xyb_dct[c] * _SPLINE_CHANNEL_WEIGHTS[c] * inv_qa
        xyb_dct[0] += corr[0] * xyb_dct[1]
        xyb_dct[2] += corr[1] * xyb_dct[1]
        sigma_dct = qs.sigma_dct * _SPLINE_CHANNEL_WEIGHTS[3] * inv_qa

        samples = _arc_samples(qs.quant_points)
        arclength = len(samples) - 2.0 + samples[-1][1]
        for i, (pt, length) in enumerate(samples):
            t = 31.0 * min(1.0, i / arclength if arclength > 0 else 1.0)
            cos_t = _idct_cos(t)
            sigma = float(_continuous_idct(sigma_dct, cos_t))
            if sigma == 0.0:
                continue
            inv_sigma = 1.0 / sigma
            values = [
                float(_continuous_idct(xyb_dct[c], cos_t)) * length
                for c in range(3)
            ]
            max_color = max(0.01, max(values))
            max_distance = (np.sqrt(2.0 * (np.log(10.0) * 3.0 + max_color))
                            * abs(sigma))
            xb = max(0, int(np.floor(pt[0] - max_distance + 0.5)))
            xe = min(width, pw, int(np.floor(pt[0] + max_distance + 1.5)))
            yb = max(0, int(np.floor(pt[1] - max_distance + 0.5)))
            ye = min(height, ph, int(np.floor(pt[1] + max_distance + 1.5)))
            if xe <= xb or ye <= yb:
                continue
            ys, xs = np.mgrid[yb:ye, xb:xe]
            dist = np.hypot(xs - pt[0], ys - pt[1])
            sqrt_0125 = 0.35355338
            factor = _erf((0.5 * dist + sqrt_0125) * inv_sigma) - _erf(
                (0.5 * dist - sqrt_0125) * inv_sigma
            )
            f2 = factor * factor
            for c in range(3):
                field_arr[c, yb:ye, xb:xe] += (
                    0.25 * values[c] * sigma * f2
                ).astype(np.float32)
    return field_arr


def render_spline(planes: list, splines: Splines, base_correlations_xb,
                  width: int, height: int) -> None:
    """Draw all splines onto the 3 colour planes in place: the host field
    (`spline_field`) goes up in one copy and is added once on the planes'
    device."""
    ph, pw = planes[0].shape
    with span("Splines"):
        field_arr = torch.from_numpy(spline_field(
            splines, base_correlations_xb, width, height, ph, pw)).to(
                planes[0].device)
        for c in range(3):
            planes[c] += field_arr[c]


# ---------------------------------------------------------------------------
# Noise synthesis (jxl-render features/noise.rs)

def noise_field(header, visible: int, invisible: int,
                device) -> torch.Tensor:
    """The frame's [3, H, W] float32 noise field (full-resolution frame
    size) on `device`: K12 on a CUDA device (ops/cuda/noise.py, which
    raises rather than fall back), the plain numpy version on the CPU."""
    from ..ops.cuda.noise import noise_field_cuda
    from ..ops.noise import noise_seed0

    return noise_field_cuda(header.width, header.height, header.group_dim,
                            noise_seed0(visible, invisible), device)


def _interp_lut(lut9: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The LUT at v (float32 >= 0 or NaN), in float64 as numpy promotes
    the JAX package's _interp_lut. Rust's float->usize cast saturates
    (noise.rs:70-72): NaN becomes 0 and +inf 1e9 first, then the index is
    min(v, 7) truncated; a float-to-int cast of an out-of-range value is
    undefined on CUDA, so the clamp comes before it. frac stays
    unclamped above 7, as in the reference."""
    v = torch.nan_to_num(v, nan=0.0, posinf=float(np.float32(1e9)),
                         neginf=0.0)
    vi = torch.clamp(v, max=7.0).to(torch.int32).long()
    frac = v.double() - vi.double()
    lo = lut9[vi]
    return (lut9[vi + 1] - lo).double() * frac + lo.double()


def render_noise(planes: list, header, visible: int, invisible: int,
                 base_correlations_xb, lut) -> None:
    """Synthesize and add noise to the 3 colour planes in place
    (features/noise.rs:12-86): the field's 5x5 box sum over symmetric
    padding, * 0.16 - 4 * centre, then the LUT-scaled mix of the
    channels. The field is full-resolution; sample-resolution planes
    (upsampling > 1) read its top-left region (noise.rs:25-33, :60-63)."""
    corr_x, corr_b = (float(v) for v in (base_correlations_xb
                                         or (0.0, 1.0)))
    device = planes[0].device
    with span("Noise"):
        field_arr = noise_field(header, visible, invisible, device)
        padded = symmetric_pad2(field_arr)
        h, w = field_arr.shape[1:]
        acc = torch.zeros_like(field_arr)
        for dy in range(5):
            for dx in range(5):
                acc += padded[:, dy:dy + h, dx:dx + w]
        noise = acc * 0.16 - field_arr * 4.0

        lut9 = torch.tensor(list(lut) + [lut[7]], dtype=torch.float32,
                            device=device)
        ph, pw = planes[0].shape
        if tuple(noise.shape[1:]) != (ph, pw):
            noise = noise[:, :ph, :pw]
        gx, gy = planes[0], planes[1]
        in_x = gx + gy
        in_y = gy - gx
        zero = torch.zeros((), dtype=torch.float32, device=device)
        sx = _interp_lut(lut9, torch.maximum(zero, in_x * 3.0))
        sy = _interp_lut(lut9, torch.maximum(zero, in_y * 3.0))
        nx = 0.22 * sx * (0.0078125 * noise[0] + 0.9921875 * noise[2])
        ny = 0.22 * sy * (0.0078125 * noise[1] + 0.9921875 * noise[2])
        nxy = nx + ny
        planes[0] += (corr_x * nxy + nx - ny).to(torch.float32)
        planes[1] += nxy.to(torch.float32)
        planes[2] += (corr_b * nxy).to(torch.float32)
