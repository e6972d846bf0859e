"""Minimal JPEG XL VarDCT encoder — TEST INFRASTRUCTURE ONLY.

Produces spec-valid bare codestreams exercising the VarDCT decode path:
DCT8-only varblocks, default dequant matrices, single pass, no EPF/gaborish,
xyb_encoded=false (so decoded planes compare directly against the source
RGB). Accounts for the decoder's LF/HF chroma-from-luma defaults (kb=1) and
quant bias so the round-trip error is pure quantization error.

Deliberately simple, shares BitWriter/AnsStreamEncoder with encoder.py.

The port's copy of tools/encoder_vardct.py, which imports the JAX
package: this one takes what it needs from jxl_oxide_tpu_torch's own
modules (OpsinInverseMatrix, jpeg_shifts, DequantMatrixSet,
TransformType, natural_order and the DCT parameter tables, dct2d) and is
numpy only: the XYB leg's sRGB -> linear is `_srgb_to_linear`, in
float32 numpy. Arguments, asserts and scope are those of
tools/encoder_vardct.py.
"""

from __future__ import annotations

import numpy as np

from ..headers.image import OpsinInverseMatrix
from ..models.vardct import (
    DequantMatrixSet,
    TransformType,
    jpeg_shifts,
    natural_order,
)
from ..ops.dct import dct2d
from .encoder import (
    DEFAULT_CFG,
    AnsStreamEncoder,
    BitWriter,
    IntegerConfig,
    _pack_signed,
    _write_bit_depth,
    _write_size_u32,
    encode_stream_tokens,
    tokenize_uint,
    write_ma_config,
    write_modular_header,
)


def _srgb_to_linear(v: np.ndarray) -> np.ndarray:
    """The sRGB transfer function's inverse on float32 samples, f(|v|)
    with v's sign (jxl_oxide_tpu/ops/color.py srgb_to_linear, there in
    jnp), in float32 numpy."""
    a = np.abs(v)
    small = a / np.float32(12.92)
    big = np.power((a + np.float32(0.055)) / np.float32(1.055),
                   np.float32(2.4))
    return np.sign(v) * np.where(a <= np.float32(0.04045), small, big)


def _write_u64(w: BitWriter, v: int):
    if v == 0:
        w.write(0, 2)
    elif v <= 16:
        w.write(1, 2)
        w.write(v - 1, 4)
    elif v <= 272:
        w.write(2, 2)
        w.write(v - 17, 8)
    else:
        raise NotImplementedError


def _encode_local_modular(w: BitWriter, channels: list[np.ndarray]):
    """Modular sub-image with a local single-leaf zero-predictor tree."""
    write_modular_header(w, use_global_tree=False)
    enc = write_ma_config(w, 0)  # predictor 0 = Zero
    values = []
    for arr in channels:
        for v in arr.astype(np.int64).reshape(-1):
            values.append(_pack_signed(int(v)))
    enc.encode_tokens(w, values)



class _PresetAnsEncoder:
    """HF token encoder with one cluster PER PRESET (shared flat-256
    histogram, distinct hybrid-uint configs), cluster map keyed by
    ctx // ctx_per_preset."""

    def __init__(self, ctx_per_preset: int, n_presets: int):
        assert 2 <= n_presets <= 4
        self.ctx_per_preset = ctx_per_preset
        self.n_presets = n_presets
        self.cfgs = [
            IntegerConfig(split_exponent=4, msb_in_token=2, lsb_in_token=2),
            IntegerConfig(split_exponent=8, msb_in_token=0, lsb_in_token=0),
            IntegerConfig(split_exponent=6, msb_in_token=1, lsb_in_token=1),
            IntegerConfig(split_exponent=5, msb_in_token=2, lsb_in_token=1),
        ][:n_presets]
        # one AnsStreamEncoder per cfg; all share the same flat histogram
        self.encs = [AnsStreamEncoder(1, 256, 8, c) for c in self.cfgs]

    def write_header(self, w: BitWriter):
        e0 = self.encs[0]
        w.write_bool(False)  # lz77 disabled
        nbits = max(self.n_presets - 1, 0).bit_length()
        w.write_bool(True)   # simple cluster map
        w.write(nbits, 2)
        total = self.ctx_per_preset * self.n_presets
        for ctx in range(total):
            w.write(ctx // self.ctx_per_preset, nbits)
        w.write_bool(False)  # ANS
        w.write(8 - 5, 2)
        for enc in self.encs:
            enc._write_integer_config(w)
        for enc in self.encs:
            enc._write_histogram(w)

    def encode_tokens(self, w: BitWriter, values: list, preset: int = 0):
        enc = self.encs[preset]
        toks = [tokenize_uint(v, enc.cfg) for v in values]
        enc.encode_raw_tokens(w, toks)


def encode_jxl_vardct(
    rgb: np.ndarray,
    global_scale: int = 512,
    quant_lf: int = 16,
    gabor: bool = False,
    epf_iters: int = 0,
    use_lf_frame: bool = False,
    lf_levels: int = 1,
    num_passes: int = 1,
    pass_shifts: list | None = None,
    pass_downsample: list | None = None,
    dct8_params: list | None = None,
    xyb: bool = False,
    x_qm_scale: int = 3,
    b_qm_scale: int = 2,
    num_hf_presets: int = 1,
    gabor_weights: list | None = None,
    epf_sharp_lut: list | None = None,
    epf_sigma: tuple | None = None,
    epf_channel_scale: tuple | None = None,
    orientation: int = 1,
    alpha: np.ndarray | None = None,
) -> bytes:
    """Encode an RGB float image (values in [0,1], shape [h, w, 3]) as a
    VarDCT bare codestream (DCT8 blocks only). With use_lf_frame, a
    LF (DC) frame at 1/8 scale is emitted first and the main frame
    references it (flags.use_lf_frame)."""
    h, w, _ = rgb.shape
    out = BitWriter()
    _write_image_header(out, h, w, xyb=xyb, orientation=orientation,
                        extra_alpha=alpha is not None)
    if xyb:
        # forward XYB (inverse of xyb.rs:34-60 + opsin inverse matrix)
        oim = OpsinInverseMatrix()
        inv = np.array(oim.inv_mat, dtype=np.float64).reshape(3, 3)
        fwd = np.linalg.inv(inv)
        ob = np.asarray(oim.opsin_bias, dtype=np.float64)
        cbrt_ob = np.cbrt(ob)
        lin = _srgb_to_linear(rgb.astype(np.float32)).astype(np.float64)
        mix = np.einsum("ij,hwj->hwi", fwd, lin)
        # out_c = (g_c^3 + ob_c) (itscale = 1) => g_c = cbrt(out_c - ob_c)
        g = np.cbrt(mix - ob[None, None, :])
        y_p = 0.5 * (g[..., 0] + g[..., 1]) + 0.5 * (cbrt_ob[0] + cbrt_ob[1])
        x_p = 0.5 * (g[..., 0] - g[..., 1]) + 0.5 * (cbrt_ob[0] - cbrt_ob[1])
        b_p = g[..., 2] + cbrt_ob[2]
        rgb = np.stack([x_p, y_p, b_p], axis=-1).astype(np.float32)
    if use_lf_frame:
        def down8(img):
            ih, iw, _ = img.shape
            b_h, b_w = -(-ih // 8), -(-iw // 8)
            p = np.zeros((b_h * 8, b_w * 8, 3), dtype=np.float32)
            p[:ih, :iw] = img
            p[ih:, :iw] = img[ih - 1 : ih, :]
            p[:ih, iw:] = p[:ih, iw - 1 : iw]
            p[ih:, iw:] = p[ih - 1, iw - 1]
            return p.reshape(b_h, 8, b_w, 8, 3).mean(axis=(1, 3))

        # chain: deepest LF level first (lf_levels=2 -> level-2 LF frame,
        # then level-1 LF frame that itself uses it, then the main frame)
        downs = [rgb]
        for _ in range(lf_levels):
            downs.append(down8(downs[-1]))
        for level in range(lf_levels, 0, -1):
            kind = "lf" if level == lf_levels else "lf_use_lf"
            _write_frame(out, downs[level], global_scale, quant_lf, False, 0,
                         frame_kind=kind, lf_level=level, xyb=xyb,
                         x_qm_scale=x_qm_scale, b_qm_scale=b_qm_scale)
        _write_frame(out, rgb, global_scale, quant_lf, gabor, epf_iters,
                     frame_kind="use_lf", xyb=xyb,
                     x_qm_scale=x_qm_scale, b_qm_scale=b_qm_scale)
    else:
        _write_frame(out, rgb, global_scale, quant_lf, gabor, epf_iters,
                     frame_kind="regular", num_passes=num_passes,
                     pass_shifts=pass_shifts, pass_downsample=pass_downsample,
                     alpha=alpha,
                     dct8_params=dct8_params, xyb=xyb,
                     x_qm_scale=x_qm_scale, b_qm_scale=b_qm_scale,
                     num_hf_presets=num_hf_presets,
                     gabor_weights=gabor_weights,
                     epf_sharp_lut=epf_sharp_lut, epf_sigma=epf_sigma,
                     epf_channel_scale=epf_channel_scale)
    return out.to_bytes()


def _write_image_header(out: BitWriter, h: int, w: int,
                        xyb: bool = False, orientation: int = 1,
                        extra_alpha: bool = False) -> None:
    out.write(0x0AFF, 16)
    out.write_bool(False)
    _write_size_u32(out, h)
    out.write(0, 3)
    _write_size_u32(out, w)
    out.write_bool(False)  # not all_default metadata
    if orientation != 1:
        out.write_bool(True)   # extra_fields
        out.write(orientation - 1, 3)
        out.write_bool(False)  # no intrinsic size
        out.write_bool(False)  # no preview
        out.write_bool(False)  # no animation
    else:
        out.write_bool(False)  # no extra_fields
    _write_bit_depth(out, 8)
    out.write_bool(True)  # modular_16bit_buffers
    if extra_alpha:
        out.write(1, 2)       # num_extra = 1
        out.write_bool(True)  # d_alpha default ExtraChannelInfo
    else:
        out.write_u32_sel(0, 0, 0)  # num_extra = 0
    out.write_bool(xyb)  # xyb_encoded
    out.write_bool(True)  # colour_encoding all_default (sRGB)
    if orientation != 1:
        out.write_bool(True)  # tone_mapping all_default (extra_fields)
    out.write_u64_zero()  # extensions
    out.write_bool(True)  # default_m
    out.zero_pad_to_byte()


def _write_passes(out: BitWriter, num_passes: int,
                  pass_shifts: list | None,
                  pass_downsample: list | None) -> None:
    """Passes header (jxl-frame header.rs Passes): num_passes
    U32(1,2,3,4+u(3)), num_ds U32(0,1,2,3+u(1)), per-pass shift u(2)
    (all but last), downsample U32(1,2,4,8) + last_pass U32(0,1,2,u(3))
    per ds entry."""
    if num_passes == 1:
        out.write_u32_sel(0, 0, 0)
        return
    if num_passes == 2:
        out.write(1, 2)
    elif num_passes == 3:
        out.write(2, 2)
    else:
        out.write(3, 2)
        out.write(num_passes - 4, 3)
    ds = pass_downsample or []
    if len(ds) == 0:
        out.write(0, 2)
    elif len(ds) == 1:
        out.write(1, 2)
    elif len(ds) == 2:
        out.write(2, 2)
    else:
        out.write(3, 2)
        out.write(len(ds) - 3, 1)
    assert len(pass_shifts) == num_passes - 1
    for s in pass_shifts:
        out.write(s, 2)
    for d, _lp in ds:
        out.write({1: 0, 2: 1, 4: 2, 8: 3}[d], 2)
    for _d, lp in ds:
        if lp == 0:
            out.write(0, 2)
        elif lp == 1:
            out.write(1, 2)
        elif lp == 2:
            out.write(2, 2)
        else:
            out.write(3, 2)
            out.write(lp, 3)


def _split_passes(q: np.ndarray, num_passes: int,
                  pass_shifts: list | None) -> list:
    """Split quantized coefficients across passes so that
    sum_p (q_p << coeff_shift(p)) == q exactly (the decoder's additive
    accumulation, hf_coeff.rs:228-236). Arithmetic >> floors negatives;
    the remainder per stage stays in [0, 2^shift)."""
    if num_passes == 1:
        return [q]
    out = []
    rem = q
    for s in pass_shifts:
        qp = rem >> s
        out.append(qp)
        rem = rem - (qp << s)
    out.append(rem)
    return out


def _write_frame(
    out: BitWriter,
    rgb: np.ndarray,
    global_scale: int,
    quant_lf: int,
    gabor: bool,
    epf_iters: int,
    frame_kind: str,
    lf_level: int = 1,
    num_passes: int = 1,
    pass_shift: int = 2,
    pass_shifts: list | None = None,      # per-pass coeff shifts (len n-1)
    pass_downsample: list | None = None,  # [(downsample, last_pass), ...]
    dct8_params: list | None = None,
    xyb: bool = False,
    x_qm_scale: int = 3,
    b_qm_scale: int = 2,
    num_hf_presets: int = 1,
    gabor_weights: list | None = None,
    epf_sharp_lut: list | None = None,
    epf_sigma: tuple | None = None,   # (quant_mul, pass0, pass2, border)
    epf_channel_scale: tuple | None = None,
    alpha: np.ndarray | None = None,  # (h, w) int alpha EC samples
) -> None:
    h, w, _ = rgb.shape
    assert h <= 2048 and w <= 2048, "single-LF-group encoder"
    bh, bw = -(-h // 8), -(-w // 8)

    # pad to block multiple (edge-replicate)
    padded = np.zeros((bh * 8, bw * 8, 3), dtype=np.float32)
    padded[:h, :w] = rgb
    padded[h:, :w] = rgb[h - 1 : h, :]
    padded[:h, w:] = padded[:h, w - 1 : w]
    padded[h:, w:] = padded[h - 1, w - 1]

    if dct8_params is not None:
        from ..models.vardct import (
            _DCT_SELECT_LIST,
            _default_dct_params,
            _params_to_matrix,
        )

        mats = [
            _params_to_matrix(
                sel,
                ("dct", dct8_params) if i == 0 else _default_dct_params(sel),
            )
            for i, sel in enumerate(_DCT_SELECT_LIST)
        ]
        dms = DequantMatrixSet(mats)
    else:
        dms = DequantMatrixSet.default()
    opsin = OpsinInverseMatrix()
    qb = opsin.quant_bias
    qbn = opsin.quant_bias_numerator
    lf_dequant = (1.0 / 32.0, 1.0 / 4.0, 1.0 / 2.0)

    hf_mul = 1
    qm = [0.8 ** (x_qm_scale - 2) if xyb else 1.0,
          1.0,
          0.8 ** (b_qm_scale - 2) if xyb else 1.0]
    scale_inv = global_scale * quant_lf
    lf_scales = [m * 512.0 / scale_inv for m in lf_dequant]
    # forward DCT of every block, per channel: F[c][by, bx, 8, 8] (stored
    # layout = dct2d output: row = vertical frequency)
    blocks = padded.transpose(2, 0, 1).reshape(3, bh, 8, bw, 8)
    blocks = blocks.transpose(0, 1, 3, 2, 4)
    F = dct2d(blocks)

    # LF: DC per block. Decoder: dequant -> CfL(kx=0, kb=1) -> (smoothing
    # skipped via frame flag)
    lf_true = F[:, :, :, 0, 0]  # [3, bh, bw]
    lf_q = np.zeros((3, bh, bw), dtype=np.int64)
    lf_q[1] = np.round(lf_true[1] / lf_scales[1])
    lf_deq_y = lf_q[1] * lf_scales[1]
    lf_q[0] = np.round(lf_true[0] / lf_scales[0])  # kx = 0
    lf_q[2] = np.round((lf_true[2] - lf_deq_y) / lf_scales[2])  # kb = 1

    # HF quantization. Decoder: bias(q) * matrix_tr * mul -> CfL -> IDCT.
    def dequant(q, c):
        matrix = dms.get(c, TransformType.DCT8, transposed=True)
        mul = 65536.0 / (global_scale * hf_mul) * qm[c]
        qf = q.astype(np.float64)
        biased = np.where(
            np.abs(qf) <= 1.0, qf * qb[c], qf - qbn / np.where(qf == 0, 1, qf)
        )
        return biased * matrix * mul

    q = np.zeros((3, bh, bw, 8, 8), dtype=np.int64)
    opsin_qb = np.asarray(qb, dtype=np.float64)
    for c in (1, 0, 2):
        matrix = dms.get(c, TransformType.DCT8, transposed=True)
        mul = 65536.0 / (global_scale * hf_mul) * qm[c]
        target = F[c].astype(np.float64)
        if c == 2:
            target = target - dequant(q[1], 1)  # kb = 1: subtract y plane
        qc = np.round(target / (matrix * mul))

        # refine against the decoder's biased dequant (|q|<=1 reconstructs
        # as q*quant_bias, not q): pick the neighbor that reconstructs
        # closest, so the round-trip error stays near half a quant step
        def rec(qv):
            safe = np.where(qv == 0, 1.0, qv)
            biased = np.where(
                np.abs(qv) <= 1.0, qv * opsin_qb[c], qv - qbn / safe
            )
            return biased * matrix * mul

        for dq in (-1.0, 1.0):
            cand = qc + dq
            better = np.abs(rec(cand) - target) < np.abs(rec(qc) - target)
            qc = np.where(better, cand, qc)
        q[c] = qc
    if use_lf_any := frame_kind in ("use_lf", "lf_use_lf"):
        q[:, :, :, 0, 0] = 0  # DC carried by the LF frame
    else:
        q[:, :, :, 0, 0] = 0  # DC carried by LF

    is_lf = frame_kind in ("lf", "lf_use_lf")
    use_lf = frame_kind in ("use_lf", "lf_use_lf")

    # --- FrameHeader (VarDCT) ---
    out.zero_pad_to_byte()
    out.write_bool(False)  # not all_default
    out.write(1 if is_lf else 0, 2)  # frame_type
    out.write(0, 1)  # encoding = VarDCT
    _write_u64(out, 0xA0 if use_lf else 0x80)  # skip_alf (+use_lf_frame)
    if not xyb:
        out.write_bool(False)  # do_ycbcr (absent when xyb_encoded)
    if not use_lf:
        out.write_u32_sel(0, 0, 0)  # upsampling = 1
        if alpha is not None:
            out.write_u32_sel(0, 0, 0)  # ec_upsampling[0] = 1
    if xyb:
        out.write(x_qm_scale, 3)
        out.write(b_qm_scale, 3)
    if pass_shifts is None and num_passes > 1:
        pass_shifts = [pass_shift] * (num_passes - 1)
    _write_passes(out, num_passes, pass_shifts, pass_downsample)
    if is_lf:
        out.write(lf_level - 1, 2)
    else:
        out.write_bool(False)  # have_crop
    if not is_lf:
        out.write_u32_sel(0, 0, 0)  # blending Replace
        if alpha is not None:
            out.write_u32_sel(0, 0, 0)  # EC blending Replace
        out.write_bool(True)  # is_last
    out.write_u32_sel(0, 0, 0)  # name len 0
    def _f16(v):
        return int(np.float16(v).view(np.uint16))

    out.write_bool(False)  # restoration filter not default
    if gabor:
        out.write_bool(True)   # gabor on
        if gabor_weights is None:
            out.write_bool(False)  # default weights
        else:
            out.write_bool(True)
            for (w1, w2) in gabor_weights:
                out.write(_f16(w1), 16)
                out.write(_f16(w2), 16)
    else:
        out.write_bool(False)  # gabor off
    out.write(epf_iters, 2)
    if epf_iters:
        if epf_sharp_lut is None:
            out.write_bool(False)  # sharp_lut default
        else:
            out.write_bool(True)
            for v in epf_sharp_lut:
                out.write(_f16(v), 16)
        if epf_channel_scale is None:
            out.write_bool(False)  # channel_scale default
        else:
            out.write_bool(True)
            for v in epf_channel_scale:
                out.write(_f16(v), 16)
            out.write(0, 32)  # ignored field (filter.rs DctSelect bits)
        if epf_sigma is None:
            out.write_bool(False)  # sigma default
        else:
            out.write_bool(True)
            for v in epf_sigma:   # quant_mul, pass0, pass2, border
                out.write(_f16(v), 16)
    out.write_u64_zero()  # rf extensions
    out.write_u64_zero()  # frame extensions

    # --- sections ---
    gpr = -(-w // 256)
    gpc = -(-h // 256)
    num_groups = gpr * gpc
    single = num_groups == 1 and num_passes == 1
    sec = BitWriter()  # lf_global (continues inline when single-entry)

    # LfGlobal
    sec.write_bool(True)  # lf_dequant all_default
    # Quantizer: global_scale U32(1+u(11), 2049+u(11), 4097+u(12), 8193+u(16))
    if global_scale <= 2048:
        sec.write(0, 2)
        sec.write(global_scale - 1, 11)
    elif global_scale <= 4096:
        sec.write(1, 2)
        sec.write(global_scale - 2049, 11)
    elif global_scale <= 8192:
        sec.write(2, 2)
        sec.write(global_scale - 4097, 12)
    else:
        sec.write(3, 2)
        sec.write(global_scale - 8193, 16)
    assert quant_lf == 16
    sec.write(0, 2)
    sec.write_bool(True)  # HfBlockContext default
    sec.write_bool(True)  # LfChannelCorrelation all_default
    sec.write_bool(False)  # no global MA tree
    if alpha is not None:
        # GlobalModular carries the EC channel (full-res alpha <=
        # group_dim stays a GLOBAL channel, prepare_gmodular)
        assert h <= 256 and w <= 256, "EC must fit one group here"
        _encode_local_modular(sec, [np.asarray(alpha, dtype=np.int64)])
    # GlobalModular: zero channels -> no modular header at all

    # LfGroup 0: LfCoeff (extra_precision + modular [y,x,b]), no mlf, HfMetadata
    lfg = sec if single else BitWriter()
    sec, _lf_global_sec = lfg, sec
    if frame_kind not in ("use_lf", "lf_use_lf"):  # LfCoeff absent
        sec.write(0, 2)  # extra_precision = 0
        _encode_local_modular(sec, [lf_q[1], lf_q[0], lf_q[2]])
    # HfMetadata: nb_blocks-1 in ceil_log2(bw*bh) bits
    nb_blocks = bh * bw
    nbits = max(nb_blocks - 1, 0).bit_length()
    sec.write(nb_blocks - 1, nbits)
    w64 = -(-w // 64)
    h64 = -(-h // 64)
    x_from_y = np.zeros((h64, w64), dtype=np.int64)
    b_from_y = np.zeros((h64, w64), dtype=np.int64)
    block_info = np.zeros((2, nb_blocks), dtype=np.int64)  # all DCT8, mul-1=0
    sharpness = np.zeros((bh, bw), dtype=np.int64)
    _encode_local_modular(sec, [x_from_y, b_from_y, block_info, sharpness])

    # HfGlobal: default dequant matrices, 1 preset, 1 HfPass
    lf_group_sec = sec
    sec = lf_group_sec if single else BitWriter()
    hf_global_sec = sec
    if dct8_params is None:
        sec.write_bool(True)  # dequant all_default
    else:
        # non-default set: DCT8 via "DCT params" encoding (mode 6), the
        # other 16 param classes from the library defaults (mode 0)
        sec.write_bool(False)
        sec.write(6, 3)
        num = len(dct8_params[0])
        sec.write(num - 1, 4)
        for chan in dct8_params:
            vals = [chan[0] / 64.0] + list(chan[1:])
            for v in vals:
                sec.write(int(np.float16(v).view(np.uint16)), 16)
        for _ in range(16):
            sec.write(0, 3)  # library default
    # num_hf_presets in ceil_log2(num_groups) bits (hf_global.rs); multi-
    # preset therefore requires a multi-group frame. The shared cluster
    # map sends every (preset, ctx) to one cluster, so preset selection
    # exercises the per-section ctx_offset plumbing without changing the
    # coded symbols.
    hfp_bits = max(num_groups - 1, 0).bit_length()
    assert 1 <= num_hf_presets <= max(num_groups, 1)
    if hfp_bits:
        sec.write(num_hf_presets - 1, hfp_bits)
    # Per-pass HfPass: used_orders = 0 (selector 2), hf_dist decoder
    num_clusters_ctx = 495 * 15 * num_hf_presets
    hf_encs = []
    for _ in range(num_passes):
        sec.write(2, 2)
        if num_hf_presets == 1:
            enc_p = AnsStreamEncoder(num_clusters_ctx, 256, 8, DEFAULT_CFG)
            enc_p.write_header(sec)
        else:
            # preset-KEYED clusters with distinct integer configs: a
            # decoder using a wrong per-preset ctx_offset lands in the
            # wrong cluster and decodes different values (so the
            # round-trip equality test is a true check of the offset
            # math, not just of selector-bit consumption)
            enc_p = _PresetAnsEncoder(495 * 15, num_hf_presets)
            enc_p.write_header(sec)
        hf_encs.append(enc_p)
    hf_enc = hf_encs[0]

    # Per-group HF token streams (hfp selector bits are 0-width for 1 preset)
    order = natural_order(0)  # DCT8

    # pass coefficient split: each non-final pass p carries the current
    # remainder >> shift[p]; the decoder ADDS (v << coeff_shift(p)) per
    # pass into the same i32 buffers (hf_coeff.rs:228-236)
    q_pass = _split_passes(q, num_passes, pass_shifts)

    def group_tokens(gx, gy, qarr=None):
        if qarr is None:
            qarr = q
        tokens: list[int] = []
        for by in range(gy * 32, min((gy + 1) * 32, bh)):
            for bx in range(gx * 32, min((gx + 1) * 32, bw)):
                for c in (1, 0, 2):
                    qb_ = qarr[c, by, bx]
                    # stored[row=x, col=y] for order pos (x, y) (transposed)
                    non_zeros = sum(
                        1 for (x, y) in order[1:] if qb_[x, y] != 0
                    )
                    tokens.append(non_zeros)
                    remaining = non_zeros
                    for (x, y) in order[1:]:
                        if remaining == 0:
                            break
                        v = int(qb_[x, y])
                        tokens.append(_pack_signed(v))
                        if v != 0:
                            remaining -= 1
        return tokens

    if single:
        hf_enc.encode_tokens(sec, group_tokens(0, 0))
        sections = [sec]
    else:
        sections = [_lf_global_sec, lf_group_sec, hf_global_sec]
        sel_bits = max(num_hf_presets - 1, 0).bit_length()
        for p in range(num_passes):
            for gy in range(gpc):
                for gx in range(gpr):
                    gsec = BitWriter()
                    toks = group_tokens(gx, gy, q_pass[p])
                    if sel_bits:
                        hfp = (gy * gpr + gx) % num_hf_presets
                        gsec.write(hfp, sel_bits)
                        # per-pass hf_dist parsed once in HfGlobal; the
                        # group stream holds only state+tokens, encoded
                        # under this preset's cluster config
                        hf_encs[p].encode_tokens(gsec, toks, preset=hfp)
                    else:
                        genc = AnsStreamEncoder(
                            num_clusters_ctx, 256, 8, DEFAULT_CFG
                        )
                        genc.encode_tokens(gsec, toks)
                    sections.append(gsec)

    # --- TOC + assemble ---
    out.write_bool(False)  # no TOC permutation
    out.zero_pad_to_byte()
    for s_ in sections:
        size = len(s_.to_bytes())
        if size < 1024:
            out.write(0, 2)
            out.write(size, 10)
        elif size < 17408:
            out.write(1, 2)
            out.write(size - 1024, 14)
        else:
            out.write(2, 2)
            out.write(size - 17408, 22)
    out.zero_pad_to_byte()

    for s_ in sections:
        s_.zero_pad_to_byte()
        out.extend(s_)




def encode_jxl_vardct_mixed(
    h: int,
    w: int,
    sel_grid: np.ndarray,   # [bh, bw] int, -1 = covered by another varblock
    mul_grid: np.ndarray,   # [bh, bw] int hf_mul at varblock origins
    coeff: np.ndarray,      # [3, bh*8, bw*8] int, stored (decoder) layout
    lf_q: np.ndarray,       # [3, bh, bw] int quantized LF
    global_scale: int = 4096,
    raw_dct8: tuple | None = None,  # (denominator, int matrix [3, 8, 8])
    hf_block_ctx: tuple | None = None,  # (qf_thresholds, lf_thresholds)
    custom_orders: dict | None = None,  # {order_id: perm over natural order}
    lf_chan_corr: tuple | None = None,  # (cf, base_x, base_b, xf_lf, bf_lf)
    cfl_grids: tuple | None = None,     # (x_from_y, b_from_y) int grids
    extra_precision: int = 0,
    quant_lf: int = 16,
) -> bytes:
    """Synthesize a single-group VarDCT codestream with an explicit
    varblock layout (any of the 27 transform types). Coefficients are
    given in the decoder's stored plane layout; LF as quantized values.
    Used to exercise the general inverse-transform pipeline end-to-end."""
    assert h <= 256 and w <= 256
    bh, bw = -(-h // 8), -(-w // 8)
    assert sel_grid.shape == (bh, bw)

    out = BitWriter()
    _write_image_header(out, h, w)
    out.zero_pad_to_byte()
    out.write_bool(False)  # not all_default
    out.write(0, 2)  # regular frame
    out.write(0, 1)  # VarDCT
    _write_u64(out, 0x80)  # skip adaptive LF smoothing
    out.write_bool(False)  # do_ycbcr
    out.write_u32_sel(0, 0, 0)  # upsampling
    out.write_u32_sel(0, 0, 0)  # num_passes = 1
    out.write_bool(False)  # have_crop
    out.write_u32_sel(0, 0, 0)  # blending Replace
    out.write_bool(True)  # is_last
    out.write_u32_sel(0, 0, 0)  # name len 0
    out.write_bool(False)  # restoration filter not default
    out.write_bool(False)  # gabor off
    out.write(0, 2)  # epf iters 0
    out.write_u64_zero()  # rf extensions
    out.write_u64_zero()  # frame extensions

    sec = BitWriter()
    # LfGlobal: defaults + quantizer
    sec.write_bool(True)  # lf_dequant all_default
    if global_scale <= 2048:
        sec.write(0, 2)
        sec.write(global_scale - 1, 11)
    elif global_scale <= 4096:
        sec.write(1, 2)
        sec.write(global_scale - 2049, 11)
    else:
        sec.write(2, 2)
        sec.write(global_scale - 4097, 12)
    # quant_lf U32(16, 1+u(5), 1+u(8), 1+u(16))
    if quant_lf == 16:
        sec.write(0, 2)
    elif quant_lf <= 32:
        sec.write(1, 2)
        sec.write(quant_lf - 1, 5)
    else:
        sec.write(2, 2)
        sec.write(quant_lf - 1, 8)
    if hf_block_ctx is None:
        sec.write_bool(True)  # HfBlockContext default
        num_block_clusters = 15
    else:
        qf_thr, lf_thr = hf_block_ctx
        sec.write_bool(False)
        for c in range(3):
            thr = lf_thr[c]
            sec.write(len(thr), 4)
            for t in thr:
                pv = _pack_signed(int(t))
                if pv < 16:
                    sec.write(0, 2)
                    sec.write(pv, 4)
                else:
                    sec.write(1, 2)
                    sec.write(pv - 16, 8)
        sec.write(len(qf_thr), 4)
        for t in qf_thr:
            v = int(t) - 1
            if v < 4:
                sec.write(0, 2)
                sec.write(v, 2)
            else:
                sec.write(1, 2)
                sec.write(v - 4, 3)
        # cluster map: simple, nbits = 0 -> every context -> cluster 0
        sec.write_bool(True)
        sec.write(0, 2)
        num_block_clusters = 1
    if lf_chan_corr is None:
        sec.write_bool(True)  # LfChannelCorrelation all_default
    else:
        cf, base_x, base_b, xf_lf, bf_lf = lf_chan_corr
        sec.write_bool(False)
        if cf == 84:
            sec.write(0, 2)
        elif cf == 256:
            sec.write(1, 2)
        else:
            sec.write(2, 2)
            sec.write(cf - 2, 8)
        sec.write(int(np.float16(base_x).view(np.uint16)), 16)
        sec.write(int(np.float16(base_b).view(np.uint16)), 16)
        sec.write(xf_lf, 8)
        sec.write(bf_lf, 8)
    sec.write_bool(False)  # no global MA tree

    # LfGroup: LfCoeff + HfMetadata
    sec.write(extra_precision, 2)
    _encode_local_modular(sec, [lf_q[1], lf_q[0], lf_q[2]])

    # varblock scan order (decoder origin scan): row-major origins
    varblocks = []
    for y in range(bh):
        for x in range(bw):
            if sel_grid[y, x] >= 0:
                varblocks.append((x, y, int(sel_grid[y, x]),
                                  int(mul_grid[y, x])))
    nb_blocks = len(varblocks)
    nbits = max(bh * bw - 1, 0).bit_length()
    sec.write(nb_blocks - 1, nbits)
    w64, h64 = -(-w // 64), -(-h // 64)
    if cfl_grids is not None:
        x_from_y = np.asarray(cfl_grids[0], dtype=np.int64)
        b_from_y = np.asarray(cfl_grids[1], dtype=np.int64)
        assert x_from_y.shape == (h64, w64)
    else:
        x_from_y = np.zeros((h64, w64), dtype=np.int64)
        b_from_y = np.zeros((h64, w64), dtype=np.int64)
    block_info = np.zeros((2, nb_blocks), dtype=np.int64)
    for i, (_x, _y, sel, mul) in enumerate(varblocks):
        block_info[0, i] = sel
        block_info[1, i] = mul - 1
    sharpness = np.zeros((bh, bw), dtype=np.int64)
    _encode_local_modular(sec, [x_from_y, b_from_y, block_info, sharpness])

    # HfGlobal: dequant matrices, 1 preset, 1 HfPass with natural orders
    if raw_dct8 is None:
        sec.write_bool(True)  # dequant all_default
    else:
        denominator, raw_vals = raw_dct8
        sec.write_bool(False)
        sec.write(7, 3)  # encoding mode 7: Raw (modular-coded)
        sec.write(int(np.float16(denominator).view(np.uint16)), 16)
        _encode_local_modular(sec, [np.asarray(raw_vals[c]) for c in range(3)])
        for _ in range(16):
            sec.write(0, 3)  # library defaults
    if custom_orders is None:
        sec.write(2, 2)  # used_orders = 0
    else:
        mask = 0
        for oid in custom_orders:
            mask |= 1 << oid
        sec.write(3, 2)  # used_orders selector 3: u(13)
        sec.write(mask, 13)
        perm_enc = AnsStreamEncoder(8, 64, 6, DEFAULT_CFG)
        perm_enc.write_header(sec)
        toks = []
        for oid in range(13):
            if not (mask & (1 << oid)):
                continue
            perm = list(custom_orders[oid])
            size = len(perm)
            skip = size // 64
            for _c in range(3):
                # Lehmer: end count + codes (permutation.rs:4-43)
                toks.append(size - skip)
                temp = list(range(skip, size))
                for target in perm[skip:]:
                    v = temp.index(target)
                    toks.append(v)
                    temp.pop(v)
        perm_enc.encode_tokens(sec, toks)
    num_clusters_ctx = 495 * num_block_clusters
    hf_enc = AnsStreamEncoder(num_clusters_ctx, 256, 8, DEFAULT_CFG)
    hf_enc.write_header(sec)

    # HF tokens mirroring write_hf_coeff scan (models/vardct.py)
    tokens = []
    for x, y, sel, _mul in varblocks:
        w8, h8 = TransformType.SELECT_SIZE[sel]
        num_blocks = w8 * h8
        order_id = TransformType.ORDER_ID[sel]
        nat = natural_order(order_id)
        if custom_orders is not None and order_id in custom_orders:
            order = [nat[i] for i in custom_orders[order_id]]
        else:
            order = nat
        transpose = TransformType.need_transpose(sel)
        for c in (1, 0, 2):
            vals = []
            for (dx, dy) in order[num_blocks:]:
                if transpose:
                    px, py = dy, dx
                else:
                    px, py = dx, dy
                vals.append(int(coeff[c, y * 8 + py, x * 8 + px]))
            non_zeros = sum(1 for v in vals if v != 0)
            tokens.append(non_zeros)
            remaining = non_zeros
            for v in vals:
                if remaining == 0:
                    break
                tokens.append(_pack_signed(v))
                if v != 0:
                    remaining -= 1
    hf_enc.encode_tokens(sec, tokens)

    # single-entry TOC
    out.write_bool(False)
    out.zero_pad_to_byte()
    size = len(sec.to_bytes())
    if size < 1024:
        out.write(0, 2)
        out.write(size, 10)
    elif size < 17408:
        out.write(1, 2)
        out.write(size - 1024, 14)
    else:
        out.write(2, 2)
        out.write(size - 17408, 22)
    out.zero_pad_to_byte()
    sec.zero_pad_to_byte()
    out.extend(sec)
    return out.to_bytes()




def encode_jxl_vardct_420(
    h: int,
    w: int,
    coeff: list,     # [y, x, b]-indexable: coeff[c] at each channel's res
    lf_q: list,      # per-channel quantized LF at channel res
    global_scale: int = 4096,
    jpeg_upsampling=(0, 1, 0),
    gabor: bool = False,
    epf_iters: int = 0,
) -> bytes:
    """Synthesize a do_ycbcr subsampled VarDCT codestream with all-DCT8
    varblocks. Default jpeg_upsampling (0, 1, 0) is 4:2:0 (y full-res,
    x/b half-res); (0, 2, 0) / (0, 3, 0) give the asymmetric 4:2:2 /
    4:4:0 layouts (param.rs from_jpeg_upsampling). Caller-provided
    coeff/lf planes must match each channel's shifted size. Drives the
    subsampled decode path (vardct staged pipeline + JPEG chroma
    upsampling)."""
    assert h <= 256 and w <= 256 and h % 16 == 0 and w % 16 == 0
    bh, bw = h // 8, w // 8
    shifts = jpeg_shifts(jpeg_upsampling)

    out = BitWriter()
    _write_image_header(out, h, w)
    out.zero_pad_to_byte()
    out.write_bool(False)  # not all_default
    out.write(0, 2)  # regular frame
    out.write(0, 1)  # VarDCT
    _write_u64(out, 0x80)  # skip adaptive LF smoothing
    out.write_bool(True)  # do_ycbcr
    for ups in jpeg_upsampling:
        out.write(ups, 2)  # jpeg_upsampling
    out.write_u32_sel(0, 0, 0)  # upsampling
    out.write_u32_sel(0, 0, 0)  # num_passes = 1
    out.write_bool(False)  # have_crop
    out.write_u32_sel(0, 0, 0)  # blending Replace
    out.write_bool(True)  # is_last
    out.write_u32_sel(0, 0, 0)  # name len 0
    out.write_bool(False)  # restoration filter not default
    out.write_bool(gabor)  # gabor on/off (default weights)
    if gabor:
        out.write_bool(False)  # default weights
    out.write(epf_iters, 2)
    if epf_iters:
        out.write_bool(False)  # sharp_lut default
        out.write_bool(False)  # channel_scale default
        out.write_bool(False)  # sigma default
    out.write_u64_zero()
    out.write_u64_zero()

    sec = BitWriter()
    sec.write_bool(True)  # lf_dequant all_default
    if global_scale <= 2048:
        sec.write(0, 2)
        sec.write(global_scale - 1, 11)
    else:
        sec.write(1, 2)
        sec.write(global_scale - 2049, 11)
    sec.write(0, 2)  # quant_lf = 16
    sec.write_bool(True)  # HfBlockContext default
    sec.write_bool(True)  # LfChannelCorrelation all_default
    sec.write_bool(False)  # no global MA tree

    # LfCoeff: channels in (y, x, b) stream order at shifted sizes
    sec.write(0, 2)  # extra_precision
    _encode_local_modular(sec, [lf_q[1], lf_q[0], lf_q[2]])

    # HfMetadata: full-res grids, all DCT8
    nb_blocks = bh * bw
    nbits = max(nb_blocks - 1, 0).bit_length()
    sec.write(nb_blocks - 1, nbits)
    w64, h64 = -(-w // 64), -(-h // 64)
    _encode_local_modular(sec, [
        np.zeros((h64, w64), dtype=np.int64),
        np.zeros((h64, w64), dtype=np.int64),
        np.zeros((2, nb_blocks), dtype=np.int64),
        np.zeros((bh, bw), dtype=np.int64),
    ])

    sec.write_bool(True)  # dequant all_default
    sec.write(2, 2)  # used_orders = 0
    num_clusters_ctx = 495 * 15
    hf_enc = AnsStreamEncoder(num_clusters_ctx, 256, 8, DEFAULT_CFG)
    hf_enc.write_header(sec)

    order = natural_order(0)
    tokens = []
    for y in range(bh):
        for x in range(bw):
            for c in (1, 0, 2):
                hs, vs = shifts[c]
                sx, sy = x >> hs, y >> vs
                if hs or vs:
                    if (sx << hs) != x or (sy << vs) != y:
                        continue
                # DCT8 need_transpose: decoder writes [sy*8+dx, sx*8+dy]
                # for order entry (dx, dy)
                vals = [int(coeff[c][sy * 8 + dx_, sx * 8 + dy_])
                        for (dx_, dy_) in order[1:]]
                non_zeros = sum(1 for v in vals if v != 0)
                tokens.append(non_zeros)
                remaining = non_zeros
                for v in vals:
                    if remaining == 0:
                        break
                    tokens.append(_pack_signed(v))
                    if v != 0:
                        remaining -= 1
    hf_enc.encode_tokens(sec, tokens)

    out.write_bool(False)  # TOC not permuted
    out.zero_pad_to_byte()
    size = len(sec.to_bytes())
    if size < 1024:
        out.write(0, 2)
        out.write(size, 10)
    elif size < 17408:
        out.write(1, 2)
        out.write(size - 1024, 14)
    else:
        out.write(2, 2)
        out.write(size - 17408, 22)
    out.zero_pad_to_byte()
    sec.zero_pad_to_byte()
    out.extend(sec)
    return out.to_bytes()


def encode_jxl_vardct_tiled(
    h: int,
    w: int,
    sel_grid: np.ndarray,    # [bh, bw] int, -1 = covered by another varblock
    mul_grid: np.ndarray,    # [bh, bw] int hf_mul at varblock origins
    coeff,                   # [3, bh*8, bw*8] int, stored (decoder) layout;
                             # subsampled: LIST of per-channel [x, y, b]
                             # planes at shifted sizes
    lf_q,                    # [3, bh, bw] int quantized LF; subsampled:
                             # LIST of per-channel planes at shifted sizes
    global_scale: int = 4096,
    quant_lf: int = 16,
    gabor: bool = False,
    epf_iters: int = 0,
    sharpness: np.ndarray | None = None,  # [bh, bw] 0..7 (EPF sigma input)
    cfl_grids: tuple | None = None,       # (x_from_y, b_from_y) int grids
    skip_lf_smoothing: bool = True,
    jpeg_upsampling=(0, 0, 0),
    num_passes: int = 1,
    pass_shift: int = 1,                  # pass-0 coefficient downshift
    pass_shifts: list | None = None,      # per-pass coeff shifts (len n-1)
    pass_downsample: list | None = None,  # [(downsample, last_pass), ...]
    alpha: np.ndarray | None = None,      # (h, w) int alpha EC samples
) -> bytes:
    """Synthesize a MULTI-GROUP (and multi-LF-group) VarDCT codestream
    with an explicit varblock layout over the whole image: the general
    tiled bitstream shape of the format (TOC sections per 2048px LF group
    and per pass x 256px group, jxl-frame/src/data/toc.rs), used to
    exercise group-parallel and mesh-sharded decode on images >= 4096x4096
    with mixed transform types, EPF sigma grids, and gaborish.

    jpeg_upsampling != (0,0,0) emits a do_ycbcr chroma-subsampled stream
    (4:2:0 and friends). The caller must pick sel_grid so each channel's
    shifted projection tiles (all-DCT8 always does): subsampled channels
    take varblocks only at lattice-aligned full-res anchors whose shifted
    position also holds an anchor (jxl-vardct hf_coeff.rs alignment rule,
    mirrored from models/vardct.py write_hf_coeff)."""
    bh, bw = -(-h // 8), -(-w // 8)
    assert sel_grid.shape == (bh, bw)
    do_ycbcr = any(j != 0 for j in jpeg_upsampling)
    shifts = jpeg_shifts(jpeg_upsampling)
    if do_ycbcr:
        assert isinstance(coeff, (list, tuple)) and len(coeff) == 3
        assert isinstance(lf_q, (list, tuple)) and len(lf_q) == 3
    else:
        coeff = [np.asarray(coeff)[c] for c in range(3)]
        lf_q = [np.asarray(lf_q)[c] for c in range(3)]
    gd, lgd = 256, 2048          # group dim (px), LF group dim (px)
    gdb, lgdb = gd // 8, lgd // 8  # in blocks
    gpr, gpc = -(-w // gd), -(-h // gd)
    lgpr, lgpc = -(-w // lgd), -(-h // lgd)
    num_groups = gpr * gpc
    num_lf_groups = lgpr * lgpc
    single = num_groups == 1

    out = BitWriter()
    _write_image_header(out, h, w, extra_alpha=alpha is not None)

    # --- FrameHeader (VarDCT) ---
    out.zero_pad_to_byte()
    out.write_bool(False)  # not all_default
    out.write(0, 2)  # regular frame
    out.write(0, 1)  # VarDCT
    _write_u64(out, 0x80 if skip_lf_smoothing else 0)
    out.write_bool(do_ycbcr)
    if do_ycbcr:
        for ups in jpeg_upsampling:
            out.write(ups, 2)
    out.write_u32_sel(0, 0, 0)  # upsampling
    if alpha is not None:
        out.write_u32_sel(0, 0, 0)  # ec_upsampling[0] = 1
    if pass_shifts is None and num_passes > 1:
        pass_shifts = [pass_shift] * (num_passes - 1)
    _write_passes(out, num_passes, pass_shifts, pass_downsample)
    out.write_bool(False)  # have_crop
    out.write_u32_sel(0, 0, 0)  # blending Replace
    if alpha is not None:
        out.write_u32_sel(0, 0, 0)  # EC blending Replace
    out.write_bool(True)  # is_last
    out.write_u32_sel(0, 0, 0)  # name len 0
    out.write_bool(False)  # restoration filter not default
    if gabor:
        out.write_bool(True)   # gab on
        out.write_bool(False)  # default weights
    else:
        out.write_bool(False)
    out.write(epf_iters, 2)
    if epf_iters:
        out.write_bool(False)  # sharp_lut default
        out.write_bool(False)  # channel_scale default
        out.write_bool(False)  # sigma default
    out.write_u64_zero()  # rf extensions
    out.write_u64_zero()  # frame extensions

    if sharpness is None:
        sharpness = np.zeros((bh, bw), dtype=np.int64)
    if cfl_grids is not None:
        x_from_y_all = np.asarray(cfl_grids[0], dtype=np.int64)
        b_from_y_all = np.asarray(cfl_grids[1], dtype=np.int64)
    else:
        w64, h64 = -(-w // 64), -(-h // 64)
        x_from_y_all = np.zeros((h64, w64), dtype=np.int64)
        b_from_y_all = np.zeros((h64, w64), dtype=np.int64)

    # --- LfGlobal section ---
    lf_global = BitWriter()
    lf_global.write_bool(True)  # lf_dequant all_default
    if global_scale <= 2048:
        lf_global.write(0, 2)
        lf_global.write(global_scale - 1, 11)
    elif global_scale <= 4096:
        lf_global.write(1, 2)
        lf_global.write(global_scale - 2049, 11)
    elif global_scale <= 8192:
        lf_global.write(2, 2)
        lf_global.write(global_scale - 4097, 12)
    else:
        lf_global.write(3, 2)
        lf_global.write(global_scale - 8193, 16)
    assert quant_lf == 16
    lf_global.write(0, 2)
    lf_global.write_bool(True)  # HfBlockContext default (15 clusters)
    lf_global.write_bool(True)  # LfChannelCorrelation all_default
    alpha_enc = None
    if alpha is None:
        lf_global.write_bool(False)  # no global MA tree
        # GlobalModular: zero channels -> no modular header
    else:
        # GlobalModular with the full-res alpha EC channel: global
        # single-leaf gradient tree + modular header; the channel itself
        # exceeds group_dim so it splits into per-(last-pass x group)
        # tiles inside the VarDCT sections (prepare_groups), leaving the
        # global stream EMPTY (state + final-state only)
        lf_global.write_bool(True)  # global MA tree
        alpha_enc = write_ma_config(lf_global, 5)  # gradient
        write_modular_header(lf_global, use_global_tree=True)
        alpha_enc.encode_tokens(lf_global, [])

    # --- per-LF-group sections: LfCoeff + HfMetadata (local grids) ---
    lf_group_secs = []
    for lgy in range(lgpc):
        for lgx in range(lgpr):
            sec = BitWriter()
            by0, bx0 = lgy * lgdb, lgx * lgdb
            lbh = min(lgdb, bh - by0)
            lbw = min(lgdb, bw - bx0)
            lsel = sel_grid[by0 : by0 + lbh, bx0 : bx0 + lbw]
            lmul = mul_grid[by0 : by0 + lbh, bx0 : bx0 + lbw]
            # per-channel local LF planes at shifted sizes (LfCoeff.parse
            # channel geometry: _shifted_size of the local block extent)
            llf = []
            for c in (1, 0, 2):  # stream order y, x, b
                chs, cvs = shifts[c]
                y0c, x0c = by0 >> cvs, bx0 >> chs
                lh_c = -(-lbh // (1 << cvs))
                lw_c = -(-lbw // (1 << chs))
                llf.append(
                    np.asarray(lf_q[c])[y0c : y0c + lh_c, x0c : x0c + lw_c]
                )
            sec.write(0, 2)  # extra_precision = 0
            _encode_local_modular(sec, llf)
            varblocks = []
            for y in range(lbh):
                for x in range(lbw):
                    if lsel[y, x] >= 0:
                        varblocks.append(
                            (x, y, int(lsel[y, x]), int(lmul[y, x]))
                        )
            nb = len(varblocks)
            nbits = max(lbh * lbw - 1, 0).bit_length()
            sec.write(nb - 1, nbits)
            # local CfL grids (per 64px of this LF group)
            c64y0, c64x0 = lgy * (lgd // 64), lgx * (lgd // 64)
            lh64 = -(-min(lgd, h - lgy * lgd) // 64)
            lw64 = -(-min(lgd, w - lgx * lgd) // 64)
            lxf = x_from_y_all[c64y0 : c64y0 + lh64, c64x0 : c64x0 + lw64]
            lbf = b_from_y_all[c64y0 : c64y0 + lh64, c64x0 : c64x0 + lw64]
            block_info = np.zeros((2, nb), dtype=np.int64)
            for i, (_x, _y, sel, mul) in enumerate(varblocks):
                block_info[0, i] = sel
                block_info[1, i] = mul - 1
            lsharp = sharpness[by0 : by0 + lbh, bx0 : bx0 + lbw]
            _encode_local_modular(sec, [lxf, lbf, block_info, lsharp])
            lf_group_secs.append(sec)

    # --- HfGlobal: default dequant, 1 preset, 1 HfPass natural orders ---
    hf_global = BitWriter()
    hf_global.write_bool(True)  # dequant all_default
    hfp_bits = max(num_groups - 1, 0).bit_length()
    if hfp_bits:
        hf_global.write(0, hfp_bits)  # 1 preset
    num_clusters_ctx = 495 * 15
    for _ in range(num_passes):
        hf_global.write(2, 2)  # used_orders = 0
        hf_enc = AnsStreamEncoder(num_clusters_ctx, 256, 8, DEFAULT_CFG)
        hf_enc.write_header(hf_global)

    # pass coefficient split (hf_coeff.rs:228-236 additive accumulation)
    if num_passes == 1:
        coeff_pass = [coeff]
    else:
        per_chan = [_split_passes(c, num_passes, pass_shifts)
                    for c in coeff]
        coeff_pass = [[pc[p] for pc in per_chan]
                      for p in range(num_passes)]

    # --- per-group HF token streams ---
    def group_tokens(gx, gy, coeff=coeff):
        tokens: list[int] = []
        by0, bx0 = gy * gdb, gx * gdb
        for by in range(by0, min(by0 + gdb, bh)):
            for bx in range(bx0, min(bx0 + gdb, bw)):
                sel = sel_grid[by, bx]
                if sel < 0:
                    continue
                sel = int(sel)
                w8, h8 = TransformType.SELECT_SIZE[sel]
                num_blocks = w8 * h8
                order = natural_order(TransformType.ORDER_ID[sel])
                transpose = TransformType.need_transpose(sel)
                for c in (1, 0, 2):
                    chs, cvs = shifts[c]
                    sx, sy = bx >> chs, by >> cvs
                    if chs or cvs:
                        # write_hf_coeff alignment rule: lattice-aligned
                        # anchor whose shifted position holds an anchor.
                        # The existence check is PASS-GROUP-local (the
                        # decoder checks the group's block_sel subgrid,
                        # jxl-frame pass_group.rs:80-96), so the check
                        # cell is group_base + (local >> shift).
                        if (sx << chs) != bx or (sy << cvs) != by:
                            continue
                        if sel_grid[by0 + ((by - by0) >> cvs),
                                    bx0 + ((bx - bx0) >> chs)] < 0:
                            continue
                    vals = []
                    for (dx, dy) in order[num_blocks:]:
                        px, py = (dy, dx) if transpose else (dx, dy)
                        vals.append(int(coeff[c][sy * 8 + py, sx * 8 + px]))
                    non_zeros = sum(1 for v in vals if v != 0)
                    tokens.append(non_zeros)
                    remaining = non_zeros
                    for v in vals:
                        if remaining == 0:
                            break
                        tokens.append(_pack_signed(v))
                        if v != 0:
                            remaining -= 1
        return tokens

    if single:
        raise NotImplementedError("use encode_jxl_vardct_mixed for single-group")

    group_secs = []
    for p in range(num_passes):
        for gy in range(gpc):
            for gx in range(gpr):
                gsec = BitWriter()
                genc = AnsStreamEncoder(num_clusters_ctx, 256, 8, DEFAULT_CFG)
                genc.encode_tokens(
                    gsec, group_tokens(gx, gy, coeff=coeff_pass[p])
                )
                if alpha is not None and p == num_passes - 1:
                    # modular substream follows the HF tokens in the
                    # same section (pass_group.rs:139); shift-0 channels
                    # belong to the LAST pass (fh_pass_shifts)
                    tile = np.asarray(
                        alpha[gy * gd : (gy + 1) * gd,
                              gx * gd : (gx + 1) * gd],
                        dtype=np.int64,
                    )
                    write_modular_header(gsec, use_global_tree=True)
                    encode_stream_tokens(gsec, alpha_enc, [tile], 5)
                group_secs.append(gsec)

    sections = [lf_global, *lf_group_secs, hf_global, *group_secs]

    # --- TOC + assemble ---
    out.write_bool(False)  # no permutation
    out.zero_pad_to_byte()
    for s_ in sections:
        size = len(s_.to_bytes())
        if size < 1024:
            out.write(0, 2)
            out.write(size, 10)
        elif size < 17408:
            out.write(1, 2)
            out.write(size - 1024, 14)
        elif size < 4211712:
            out.write(2, 2)
            out.write(size - 17408, 22)
        else:
            out.write(3, 2)
            out.write(size - 4211712, 30)
    out.zero_pad_to_byte()
    for s_ in sections:
        s_.zero_pad_to_byte()
        out.extend(s_)
    return out.to_bytes()
