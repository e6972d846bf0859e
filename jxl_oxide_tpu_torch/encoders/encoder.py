"""Minimal JPEG XL Modular encoder — TEST INFRASTRUCTURE ONLY.

The port's copy of tools/encoder.py, which imports the JAX package: this
one takes what it needs from jxl_oxide_tpu_torch's own modules (the
entropy coder's AnsHistogram, IntegerConfig and add_log2_ceil, the
Bitstream reader, the squeeze tendency, the ICC header predictor) and
is numpy only, so a host without JAX writes the same bytes. Arguments,
asserts and scope are those of tools/encoder.py.

Produces spec-valid bare codestreams for round-trip validation of the
decoder: grayscale/RGB/multi-channel lossless Modular images with selectable
predictor, optional RCT / squeeze transforms, multiple groups, 8/16-bit.

Deliberately simple: rANS with flat (evenly distributed) histograms, simple
cluster maps, single-leaf or table MA trees. Compression ratio is irrelevant;
only spec validity and decoder coverage matter. The rANS encoder derives its
alias tables by round-tripping the histogram header through the DECODER's
parser, guaranteeing table consistency.
"""

from __future__ import annotations

import numpy as np

from ..coding.entropy import AnsHistogram, IntegerConfig
from ..io.bitstream import Bitstream


class BitWriter:
    def __init__(self):
        self.bits: list[tuple[int, int]] = []  # (value, nbits)
        self._len = 0

    def write(self, value: int, nbits: int):
        assert 0 <= value < (1 << nbits) or nbits == 0
        if nbits:
            self.bits.append((value, nbits))
            self._len += nbits

    def write_bool(self, b: bool):
        self.write(1 if b else 0, 1)

    def write_u32_sel(self, selector: int, value: int, nbits: int, offset: int = 0):
        self.write(selector, 2)
        if nbits:
            self.write(value - offset, nbits)

    def write_u64_zero(self):
        self.write(0, 2)

    def zero_pad_to_byte(self):
        pad = (-self._len) % 8
        self.write(0, pad) if pad else None

    def extend(self, other: "BitWriter"):
        self.bits.extend(other.bits)
        self._len += other._len

    def __len__(self):
        return self._len

    def to_bytes(self) -> bytes:
        out = bytearray()
        acc = 0
        nacc = 0
        for value, nbits in self.bits:
            acc |= value << nacc
            nacc += nbits
            while nacc >= 8:
                out.append(acc & 0xFF)
                acc >>= 8
                nacc -= 8
        if nacc:
            out.append(acc & 0xFF)
        return bytes(out)


# ---------------------------------------------------------------------------
# Hybrid-uint tokenization (inverse of entropy.read_uint)


def tokenize_uint(v: int, cfg: IntegerConfig) -> tuple[int, int, int]:
    """-> (token, n_rest_bits, rest_value)"""
    split = cfg.split
    if v < split:
        return v, 0, 0
    msb, lsb = cfg.msb_in_token, cfg.lsb_in_token
    L = v.bit_length()
    n = L - 1 - msb - lsb
    assert n >= cfg.split_exponent - (msb + lsb)
    token = (
        split
        + (((n - (cfg.split_exponent - msb - lsb)) << (msb + lsb)))
        + (((v >> (n + lsb)) & ((1 << msb) - 1)) << lsb)
        + (v & ((1 << lsb) - 1))
    )
    rest = (v >> lsb) & ((1 << n) - 1)
    return token, n, rest


def pack_signed(value: int) -> int:
    return 2 * value - 1 if value > 0 else -2 * value if value <= 0 else 0


def _pack_signed(v: int) -> int:
    # inverse of unpack_signed: 0,-1,1,-2,2 -> 0,1,2,3,4
    return (v << 1) if v >= 0 else (-(v << 1) - 1)


# ---------------------------------------------------------------------------
# rANS stream encoder


class AnsStreamEncoder:
    """Encodes one entropy stream: header (dists) + state + tokens."""

    def __init__(self, num_dist: int, alphabet_size: int, log_alphabet_size: int,
                 cfg: IntegerConfig):
        assert 5 <= log_alphabet_size <= 8
        assert alphabet_size <= (1 << log_alphabet_size)
        self.num_dist = num_dist
        self.alphabet_size = alphabet_size
        self.log_alphabet_size = log_alphabet_size
        self.cfg = cfg

        # Build the histogram header bits once, then parse them back with the
        # decoder to obtain the exact alias table.
        hw = BitWriter()
        self._write_histogram(hw)
        hist_bits = hw.to_bytes()
        self.hist = AnsHistogram(Bitstream(hist_bits), log_alphabet_size)
        # inverse alias map: (sym, offset_in_dist) -> idx
        self.inv = {}
        for idx in range(1 << 12):
            i = idx >> self.hist.log_bucket_size
            pos = idx & self.hist.bucket_mask
            if pos >= self.hist.alias_cutoff[i]:
                sym = int(self.hist.alias_symbol[i])
                off = int(self.hist.alias_offset[i]) + pos
            else:
                sym = i
                off = pos
            self.inv[(sym, off)] = idx
        self.dist = self.hist.dist

    def _write_u8_coded(self, w: BitWriter, v: int):
        if v == 0:
            w.write_bool(False)
            return
        w.write_bool(True)
        n = v.bit_length() - 1
        w.write(n, 3)
        w.write(v - (1 << n), n)

    def _write_histogram(self, w: BitWriter):
        # evenly distributed: [0][1][u8 alphabet-1]
        w.write_bool(False)
        w.write_bool(True)
        self._write_u8_coded(w, self.alphabet_size - 1)

    def _write_integer_config(self, w: BitWriter):
        cfg = self.cfg
        las = self.log_alphabet_size
        # split_exponent: add_log2_ceil(las) bits
        from ..coding.entropy import add_log2_ceil

        w.write(cfg.split_exponent, add_log2_ceil(las))
        if cfg.split_exponent != las:
            w.write(cfg.msb_in_token, add_log2_ceil(cfg.split_exponent))
            w.write(
                cfg.lsb_in_token,
                add_log2_ceil(cfg.split_exponent - cfg.msb_in_token),
            )

    def write_header(self, w: BitWriter):
        """Decoder::parse bits: lz77 off, clusters, ANS, configs, histograms."""
        w.write_bool(False)  # lz77 disabled
        if self.num_dist > 1:
            w.write_bool(True)  # simple cluster map
            w.write(0, 2)  # nbits = 0 -> all zero clusters
        w.write_bool(False)  # use_prefix_code = false
        w.write(self.log_alphabet_size - 5, 2)
        # one cluster
        self._write_integer_config(w)
        self._write_histogram(w)

    def encode_tokens(self, w: BitWriter, values: list[int]):
        """Append [32-bit state][per-symbol renorm + raw bits] for the given
        uint values (cluster 0)."""
        toks = [tokenize_uint(v, self.cfg) for v in values]
        self.encode_raw_tokens(w, toks)

    def encode_raw_tokens(self, w: BitWriter, toks: list):
        """Symbol-level encode: toks = [(token, nbits, rest), ...]."""
        for token, _, _ in toks:
            if token >= self.alphabet_size:
                raise ValueError(f"token {token} exceeds alphabet")
        # reverse rANS
        state = 0x130000
        emits: list[int | None] = [None] * len(toks)
        for i in range(len(toks) - 1, -1, -1):
            token = toks[i][0]
            d = int(self.dist[token])
            assert d > 0
            if state >= (d << 20):
                emits[i] = state & 0xFFFF
                state >>= 16
            q, r = divmod(state, d)
            state = (q << 12) | self.inv[(token, r)]
        w.write(state, 32)
        for (token, nbits, rest), emit in zip(toks, emits):
            if emit is not None:
                w.write(emit, 16)
            if nbits:
                w.write(rest, nbits)


DEFAULT_CFG = IntegerConfig(split_exponent=4, msb_in_token=2, lsb_in_token=2)

# LZ77 run-length coding shape (the "fast-lossless" stream layout):
# min_symbol 224, min_length 3, length tokens coded with a bare
# exponential config (split_exponent 0).
RLE_MIN_SYMBOL = 224
RLE_MIN_LENGTH = 3
RLE_LEN_CFG = IntegerConfig(split_exponent=0, msb_in_token=0, lsb_in_token=0)


class RleAnsStreamEncoder(AnsStreamEncoder):
    """AnsStreamEncoder variant that emits an LZ77-enabled stream in the
    RLE shape the decoders fast-path (jxl-coding lib.rs as_rle: the
    distance cluster is a single symbol == 1 with split_exponent 0, so
    every match copies the previous value). Distance symbols are state
    no-ops in rANS (full 2^12 mass) and are not emitted; run lengths ride
    the same value cluster at token >= RLE_MIN_SYMBOL."""

    def write_header(self, w: BitWriter):
        from ..coding.entropy import add_log2_ceil

        w.write_bool(True)   # lz77 enabled
        w.write(0, 2)        # min_symbol U32 selector 0 -> 224
        w.write(0, 2)        # min_length U32 selector 0 -> 3
        # len_config, parsed with log_alphabet_size=8 context
        w.write(RLE_LEN_CFG.split_exponent, add_log2_ceil(8))
        # split_exponent 0 != 8 -> msb/lsb fields are 0-bit wide
        # cluster map over num_dist+1 distributions: samples -> 0, dist -> 1
        w.write_bool(True)   # simple cluster map
        w.write(1, 2)        # nbits = 1
        for _ in range(self.num_dist):
            w.write(0, 1)
        w.write(1, 1)        # the lz77 distance distribution
        w.write_bool(False)  # use_prefix_code = false
        w.write(self.log_alphabet_size - 5, 2)
        # cluster 0: sample/length tokens; cluster 1: distances
        self._write_integer_config(w)
        w.write(0, add_log2_ceil(self.log_alphabet_size))  # dist split_exp 0
        self._write_histogram(w)
        # distance histogram: unary (single symbol) form, symbol 1
        w.write_bool(True)
        w.write_bool(False)
        self._write_u8_coded(w, 1)

    def encode_rle_values(self, w: BitWriter, values: list[int]):
        """RLE-tokenize packed residuals: runs >= RLE_MIN_LENGTH of the
        current value become one length token (repeat-last semantics)."""
        toks = []
        prev = None
        i, n = 0, len(values)
        while i < n:
            v = values[i]
            if v == prev:
                j = i
                while j < n and values[j] == prev:
                    j += 1
                run = j - i
                if run >= RLE_MIN_LENGTH:
                    t, nb, rest = tokenize_uint(run - RLE_MIN_LENGTH,
                                                RLE_LEN_CFG)
                    assert RLE_MIN_SYMBOL + t < self.alphabet_size
                    toks.append((RLE_MIN_SYMBOL + t, nb, rest))
                    i = j
                    continue
            t, nb, rest = tokenize_uint(v, self.cfg)
            assert t < RLE_MIN_SYMBOL, "literal token collides with lengths"
            toks.append((t, nb, rest))
            prev = v
            i += 1
        self.encode_raw_tokens(w, toks)


# ---------------------------------------------------------------------------
# Forward prediction (encoder side)

PRED_ZERO, PRED_WEST, PRED_GRADIENT = 0, 1, 5


def _forward_squeeze_h(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Encoder-side horizontal squeeze (exact inverse of the decoder's
    inverse_squeeze_h, squeeze.rs:59-88): avg = first - trunc(diff/2),
    residual = diff - smooth tendency of the reconstructed neighborhood.
    Odd widths carry the last column in avg."""
    from ..models.modular_transform import _tendency

    v = np.asarray(v, dtype=np.int64)
    h, w = v.shape
    rw = w // 2
    aw = w - rw
    avg = np.zeros((h, aw), dtype=np.int64)
    res = np.zeros((h, rw), dtype=np.int64)
    if w % 2 == 1:
        avg[:, -1] = v[:, -1]
    diff = v[:, 0 : 2 * rw : 2] - v[:, 1 : 2 * rw : 2]
    half = np.sign(diff) * (np.abs(diff) // 2)
    avg[:, :rw] = v[:, 0 : 2 * rw : 2] - half
    left = avg[:, 0].copy()
    for x in range(rw):
        nxt = avg[:, x + 1] if x + 1 < aw else avg[:, x]
        t = _tendency(left, avg[:, x], nxt)
        res[:, x] = diff[:, x] - t
        left = v[:, 2 * x + 1]
    return avg, res


def forward_residuals(arr: np.ndarray, predictor: int) -> list[int]:
    h, w = arr.shape
    a = arr.astype(np.int64)
    res = []
    if predictor == PRED_ZERO:
        return [int(v) for v in a.reshape(-1)]
    for y in range(h):
        for x in range(w):
            if predictor == PRED_WEST:
                pred = int(a[y, x - 1]) if x > 0 else (int(a[y - 1, 0]) if y > 0 else 0)
            else:  # gradient
                if y == 0:
                    pred = int(a[0, x - 1]) if x > 0 else 0
                elif x == 0:
                    pred = int(a[y - 1, 0])
                else:
                    n = int(a[y - 1, x])
                    wv = int(a[y, x - 1])
                    nw = int(a[y - 1, x - 1])
                    lo, hi = (wv, n) if n > wv else (n, wv)
                    pred = min(max(n + wv - nw, lo), hi)
            res.append(int(a[y, x]) - pred)
    return res


# ---------------------------------------------------------------------------
# Modular sub-stream encoding


class Lz77AnsStreamEncoder(AnsStreamEncoder):
    """LZ77 stream with GENERAL matches (not the RLE shape): every
    distribution incl. the distance one maps to one shared cluster, so
    distance tokens are plain hybrid-uint values. Used to drive the
    decoder's generic LZ77 window path with 2-D special distances
    (jxl-coding lib.rs:487-569) through full images."""

    def write_header(self, w: BitWriter):
        from ..coding.entropy import add_log2_ceil

        w.write_bool(True)   # lz77 enabled
        w.write(0, 2)        # min_symbol = 224
        w.write(0, 2)        # min_length = 3
        w.write(RLE_LEN_CFG.split_exponent, add_log2_ceil(8))
        # cluster map over num_dist+1 distributions: ALL -> cluster 0
        w.write_bool(True)
        w.write(0, 2)        # nbits = 0
        w.write_bool(False)  # ANS
        w.write(self.log_alphabet_size - 5, 2)
        self._write_integer_config(w)
        self._write_histogram(w)

    def encode_lz77_values(self, w: BitWriter, values: list[int],
                           width: int):
        """Greedy match emission: runs copying from `width` back (the 2-D
        row-above special distance) or 1 back (repeat-last) become one
        (length, distance) token pair. Distance values decode through
        SPECIAL_DIST with dist_multiplier == width and an effective
        distance of (a + width*b - 1) + 1: value 1 -> (1,0) -> distance
        1 (repeat-last); value 0 -> (0,1) -> distance width (row
        above)."""
        toks = []
        i, n = 0, len(values)
        while i < n:
            best_len, best_dist_tok = 0, 0
            if i >= width:
                L = 0
                while i + L < n and values[i + L] == values[i + L - width]:
                    L += 1
                if L > best_len:
                    best_len, best_dist_tok = L, 0
            if i >= 1:
                L = 0
                while i + L < n and values[i + L] == values[i - 1]:
                    L += 1
                if L > best_len:
                    best_len, best_dist_tok = L, 1
            if best_len >= RLE_MIN_LENGTH:
                t, nb, rest = tokenize_uint(best_len - RLE_MIN_LENGTH,
                                            RLE_LEN_CFG)
                assert RLE_MIN_SYMBOL + t < self.alphabet_size
                toks.append((RLE_MIN_SYMBOL + t, nb, rest))
                toks.append(tokenize_uint(best_dist_tok, self.cfg))
                i += best_len
                continue
            t, nb, rest = tokenize_uint(values[i], self.cfg)
            assert t < RLE_MIN_SYMBOL
            toks.append((t, nb, rest))
            i += 1
        self.encode_raw_tokens(w, toks)


def write_ma_config(w: BitWriter, predictor: int, lz77_rle: bool = False,
                    lz77_matches: bool = False, cfg=None):
    """Single-leaf MA tree + token decoder header.

    Tree stream tokens (ctx order): prop+1=0 (leaf), predictor, offset=0,
    mul_log=0, mul_bits=0."""
    tree_cfg = IntegerConfig(split_exponent=5, msb_in_token=0, lsb_in_token=0)
    tree_enc = AnsStreamEncoder(6, 32, 5, tree_cfg)
    tree_enc.write_header(w)
    tree_enc.encode_tokens(w, [0, predictor, 0, 0, 0])
    # token decoder for 1 leaf context
    cls = (Lz77AnsStreamEncoder if lz77_matches
           else RleAnsStreamEncoder if lz77_rle else AnsStreamEncoder)
    sample_enc = cls(1, 256, 8, cfg or DEFAULT_CFG)
    sample_enc.write_header(w)
    return sample_enc


def write_ma_config_tree(w: BitWriter, tree_tokens: list[int], num_leaves: int,
                         cfg=None):
    """General MA tree writer: tree_tokens in MaConfig.parse order (BFS:
    prop+1 [, packed value | predictor, packed offset, mul_log, mul_bits]).
    Returns the sample-token encoder (num_leaves contexts -> cluster 0)."""
    tree_cfg = IntegerConfig(split_exponent=5, msb_in_token=0, lsb_in_token=0)
    tree_enc = AnsStreamEncoder(6, 64, 6, tree_cfg)
    tree_enc.write_header(w)
    tree_enc.encode_tokens(w, tree_tokens)
    sample_enc = AnsStreamEncoder(num_leaves, 256, 8, cfg or DEFAULT_CFG)
    sample_enc.write_header(w)
    return sample_enc


def write_modular_header(w: BitWriter, use_global_tree: bool, rct_begin: int | None = None,
                         squeeze_h: bool = False, palette_spec: dict | None = None,
                         rct_type: int = 6):
    w.write_bool(use_global_tree)
    w.write_bool(True)  # default wp
    # forward (header) transform order; the decoder inverts in reverse
    n_tr = int(palette_spec is not None) + int(rct_begin is not None) \
        + int(squeeze_h)
    if n_tr == 0:
        w.write_u32_sel(0, 0, 0)
    elif n_tr == 1:
        w.write_u32_sel(1, 1, 0)
    else:
        w.write_u32_sel(2, n_tr, 4, offset=2)
    if palette_spec is not None:
        w.write(1, 2)  # transform id = Palette
        w.write(0, 2)  # begin_c selector u(3)
        w.write(palette_spec.get("begin_c", 0), 3)
        w.write(0, 2)  # num_c selector 0 -> 1
        w.write(0, 2)  # nb_colours selector u(8)
        w.write(palette_spec["nb_colours"], 8)
        nd = palette_spec.get("nb_deltas", 0)
        if nd == 0:
            w.write(0, 2)
        else:
            w.write(1, 2)
            w.write(nd - 1, 8)
        w.write(palette_spec.get("d_pred", 0), 4)
    if rct_begin is not None:
        w.write(0, 2)  # transform id = RCT
        # begin_c via U32(u(3), 8+u(6), 72+u(10), 1096+u(13))
        assert rct_begin < 8
        w.write(0, 2)
        w.write(rct_begin, 3)
        # rct_type via U32(6, u(2), 2+u(4), 10+u(6))
        if rct_type == 6:
            w.write(0, 2)
        elif rct_type < 4:
            w.write(1, 2)
            w.write(rct_type, 2)
        elif rct_type < 18:
            w.write(2, 2)
            w.write(rct_type - 2, 4)
        else:
            w.write(3, 2)
            w.write(rct_type - 10, 6)
    if squeeze_h:
        w.write(2, 2)  # transform id = Squeeze
        w.write(1, 2)  # num_sq U32 selector 1 (1 + u(4))
        w.write(0, 4)  # -> num_sq = 1
        w.write_bool(True)   # horizontal
        w.write_bool(True)   # in_place
        w.write(0, 2)        # begin_c selector u(3)
        w.write(0, 3)        # begin_c = 0
        w.write(0, 2)        # num_c selector 0 -> 1


def encode_stream_tokens(w: BitWriter, enc: AnsStreamEncoder, channels, predictor):
    values = []
    for arr in channels:
        for r in forward_residuals(arr, predictor):
            values.append(_pack_signed(r))
    if isinstance(enc, Lz77AnsStreamEncoder):
        width = int(channels[0].shape[1]) if len(channels) else 1
        enc.encode_lz77_values(w, values, width)
    elif isinstance(enc, RleAnsStreamEncoder):
        enc.encode_rle_values(w, values)
    else:
        enc.encode_tokens(w, values)


# ---------------------------------------------------------------------------
# Full image encoding


def _encode_patches(w: BitWriter, spec: dict, num_extra: int = 0,
                    num_alpha: int = 1) -> None:
    """Entropy-coded patch list (jxl-frame data/patch.rs): one PatchRef
    with one target; per-target blending info for color + each of
    num_extra ECs (mode per EC from spec["ec_modes"], default NONE).
    spec keys: ref_idx, x0, y0, width, height, x, y, mode
    (PatchBlendMode raw value); optional alpha_channel coded per entry
    when the mode uses alpha and the image has >= 2 alpha ECs."""
    enc = AnsStreamEncoder(10, 64, 6, DEFAULT_CFG)
    enc.write_header(w)
    toks = [
        1,                      # num_patch_refs   (ctx 0)
        spec["ref_idx"],        # ctx 1
        spec["x0"],             # ctx 3
        spec["y0"],             # ctx 3
        spec["width"] - 1,      # ctx 2
        spec["height"] - 1,     # ctx 2
        0,                      # count - 1        (ctx 7)
        spec["x"],              # first target x   (ctx 4)
        spec["y"],              # first target y   (ctx 4)
    ]
    ec_modes = spec.get("ec_modes", [0] * num_extra)
    for mode in [spec["mode"]] + list(ec_modes):
        toks.append(mode)       # ctx 5
        if mode >= 4 and num_alpha >= 2:
            # alpha-channel selector (ctx 8), present per blending entry
            toks.append(int(spec.get("alpha_channel", 0)))
        if mode >= 3:
            toks.append(int(spec.get("clamp", False)))  # ctx 9
    enc.encode_tokens(w, toks)


def _pack_s(v: int) -> int:
    return (v << 1) if v >= 0 else (-(v << 1) - 1)


def _encode_noise(w: BitWriter, lut) -> None:
    """NoiseParameters: 8 x u(10) LUT entries (data/noise.rs)."""
    assert len(lut) == 8
    for v in lut:
        w.write(int(round(v * (1 << 10))) & 0x3FF, 10)


def _encode_splines(w: BitWriter, splines, quant_adjust: int = 0) -> None:
    """Entropy-coded spline list (data/spline.rs): each spline is a dict
    with keys points (list[(x, y)]), xyb_dct [3][32], sigma_dct [32]."""
    enc = AnsStreamEncoder(6, 128, 7, DEFAULT_CFG)
    enc.write_header(w)
    toks = [len(splines) - 1]
    prev = None
    for sp in splines:
        x, y = sp["points"][0]
        if prev is None:
            toks += [x, y]
        else:
            toks += [_pack_s(x - prev[0]), _pack_s(y - prev[1])]
        prev = (x, y)
    toks.append(_pack_s(quant_adjust))
    for sp in splines:
        pts = sp["points"]
        toks.append(len(pts) - 1)
        delta = [0, 0]
        cur = list(pts[0])
        for px, py in pts[1:]:
            ndx, ndy = px - cur[0], py - cur[1]
            toks += [_pack_s(ndx - delta[0]), _pack_s(ndy - delta[1])]
            delta = [ndx, ndy]
            cur = [px, py]
        for c in range(3):
            toks += [_pack_s(int(v)) for v in sp["xyb_dct"][c]]
        toks += [_pack_s(int(v)) for v in sp["sigma_dct"]]
    enc.encode_tokens(w, toks)


def _write_u64(w: BitWriter, v: int) -> None:
    """General U64 writer (Bitstream.read_u64 inverse)."""
    if v == 0:
        w.write(0, 2)
    elif v <= 16:
        w.write(1, 2)
        w.write(v - 1, 4)
    elif v <= 272:
        w.write(2, 2)
        w.write(v - 17, 8)
    else:
        w.write(3, 2)
        w.write(v & 0xFFF, 12)
        v >>= 12
        shift = 12
        while v:
            w.write(1, 1)  # continuation (read before each chunk)
            if shift == 60:
                w.write(v & 0xF, 4)
                return  # decoder breaks after the shift-60 chunk
            w.write(v & 0xFF, 8)
            v >>= 8
            shift += 8
        w.write(0, 1)  # terminator


def _icc_varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def encode_icc_payload(icc: bytes) -> bytes:
    """ICC binary -> the predicted command/data stream decode_icc expects,
    in the degenerate form: header-byte residuals, NO tag list (varint 0),
    then one literal-insert command for everything past byte 128. Valid
    for any profile; no compression gain, which tests don't need."""
    from ..color.icc import _predict_header

    n = len(icc)
    resid = bytearray()
    for i in range(min(128, n)):
        p = _predict_header(i, n & 0xFFFFFFFF, resid)
        resid.append((icc[i] - p) & 0xFF)
    if n <= 128:
        commands = b""
        data = bytes(resid)
    else:
        rest = icc[128:]
        commands = _icc_varint(0) + b"\x01" + _icc_varint(len(rest))
        data = bytes(resid) + rest
    return _icc_varint(n) + _icc_varint(len(commands)) + commands + data


def write_icc_section(out: BitWriter, icc: bytes) -> None:
    """enc_size U64 + 41-context entropy-coded payload bytes (read_icc
    inverse; all 41 contexts map to one cluster via the simple map)."""
    payload = encode_icc_payload(icc)
    _write_u64(out, len(payload))
    # split_exponent == log_alphabet_size == 8: token IS the byte value
    enc = AnsStreamEncoder(
        41, 256, 8, IntegerConfig(split_exponent=8, msb_in_token=0,
                                  lsb_in_token=0)
    )
    enc.write_header(out)
    enc.encode_tokens(out, list(payload))


def encode_jxl_modular(
    channels: list[np.ndarray],
    bit_depth: int = 8,
    grayscale: bool | None = None,
    predictor: int = PRED_GRADIENT,
    rct: bool = False,
    rct_type: int = 6,
    group_size_shift: int = 1,
    animation_frames: list[list[np.ndarray]] | None = None,
    reference_patch: tuple | None = None,
    noise_lut=None,
    splines_spec: tuple | None = None,
    extra_alpha: bool = False,
    extra_alpha_associated: bool = False,
    animation_blend: bool | int | dict = False,
    spot_colour: tuple | None = None,
    upsampling: int = 1,
    do_ycbcr: bool = False,
    jpeg_upsampling: tuple = (0, 0, 0),
    ec_upsampling: list | None = None,
    image_size: tuple | None = None,
    squeeze: bool = False,
    palette_spec: dict | None = None,
    custom_tree: tuple | None = None,
    gabor: bool = False,
    epf_iters: int = 0,
    toc_permutation: list | None = None,
    xyb: bool = False,
    orientation: int = 1,
    crop: tuple | None = None,
    alpha_dim_shift: int = 0,
    lz77_rle: bool = False,
    lz77_matches: bool = False,
    up2_weights: list | None = None,
    opsin_override: dict | None = None,
    preview_channels: list | None = None,
    float_exp_bits: int | None = None,
    extra_channel_specs: list | None = None,  # [{"ty", "name", ...}]
    tone_mapping: tuple | None = None,  # (intensity, min_nits, rel, linear_below)
    intrinsic_size: tuple | None = None,  # (w, h)
    frame_name: str = "",
    animation_params: tuple | None = None,  # (tps_num, tps_den, loops, timecodes)
    lf_dequant: tuple | None = None,  # custom (m_x, m_y, m_b) LF weights
    embed_icc: bytes | None = None,  # want_icc colour encoding + ICC stream
) -> bytes:
    """Encode channel arrays as a lossless Modular bare codestream.

    channels: list of (H, W) integer arrays (1 = grayscale, 3 = RGB).
    """
    assert np.asarray(channels[0]).ndim == 2, (
        "channels must be a LIST of (H, W) planes, not an interleaved "
        "(H, W, C) array"
    )
    assert not (do_ycbcr and any(jpeg_upsampling)), (
        "encoder scope: do_ycbcr modular only at 4:4:4"
    )
    assert not do_ycbcr or not xyb, "do_ycbcr is absent when xyb_encoded"
    h, w = image_size if image_size is not None else channels[0].shape
    ch_h, ch_w = channels[0].shape
    n_ch = len(channels)
    num_extra = ((1 if extra_alpha else 0) + (1 if spot_colour else 0)
                 + len(extra_channel_specs or []))
    num_alpha = ((1 if extra_alpha else 0)
                 + sum(1 for s in (extra_channel_specs or [])
                       if int(s["ty"]) == 0))
    n_color = n_ch - num_extra
    if grayscale is None:
        grayscale = n_color == 1
    if palette_spec is None and not squeeze:
        ec_shifted = extra_alpha and (
            alpha_dim_shift
            or (ec_upsampling and ec_upsampling[0] != upsampling)
        )
        n_full = n_ch - (1 if ec_shifted else 0)
        assert all(c.shape == (ch_h, ch_w) for c in channels[:n_full])

    if rct:
        assert n_ch == 3
        perm, ty = rct_type // 7, rct_type % 7
        disp = [c.astype(np.int64) for c in channels]
        # forward permutation: decoded (d, e, f) = P^-1(display), inverse
        # of rct.rs inverse_permute
        fwd_perm = {
            0: (0, 1, 2), 1: (1, 2, 0), 2: (2, 0, 1),
            3: (0, 2, 1), 4: (1, 0, 2), 5: (2, 1, 0),
        }[perm]
        d, e, f = (disp[i] for i in fwd_perm)
        if ty == 6:
            # forward YCoCg: inverse is tmp=a-(c>>1); e=c+tmp;
            # f=tmp-(b>>1); d=f+b
            co = d - f               # coded channel b
            tmp = f + (co >> 1)
            cg = e - tmp             # coded channel c
            y = tmp + (cg >> 1)      # coded channel a
            enc_channels = [y, co, cg]
        else:
            # inverse: d=a; f=c+a if ty&1 else c; e = b [+a | +((a+f)>>1)]
            a = d
            c_ = f - a if (ty & 1) else f
            if (ty >> 1) == 1:
                b_ = e - a
            elif (ty >> 1) == 2:
                b_ = e - ((a + f) >> 1)
            else:
                b_ = e
            enc_channels = [a, b_, c_]
    else:
        enc_channels = [c.astype(np.int64) for c in channels]

    out = BitWriter()
    # --- ImageHeader ---
    out.write(0x0AFF, 16)
    # SizeHeader: div8=0, height U32 selectors, ratio=0, width
    out.write_bool(False)
    _write_size_u32(out, h)
    out.write(0, 3)  # ratio
    _write_size_u32(out, w)
    # ImageMetadata: all_default=0
    out.write_bool(False)
    if animation_frames is not None:
        out.write_bool(True)   # extra_fields
        out.write(orientation - 1, 3)
        if intrinsic_size is None:
            out.write_bool(False)  # no intrinsic size
        else:
            out.write_bool(True)
            iw, ih = intrinsic_size
            out.write_bool(False)  # div8
            _write_size_u32(out, ih)
            out.write(0, 3)  # ratio
            _write_size_u32(out, iw)
        if preview_channels is None:
            out.write_bool(False)  # no preview
        else:
            out.write_bool(True)
            ph, pw = preview_channels[0].shape
            assert 1 <= ph <= 64 and 1 <= pw <= 64
            out.write_bool(False)  # div8 = 0
            out.write(0, 2)        # height selector 0: 1 + u(6)
            out.write(ph - 1, 6)
            out.write(0, 3)        # ratio = 0
            out.write(0, 2)        # width selector 0
            out.write(pw - 1, 6)
        out.write_bool(True)   # animation
        if animation_params is None:
            # AnimationHeader: tps 100/1, loops 0, no timecodes
            out.write(0, 2)  # tps_numerator = 100
            out.write(0, 2)  # tps_denominator = 1
            out.write(0, 2)  # num_loops = 0
            out.write_bool(False)  # have_timecodes
        else:
            tn, td, loops, timecodes = animation_params
            out.write(2, 2)          # tps_numerator 1 + u(10)
            out.write(tn - 1, 10)
            out.write(2, 2)          # tps_denominator 1 + u(8)
            out.write(td - 1, 8)
            out.write(1, 2)          # num_loops u(3)
            out.write(loops, 3)
            out.write_bool(bool(timecodes))
    elif (orientation != 1 or preview_channels is not None
          or tone_mapping is not None or intrinsic_size is not None):
        out.write_bool(True)   # extra_fields
        out.write(orientation - 1, 3)
        if intrinsic_size is None:
            out.write_bool(False)  # no intrinsic size
        else:
            out.write_bool(True)
            iw, ih = intrinsic_size
            out.write_bool(False)  # div8
            _write_size_u32(out, ih)
            out.write(0, 3)  # ratio
            _write_size_u32(out, iw)
        if preview_channels is None:
            out.write_bool(False)  # no preview
        else:
            out.write_bool(True)
            ph, pw = preview_channels[0].shape
            assert 1 <= ph <= 64 and 1 <= pw <= 64
            out.write_bool(False)  # div8 = 0
            out.write(0, 2)        # height selector 0: 1 + u(6)
            out.write(ph - 1, 6)
            out.write(0, 3)        # ratio = 0
            out.write(0, 2)        # width selector 0
            out.write(pw - 1, 6)
        out.write_bool(False)  # no animation
    else:
        out.write_bool(False)  # no extra_fields
    _write_bit_depth(out, bit_depth, float_exp_bits)
    # modular_16bit_buffers: promise that every modular sample (including
    # transform intermediates) fits i16 — only honest for small depths
    # (squeeze/RCT expand the range by a few bits)
    # modular_16bit_buffers: a conformant encoder must clear it when any
    # channel's samples exceed 16-bit patterns (float-sample ECs store
    # raw bit patterns; narrow i16 buffers would wrap them — the
    # reference narrows purely on this flag, lib.rs:280-282)
    ec_wide = any(
        spec.get("float_exp_bits") is not None and spec.get("bits", bit_depth) > 16
        for spec in (extra_channel_specs or [])
    )
    out.write_bool(bit_depth <= 12 and float_exp_bits is None and not ec_wide)
    if num_extra == 1:
        out.write(1, 2)  # num_extra U32 selector 1 (= 1)
    elif num_extra:
        out.write(2, 2)
        out.write(num_extra - 2, 4)
    else:
        out.write_u32_sel(0, 0, 0)  # num_extra = 0
    if extra_alpha:
        if alpha_dim_shift == 0:
            out.write_bool(True)  # d_alpha: default alpha channel
        else:
            # full ExtraChannelInfo with a nonzero dim_shift: the alpha
            # channel is coded at (w, h) >> dim_shift and upsampled at
            # render time by ec_upsampling << dim_shift
            out.write_bool(False)
            _write_enum(out, 0)  # Alpha
            _write_bit_depth(out, bit_depth)
            # dim_shift U32(0, 3, 4, 1+u(3))
            if alpha_dim_shift == 3:
                out.write(1, 2)
            elif alpha_dim_shift == 4:
                out.write(2, 2)
            else:
                out.write(3, 2)
                out.write(alpha_dim_shift - 1, 3)
            out.write_u32_sel(0, 0, 0)  # name len 0
            out.write_bool(extra_alpha_associated)  # alpha_associated
    if spot_colour:
        out.write_bool(False)  # not default
        _write_enum(out, 2)  # SpotColour
        _write_bit_depth(out, bit_depth)
        out.write(0, 2)  # dim_shift = 0
        out.write_u32_sel(0, 0, 0)  # name len 0
        for v in spot_colour:  # (r, g, b, solidity) f16s
            out.write(int(np.float16(v).view(np.uint16)), 16)
    for spec in (extra_channel_specs or []):
        # full ExtraChannelInfo for any type (Depth/CFA/Thermal/...)
        out.write_bool(False)
        out_ty = int(spec["ty"])
        _write_enum(out, out_ty)
        _write_bit_depth(out, spec.get("bits", bit_depth),
                         spec.get("float_exp_bits"))
        out.write(0, 2)  # dim_shift = 0
        nm = spec.get("name", "").encode("utf-8")
        if nm:
            assert 1 <= len(nm) <= 15
            out.write(1, 2)  # name len u(4)
            out.write(len(nm), 4)
            for byte in nm:
                out.write(byte, 8)
        else:
            out.write_u32_sel(0, 0, 0)
        if out_ty == 0:
            out.write_bool(bool(spec.get("alpha_associated", False)))
        elif out_ty == 2:
            for v in spec["spot_colour"]:
                out.write(int(np.float16(v).view(np.uint16)), 16)
        elif out_ty == 5:
            cfa = int(spec.get("cfa_channel", 1))
            if cfa == 1:
                out.write(0, 2)
            else:
                out.write(1, 2)
                out.write(cfa, 2)
    out.write_bool(xyb)  # xyb_encoded
    # colour_encoding
    if embed_icc is not None:
        assert not xyb, "embedded-ICC samples are non-XYB"
        out.write_bool(False)  # not all_default
        out.write_bool(True)  # want_icc
        _write_enum(out, 1 if grayscale else 0)  # Grey / RGB
    elif grayscale:
        out.write_bool(False)  # not all_default
        out.write_bool(False)  # want_icc = false
        _write_enum(out, 1)  # Grey
        _write_enum(out, 1)  # white point D65
        # primaries skipped for grey
        out.write_bool(False)  # tf: not gamma
        _write_enum(out, 13)  # sRGB tf
        _write_enum(out, 1)  # relative intent
    else:
        out.write_bool(True)  # all_default -> sRGB
    if (animation_frames is not None or orientation != 1
            or preview_channels is not None or tone_mapping is not None
            or intrinsic_size is not None):
        if tone_mapping is None:
            out.write_bool(True)  # tone_mapping all_default
        else:
            out.write_bool(False)
            it, mn, rel, lb = tone_mapping
            for v in (it, mn):
                out.write(int(np.float16(v).view(np.uint16)), 16)
            out.write_bool(bool(rel))
            out.write(int(np.float16(lb).view(np.uint16)), 16)
    out.write_u64_zero()  # extensions
    if up2_weights is None and opsin_override is None:
        out.write_bool(True)  # default_m
    else:
        # CustomTransformData (lib.rs:163-168): optional opsin inverse
        # matrix override (xyb streams only) + custom upsampling weights
        out.write_bool(False)

        def _f16w(v):
            out.write(int(np.float16(v).view(np.uint16)), 16)

        if xyb:
            if opsin_override is None:
                out.write_bool(True)  # opsin all_default
            else:
                out.write_bool(False)
                for row in opsin_override["inv_mat"]:
                    for v in row:
                        _f16w(v)
                for v in opsin_override["opsin_bias"]:
                    _f16w(v)
                for v in opsin_override["quant_bias"]:
                    _f16w(v)
                _f16w(opsin_override["quant_bias_numerator"])
        else:
            assert opsin_override is None, "opsin override needs xyb"
        if up2_weights is None:
            out.write(0, 3)  # cw_mask: none
        else:
            assert len(up2_weights) == 15
            out.write(1, 3)  # cw_mask: up2 only
            for v in up2_weights:
                _f16w(v)
    if embed_icc is not None:
        # ICC stream directly after ImageHeader (read_icc position)
        write_icc_section(out, embed_icc)
    out.zero_pad_to_byte()  # frames start byte-aligned (Frame::parse)

    def _write_one_frame(enc_channels, duration, is_last, frame_type=0,
                         save_as_reference=0, patch_spec=None,
                         noise_lut=None, splines_spec=None,
                         blend=False, crop=None, dims=None,
                         is_preview=False):
        out.zero_pad_to_byte()
        # --- FrameHeader ---
        out.write_bool(False)  # not all_default
        out.write(frame_type, 2)
        out.write(1, 1)  # encoding modular
        # flags U64: bit 0 = noise, bit 1 = patches, bit 4 = splines
        flags = 0
        if noise_lut is not None:
            flags |= 0x1
        if patch_spec is not None:
            flags |= 0x2
        if splines_spec is not None:
            flags |= 0x10
        if flags == 0:
            out.write_u64_zero()
        elif flags <= 16:
            out.write(1, 2)  # U64 selector: 1 + u(4)
            out.write(flags - 1, 4)
        else:
            out.write(2, 2)  # U64 selector: 17 + u(8)
            out.write(flags - 17, 8)
        if not xyb:
            out.write_bool(do_ycbcr)  # absent when xyb_encoded
        if do_ycbcr:
            for v in jpeg_upsampling:
                out.write(v, 2)
        out.write({1: 0, 2: 1, 4: 2, 8: 3}[upsampling], 2)  # upsampling
        for i in range(num_extra):
            eu = ec_upsampling[i] if ec_upsampling else 1
            out.write({1: 0, 2: 1, 4: 2, 8: 3}[eu], 2)
        out.write(group_size_shift, 2)
        if frame_type != 2:  # ReferenceOnly has no Passes
            out.write_u32_sel(0, 0, 0)  # num_passes = 1
        if crop is None:
            out.write_bool(False)  # have_crop
        else:
            out.write_bool(True)
            cx0, cy0, cw, chh = crop

            def _crop_u32(v):
                # U32(u(8), 256+u(11), 2304+u(14), 18688+u(30))
                if v < 256:
                    out.write(0, 2)
                    out.write(v, 8)
                elif v < 2304:
                    out.write(1, 2)
                    out.write(v - 256, 11)
                else:
                    out.write(2, 2)
                    out.write(v - 2304, 14)

            def _pk(v):
                return (v << 1) if v >= 0 else (-(v << 1) - 1)

            if frame_type != 2:
                _crop_u32(_pk(cx0))
                _crop_u32(_pk(cy0))
            _crop_u32(cw)
            _crop_u32(chh)
        if frame_type in (0, 3):  # is_normal: blending/duration/is_last
            if blend:
                # blend spec: True = Blend(2); int = that BlendMode raw
                # value; dict allows {"mode", "ec_mode", "clamp"}.
                # Wire format (header.rs BlendingInfo): mode U32(0,1,2,
                # 3+u(2)); alpha_channel iff have_extra and use_alpha;
                # clamp iff (have_extra and use_alpha) or mode==Mul;
                # source iff the effective mode doesn't reset the canvas.
                bmode, bclamp, balpha = 2, False, 0
                ec_mode = None
                if blend is not True:
                    if isinstance(blend, dict):
                        bmode = int(blend.get("mode", 2))
                        bclamp = bool(blend.get("clamp", False))
                        balpha = int(blend.get("alpha_channel", 0))
                        ec_mode = blend.get("ec_mode")
                    else:
                        bmode = int(blend)
                assert 1 <= bmode <= 4, "blending main mode must not reset"

                def _binfo(mode, clamp):
                    if mode < 3:
                        out.write(mode, 2)
                    else:
                        out.write(3, 2)
                        out.write(mode - 3, 2)
                    use_alpha = mode in (2, 3)  # Blend / MulAdd
                    if num_extra and use_alpha:
                        # alpha_channel U32(0, 1, 2, 3 + u(3))
                        if balpha < 3:
                            out.write(balpha, 2)
                        else:
                            out.write(3, 2)
                            out.write(balpha - 3, 3)
                    if (num_extra and use_alpha) or mode == 4:
                        out.write_bool(clamp)
                    out.write(1, 2)  # source = slot 1 (prev frame there)

                _binfo(bmode, bclamp)
                for _ in range(num_extra):
                    # alpha ECs: Blend means MixAlpha on themselves;
                    # other ECs/modes follow ec_mode (default = main)
                    _binfo(bmode if ec_mode is None else int(ec_mode),
                           bclamp)
            else:
                out.write_u32_sel(0, 0, 0)  # blending mode Replace
                if crop is not None:
                    out.write(0, 2)  # source (crop Replace keeps canvas)
                for _ in range(num_extra):
                    out.write_u32_sel(0, 0, 0)  # EC blending Replace
                    if crop is not None:
                        out.write(0, 2)  # EC source
            if animation_frames is not None and not is_preview:
                # duration U32(0, 1, U(8), U(32))
                if duration == 0:
                    out.write(0, 2)
                elif duration == 1:
                    out.write(1, 2)
                else:
                    out.write(2, 2)
                    out.write(duration, 8)
                if animation_params is not None and animation_params[3]:
                    out.write(duration * 100, 32)  # timecode
            if not is_preview:
                out.write_bool(is_last)
            # preview frames: is_last is not coded (defaults true)
        else:
            is_last = False
        if not is_last:
            out.write(save_as_reference, 2)
        # save_before_ct: present iff (header.rs:119-128) the frame is
        # ReferenceOnly, or resets the canvas while being a non-last
        # zero-duration/referenced frame. resets_canvas here: normal frame
        # with full-canvas Replace blending (blend=False, crop=None).
        resets_canvas = frame_type in (0, 3) and not blend and crop is None
        if frame_type == 2 or (
            resets_canvas
            and not is_last
            and (duration == 0 or save_as_reference != 0)
        ):
            out.write_bool(False)  # save_before_ct
        if frame_name:
            nm = frame_name.encode("utf-8")
            assert 1 <= len(nm) <= 15
            out.write(1, 2)  # name len u(4)
            out.write(len(nm), 4)
            for byte in nm:
                out.write(byte, 8)
        else:
            out.write_u32_sel(0, 0, 0)  # name len = 0
        # RestorationFilter: not default
        out.write_bool(False)
        if gabor:
            out.write_bool(True)   # gab on
            out.write_bool(False)  # default weights
        else:
            out.write_bool(False)  # gab off
        out.write(epf_iters, 2)
        if epf_iters:
            # modular encoding: no sharp_lut bool; sigma_for_modular f16
            out.write_bool(False)  # channel_scale default
            out.write_bool(False)  # sigma default
            out.write(0x3C00, 16)  # sigma_for_modular = 1.0 (f16)
        out.write_u64_zero()  # rf extensions
        out.write_u64_zero()  # frame extensions

        # --- sections ---
        fh, fw = dims if dims is not None else (h, w)
        group_dim = 128 << group_size_shift
        gpr = -(-fw // group_dim)
        gpc = -(-fh // group_dim)
        num_groups = gpr * gpc
        single = num_groups == 1  # num_passes == 1

        # coded channel list: (array, hshift, vshift). The in-place
        # horizontal squeeze of channel 0 codes [avg, res, c1, c2] with
        # hshift 1 on avg/res (modular_transform.py Squeeze.check)
        if squeeze:
            avg0, res0 = _forward_squeeze_h(enc_channels[0])
            coded = ([(avg0, 1, 0), (res0, 1, 0)]
                     + [(c, 0, 0) for c in enc_channels[1:]])
        else:
            coded = [(c, 0, 0) for c in enc_channels]

        global_channels = []
        group_channels: dict[int, list[np.ndarray]] = {}
        if fw <= group_dim and fh <= group_dim:
            global_channels = [c for c, _, _ in coded]
        else:
            rest = coded
            if squeeze:
                # image.rs prepare_gmodular take_while: leading coded
                # channels that fit group_dim decode in the LfGlobal
                # stream (a squeezed avg/res can fit while the full
                # channels do not)
                n_glob = 0
                for c, _, _ in coded:
                    if c.shape[0] <= group_dim and c.shape[1] <= group_dim:
                        n_glob += 1
                    else:
                        break
                global_channels = [c for c, _, _ in coded[:n_glob]]
                rest = coded[n_glob:]
            for ch, hs_c, vs_c in rest:
                # per-channel tile = group_dim >> shift; the group grid
                # comes from the ORIGINAL (unsqueezed) dims, which the
                # squeeze preserves (prepare_groups, modular.py:216-221)
                gw_t = group_dim >> hs_c
                gh_t = group_dim >> vs_c
                for gy in range(gpc):
                    for gx in range(gpr):
                        gi = gy * gpr + gx
                        tile = ch[
                            gy * gh_t : (gy + 1) * gh_t,
                            gx * gw_t : (gx + 1) * gw_t,
                        ]
                        if tile.size == 0:
                            continue
                        group_channels.setdefault(gi, []).append(tile)

        # LfGlobal section
        lf = BitWriter()
        if patch_spec is not None:
            _encode_patches(lf, patch_spec, num_extra, num_alpha)
        if splines_spec is not None:
            _encode_splines(lf, *splines_spec)
        if noise_lut is not None:
            _encode_noise(lf, noise_lut)
        if lf_dequant is None:
            lf.write_bool(True)  # lf_dequant all_default
        else:
            lf.write_bool(False)
            for v in lf_dequant:
                lf.write(int(np.float16(v).view(np.uint16)), 16)
        lf.write_bool(True)  # has global MA tree
        # huge samples (float-sample ECs store raw bit patterns, e.g.
        # ~2^30 for f32) overflow the 256-token alphabet under the
        # default msb/lsb=2 config; fall back to a pure-exponent config
        # (token == bit length) whose tokens stay < 64 for any i64
        vmax = max(
            (int(np.abs(np.asarray(c)).max()) if np.asarray(c).size else 0
             for c in enc_channels),
            default=0,
        )
        cfg = (
            IntegerConfig(split_exponent=4, msb_in_token=0, lsb_in_token=0)
            if vmax >= (1 << 16) else None
        )
        if custom_tree is not None:
            tree_tokens, num_leaves, token_fn = custom_tree
            sample_enc = write_ma_config_tree(lf, tree_tokens, num_leaves,
                                              cfg=cfg)
        else:
            sample_enc = write_ma_config(lf, predictor, lz77_rle=lz77_rle,
                                         lz77_matches=lz77_matches, cfg=cfg)
        write_modular_header(lf, use_global_tree=True,
                             rct_begin=0 if rct else None,
                             squeeze_h=squeeze, palette_spec=palette_spec,
                             rct_type=rct_type)
        if custom_tree is not None:
            sample_enc.encode_tokens(lf, token_fn(global_channels))
        elif global_channels:
            encode_stream_tokens(lf, sample_enc, global_channels, predictor)
        else:
            # empty global stream: begin + finalize only
            sample_enc.encode_tokens(lf, [])

        sections = [lf]
        if not single:
            # empty LF-group sections + HfGlobal + per-group pass sections
            num_lf_groups = (-(-fw // (group_dim * 8))) * (-(-fh // (group_dim * 8)))
            for _ in range(num_lf_groups):
                sections.append(BitWriter())
            sections.append(BitWriter())  # HfGlobal (empty for modular)
            for gi in range(num_groups):
                gw = BitWriter()
                chs = group_channels.get(gi, [])
                write_modular_header(gw, use_global_tree=True)
                enc2 = AnsStreamEncoder(1, 256, 8, DEFAULT_CFG)
                # use_global_tree -> distributions come from the global
                # MaConfig; the per-group stream holds only state+tokens.
                encode_stream_tokens(gw, sample_enc, chs, predictor)
                sections.append(gw)

        section_bytes = [s.to_bytes() for s in sections]

        # --- TOC ---
        if toc_permutation is not None:
            p = list(toc_permutation)
            assert sorted(p) == list(range(len(section_bytes)))
            out.write_bool(True)  # permuted TOC
            perm_enc = AnsStreamEncoder(8, 64, 6, DEFAULT_CFG)
            perm_enc.write_header(out)
            lehmer = []
            temp = list(range(len(p)))
            for target in p:
                v = temp.index(target)
                lehmer.append(v)
                temp.pop(v)
            perm_enc.encode_tokens(out, [len(p)] + lehmer)
            # bitstream slot s holds original section o with p[o] == s
            inv = [0] * len(p)
            for o, slot in enumerate(p):
                inv[slot] = o
            section_bytes = [section_bytes[inv[slot]]
                             for slot in range(len(p))]
        else:
            out.write_bool(False)  # not permuted
        out.zero_pad_to_byte()
        for sb in section_bytes:
            _write_toc_size(out, len(sb))
        out.zero_pad_to_byte()
        for sb in section_bytes:
            for byte in sb:
                out.write(byte, 8)

    if preview_channels is not None:
        # preview frame (skipped by the decoder; lib.rs:384-411): a
        # complete regular frame over the PreviewHeader canvas
        _write_one_frame(
            [c.astype(np.int64) for c in preview_channels], 0, True,
            dims=preview_channels[0].shape, is_preview=True,
        )

    if reference_patch is not None:
        ref_channels, patch_spec = reference_patch
        _write_one_frame(
            [c.astype(np.int64) for c in ref_channels], 0, False,
            frame_type=2, save_as_reference=patch_spec.get("ref_idx", 0),
        )
        _write_one_frame(enc_channels, duration=0, is_last=True,
                         patch_spec=patch_spec)
    elif animation_frames is not None:
        all_frames = [
            [c.astype(np.int64) for c in fchans]
            for fchans in animation_frames
        ]
        for fi, fchans in enumerate(all_frames):
            _write_one_frame(fchans, duration=1,
                             is_last=fi == len(all_frames) - 1,
                             blend=animation_blend if fi > 0 else False,
                             save_as_reference=1 if animation_blend else 0)
    else:
        _write_one_frame(enc_channels, duration=0, is_last=True,
                         noise_lut=noise_lut, splines_spec=splines_spec,
                         crop=crop)
    return out.to_bytes()


def _write_size_u32(w: BitWriter, v: int):
    # U32(1+u(9), 1+u(13), 1+u(18), 1+u(30))
    if v <= 1 << 9:
        w.write_u32_sel(0, v, 9, 1)
    elif v <= 1 << 13:
        w.write_u32_sel(1, v, 13, 1)
    elif v <= 1 << 18:
        w.write_u32_sel(2, v, 18, 1)
    else:
        w.write_u32_sel(3, v, 30, 1)


def _write_bit_depth(w: BitWriter, bits, float_exp_bits: int | None = None):
    if float_exp_bits is not None:
        # float samples (BitDepth float form): bits u32(32,16,24,1+u6)
        w.write_bool(True)
        if bits == 32:
            w.write(0, 2)
        elif bits == 16:
            w.write(1, 2)
        elif bits == 24:
            w.write(2, 2)
        else:
            w.write(3, 2)
            w.write(bits - 1, 6)
        w.write(float_exp_bits - 1, 4)
        return
    w.write_bool(False)  # integer samples
    if bits == 8:
        w.write(0, 2)
    elif bits == 10:
        w.write(1, 2)
    elif bits == 12:
        w.write(2, 2)
    else:
        w.write(3, 2)
        w.write(bits - 1, 6)


def _write_enum(w: BitWriter, v: int):
    # read_u32(0, 1, 2+u(4), 18+u(6))
    if v == 0:
        w.write(0, 2)
    elif v == 1:
        w.write(1, 2)
    elif v < 18:
        w.write(2, 2)
        w.write(v - 2, 4)
    else:
        w.write(3, 2)
        w.write(v - 18, 6)


def _write_toc_size(w: BitWriter, size: int):
    # U32(u(10), 1024+u(14), 17408+u(22), 4211712+u(30))
    if size < 1024:
        w.write_u32_sel(0, size, 10)
    elif size < 17408:
        w.write_u32_sel(1, size, 14, 1024)
    elif size < 4211712:
        w.write_u32_sel(2, size, 22, 17408)
    else:
        w.write_u32_sel(3, size, 30, 4211712)

