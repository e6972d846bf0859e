"""Minimal JPEG XL Modular encoder — TEST INFRASTRUCTURE ONLY.

The benchmark's frozen copy of jxl_oxide_tpu_torch/encoders/encoder.py
(itself a JAX-free copy of tools/encoder.py): what it took from the
port's modules now comes from `_support.py`, so it imports nothing of
the port and a change to the port never changes the benchmark's inputs.
Arguments, asserts and bytes are those of the port's copy
(portbench/tests/test_portbench_streams.py holds the bytes equal).
Only what the VarDCT encoder uses is kept: the bit writer, the rANS
stream encoder and the Modular headers and token streams of its LF and
HF metadata sections.

Deliberately simple: rANS with flat (evenly distributed) histograms, simple
cluster maps, single-leaf or table MA trees. Compression ratio is irrelevant;
only spec validity and decoder coverage matter. The rANS encoder derives its
alias tables by round-tripping the histogram header through the DECODER's
parser, guaranteeing table consistency.
"""

from __future__ import annotations

from ._support import AnsHistogram, IntegerConfig
from ._support import Bitstream


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
        from ._support import add_log2_ceil

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
        from ._support import add_log2_ceil

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


# ---------------------------------------------------------------------------
# Modular sub-stream encoding


class Lz77AnsStreamEncoder(AnsStreamEncoder):
    """LZ77 stream with GENERAL matches (not the RLE shape): every
    distribution incl. the distance one maps to one shared cluster, so
    distance tokens are plain hybrid-uint values. Used to drive the
    decoder's generic LZ77 window path with 2-D special distances
    (jxl-coding lib.rs:487-569) through full images."""

    def write_header(self, w: BitWriter):
        from ._support import add_log2_ceil

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


# ---------------------------------------------------------------------------
# Full image encoding


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

