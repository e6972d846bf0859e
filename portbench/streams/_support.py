"""What the frozen encoders take from the decoder's modules, copied out of
`jxl_oxide_tpu_torch` (io/bitstream.py, coding/entropy.py,
headers/image.py, models/vardct.py, ops/dct.py,
models/modular_transform.py, color/icc.py) with the parsers left out: the
bitstream reader and the ANS histogram the encoder reads its own
histograms back with, the hybrid-integer configuration, the opsin and
quantization defaults, the transform types and their coefficient orders,
the default dequantization matrices and the forward DCT basis. Numpy
only; nothing here imports the port,
so a change to the port never changes the benchmark's streams."""

from __future__ import annotations

import functools
import struct
from dataclasses import dataclass

import numpy as np


class JxlBitstreamError(ValueError):
    """A malformed bitstream (the encoders never read one)."""


class JxlEofError(JxlBitstreamError):
    """A read past the end of a bitstream."""


class JxlValidationError(ValueError):
    """A value out of the range the format allows."""


# --- from io/bitstream.py ---
@dataclass(frozen=True)
class U:
    """`u(n)`: read n raw bits (optionally with additive offset)."""

    bits: int
    offset: int = 0

    def __radd__(self, offset: int) -> "U":
        return U(self.bits, self.offset + offset)

U32Spec = int | U

class Bitstream:
    """Bit reader over an immutable bytes-like buffer.

    Unlike the reference's 64-bit sliding buffer, we track an absolute bit
    position; Python-int shifts on small windows keep this simple and exactly
    equivalent (each byte's bits are consumed LSB first).
    """

    __slots__ = ("data", "pos", "_len_bits")

    def __init__(self, data: bytes | bytearray | memoryview, pos: int = 0):
        self.data = bytes(data)
        self.pos = pos
        self._len_bits = len(self.data) * 8

    # -- core ------------------------------------------------------------

    def remaining_bits(self) -> int:
        return self._len_bits - self.pos

    def num_read_bits(self) -> int:
        return self.pos

    def read_bits(self, n: int) -> int:
        """Read n (<= 57 typical, any n supported) bits, LSB-first."""
        pos = self.pos
        end = pos + n
        if end > self._len_bits:
            raise JxlEofError(f"need {n} bits at {pos}, have {self._len_bits - pos}")
        first_byte = pos >> 3
        last_byte = (end + 7) >> 3
        window = int.from_bytes(self.data[first_byte:last_byte], "little")
        self.pos = end
        return (window >> (pos & 7)) & ((1 << n) - 1)

    def peek_bits(self, n: int) -> int:
        """Peek up to n bits without consuming; short reads past EOF return
        zero-extended bits (matches the reference's refill-with-zeros tail
        behavior used by entropy decoders near stream end)."""
        pos = self.pos
        avail = self._len_bits - pos
        first_byte = pos >> 3
        end = pos + n
        last_byte = (end + 7) >> 3
        window = int.from_bytes(self.data[first_byte:last_byte], "little")
        out = (window >> (pos & 7)) & ((1 << n) - 1)
        if avail < 0:
            raise JxlEofError("peek past end")
        return out

    def consume_bits(self, n: int) -> None:
        if self.pos + n > self._len_bits:
            raise JxlEofError("consume past end")
        self.pos += n

    def skip_bits(self, n: int) -> None:
        self.consume_bits(n)

    def read_bool(self) -> bool:
        return self.read_bits(1) != 0

    def zero_pad_to_byte(self) -> None:
        n = (-self.pos) % 8
        if n and self.read_bits(n) != 0:
            raise JxlBitstreamError("non-zero padding bits")

    # -- spec primitives ---------------------------------------------------

    def read_u32(self, d0: U32Spec, d1: U32Spec, d2: U32Spec, d3: U32Spec) -> int:
        d = (d0, d1, d2, d3)[self.read_bits(2)]
        if isinstance(d, int):
            return d
        return (self.read_bits(d.bits) + d.offset) & 0xFFFFFFFF

    def read_u64(self) -> int:
        sel = self.read_bits(2)
        if sel == 0:
            return 0
        if sel == 1:
            return self.read_bits(4) + 1
        if sel == 2:
            return self.read_bits(8) + 17
        value = self.read_bits(12)
        shift = 12
        while self.read_bits(1) == 1:
            if shift == 60:
                value |= self.read_bits(4) << shift
                break
            value |= self.read_bits(8) << shift
            shift += 8
        return value

    def read_f16_as_f32(self) -> float:
        import struct

        v = self.read_bits(16)
        sign = -1.0 if (v & 0x8000) else 1.0
        if v & 0x7FFF == 0:
            return sign * 0.0
        mantissa = v & 0x3FF
        exponent = (v >> 10) & 0x1F
        if exponent == 0x1F:
            raise JxlBitstreamError("F16 NaN/Inf not allowed")
        if exponent == 0:
            return sign * (1.0 / 16384.0) * (mantissa / 1024.0)
        bits = (mantissa << 13) | ((exponent + 112) << 23)
        out = struct.unpack("<f", struct.pack("<I", bits))[0]
        return sign * out

    def read_enum(self, enum_cls):
        v = self.read_u32(0, 1, 2 + U(4), 18 + U(6))
        try:
            return enum_cls(v)
        except ValueError:
            raise JxlBitstreamError(f"invalid {enum_cls.__name__} value {v}") from None


# --- from coding/entropy.py ---
ANS_PRECISION_BITS = 12

def add_log2_ceil(x: int) -> int:
    # Matches reference add_log2_ceil: (x+1).next_power_of_two().trailing_zeros()
    if x >= 0x80000000:
        return 32
    v = x + 1
    p = 1
    n = 0
    while p < v:
        p <<= 1
        n += 1
    return n

def _read_u8_coded(bs: Bitstream) -> int:
    """Variable u8 coding used by ANS histograms (ans.rs read_u8)."""
    if bs.read_bool():
        n = bs.read_bits(3)
        return (1 << n) + bs.read_bits(n)
    return 0

class AnsHistogram:
    __slots__ = (
        "log_bucket_size",
        "bucket_mask",
        "dist",
        "alias_symbol",
        "alias_cutoff",
        "alias_offset",
        "single_symbol",
    )

    def __init__(self, bs: Bitstream, log_alphabet_size: int):
        table_size = 1 << log_alphabet_size
        log_bucket_size = ANS_PRECISION_BITS - log_alphabet_size
        bucket_size = 1 << log_bucket_size
        self.log_bucket_size = log_bucket_size
        self.bucket_mask = bucket_size - 1

        dist = self._parse_distribution(bs, table_size)
        self.dist = dist

        # Single-symbol fast path: one bucket has the full 2^12 mass.
        single = None
        for i, d in enumerate(dist):
            if d == (1 << ANS_PRECISION_BITS):
                single = i
                break
        self.single_symbol = single

        n = table_size
        alias_symbol = np.zeros(n, dtype=np.int32)
        alias_cutoff = np.zeros(n, dtype=np.int32)
        alias_offset = np.zeros(n, dtype=np.int32)
        if single is not None:
            for i in range(n):
                alias_symbol[i] = single
                alias_offset[i] = bucket_size * i
                alias_cutoff[i] = 0
        else:
            # Normative alias mapping: stacks of underfull/overfull buckets.
            sym = list(range(n))
            cutoff = list(dist)
            offset = [0] * n
            underfull = [i for i in range(n) if dist[i] < bucket_size]
            overfull = [i for i in range(n) if dist[i] > bucket_size]
            while overfull and underfull:
                o = overfull.pop()
                u = underfull.pop()
                by = bucket_size - cutoff[u]
                cutoff[o] -= by
                sym[u] = o
                offset[u] = cutoff[o]
                if cutoff[o] < bucket_size:
                    underfull.append(o)
                elif cutoff[o] > bucket_size:
                    overfull.append(o)
            for i in range(n):
                if cutoff[i] == bucket_size:
                    alias_symbol[i] = i
                    alias_offset[i] = 0
                    alias_cutoff[i] = 0
                else:
                    alias_symbol[i] = sym[i]
                    alias_offset[i] = offset[i] - cutoff[i]
                    alias_cutoff[i] = cutoff[i]
        self.alias_symbol = alias_symbol
        self.alias_cutoff = alias_cutoff
        self.alias_offset = alias_offset

    # -- parsing -----------------------------------------------------------

    @staticmethod
    def _parse_distribution(bs: Bitstream, table_size: int) -> list[int]:
        dist = [0] * table_size
        if bs.read_bool():
            if bs.read_bool():
                # binary: two symbols with 12-bit split
                v0 = _read_u8_coded(bs)
                v1 = _read_u8_coded(bs)
                if v0 == v1 or max(v0, v1) + 1 > table_size:
                    raise JxlBitstreamError("invalid binary ANS histogram")
                prob = bs.read_bits(12)
                dist[v0] = prob
                dist[v1] = (1 << 12) - prob
            else:
                # unary: single symbol
                val = _read_u8_coded(bs)
                if val + 1 > table_size:
                    raise JxlBitstreamError("invalid unary ANS histogram")
                dist[val] = 1 << 12
            return dist
        if bs.read_bool():
            # evenly distributed over alphabet
            alphabet_size = _read_u8_coded(bs) + 1
            if alphabet_size > table_size:
                raise JxlBitstreamError("invalid flat ANS histogram")
            base = (1 << 12) // alphabet_size
            leftover = (1 << 12) % alphabet_size
            for i in range(alphabet_size):
                dist[i] = base + (1 if i < leftover else 0)
            return dist

        # compressed distribution: prefix-coded log counts + repeat-13 RLE,
        # max entry omitted and reconstructed from the remainder.
        length = 0
        while length < 3 and bs.read_bool():
            length += 1
        shift = bs.read_bits(length) + (1 << length) - 1
        if shift > 13:
            raise JxlBitstreamError("invalid ANS histogram shift")
        alphabet_size = _read_u8_coded(bs) + 3
        if alphabet_size > table_size:
            raise JxlBitstreamError("ANS alphabet too large")

        codes = [0] * table_size
        repeat_ranges: list[tuple[int, int]] = []
        omit_log = -1
        omit_pos = -1
        idx = 0
        while idx < alphabet_size:
            c = _read_log_count(bs)
            codes[idx] = c
            if c == 13:
                repeat_count = _read_u8_coded(bs) + 4
                if idx + repeat_count > alphabet_size:
                    raise JxlBitstreamError("ANS repeat overruns alphabet")
                repeat_ranges.append((idx, idx + repeat_count))
                idx += repeat_count
                continue
            if omit_pos < 0 or c > omit_log:
                omit_log = c
                omit_pos = idx
            idx += 1
        if omit_pos < 0:
            raise JxlBitstreamError("no ANS omit position")
        if omit_pos + 1 < table_size and codes[omit_pos + 1] == 13:
            raise JxlBitstreamError("ANS omit followed by repeat")

        rr_idx = 0
        acc = 0
        prev = 0
        for i in range(table_size):
            if rr_idx < len(repeat_ranges) and repeat_ranges[rr_idx][0] <= i:
                if repeat_ranges[rr_idx][1] == i:
                    rr_idx += 1
                else:
                    dist[i] = prev
                    acc += prev
                    if acc > (1 << 12):
                        raise JxlBitstreamError("ANS distribution overflow")
                    continue
            c = codes[i]
            if c == 0 or i == omit_pos:
                prev = 0
                continue
            if c > 1:
                zeros = c - 1
                bitcount = shift - ((12 - zeros) >> 1)
                bitcount = max(0, min(zeros, bitcount))
                c = (1 << zeros) + (bs.read_bits(bitcount) << (zeros - bitcount))
            dist[i] = c
            prev = c
            acc += c
            if acc > (1 << 12):
                raise JxlBitstreamError("ANS distribution overflow")
        dist[omit_pos] = (1 << 12) - acc
        return dist

    # -- decode ------------------------------------------------------------

    def read_symbol(self, bs: Bitstream, state: int) -> tuple[int, int]:
        """Decode one symbol; returns (symbol, next_state)."""
        idx = state & 0xFFF
        i = idx >> self.log_bucket_size
        pos = idx & self.bucket_mask
        if pos >= self.alias_cutoff[i]:
            symbol = int(self.alias_symbol[i])
            offset = int(self.alias_offset[i]) + pos
        else:
            symbol = i
            offset = pos
        next_state = (state >> 12) * int(self.dist[symbol]) + offset
        if next_state < (1 << 16):
            next_state = (next_state << 16) | bs.peek_bits(16)
            bs.consume_bits(16)
        return symbol, next_state

def _read_log_count(bs: Bitstream) -> int:
    """kLogCountLut prefix decoding (ans.rs read_prefix)."""
    v = bs.read_bits(3)
    if v == 0:
        return 10
    if v == 1:
        for val in (4, 0, 11, 13):
            if bs.read_bool():
                return val
        return 12
    if v == 2:
        return 7
    if v == 3:
        return 1 if bs.read_bool() else 3
    if v == 4:
        return 6
    if v == 5:
        return 8
    if v == 6:
        return 9
    return 2 if bs.read_bool() else 5

@dataclass(frozen=True)
class IntegerConfig:
    split_exponent: int
    msb_in_token: int
    lsb_in_token: int

    @property
    def split(self) -> int:
        return 1 << self.split_exponent


# --- from headers/image.py ---
DEFAULT_INV_MAT = (
    (11.031566901960783, -9.866943921568629, -0.16462299647058826),
    (-3.254147380392157, 4.418770392156863, -0.16462299647058826),
    (-3.6588512862745097, 2.7129230470588235, 1.9459282392156863),
)

DEFAULT_OPSIN_BIAS = (-0.0037930732552754493,) * 3

DEFAULT_QUANT_BIAS = (
    1.0 - 0.05465007330715401,
    1.0 - 0.07005449891748593,
    1.0 - 0.049935103337343655,
)

@dataclass
class OpsinInverseMatrix:
    inv_mat: tuple = DEFAULT_INV_MAT
    opsin_bias: tuple = DEFAULT_OPSIN_BIAS
    quant_bias: tuple = DEFAULT_QUANT_BIAS
    quant_bias_numerator: float = 0.145


# --- from models/vardct.py ---
class TransformType:
    """Varblock transform types, numbered per spec (dct_select.rs:4-32).

    Tables are plain arrays indexed by the type id; the decode plan buckets
    varblocks by type id so the device pipeline is fully shape-static.
    """

    DCT8 = 0
    HORNUSS = 1
    DCT2 = 2
    DCT4 = 3
    DCT16 = 4
    DCT32 = 5
    DCT16X8 = 6
    DCT8X16 = 7
    DCT32X8 = 8
    DCT8X32 = 9
    DCT32X16 = 10
    DCT16X32 = 11
    DCT4X8 = 12
    DCT8X4 = 13
    AFV0 = 14
    AFV1 = 15
    AFV2 = 16
    AFV3 = 17
    DCT64 = 18
    DCT64X32 = 19
    DCT32X64 = 20
    DCT128 = 21
    DCT128X64 = 22
    DCT64X128 = 23
    DCT256 = 24
    DCT256X128 = 25
    DCT128X256 = 26

    NUM_TYPES = 27

    # (bw, bh) in 8x8 blocks (dct_select_size, dct_select.rs:51-77)
    SELECT_SIZE = [
        (1, 1), (1, 1), (1, 1), (1, 1), (2, 2), (4, 4), (1, 2), (2, 1),
        (1, 4), (4, 1), (2, 4), (4, 2), (1, 1), (1, 1), (1, 1), (1, 1),
        (1, 1), (1, 1), (8, 8), (4, 8), (8, 4), (16, 16), (8, 16), (16, 8),
        (32, 32), (16, 32), (32, 16),
    ]

    # 17 dequant parameter classes (dequant_matrix_param_index, dct_select.rs:79-101)
    PARAM_INDEX = [
        0, 1, 2, 3, 4, 5, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 10, 10, 11, 12,
        12, 13, 14, 14, 15, 16, 16,
    ]

    # (width, height) of the dequant matrix (dequant_matrix_size)
    MATRIX_SIZE = [
        (8, 8), (8, 8), (8, 8), (8, 8), (16, 16), (32, 32), (16, 8), (16, 8),
        (32, 8), (32, 8), (32, 16), (32, 16), (8, 8), (8, 8), (8, 8), (8, 8),
        (8, 8), (8, 8), (64, 64), (64, 32), (64, 32), (128, 128), (128, 64),
        (128, 64), (256, 256), (256, 128), (256, 128),
    ]

    # 13 coefficient-order classes (order_id, dct_select.rs:120-140)
    ORDER_ID = [
        0, 1, 1, 1, 2, 3, 4, 4, 5, 5, 6, 6, 1, 1, 1, 1, 1, 1, 7, 8, 8, 9,
        10, 10, 11, 12, 12,
    ]

    # vectorized views for varblock placement (built once, not per group)
    SELECT_SIZE_ARR = np.asarray(SELECT_SIZE, dtype=np.int32)  # [27, 2]
    IS_1X1 = np.asarray([w == 1 and h == 1 for w, h in SELECT_SIZE])

    @staticmethod
    def need_transpose(t: int) -> bool:
        """need_transpose (dct_select.rs:143-157)."""
        if t in (1, 2, 3, 12, 13, 14, 15, 16, 17):
            return False
        w, h = TransformType.SELECT_SIZE[t]
        return h >= w

_ORDER_BLOCK_SIZES = [
    (8, 8), (8, 8), (16, 16), (32, 32), (16, 8), (32, 8), (32, 16),
    (64, 64), (64, 32), (128, 128), (128, 64), (256, 256), (256, 128),
]

@functools.lru_cache(maxsize=None)
def natural_order(order_id: int) -> tuple[tuple[int, int], ...]:
    """Natural (zigzag-like) coefficient order for an order class.

    Reimplements hf_pass.rs fill_natural_order: the first lbw*lbh entries
    are the LF corner in raster order, then anti-diagonal scan positions
    with y compressed by y_scale.
    """
    bw, bh = _ORDER_BLOCK_SIZES[order_id]
    y_scale = bw // bh
    lbw, lbh = bw // 8, bh // 8
    out = []
    for idx in range(lbw * lbh):
        out.append((idx % lbw, idx // lbw))
    for dist in range(1, 2 * bw):
        margin = max(0, dist - bw)
        for order in range(margin, dist - margin):
            if dist % 2 == 1:
                x, y = order, dist - 1 - order
            else:
                x, y = dist - 1 - order, order
            if x < lbw and y < lbw:
                continue
            if y % y_scale != 0:
                continue
            out.append((x, y // y_scale))
    return tuple(out)

_SEQ_A = [-1.025, -0.78, -0.65012, -0.19041574, -0.20819396, -0.421064, -0.32733846]

_SEQ_B = [-0.30419582, -0.36330363, -0.3566038, -0.34430745, -0.33699593, -0.30180866, -0.27321684]

_SEQ_C = [-1.2, -1.2, -0.8, -0.7, -0.7, -0.4, -0.5]

_DCT4X8_PARAMS = [
    [2198.0505, -0.96269625, -0.7619425, -0.65511405],
    [764.36554, -0.926302, -0.967523, -0.2784529],
    [527.10754, -1.4594386, -1.4500821, -1.5843723],
]

_DCT4_PARAMS = [
    [2200.0, 0.0, 0.0, 0.0],
    [392.0, 0.0, 0.0, 0.0],
    [112.0, -0.25, -0.25, -0.5],
]

_DCT_SELECT_LIST = [
    TransformType.DCT8, TransformType.HORNUSS, TransformType.DCT2,
    TransformType.DCT4, TransformType.DCT16, TransformType.DCT32,
    TransformType.DCT8X16, TransformType.DCT8X32, TransformType.DCT16X32,
    TransformType.DCT4X8, TransformType.AFV0, TransformType.DCT64,
    TransformType.DCT32X64, TransformType.DCT128, TransformType.DCT64X128,
    TransformType.DCT256, TransformType.DCT128X256,
]

def _default_dct_params(dct_select: int):
    """Library default encoding parameters (dequant.rs default_with)."""
    T = TransformType
    def seq(a, b, c):
        return ("dct", [[a] + _SEQ_A, [b] + _SEQ_B, [c] + _SEQ_C])
    if dct_select == T.DCT8:
        return ("dct", [
            [3150.0, 0.0, -0.4, -0.4, -0.4, -2.0],
            [560.0, 0.0, -0.3, -0.3, -0.3, -0.3],
            [512.0, -2.0, -1.0, 0.0, -1.0, -2.0],
        ])
    if dct_select == T.HORNUSS:
        return ("hornuss", [
            [280.0, 3160.0, 3160.0],
            [60.0, 864.0, 864.0],
            [18.0, 200.0, 200.0],
        ])
    if dct_select == T.DCT2:
        return ("dct2", [
            [3840.0, 2560.0, 1280.0, 640.0, 480.0, 300.0],
            [960.0, 640.0, 320.0, 180.0, 140.0, 120.0],
            [640.0, 320.0, 128.0, 64.0, 32.0, 16.0],
        ])
    if dct_select == T.DCT4:
        return ("dct4", [[1.0, 1.0]] * 3, [list(p) for p in _DCT4_PARAMS])
    if dct_select == T.DCT16:
        return ("dct", [
            [8996.873, -1.3000778, -0.4942453, -0.43909377, -0.6350102, -0.9017726, -1.6162099],
            [3191.4836, -0.67424583, -0.80745816, -0.4492584, -0.3586544, -0.3132239, -0.37615025],
            [1157.504, -2.0531423, -1.4, -0.5068713, -0.4270873, -1.4856834, -4.920914],
        ])
    if dct_select == T.DCT32:
        return ("dct", [
            [15718.408, -1.025, -0.98, -0.9012, -0.4, -0.48819396, -0.421064, -0.27],
            [7305.7637, -0.8041958, -0.76330364, -0.5566038, -0.49785304, -0.43699592, -0.40180868, -0.27321684],
            [3803.5317, -3.0607336, -2.041327, -2.023565, -0.54953897, -0.4, -0.4, -0.3],
        ])
    if dct_select == T.DCT8X16:
        return ("dct", [
            [7240.7734, -0.7, -0.7, -0.2, -0.2, -0.2, -0.5],
            [1448.1547, -0.5, -0.5, -0.5, -0.2, -0.2, -0.2],
            [506.85413, -1.4, -0.2, -0.5, -0.5, -1.5, -3.6],
        ])
    if dct_select == T.DCT8X32:
        return ("dct", [
            [16283.249, -1.7812846, -1.6309059, -1.0382179, -0.85, -0.7, -0.9, -1.2360638],
            [5089.1577, -0.3200494, -0.3536285, -0.3034, -0.61, -0.5, -0.5, -0.6],
            [3397.7761, -0.32132736, -0.3450762, -0.7034, -0.9, -1.0, -1.0, -1.1754606],
        ])
    if dct_select == T.DCT16X32:
        return ("dct", [
            [13844.971, -0.971138, -0.658, -0.42026, -0.22712, -0.2206, -0.226, -0.6],
            [4798.964, -0.6112531, -0.8377079, -0.7901486, -0.26927274, -0.38272768, -0.22924222, -0.20719099],
            [1807.2369, -1.2, -1.2, -0.7, -0.7, -0.7, -0.4, -0.5],
        ])
    if dct_select == T.DCT4X8:
        return ("dct4x8", [[1.0]] * 3, [list(p) for p in _DCT4X8_PARAMS])
    if dct_select == T.AFV0:
        return ("afv",
                [
                    [3072.0, 3072.0, 256.0, 256.0, 256.0, 414.0, 0.0, 0.0, 0.0],
                    [1024.0, 1024.0, 50.0, 50.0, 50.0, 58.0, 0.0, 0.0, 0.0],
                    [384.0, 384.0, 12.0, 12.0, 12.0, 22.0, -0.25, -0.25, -0.25],
                ],
                [list(p) for p in _DCT4X8_PARAMS],
                [list(p) for p in _DCT4_PARAMS])
    if dct_select == T.DCT64:
        return seq(23966.166, 8380.191, 4493.024)
    if dct_select == T.DCT32X64:
        return seq(15358.898, 5597.3604, 2919.9617)
    if dct_select == T.DCT128:
        return seq(47932.332, 16760.383, 8986.048)
    if dct_select == T.DCT64X128:
        return seq(30717.797, 11194.721, 5839.9233)
    if dct_select == T.DCT256:
        return seq(95864.664, 33520.766, 17972.096)
    if dct_select == T.DCT128X256:
        return seq(61435.594, 24209.441, 12979.847)
    raise AssertionError(dct_select)

def _interpolate(pos: float, vmax: float, bands: list[float]) -> float:
    if len(bands) == 1:
        return bands[0]
    scaled_pos = pos * (len(bands) - 1) / vmax
    idx = int(scaled_pos)
    frac = scaled_pos - idx
    # IEEE semantics, not Python-float (which raises on x/0): the
    # reference computes a * (b/a)^frac with f32 — a zero band gives
    # inf/NaN which the matrix range check downstream rejects or passes
    # exactly like dequant.rs:176-178 does.
    a, b = np.float64(bands[idx]), np.float64(bands[idx + 1])
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(a * (b / a) ** frac)

def _mult(x: float) -> float:
    return 1.0 + x if x > 0.0 else 1.0 / (1.0 - x)

def _dct_quant_weights(params: list[float], width: int, height: int) -> np.ndarray:
    bands = [params[0]]
    for val in params[1:]:
        band = bands[-1] * _mult(val)
        if band <= 0.0:
            raise JxlValidationError("DCT dequant matrix: band <= 0")
        bands.append(band)
    vmax = float(np.sqrt(2.0) + 1e-6)
    dy = (np.arange(height) / (height - 1))[:, None]
    dx = (np.arange(width) / (width - 1))[None, :]
    distance = np.sqrt(dx * dx + dy * dy)
    if len(bands) == 1:
        return np.full((height, width), bands[0], dtype=np.float32)
    # geometric interpolation between bands (dequant.rs interpolate)
    b = np.asarray(bands, dtype=np.float64)
    scaled = distance * (len(bands) - 1) / vmax
    idx = scaled.astype(np.int64)
    frac = scaled - idx
    a = b[idx]
    nxt = b[np.minimum(idx + 1, len(bands) - 1)]
    out = a * (nxt / a) ** frac
    return out.astype(np.float32)

def _params_to_matrix(dct_select: int, encoding: tuple) -> list[np.ndarray]:
    """dequant.rs into_matrix: three [h, w] float32 matrices (x, y, b)."""
    kind = encoding[0]
    w, h = TransformType.MATRIX_SIZE[dct_select]
    out = []
    if kind == "dct":
        for params in encoding[1]:
            out.append(_dct_quant_weights(params, w, h))
    elif kind == "hornuss":
        for params in encoding[1]:
            m = np.full((8, 8), params[0], dtype=np.float32)
            m[0, 0] = 1.0
            m[0, 1] = params[1]
            m[1, 0] = params[1]
            m[1, 1] = params[2]
            out.append(m)
    elif kind == "dct2":
        for params in encoding[1]:
            m = np.zeros((8, 8), dtype=np.float32)
            m[0, 0] = 1.0
            for idx, val in enumerate(params):
                dim = 1 << (idx // 2)
                if idx % 2 == 0:
                    m[0:dim, dim:dim * 2] = val
                    m[dim:dim * 2, 0:dim] = val
                else:
                    m[dim:dim * 2, dim:dim * 2] = val
            out.append(m)
    elif kind == "dct4":
        for params, dct_params in zip(encoding[1], encoding[2]):
            mat = _dct_quant_weights(dct_params, 4, 4)
            m = np.repeat(np.repeat(mat, 2, axis=0), 2, axis=1)
            # zero params give inf (f32 semantics, like dequant.rs), which
            # the range check below rejects
            with np.errstate(divide="ignore"):
                m[0, 1] /= params[0]
                m[1, 0] /= params[0]
                m[1, 1] /= params[1]
            out.append(m)
    elif kind == "dct4x8":
        for params, dct_params in zip(encoding[1], encoding[2]):
            mat = _dct_quant_weights(dct_params, 8, 4)
            m = np.repeat(mat, 2, axis=0)
            with np.errstate(divide="ignore"):
                m[1, 0] /= params[0]
            out.append(m)
    elif kind == "afv":
        freqs = [0.0, 0.0, 0.8517779, 5.3777843, 0.0, 0.0, 4.734748,
                 5.4492455, 1.659827, 4.0, 7.275749, 10.423227, 2.6629324,
                 7.6306577, 8.962389, 12.971662]
        freq_lo, freq_hi = freqs[2], freqs[15]
        for params, dct_params, dct4x4_params in zip(
            encoding[1], encoding[2], encoding[3]
        ):
            weights_4x8 = _dct_quant_weights(dct_params, 8, 4)
            weights_4x4 = _dct_quant_weights(dct4x4_params, 4, 4)
            bands = [params[5]]
            for p in params[6:9]:
                bands.append(bands[-1] * _mult(p))
            m = np.zeros((8, 8), dtype=np.float32)
            for y in range(4):
                for x in range(4):
                    if (x, y) == (0, 0):
                        val = 1.0
                    elif (x, y) == (0, 1):
                        val = params[2]
                    elif (x, y) == (1, 0):
                        val = params[3]
                    elif (x, y) == (1, 1):
                        val = params[4]
                    else:
                        val = _interpolate(
                            freqs[y * 4 + x] - freq_lo,
                            freq_hi - freq_lo + 1e-6, bands,
                        )
                    m[2 * y, 2 * x] = val
            for y in range(4):
                for x in range(8):
                    m[2 * y + 1, x] = params[0] if (y == 0 and x == 0) else weights_4x8[y, x]
                for x in range(4):
                    m[2 * y, 2 * x + 1] = params[1] if (y == 0 and x == 0) else weights_4x4[y, x]
            out.append(m)
    elif kind == "raw":
        denominator, channels = encoding[1], encoding[2]
        for c in range(3):
            out.append(channels[c].astype(np.float32) * denominator)
    else:
        raise AssertionError(kind)

    if kind != "raw":
        # zero weights invert to inf and are rejected by the range check
        # below (dequant.rs band<=0 validation); silence the numpy warning
        with np.errstate(divide="ignore"):
            out = [1.0 / m for m in out]
    for m in out:
        if np.any(m >= 1e8) or np.any(m <= 0.0):
            raise JxlValidationError("dequant matrix element out of range")
        if m.shape != (h, w):
            raise AssertionError((m.shape, (h, w)))
    return out

class DequantMatrixSet:
    """The 17 dequant matrices + transposed variants (dequant.rs:580+).

    matrices[param_idx][channel] is an [h, w] float32 array in raster order
    (h = bh*8, w = bw*8 of the canonical orientation).
    """

    def __init__(self, matrices, jpeg_quant_values=None):
        self.matrices = matrices  # list of [3][h,w]
        self.matrices_tr = [
            [self._transpose_raster(m) for m in chans] for chans in matrices
        ]
        self.jpeg_quant_values = jpeg_quant_values

    @staticmethod
    def _transpose_raster(m: np.ndarray) -> np.ndarray:
        # dequant.rs matrices_tr: out[idx] = matrix[(idx%h)*w + idx//h]
        # for a [h, w] matrix => plain transpose as a [w, h] array.
        return np.ascontiguousarray(m.T)

    _default_cache = None

    @classmethod
    def default(cls) -> "DequantMatrixSet":
        if cls._default_cache is None:
            cls._default_cache = cls([
                _params_to_matrix(sel, _default_dct_params(sel))
                for sel in _DCT_SELECT_LIST
            ])
        return cls._default_cache

    def get(self, channel: int, dct_select: int, transposed: bool) -> np.ndarray:
        idx = TransformType.PARAM_INDEX[dct_select]
        src = self.matrices_tr if transposed else self.matrices
        return src[idx][channel]


# --- from ops/dct.py ---
@functools.lru_cache(maxsize=None)
def dct_basis_forward(n: int) -> np.ndarray:
    """A[k, x]: forward DCT matrix, F = A @ x (float32, computed in f64)."""
    if n == 1:
        return np.ones((1, 1), dtype=np.float32)
    k = np.arange(n, dtype=np.float64)[:, None]
    x = np.arange(n, dtype=np.float64)[None, :]
    mat = np.cos(np.pi * k * (2.0 * x + 1.0) / (2.0 * n)) / n
    mat[1:, :] *= np.sqrt(2.0)
    return mat.astype(np.float32)


def dct2d(block: np.ndarray) -> np.ndarray:
    """Forward 2D DCT (numpy oracle), any power-of-two (h, w)."""
    h, w = block.shape[-2:]
    a_h = dct_basis_forward(h)
    a_w = dct_basis_forward(w)
    return np.einsum("ky,...yx,lx->...kl", a_h, block.astype(np.float32), a_w)


# --- from models/modular_transform.py ---


# --- from color/icc.py ---
