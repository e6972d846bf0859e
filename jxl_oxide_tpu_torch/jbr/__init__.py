"""JPEG bitstream reconstruction (jbrd box).

A copy of jxl_oxide_tpu/jbr/__init__.py, with the coefficients taken from
the port's host stage. Behavioral parity: jxl-jbr crate —
JpegBitstreamHeader (lib.rs:124-283), HuffmanCode (huffman.rs), MSB-first
bit writer with 0xFF stuffing (bit_writer.rs), and the byte-exact
re-encoding (reconstruct.rs + reconstruct/scan.rs): markers are
replayed from jbrd metadata, quant tables come from the frame's Raw
dequant matrices, coefficients come from the VarDCT frame's quantized
planes (render/render.py `coefficient_host_stage`: host work only, kept
out of the plane pool) with integer chroma-from-luma undone, and entropy
data is Huffman re-encoded (sequential + both progressive scan types,
restart markers, EOB runs, refinement bits), by the native scan encoder
(native `jbr_encode_scan`) or, without the native library, by the
Python one below; both write the same bytes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..io.bitstream import Bitstream, U
from ..utils.brotli import brotli_decompress
from ..utils.errors import JxlError, JxlValidationError

__all__ = ["JpegBitstreamData", "JpegBitstreamHeader", "reconstruct_jpeg"]

HEADER_ICC = b"ICC_PROFILE\0"
HEADER_EXIF = b"Exif\0\0"
HEADER_XMP = b"http://ns.adobe.com/xap/1.0/\0"

CFL_FIXED_POINT_BITS = 11
CFL_DEFAULT_COLOR_FACTOR = 84


@dataclass
class AppMarker:
    ty: int
    length: int


@dataclass
class QuantTableMeta:
    precision: int
    index: int
    is_last: bool


@dataclass
class HuffmanCode:
    is_ac: bool
    id: int
    is_last: bool
    counts: list
    values: list

    @classmethod
    def parse(cls, bs: Bitstream) -> "HuffmanCode":
        is_ac = bs.read_bool()
        hid = bs.read_bits(2)
        is_last = bs.read_bool()
        counts = []
        total = 0
        for _ in range(17):
            x = bs.read_u32(0, 1, 2 + U(3), U(8))
            total += x
            counts.append(x)
        values = [
            bs.read_u32(U(2), 4 + U(2), 8 + U(4), 1 + U(8)) for _ in range(total)
        ]
        return cls(is_ac, hid, is_last, counts, values)

    @property
    def encoded_len(self) -> int:
        return 1 + 16 + len(self.values) - 1

    def build(self) -> "BuiltHuffmanTable":
        """Canonical code assignment (huffman.rs:19-60); the last value is a
        sentinel without a code."""
        lengths = []
        for length, count in enumerate(self.counts):
            lengths.extend([length] * count)
        lengths.pop()
        bits = []
        next_code = 0
        prev_len = lengths[0] if lengths else 0
        for length in lengths:
            if length != prev_len:
                next_code <<= length - prev_len
                prev_len = length
            bits.append((next_code << (64 - length)) & ((1 << 64) - 1) if length else 0)
            next_code += 1
        table_len = [0] * 256
        table_bits = [0] * 256
        for value, length, bit in zip(self.values, lengths, bits):
            table_len[value] = length
            table_bits[value] = bit
        return BuiltHuffmanTable(table_len, table_bits)


class BuiltHuffmanTable:
    __slots__ = ("lengths", "bits", "_native_arrs")

    def __init__(self, lengths=None, bits=None):
        self.lengths = lengths or [0] * 256
        self.bits = bits or [0] * 256

    def lookup(self, symbol: int) -> tuple[int, int]:
        length = self.lengths[symbol]
        if length == 0:
            raise JxlError("JPEG huffman symbol has no code")
        return length, self.bits[symbol]


EMPTY_TABLE = BuiltHuffmanTable()


@dataclass
class ScanComponentInfo:
    comp_idx: int
    ac_tbl_idx: int
    dc_tbl_idx: int


@dataclass
class ScanInfo:
    ss: int
    se: int
    al: int
    ah: int
    component_info: list


@dataclass
class ScanMoreInfo:
    reset_points: set
    extra_zero_runs: dict


@dataclass
class Component:
    id: int
    q_idx: int


class JpegBitstreamHeader:
    """jbrd box header (jxl-jbr lib.rs:124-283)."""

    def __init__(self, bs: Bitstream):
        self.is_gray = bs.read_bool()

        self.markers: list[int] = []
        num_app = num_com = num_scans = num_inter = 0
        has_dri = False
        while not self.markers or self.markers[-1] != 0xD9:
            m = bs.read_bits(6) + 0xC0
            if 0xE0 <= m <= 0xEF:
                num_app += 1
            elif m == 0xFE:
                num_com += 1
            elif m == 0xDA:
                num_scans += 1
            elif m == 0xFF:
                num_inter += 1
            elif m == 0xDD:
                has_dri = True
            self.markers.append(m)

        self.app_markers = [
            AppMarker(bs.read_u32(0, 1, 2 + U(1), 4 + U(2)), bs.read_bits(16) + 1)
            for _ in range(num_app)
        ]
        self.com_lengths = [bs.read_bits(16) + 1 for _ in range(num_com)]

        num_quant = bs.read_bits(2) + 1
        self.quant_tables = [
            QuantTableMeta(bs.read_bits(1), bs.read_bits(2), bs.read_bool())
            for _ in range(num_quant)
        ]

        comp_type = bs.read_bits(2)
        if comp_type == 0:
            ids = [1]
        elif comp_type == 1:
            ids = [1, 2, 3]
        elif comp_type == 2:
            ids = [ord("R"), ord("G"), ord("B")]
        else:
            n = bs.read_bits(2) + 1
            ids = [bs.read_bits(8) for _ in range(n)]
        self.components = [Component(i, bs.read_bits(2)) for i in ids]

        num_huff = bs.read_u32(4, 2 + U(3), 10 + U(4), 26 + U(6))
        self.huffman_codes = [HuffmanCode.parse(bs) for _ in range(num_huff)]

        self.scan_info = []
        for _ in range(num_scans):
            num_comps = bs.read_bits(2) + 1
            ss = bs.read_bits(6)
            se = bs.read_bits(6)
            al = bs.read_bits(4)
            ah = bs.read_bits(4)
            comps = [
                ScanComponentInfo(bs.read_bits(2), bs.read_bits(2), bs.read_bits(2))
                for _ in range(num_comps)
            ]
            bs.read_u32(0, 1, 2, 3 + U(3))  # last_needed_pass
            self.scan_info.append(ScanInfo(ss, se, al, ah, comps))

        self.restart_interval = bs.read_bits(16) if has_dri else 0

        self.scan_more_info = []
        for _ in range(num_scans):
            n_reset = bs.read_u32(0, 1 + U(2), 4 + U(4), 20 + U(16))
            reset_points = set()
            last = None
            for _ in range(n_reset):
                diff = bs.read_u32(0, 1 + U(3), 9 + U(5), 41 + U(28))
                idx = diff if last is None else min(last + diff + 1, (1 << 32) - 1)
                if idx > (3 << 26):
                    raise JxlValidationError("reset_points too large")
                last = idx
                reset_points.add(idx)
            n_ezr = bs.read_u32(0, 1 + U(2), 4 + U(4), 20 + U(16))
            extra_zero_runs = {}
            last = None
            for _ in range(n_ezr):
                nruns = bs.read_u32(1 + U(2), 5 + U(4), 21 + U(8), 277 + U(16))
                diff = bs.read_u32(0, 1 + U(3), 9 + U(5), 41 + U(28))
                idx = diff if last is None else min(last + diff + 1, (1 << 32) - 1)
                if idx > (3 << 26):
                    raise JxlValidationError("extra_zero_runs too large")
                last = idx
                extra_zero_runs[idx] = nruns
            self.scan_more_info.append(ScanMoreInfo(reset_points, extra_zero_runs))

        self.intermarker_lengths = [bs.read_bits(16) for _ in range(num_inter)]
        self.tail_data_length = bs.read_u32(0, 1 + U(8), 257 + U(16), 65793 + U(22))

        self.padding_bits: bytes | None = None
        if bs.read_bool():
            num_bits = bs.read_bits(24)
            full, extra = divmod(num_bits, 8)
            pad = bytearray(bs.read_bits(8) for _ in range(full))
            pad.append(bs.read_bits(extra) if extra else 0)
            self.padding_bits = bytes(pad)

    # -- data stream layout (lib.rs:243-289) --------------------------------

    def app_data_len(self) -> int:
        return sum(m.length for m in self.app_markers if m.ty == 0)

    def com_data_len(self) -> int:
        return sum(self.com_lengths)

    def intermarker_data_len(self) -> int:
        return sum(self.intermarker_lengths)

    def expected_data_len(self) -> int:
        return (
            self.app_data_len()
            + self.com_data_len()
            + self.intermarker_data_len()
            + self.tail_data_length
        )

    def expected_icc_len(self) -> int:
        return sum(
            m.length - 5 - len(HEADER_ICC)
            for m in self.app_markers
            if m.ty == 1
        )

    def expected_exif_len(self) -> int:
        for m in self.app_markers:
            if m.ty == 2:
                return m.length - 3 - len(HEADER_EXIF)
        return 0

    def expected_xmp_len(self) -> int:
        for m in self.app_markers:
            if m.ty == 3:
                return m.length - 3 - len(HEADER_XMP)
        return 0


class JpegBitstreamData:
    """Parsed jbrd box: header + brotli-decompressed data stream."""

    def __init__(self, data: bytes):
        bs = Bitstream(data)
        self.header = JpegBitstreamHeader(bs)
        bs.zero_pad_to_byte()
        compressed = data[bs.pos // 8 :]
        self.data = brotli_decompress(
            compressed, expected_size=self.header.expected_data_len() or None
        )
        if len(self.data) != self.header.expected_data_len():
            raise JxlValidationError("jbrd data stream length mismatch")


class BitWriter:
    """MSB-first JPEG bit writer with 0xFF stuffing (bit_writer.rs)."""

    __slots__ = ("output", "buf", "valid")

    def __init__(self):
        self.output = bytearray()
        self.buf = 0  # 64-bit, MSB-aligned
        self.valid = 0

    def write_huffman(self, bits: int, length: int) -> None:
        self.buf |= bits >> self.valid
        self.valid += length
        if self.valid >= 64:
            extra = self.valid - 64
            out = self.buf
            self.valid = extra
            self.buf = (bits << (length - extra)) & ((1 << 64) - 1) if length - extra < 64 else 0
            self._emit_word(out, 8)

    def write_raw(self, bits: int, length: int) -> None:
        if length == 0:
            return
        self.write_huffman((bits << (64 - length)) & ((1 << 64) - 1), length)

    def _emit_word(self, word: int, nbytes: int) -> None:
        b = word.to_bytes(8, "big")[:nbytes]
        if b"\xff" not in b:
            self.output += b
        else:
            for byte in b:
                self.output.append(byte)
                if byte == 0xFF:
                    self.output.append(0)

    def padding_bits(self) -> int:
        return (8 - self.valid % 8) % 8

    def finalize(self) -> bytes:
        nbytes = (self.valid + 7) // 8
        if nbytes:
            self._emit_word(self.buf, nbytes)
        return bytes(self.output)


# ---------------------------------------------------------------------------
# Reconstruction


def _dct8_natural_order():
    from ..models.vardct import natural_order

    return natural_order(0)


class _ScanState:
    def __init__(self, num_comps: int):
        self.bw = BitWriter()
        self.dc_pred = [0] * num_comps
        self.eobrun = 0
        self.last_ac_table: BuiltHuffmanTable | None = None
        self.refine_bits: list[tuple[int, int]] = []
        self.rst_m = 0

    def update_dc_pred(self, comp_idx: int, coeff: int) -> int:
        diff = np.int16(coeff - self.dc_pred[comp_idx])
        self.dc_pred[comp_idx] = coeff
        return int(diff)

    def emit_eobrun(self) -> None:
        if self.eobrun == 0:
            return
        ac_table = self.last_ac_table
        eobn = self.eobrun.bit_length() - 1
        length, bits = ac_table.lookup(eobn << 4)
        self.bw.write_huffman(bits, length)
        self.bw.write_raw(self.eobrun & ((1 << eobn) - 1), eobn)
        self.eobrun = 0
        for bits_, len_ in self.refine_bits:
            self.bw.write_raw(bits_, len_)
        self.refine_bits = []

    def flush(self, padding_bs: Bitstream | None, out: bytearray) -> None:
        self.emit_eobrun()
        pad = self.bw.padding_bits()
        if pad:
            if padding_bs is not None:
                bits = padding_bs.read_bits(pad)
            else:
                bits = (1 << pad) - 1
            self.bw.write_raw(bits, pad)
        out += self.bw.finalize()
        self.bw = BitWriter()

    def restart(self, padding_bs, out: bytearray) -> None:
        self.dc_pred = [0] * len(self.dc_pred)
        self.flush(padding_bs, out)
        out += bytes([0xFF, 0xD0 + self.rst_m])
        self.rst_m = (self.rst_m + 1) % 8


def _bitlen16(v: int) -> int:
    return int(v).bit_length()


def _seq_block(state, comp_idx, dc_table, ac_table, dc, ac, ezr) -> None:
    diff = state.update_dc_pred(comp_idx, dc)
    neg = diff < 0
    mag = -diff if neg else diff
    bitlen = _bitlen16(mag)
    raw = (-mag - 1) & 0xFFFF if neg else mag
    length, bits = dc_table.lookup(bitlen)
    state.bw.write_huffman(bits, length)
    state.bw.write_raw(raw & ((1 << bitlen) - 1), bitlen)
    num_zeros = _encode_ac_run(state, ac_table, ac, ezr, None)
    if num_zeros > 0:
        length, bits = ac_table.lookup(0)
        state.bw.write_huffman(bits, length)


def _encode_ac_run(state, ac_table, ac, ezr, eob_hook) -> None:
    """Shared AC run-length encoding (scan.rs process_sequential /
    process_progressive_first AC part)."""
    i = 0
    n = len(ac)
    while True:
        j = i
        while j < n and ac[j] == 0:
            j += 1
        if j >= n:
            break
        if eob_hook is not None:
            eob_hook()
        run = j - i
        coeff = ac[j]
        i = j + 1
        while run >= 16:
            length, bits = ac_table.lookup(0xF0)
            state.bw.write_huffman(bits, length)
            run -= 16
        if coeff < 0:
            mag = -coeff
            raw = (~mag) & 0xFFFF
        else:
            mag = coeff
            raw = coeff
        bitlen = _bitlen16(mag)
        sym = (run << 4) | bitlen
        length, bits = ac_table.lookup(sym)
        state.bw.write_huffman(bits, length)
        state.bw.write_raw(raw & ((1 << bitlen) - 1), bitlen)

    num_zeros = n - i
    if ezr:
        if eob_hook is not None:
            eob_hook()
        length, bits = ac_table.lookup(0xF0)
        for _ in range(ezr):
            state.bw.write_huffman(bits, length)
        num_zeros -= ezr * 16
    return num_zeros


def _prog_first_block(state, comp_idx, dc_table, ac_table, dc, ac, ezr) -> None:
    if dc is not None:
        diff = state.update_dc_pred(comp_idx, dc)
        neg = diff < 0
        mag = -diff if neg else diff
        bitlen = _bitlen16(mag)
        raw = (-mag - 1) & 0xFFFF if neg else mag
        state.emit_eobrun()
        length, bits = dc_table.lookup(bitlen)
        state.bw.write_huffman(bits, length)
        state.bw.write_raw(raw & ((1 << bitlen) - 1), bitlen)

    num_zeros = _encode_ac_run(state, ac_table, ac, ezr, state.emit_eobrun)
    if state.eobrun == 0:
        state.last_ac_table = ac_table
    if num_zeros > 0:
        state.eobrun += 1
        if state.eobrun >= 32767:
            state.emit_eobrun()


def _prog_refine_block(state, ac_table, dc, ac, ezr) -> None:
    if dc is not None:
        state.emit_eobrun()
        state.bw.write_raw(dc & 1, 1)

    remaining = list(ac)
    pos = 0
    while True:
        try:
            nonzero_idx = next(
                i for i in range(pos, len(remaining))
                if remaining[i] in (1, -1)
            )
        except StopIteration:
            break
        state.emit_eobrun()
        zero_runs = 0
        ref_bits = 0
        ref_len = 0
        for i in range(pos, nonzero_idx):
            c = remaining[i]
            if c == 0:
                zero_runs += 1
                if zero_runs == 16:
                    length, bits = ac_table.lookup(0xF0)
                    state.bw.write_huffman(bits, length)
                    state.bw.write_raw(ref_bits, ref_len)
                    zero_runs = 0
                    ref_len = 0
                    ref_bits = 0
            else:
                ref_bits = ((ref_bits << 1) | (c & 1)) & ((1 << 64) - 1)
                ref_len += 1
        coeff = remaining[nonzero_idx]
        pos = nonzero_idx + 1
        bit = 1 if coeff == 1 else 0
        sym = (zero_runs << 4) | 1
        length, bits = ac_table.lookup(sym)
        state.bw.write_huffman(bits, length)
        state.bw.write_raw(bit, 1)
        state.bw.write_raw(ref_bits, ref_len)

    remaining_zrl = ezr or 0
    if remaining_zrl > 0:
        state.emit_eobrun()
        zrl_len, zrl_bits = ac_table.lookup(0xF0)
    else:
        zrl_len, zrl_bits = 0, 0

    zero_runs = 0
    ref_bits = 0
    ref_len = 0
    for i in range(pos, len(remaining)):
        c = remaining[i]
        if c == 0:
            zero_runs += 1
            if remaining_zrl > 0 and zero_runs == 16:
                state.bw.write_huffman(zrl_bits, zrl_len)
                state.bw.write_raw(ref_bits, ref_len)
                zero_runs = 0
                ref_len = 0
                remaining_zrl -= 1
        else:
            ref_bits = ((ref_bits << 1) | (c & 1)) & ((1 << 64) - 1)
            ref_len += 1

    for _ in range(remaining_zrl):
        state.bw.write_huffman(zrl_bits, zrl_len)
        state.bw.write_raw(ref_bits, ref_len)
        zero_runs = 0
        ref_len = 0

    if state.eobrun == 0:
        state.last_ac_table = ac_table
    if zero_runs > 0 or ref_len > 0:
        state.eobrun += 1
        state.refine_bits.append((ref_bits, ref_len))
        if state.eobrun >= 32767:
            state.emit_eobrun()


def reconstruct_jpeg(jbrd: JpegBitstreamData, frame, icc: bytes = b"",
                     exif: bytes = b"", xmp: bytes = b"") -> bytes:
    """Byte-exact JPEG reconstruction (reconstruct.rs write/process_next)."""
    from ..headers.frame import Encoding
    from ..render.render import coefficient_host_stage

    header = jbrd.header
    data = jbrd.data
    frame_header = frame.header
    image_header = frame.image_header

    if image_header.metadata.xyb_encoded:
        raise JxlError("jbrd: frame is xyb-encoded")
    if frame_header.encoding != Encoding.VARDCT:
        raise JxlError("jbrd: frame is not VarDCT")
    if frame_header.flags.use_lf_frame or not frame_header.flags.skip_adaptive_lf_smoothing:
        raise JxlError("jbrd: incompatible frame flags")

    if header.expected_icc_len() and header.expected_icc_len() != len(icc):
        raise JxlValidationError("jbrd: ICC length mismatch")
    if header.expected_exif_len() and header.expected_exif_len() != len(exif):
        raise JxlValidationError("jbrd: Exif length mismatch")
    if header.expected_xmp_len() and header.expected_xmp_len() != len(xmp):
        raise JxlValidationError("jbrd: XMP length mismatch")

    # The frame's quantized coefficients: a frame that carries its decoded
    # state keeps it (`_vardct_state` with its planes, and `_hf_global`);
    # any other decodes them on the host (no render, no plane pool)
    state = getattr(frame, "_vardct_state", None)
    if state is not None and state.coeff_planes is not None:
        hf_global = frame._hf_global
    else:
        host = coefficient_host_stage(frame)
        state, hf_global = host.state, host.hf_global
    jpeg_quant = hf_global.dequant_matrices.jpeg_quant_values
    if jpeg_quant is None or len(jpeg_quant) < 3:
        raise JxlError("jbrd: frame has no raw JPEG quant matrices")

    do_ycbcr = frame_header.do_ycbcr
    jpeg_upsampling_ycbcr = list(frame_header.jpeg_upsampling)
    jpeg_upsampling_ycbcr[0], jpeg_upsampling_ycbcr[1] = (
        jpeg_upsampling_ycbcr[1], jpeg_upsampling_ycbcr[0],
    )
    is_subsampled = any(jpeg_upsampling_ycbcr)

    # coefficient planes in [y, x, b] stream order -> plane index map
    # (state planes are [x, y, b])
    plane_of = [1, 0, 2]
    coeff_planes = [state.coeff_planes[plane_of[i]].copy() for i in range(3)]
    lf_quant_planes = [state.lf_quant_planes[plane_of[i]] for i in range(3)]

    if not header.is_gray and not is_subsampled:
        _integer_cfl(state, hf_global, coeff_planes, jpeg_quant)

    if do_ycbcr:
        dc_offset = [0, 0, 0]
    else:
        dc_dequant = [jpeg_quant[1][0], jpeg_quant[0][0], jpeg_quant[2][0]]
        dc_offset = [1024 // q for q in dc_dequant]

    out = bytearray([0xFF, 0xD8])
    ctx = _MarkerContext(header, data, icc, exif, xmp)
    padding_bs = (
        Bitstream(header.padding_bits) if header.padding_bits is not None else None
    )
    dc_tables: list[BuiltHuffmanTable | None] = [None] * 4
    ac_tables: list[BuiltHuffmanTable | None] = [None] * 4
    is_progressive = False
    restart_interval = None
    scan_ptr = 0
    nat8 = _dct8_natural_order()

    for marker in header.markers:
        if marker in (0xC0, 0xC1, 0xC2, 0xC9, 0xCA):
            is_progressive = marker in (0xC2, 0xCA)
            w = image_header.size.width
            h = image_header.size.height
            ncomp = len(header.components)
            enc_len = 8 + ncomp * 3
            out += bytes([0xFF, marker]) + enc_len.to_bytes(2, "big")
            out += bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big")
            out.append(ncomp)
            for idx, comp in enumerate(header.components):
                sf = (
                    jpeg_upsampling_ycbcr[idx]
                    if idx < len(jpeg_upsampling_ycbcr)
                    else 0
                )
                sampling_val = {0: 0x11, 1: 0x22, 2: 0x21, 3: 0x12}.get(sf, 0x11)
                out += bytes([comp.id, sampling_val, comp.q_idx])
        elif marker == 0xC4:  # DHT
            hcs, ctx.huffman_ptr = _take_until_last(
                header.huffman_codes, ctx.huffman_ptr
            )
            enc_len = 2 + sum(hc.encoded_len for hc in hcs)
            out += bytes([0xFF, 0xC4]) + enc_len.to_bytes(2, "big")
            for hc in hcs:
                id_counts = bytearray(17)
                id_counts[0] = hc.id | (0x10 if hc.is_ac else 0)
                id_counts[1:] = bytes(hc.counts[1:])
                for i in range(16, 0, -1):
                    if id_counts[i] != 0:
                        id_counts[i] -= 1
                        break
                out += id_counts
                out += bytes(hc.values[:-1])
                table = hc.build()
                if hc.is_ac:
                    ac_tables[hc.id] = table
                else:
                    dc_tables[hc.id] = table
        elif 0xD0 <= marker <= 0xD7:
            out += bytes([0xFF, marker])
        elif marker == 0xD9:
            out += bytes([0xFF, 0xD9])
            out += ctx.tail_data
        elif marker == 0xDA:  # SOS
            si = header.scan_info[scan_ptr]
            smi = header.scan_more_info[scan_ptr]
            scan_ptr += 1
            if not si.component_info:
                raise JxlValidationError("jbrd: no components in SOS")
            ncomps = len(si.component_info)
            out += bytes([0xFF, 0xDA]) + (6 + 2 * ncomps).to_bytes(2, "big")
            out.append(ncomps)
            for c in si.component_info:
                out += bytes([
                    header.components[c.comp_idx].id,
                    (c.dc_tbl_idx << 4) | c.ac_tbl_idx,
                ])
            out += bytes([si.ss, si.se, (si.ah << 4) | si.al])

            _process_scan(
                out, si, smi, frame_header, header, coeff_planes,
                lf_quant_planes, dc_offset, dc_tables, ac_tables,
                is_progressive, restart_interval, padding_bs,
                jpeg_upsampling_ycbcr, do_ycbcr, nat8,
            )
        elif marker == 0xDB:  # DQT
            qts, ctx.quant_ptr = _take_until_last(
                header.quant_tables, ctx.quant_ptr
            )
            enc_len = (
                2 + 65 * len(qts)
                + 64 * sum(1 for qt in qts if qt.precision != 0)
            )
            out += bytes([0xFF, 0xDB]) + enc_len.to_bytes(2, "big")
            for qt in qts:
                channel = next(
                    (
                        i for i, c in enumerate(header.components)
                        if c.q_idx == qt.index
                    ),
                    None,
                )
                if channel is not None:
                    if do_ycbcr and channel <= 1:
                        channel ^= 1
                    q = jpeg_quant[channel] if channel < len(jpeg_quant) else None
                    if q is not None:
                        # transposed for DCT8 (reconstruct.rs:648-653)
                        ctx.last_quant_val = [
                            int(q[b + 8 * a]) for (a, b) in nat8
                        ]
                if ctx.last_quant_val is None:
                    raise JxlValidationError("jbrd: missing quant values")
                if qt.precision == 0:
                    out.append(qt.index)
                    out += bytes(v & 0xFF for v in ctx.last_quant_val)
                else:
                    out.append(qt.index | (qt.precision << 4))
                    for v in ctx.last_quant_val:
                        out += int(v).to_bytes(2, "big")
        elif marker == 0xDD:  # DRI
            out += bytes([0xFF, 0xDD, 0, 4])
            out += header.restart_interval.to_bytes(2, "big")
            if header.restart_interval:
                restart_interval = header.restart_interval
        elif 0xE0 <= marker <= 0xEF:
            am = header.app_markers[ctx.app_ptr]
            ctx.app_ptr += 1
            enc_len = (am.length - 1).to_bytes(2, "big")
            if am.ty == 0:
                out.append(0xFF)
                out += ctx.take_app_data(am.length)
            elif am.ty == 1:
                out += bytes([0xFF, 0xE2]) + enc_len + HEADER_ICC
                out += bytes([ctx.next_icc + 1, ctx.num_icc])
                ln = am.length - 5 - len(HEADER_ICC)
                out += icc[ctx.icc_off : ctx.icc_off + ln]
                ctx.next_icc += 1
                ctx.icc_off += ln
            elif am.ty == 2:
                out += bytes([0xFF, 0xE1]) + enc_len + HEADER_EXIF + exif
            elif am.ty == 3:
                out += bytes([0xFF, 0xE1]) + enc_len + HEADER_XMP + xmp
        elif marker == 0xFE:  # COM
            length = header.com_lengths[ctx.com_ptr]
            ctx.com_ptr += 1
            out += bytes([0xFF, 0xFE])
            out += ctx.take_com_data(length)
        elif marker == 0xFF:  # intermarker
            length = header.intermarker_lengths[ctx.inter_ptr]
            ctx.inter_ptr += 1
            out += ctx.take_inter_data(length)
        else:
            raise JxlValidationError(f"jbrd: unknown marker {marker:#x}")

    return bytes(out)


class _MarkerContext:
    def __init__(self, header, data, icc, exif, xmp):
        self.header = header
        app_len = header.app_data_len()
        com_len = header.com_data_len()
        inter_len = header.intermarker_data_len()
        self.app_data = data[:app_len]
        self.com_data = data[app_len : app_len + com_len]
        self.inter_data = data[app_len + com_len : app_len + com_len + inter_len]
        self.tail_data = data[app_len + com_len + inter_len :]
        self.app_ptr = self.com_ptr = self.inter_ptr = 0
        self.app_off = self.com_off = self.inter_off = 0
        self.huffman_ptr = 0
        self.quant_ptr = 0
        self.last_quant_val = None
        self.next_icc = 0
        self.icc_off = 0
        self.num_icc = sum(1 for m in header.app_markers if m.ty == 1)

    def take_app_data(self, n):
        d = self.app_data[self.app_off : self.app_off + n]
        self.app_off += n
        return d

    def take_com_data(self, n):
        d = self.com_data[self.com_off : self.com_off + n]
        self.com_off += n
        return d

    def take_inter_data(self, n):
        d = self.inter_data[self.inter_off : self.inter_off + n]
        self.inter_off += n
        return d


def _take_until_last(items, ptr):
    end = ptr
    while end < len(items) and not items[end].is_last:
        end += 1
    return items[ptr : end + 1], end + 1


def _integer_cfl(state, hf_global, coeff_planes, jpeg_quant) -> None:
    """Integer chroma-from-luma undo (reconstruct.rs:316-397), applied
    frame-wide on the [y, x, b]-ordered quantized coefficient planes."""
    dequant_y = np.asarray(jpeg_quant[1], dtype=np.int64)
    dequant_x = np.asarray(jpeg_quant[0], dtype=np.int64)
    dequant_b = np.asarray(jpeg_quant[2], dtype=np.int64)
    ratio_x = (1 << CFL_FIXED_POINT_BITS) * dequant_y // dequant_x
    ratio_b = (1 << CFL_FIXED_POINT_BITS) * dequant_y // dequant_b

    # frame-wide CfL factor grids (per 64x64) from the LF groups
    header = state.header
    h, w = state.plane_shapes[0]
    w64 = -(-state.width_rounded // 64)
    h64 = -(-state.height_rounded // 64)
    x_grid = np.zeros((h64, w64), dtype=np.int64)
    b_grid = np.zeros((h64, w64), dtype=np.int64)
    lfg_per_row = header.lf_groups_per_row
    for lf_group_idx, group in state.lf_groups.items():
        if group.hf_meta is None:
            continue
        gx = lf_group_idx % lfg_per_row
        gy = lf_group_idx // lfg_per_row
        x0 = gx * (header.lf_group_dim // 64)
        y0 = gy * (header.lf_group_dim // 64)
        gh, gw = group.hf_meta.x_from_y.shape
        x_grid[y0 : y0 + gh, x0 : x0 + gw] = group.hf_meta.x_from_y
        b_grid[y0 : y0 + gh, x0 : x0 + gw] = group.hf_meta.b_from_y

    rounding = 1 << (CFL_FIXED_POINT_BITS - 1)
    coeff_y = coeff_planes[0].astype(np.int64)
    yy = np.arange(h)
    xx = np.arange(w)
    factor_x = x_grid[np.minimum(yy // 64, h64 - 1)][:, np.minimum(xx // 64, w64 - 1)]
    factor_b = b_grid[np.minimum(yy // 64, h64 - 1)][:, np.minimum(xx // 64, w64 - 1)]
    # quant ratio indexed transposed: q[y%8 + 8*(x%8)]
    qidx = (yy[:, None] % 8) + 8 * (xx[None, :] % 8)
    for plane, factor, ratio in (
        (coeff_planes[1], factor_x, ratio_x),
        (coeff_planes[2], factor_b, ratio_b),
    ):
        q = ratio[qidx]
        scale_factor = factor * (1 << CFL_FIXED_POINT_BITS) // CFL_DEFAULT_COLOR_FACTOR
        q_scale = (q * scale_factor + rounding) >> CFL_FIXED_POINT_BITS
        add = (coeff_y * q_scale + rounding) >> CFL_FIXED_POINT_BITS
        plane += add.astype(plane.dtype)


def _process_scan(out, si, smi, frame_header, header, coeff_planes,
                  lf_quant_planes, dc_offset, dc_tables, ac_tables,
                  is_progressive, restart_interval, padding_bs,
                  jpeg_upsampling_ycbcr, do_ycbcr, nat8) -> None:
    """One SOS scan (reconstruct/scan.rs process_scan)."""
    comps = si.component_info
    hsamples = [[1, 2, 2, 1][jpeg_upsampling_ycbcr[c.comp_idx]] for c in comps]
    vsamples = [[1, 2, 1, 2][jpeg_upsampling_ycbcr[c.comp_idx]] for c in comps]
    max_h = max(hsamples).bit_length() - 1
    max_v = max(vsamples).bit_length() - 1
    fw8 = -(-frame_header.width // 8)
    fh8 = -(-frame_header.height // 8)
    w8 = (fw8 + max_h) >> max_h
    h8 = (fh8 + max_v) >> max_v
    if len(comps) == 1:
        if (1 << max_h) == hsamples[0]:
            w8 = fw8
            max_h = 0
        if (1 << max_v) == vsamples[0]:
            h8 = fh8
            max_v = 0
        hsamples = [1]
        vsamples = [1]

    scan_type = 0
    if is_progressive:
        scan_type = 2 if si.ah != 0 else 1
    elif si.ss != 0 or si.se != 0x3F or si.al != 0 or si.ah != 0:
        raise JxlValidationError("jbrd: progressive params in sequential scan")

    ss = max(si.ss, 1)
    se = si.se + 1
    al = si.al

    # Native (C++) scan encoder: the whole per-block Huffman hot loop in
    # one call (reconstruct.rs process_scan + bit_writer.rs parity).
    from .. import native as _native

    if _native.available():
        comps_data = []
        for cidx, c in enumerate(comps):
            idx = c.comp_idx if do_ycbcr else [1, 0, 2][c.comp_idx]
            comps_data.append((
                lf_quant_planes[idx], coeff_planes[idx], dc_offset[idx],
                hsamples[cidx], vsamples[cidx],
                dc_tables[c.dc_tbl_idx], ac_tables[c.ac_tbl_idx],
            ))
        encoded, new_pos = _native.jbr_encode_scan(
            comps_data, scan_type, si.ss == 0, ss, se, al, w8, h8,
            restart_interval, smi.reset_points, smi.extra_zero_runs,
            nat8,
            padding_bs.data if padding_bs is not None else None,
            padding_bs.pos if padding_bs is not None else 0,
        )
        if padding_bs is not None:
            padding_bs.pos = new_pos
        out += encoded
        return

    state = _ScanState(len(comps))
    block_idx = 0
    for y8 in range(h8):
        for x8 in range(w8):
            mcu_idx = x8 + w8 * y8
            if restart_interval and mcu_idx != 0 and mcu_idx % restart_interval == 0:
                state.restart(padding_bs, out)
            for cidx, c in enumerate(comps):
                dc_table = dc_tables[c.dc_tbl_idx] or EMPTY_TABLE
                ac_table = ac_tables[c.ac_tbl_idx] or EMPTY_TABLE
                if state.last_ac_table is None:
                    state.last_ac_table = ac_table
                idx = c.comp_idx if do_ycbcr else [1, 0, 2][c.comp_idx]
                lf_plane = lf_quant_planes[idx]
                hf_plane = coeff_planes[idx]
                dco = dc_offset[idx]
                hs, vs = hsamples[cidx], vsamples[cidx]
                for dy8 in range(vs):
                    y_dc = y8 * vs + dy8
                    for dx8 in range(hs):
                        x_dc = x8 * hs + dx8
                        lh, lw = lf_plane.shape
                        dc_coeff = None
                        if si.ss == 0:
                            v = int(lf_plane[min(y_dc, lh - 1), min(x_dc, lw - 1)])
                            v = max(-2047, min(2047, v - dco))
                            dc_coeff = v >> al if v >= 0 else -((-v) >> al)
                        y0, x0 = y_dc * 8, x_dc * 8
                        ph, pw = hf_plane.shape
                        block = hf_plane[y0 : y0 + 8, x0 : x0 + 8]
                        ac_coeffs = []
                        for (x, y) in nat8[ss:se]:
                            coeff = (
                                int(block[y, x])
                                if y < block.shape[0] and x < block.shape[1]
                                else 0
                            )
                            coeff = np.int16(coeff)
                            coeff = (
                                -((-int(coeff)) >> al)
                                if coeff < 0
                                else int(coeff) >> al
                            )
                            ac_coeffs.append(coeff)
                        ezr = smi.extra_zero_runs.get(block_idx)
                        if block_idx in smi.reset_points:
                            state.emit_eobrun()
                        if scan_type == 0:
                            _seq_block(state, cidx, dc_table, ac_table,
                                       dc_coeff, ac_coeffs, ezr)
                        elif scan_type == 1:
                            _prog_first_block(state, cidx, dc_table, ac_table,
                                              dc_coeff, ac_coeffs, ezr)
                        else:
                            _prog_refine_block(state, ac_table, dc_coeff,
                                               ac_coeffs, ezr)
                        block_idx += 1
    state.flush(padding_bs, out)
