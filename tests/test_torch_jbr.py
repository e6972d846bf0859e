"""JPEG reconstruction in the port (jxl_oxide_tpu_torch/jbr/) against the
JAX package's (jxl_oxide_tpu/jbr/), byte for byte: every fake-frame case
of tests/test_jbr.py (its helpers, imported), with the native scan
encoder and with the Python one, and the committed container
jbrd_container_256 (its reconstruction by the JAX package in the .npz);
the coefficient planes of the port's host stage against the JAX
package's keep_coeffs decode; the errors."""

import contextlib
import copy
import types

import numpy as np
import pytest

import jxl_oxide_tpu.native as jax_native
import jxl_oxide_tpu_torch.native as torch_native
import torch_parity as tp
from jxl_oxide_tpu.jbr import JpegBitstreamData as JaxJbrd
from jxl_oxide_tpu.jbr import reconstruct_jpeg as jax_reconstruct
from jxl_oxide_tpu_torch import JxlImage
from jxl_oxide_tpu_torch.headers.frame import Encoding
from jxl_oxide_tpu_torch.jbr import JpegBitstreamData, reconstruct_jpeg
from jxl_oxide_tpu_torch.utils.errors import JxlError, JxlValidationError
from test_jbr import (
    _Flags,
    make_fake_frame,
    make_jbrd_box,
    make_jbrd_box_color_420,
    make_jbrd_box_dri,
    make_jbrd_box_progressive,
)

SEQ = [0xC0, 0xC4, 0xDB, 0xDA, 0xD9]


def _rng_planes(seed, h, w, lo, hi, zero=0.0):
    rng = np.random.default_rng(seed)
    lf = rng.integers(-20, 21, (h // 8, w // 8)).astype(np.int32)
    co = rng.integers(lo, hi, (h, w)).astype(np.int32)
    co[rng.random((h, w)) < zero] = 0
    return lf, co


def _color_420_frame(lf_planes, y_coeff, quant):
    """The 4:2:0 fake frame of test_jbr.py's color cases (built inline
    there)."""
    header = types.SimpleNamespace(
        encoding=None, do_ycbcr=True, jpeg_upsampling=(0, 1, 0),
        flags=_Flags(), width=32, height=32, lf_groups_per_row=1,
        lf_group_dim=2048)
    state = types.SimpleNamespace(
        coeff_planes=[np.zeros((16, 16), np.int32), y_coeff.copy(),
                      np.zeros((16, 16), np.int32)],
        lf_quant_planes=[p.copy() for p in lf_planes],
        plane_shapes=[(16, 16), (32, 32), (16, 16)],
        width_rounded=32, height_rounded=32, lf_groups={}, header=header)
    return types.SimpleNamespace(
        header=header,
        image_header=types.SimpleNamespace(
            metadata=types.SimpleNamespace(xyb_encoded=False),
            size=types.SimpleNamespace(width=32, height=32)),
        _vardct_state=state,
        _hf_global=types.SimpleNamespace(
            dequant_matrices=types.SimpleNamespace(
                jpeg_quant_values=[list(quant.ravel())] * 3)))


def _progressive_coeff():
    quant = np.full((8, 8), 8, dtype=np.int32)
    lf = np.array([[5, -6], [7, 2]], dtype=np.int32)
    co = np.zeros((16, 16), dtype=np.int32)
    co[0, 1], co[3, 2], co[9, 10] = 4, -2, 3
    for by in range(2):
        for bx in range(2):
            co[by * 8 + 7, bx * 8 + 7] = (-1) ** (by + bx) * (1 + bx)
    return lf, co, quant


def _cases():
    """name -> (box maker, frame maker) of tests/test_jbr.py's cases,
    and of its differential sweep's seeds."""
    q16 = np.full((8, 8), 16, dtype=np.int32)
    q8 = np.full((8, 8), 8, dtype=np.int32)
    out = {}
    lf = np.array([[2, -3], [5, 0]], dtype=np.int32)
    out["grayscale_sequential"] = (
        lambda: make_jbrd_box(SEQ),
        lambda: make_fake_frame(16, 16, lf, np.zeros((16, 16), np.int32),
                                q16))
    co = np.zeros((8, 8), dtype=np.int32)
    co[0, 1], co[3, 2], co[7, 7] = 4, -2, 1
    out["ac_coefficients"] = (
        lambda: make_jbrd_box(SEQ),
        lambda: make_fake_frame(8, 8, np.array([[10]], np.int32), co, q8))
    out["tail_data"] = (
        lambda: make_jbrd_box(SEQ, tail=b"TRAILER-BYTES"),
        lambda: make_fake_frame(8, 8, np.zeros((1, 1), np.int32),
                                np.zeros((8, 8), np.int32), q16))
    y_dc = np.array([[-2, 1, 4, -1], [3, 0, -4, 2], [1, 1, 0, -3],
                     [2, -1, 3, 0]], dtype=np.int32)
    cb, cr = (np.array([[4, -4], [2, -2]], np.int32),
              np.array([[-3, 3], [-1, 1]], np.int32))
    out["color_420"] = (
        lambda: make_jbrd_box_color_420(SEQ),
        lambda: _color_420_frame([cb, y_dc, cr],
                                 np.zeros((32, 32), np.int32), q16))
    plf, pco, pq = _progressive_coeff()
    out["progressive"] = (make_jbrd_box_progressive,
                          lambda: make_fake_frame(16, 16, plf, pco, pq))
    slf, sco = _rng_planes(3, 32, 32, -6, 7, 0.7)
    out["sequential_32"] = (lambda: make_jbrd_box(SEQ),
                            lambda: make_fake_frame(32, 32, slf, sco, q16))
    rlf, rco = _rng_planes(9, 16, 32, -4, 5, 0.75)
    out["restart_intervals"] = (
        lambda: make_jbrd_box_dri(2),
        lambda: make_fake_frame(32, 16, rlf, rco, q16))
    dlf, dco = _rng_planes(21, 64, 256, -4, 5, 0.7)
    out["dri_segments"] = (lambda: make_jbrd_box_dri(8),
                           lambda: make_fake_frame(256, 64, dlf, dco, q16))
    for seed in range(6):
        out[f"sweep_{seed}"] = _sweep_case(seed)
    return out


def _sweep_case(seed):
    """test_jbr.py test_jbr_differential_sweep's case of `seed`."""
    rng = np.random.default_rng(100 + seed)
    quant = np.full((8, 8), int(rng.integers(4, 32)), dtype=np.int32)
    kind = seed % 3
    if kind == 0:
        h8, w8 = int(rng.integers(1, 5)), int(rng.integers(1, 5))
        lf = rng.integers(-30, 31, (h8, w8)).astype(np.int32)
        co = rng.integers(-8, 9, (h8 * 8, w8 * 8)).astype(np.int32)
        co[rng.random(co.shape) < 0.6] = 0
        dri = int(rng.integers(1, 4))
        box = ((lambda: make_jbrd_box_dri(dri)) if seed % 2
               else (lambda: make_jbrd_box(SEQ)))
        return box, lambda: make_fake_frame(w8 * 8, h8 * 8, lf, co, quant)
    if kind == 1:
        lf = rng.integers(-20, 21, (2, 2)).astype(np.int32)
        co = rng.integers(-6, 7, (16, 16)).astype(np.int32)
        co[rng.random(co.shape) < 0.5] = 0
        co[7::8, 7::8] = 1  # keep eobrun at 0 (no EOBn in Annex K)
        return (make_jbrd_box_progressive,
                lambda: make_fake_frame(16, 16, lf, co, quant))
    yv = rng.integers(-7, 8, (32, 32)).astype(np.int32)
    yv[rng.random((32, 32)) < 0.7] = 0
    lfs = [rng.integers(-9, 10, (2, 2)).astype(np.int32),
           rng.integers(-9, 10, (4, 4)).astype(np.int32),
           rng.integers(-9, 10, (2, 2)).astype(np.int32)]
    return (lambda: make_jbrd_box_color_420(SEQ),
            lambda: _color_420_frame(lfs, yv, quant))


CASES = _cases()


@contextlib.contextmanager
def python_scan_encoder(native_module):
    """The package's scan encoder without its native library (the Python
    fallback in jbr/ `_process_scan`)."""
    old = (native_module._lib, native_module._tried)
    native_module._lib, native_module._tried = None, True
    try:
        yield
    finally:
        native_module._lib, native_module._tried = old


def _port_frame(frame):
    """A fake frame whose header names the port's Encoding."""
    frame = copy.copy(frame)
    frame.header = copy.copy(frame.header)
    frame.header.encoding = Encoding.VARDCT
    frame._vardct_state = copy.copy(frame._vardct_state)
    frame._vardct_state.header = frame.header
    return frame


def _jax_frame(frame):
    from jxl_oxide_tpu.headers.frame import Encoding as JaxEncoding

    frame.header.encoding = JaxEncoding.VARDCT
    return frame


@pytest.mark.parametrize("encoder", ["native", "python"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fake_frames_byte_identical(case, encoder):
    box, frame = CASES[case]
    want = jax_reconstruct(JaxJbrd(box()), _jax_frame(frame()))
    ctx = (python_scan_encoder(torch_native) if encoder == "python"
           else contextlib.nullcontext())
    with ctx:
        got = reconstruct_jpeg(JpegBitstreamData(box()),
                               _port_frame(frame()))
    assert got == want
    if case == "tail_data":
        assert got.endswith(b"TRAILER-BYTES")
    if case.startswith("restart"):
        assert b"\xff\xd0" in got


def test_python_encoder_matches_jax_python_encoder():
    """The Python scan encoders of both packages on the progressive case
    (its EOB runs and refinement bits take the fallback's longest
    branches)."""
    box, frame = CASES["progressive"]
    with python_scan_encoder(jax_native):
        want = jax_reconstruct(JaxJbrd(box()), _jax_frame(frame()))
    with python_scan_encoder(torch_native):
        got = reconstruct_jpeg(JpegBitstreamData(box()),
                               _port_frame(frame()))
    assert got == want


@pytest.fixture(scope="module")
def container():
    data, _ = tp.fixture("jbrd_container_256")
    ref = np.load(f"{tp.TESTDATA}/jbrd_container_256.npz")
    return data, ref


@pytest.mark.parametrize("encoder", ["native", "python"])
def test_container_reconstructs_the_jax_bytes(container, encoder):
    data, ref = container
    img = JxlImage.from_bytes(data, device="cpu")
    assert img.jpeg_reconstruction_available
    ctx = (python_scan_encoder(torch_native) if encoder == "python"
           else contextlib.nullcontext())
    with ctx:
        assert img.reconstruct_jpeg() == ref["jpeg"].tobytes()


def test_render_around_the_reconstruction(container):
    """A render before and after the reconstruction gives the committed
    render (the JAX package's render after its reconstruction raises on
    this single-section frame, ROADMAP Queue 3), and the reconstruction
    takes no plane from the plane pool and gives none back."""
    from jxl_oxide_tpu_torch.render import vardct

    data, ref = container
    img = JxlImage.from_bytes(data, device="cpu")
    before = img.render_frame(0).to_u8()
    img._keyframe_cache.clear()
    with vardct._PLANE_POOL_LOCK:
        pool = {k: [id(a) for a in v] for k, v in vardct._PLANE_POOL.items()}
    assert img.reconstruct_jpeg() == ref["jpeg"].tobytes()
    with vardct._PLANE_POOL_LOCK:
        assert {k: [id(a) for a in v]
                for k, v in vardct._PLANE_POOL.items()} == pool
    after = img.render_frame(0).to_u8()
    assert tp.max_lsb(before, ref["u8"]) <= 1
    assert np.array_equal(before, after)


def test_coefficient_planes_equal_the_jax_keep_coeffs_decode(container):
    """The port's host stage for the reconstruction against
    decode_vardct_frame(frame, keep_coeffs=True): every quantized
    coefficient and LF-quant plane bit for bit, in [x, y, b] order, and
    none of them a pool plane."""
    from jxl_oxide_tpu import JxlImage as JaxImage
    from jxl_oxide_tpu.render.vardct import decode_vardct_frame
    from jxl_oxide_tpu_torch.render.render import coefficient_host_stage

    data, _ = container
    jframe = JaxImage.from_bytes(data)._frames[0]
    decode_vardct_frame(jframe, keep_coeffs=True)
    want = jframe._vardct_state
    host = coefficient_host_stage(
        JxlImage.from_bytes(data, device="cpu")._frames[0])
    assert not host.state._planes_poolable
    for got_planes, want_planes in (
            (host.state.coeff_planes, want.coeff_planes),
            (host.state.lf_quant_planes, want.lf_quant_planes)):
        assert len(got_planes) == 3
        for g, w in zip(got_planes, want_planes):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    assert (host.hf_global.dequant_matrices.jpeg_quant_values
            == jframe._hf_global.dequant_matrices.jpeg_quant_values)


def test_a_4_4_4_ycbcr_frame_reconstructs_though_it_does_not_render(
        container):
    """A jbrd stream from a 4:4:4 colour JPEG is ROADMAP item 7's 4:4:4
    YCbCr VarDCT layout, which the render refuses; the reconstruction
    checks no envelope. The frame header is set to do_ycbcr in both
    packages (no in-repo encoder writes it)."""
    from jxl_oxide_tpu import JxlImage as JaxImage
    from jxl_oxide_tpu_torch.utils.errors import JxlNotSupportedError

    data, _ = container
    jimg = JaxImage.from_bytes(data)
    jimg._frames[0].header.do_ycbcr = True
    img = JxlImage.from_bytes(data, device="cpu")
    img._frames[0].header.do_ycbcr = True
    with pytest.raises(JxlNotSupportedError, match="item 7"):
        img.render_frame(0)
    assert img.reconstruct_jpeg() == jimg.reconstruct_jpeg()


def _container(codestream: bytes, jbrd: bytes | None = None) -> bytes:
    def box(ty, content):
        return (8 + len(content)).to_bytes(4, "big") + ty + content

    return (b"\x00\x00\x00\x0cJXL \x0d\x0a\x87\x0a"
            + (box(b"jbrd", jbrd) if jbrd is not None else b"")
            + box(b"jxlc", codestream))


def test_errors_as_the_jax_package_raises():
    """No jbrd box; an XYB frame; a Modular frame; an ICC length the
    frame does not have: the port raises where and as the JAX package
    does."""
    from encoder import encode_jxl_modular

    from jxl_oxide_tpu import JxlImage as JaxImage
    from jxl_oxide_tpu.utils.errors import JxlError as JaxError

    box, frame = CASES["grayscale_sequential"]
    jbrd = box()
    modular = encode_jxl_modular([np.zeros((16, 16), np.int64)], bit_depth=8,
                                 grayscale=True)
    xyb = tp.vardct_stream(16, 16, 3, xyb=True)
    for stream, match in ((_container(modular), "no jbrd box"),
                          (_container(modular, jbrd), "not VarDCT"),
                          (_container(xyb, jbrd), "xyb")):
        img = JxlImage.from_bytes(stream, device="cpu")
        assert img.jpeg_reconstruction_available == (
            JaxImage.from_bytes(stream).jpeg_reconstruction_available)
        with pytest.raises(JaxError, match=match):
            JaxImage.from_bytes(stream).reconstruct_jpeg()
        with pytest.raises(JxlError, match=match):
            img.reconstruct_jpeg()
    # the grey case's box with an ICC app marker of 9 payload bytes
    icc_box = _icc_marker_box()
    f = frame()
    with pytest.raises(JaxError, match="ICC length"):
        jax_reconstruct(JaxJbrd(icc_box), _jax_frame(f), icc=b"x" * 8)
    with pytest.raises(JxlValidationError, match="ICC length"):
        reconstruct_jpeg(JpegBitstreamData(icc_box), _port_frame(frame()),
                         icc=b"x" * 8)
    assert (reconstruct_jpeg(JpegBitstreamData(icc_box),
                             _port_frame(frame()), icc=b"x" * 9)
            == jax_reconstruct(JaxJbrd(icc_box), _jax_frame(frame()),
                               icc=b"x" * 9))


def _icc_marker_box() -> bytes:
    """make_jbrd_box's grey sequential header with one APP2 ICC marker
    (type 1) of 9 payload bytes before the frame markers."""
    from encoder import BitWriter

    from test_jbr import (
        AC_COUNTS,
        AC_VALUES,
        DC_COUNTS,
        DC_VALUES,
        _write_huffman_code,
        brotli_compress,
    )

    w = BitWriter()
    w.write_bool(True)  # is_gray
    for m in [0xE2] + SEQ:
        w.write(m - 0xC0, 6)
    w.write(1, 2)  # app marker type 1 (ICC): U32 selector 1
    w.write(9 + 5 + 12 - 1, 16)  # length - 1: payload + 5 + "ICC_PROFILE\0"
    w.write(0, 2)
    w.write(0, 1)
    w.write(0, 2)
    w.write_bool(True)
    w.write(0, 2)
    w.write(0, 2)
    w.write(1, 2)
    w.write(0, 3)
    _write_huffman_code(w, False, 0, False, DC_COUNTS, DC_VALUES)
    _write_huffman_code(w, True, 0, True, AC_COUNTS, AC_VALUES)
    w.write(0, 2)
    w.write(0, 6)
    w.write(63, 6)
    w.write(0, 4)
    w.write(0, 4)
    w.write(0, 2)
    w.write(0, 2)
    w.write(0, 2)
    w.write(0, 2)  # last_needed_pass
    w.write(0, 2)  # no reset points
    w.write(0, 2)  # no extra zero runs
    w.write(0, 2)  # no tail
    w.write_bool(False)
    w.zero_pad_to_byte()
    return w.to_bytes() + brotli_compress(b"")
