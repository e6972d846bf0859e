"""Splines and noise in the port (render/features.py, ops/noise.py, the
noise field kernel's arithmetic in csrc/noise_math.cuh) against
jxl_oxide_tpu/render/features.py, on the CPU.

Tolerances: parsing, the noise field (integer XorShift128+ bits) and
K12's walk under g++ bit for bit; render_noise and render_spline within
FEAT_TOL = 2e-5 of the JAX functions (tests/test_oracle.py:579; the port
sums each spline's samples into one field before adding it to the
planes, the JAX package adds them one by one); decodes within 1 LSB in
u8 and 2e-5 in float32 (tests/torch_parity.py assert_keyframes_match).
"""

import ctypes
import subprocess

import numpy as np
import pytest
import torch

import torch_parity as tp
from encoder import encode_jxl_modular
from jxl_oxide_tpu.render import context as jax_context
from jxl_oxide_tpu.render import features as jax_features
from jxl_oxide_tpu.render import render as jax_render
from jxl_oxide_tpu_torch import JxlImage
from jxl_oxide_tpu_torch.ops import noise as noise_ops
from jxl_oxide_tpu_torch.ops.cuda import build
from jxl_oxide_tpu_torch.ops.noise import noise_field_plain, noise_seed0
from jxl_oxide_tpu_torch.ops.upsample import symmetric_pad2
from jxl_oxide_tpu_torch.render import context as torch_context
from jxl_oxide_tpu_torch.render import features
from jxl_oxide_tpu_torch.render import render as torch_render

FEAT_TOL = 2e-5
LUT = [0.2, 0.3, 0.4, 0.5, 0.5, 0.4, 0.3, 0.2]


class _Header:
    """The header fields the noise field reads."""

    def __init__(self, width, height, group_dim):
        self.width, self.height, self.group_dim = width, height, group_dim


def spline_spec(points, seed, sigma0=30):
    rng = np.random.default_rng(seed)
    xyb_dct = np.zeros((3, 32), dtype=np.int64)
    xyb_dct[:, :4] = rng.integers(-40, 41, (3, 4))
    xyb_dct[1, 0] = 40
    sigma_dct = np.zeros(32, dtype=np.int64)
    sigma_dct[:2] = (sigma0, 4)
    return dict(points=points, xyb_dct=xyb_dct, sigma_dct=sigma_dct)


def splines_stream(h=48, w=48, upsampling=1, noise=False, seed=3,
                   quant_adjust=2) -> bytes:
    """A Modular stream with three splines (one partly off the frame) and,
    optionally, noise (tests/test_oracle.py:697-716's recipe)."""
    rng = np.random.default_rng(seed)
    sh, sw = -(-h // upsampling), -(-w // upsampling)
    base = [rng.integers(60, 196, (sh, sw), dtype=np.int64)
            for _ in range(3)]
    specs = [spline_spec([(6, 8), (20, 12), (30, 28)], seed),
             spline_spec([(40, 5), (44, 30)], seed + 1, sigma0=12),
             spline_spec([(2, 40), (h + 10, w + 6)], seed + 2)]
    return encode_jxl_modular(
        base, bit_depth=8, image_size=(h, w), upsampling=upsampling,
        splines_spec=(specs, quant_adjust),
        noise_lut=LUT if noise else None)


def noise_stream(h=40, w=40, seed=11, lut=None) -> bytes:
    rng = np.random.default_rng(seed)
    base = [rng.integers(80, 176, (h, w), dtype=np.int64) for _ in range(3)]
    return encode_jxl_modular(
        base, bit_depth=8,
        noise_lut=lut or [0.0, 0.1, 0.2, 0.4, 0.5, 0.5, 0.6, 0.8])


def lf_globals(data):
    """(port, JAX) LfGlobal of frame 0."""
    ours = JxlImage.from_bytes(data, device="cpu")._frames[0]
    ref = tp.jax_image(data)._frames[0]
    return ours.parse_lf_global(), ref.parse_lf_global()


# -- parsing ----------------------------------------------------------------

@pytest.mark.parametrize("quant_adjust", [-3, 0, 2])
def test_spline_parse_matches_jax(quant_adjust):
    ours, ref = lf_globals(splines_stream(quant_adjust=quant_adjust))
    assert ours.splines.quant_adjust == ref.splines.quant_adjust \
        == quant_adjust
    assert len(ours.splines.quant_splines) == 3
    for a, b in zip(ours.splines.quant_splines, ref.splines.quant_splines):
        assert a.quant_points == b.quant_points
        assert a.manhattan_distance == b.manhattan_distance
        np.testing.assert_array_equal(a.xyb_dct, b.xyb_dct)
        np.testing.assert_array_equal(a.sigma_dct, b.sigma_dct)
    for corr in (None, (0.5, -1.25)):
        assert (ours.splines.estimate_area(corr)
                == ref.splines.estimate_area(corr))


def test_noise_parse_matches_jax():
    lut = [0.0, 0.125, 0.25, 0.5, 0.75, 0.999, 0.3, 0.1]
    ours, ref = lf_globals(noise_stream(lut=lut))
    assert ours.noise.lut == ref.noise.lut
    np.testing.assert_allclose(ours.noise.lut, lut, atol=1 / 1024)
    assert ours.splines is None and ours.patches is None


# -- the noise field: the plain version and K12's arithmetic ----------------

FIELD_CASES = [(1, 1, 128), (17, 5, 128), (16, 16, 128), (33, 2, 128),
               (130, 129, 128), (300, 260, 128), (256, 256, 256),
               (513, 130, 256), (200, 70, 512), (90, 1030, 1024)]


@pytest.mark.parametrize("w,h,gdim", FIELD_CASES)
def test_plain_noise_field_is_the_jax_field(w, h, gdim):
    for visible, invisible in ((1, 0), (3, 2), (0, 7)):
        want = jax_features._noise_field(_Header(w, h, gdim), visible,
                                         invisible)
        got = noise_field_plain(w, h, gdim, noise_seed0(visible, invisible))
        assert got.dtype == np.float32 and got.shape == (3, h, w)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


def test_noise_field_on_cpu_is_the_plain_version():
    from jxl_oxide_tpu_torch.ops.cuda.noise import noise_field_cuda

    before = noise_field_cuda.launches
    got = noise_field_cuda(70, 40, 128, 5, "cpu")
    assert noise_field_cuda.launches == before
    np.testing.assert_array_equal(got.numpy(),
                                  noise_field_plain(70, 40, 128, 5))
    with pytest.raises(ValueError):
        noise_field_cuda(70, 40, 128, 5, "meta")


NOISE_SHIM = r"""
#include "noise_math.cuh"

using namespace jxl_noise;

extern "C" unsigned long long split_mix(unsigned long long z) {
  return split_mix_64(z);
}

// n steps of lane `lane` seeded with (seed0, seed1): their sums
extern "C" void lane_steps(unsigned long long seed0, unsigned long long seed1,
                           int lane, int n, unsigned long long* out) {
  Lane st = seed_lane(seed0, seed1, lane);
  for (int i = 0; i < n; ++i) out[i] = next(st);
}

// the kernel's work with each lane's walk in one piece (one segment
// longer than any walk, its jump by x^0): every (group, lane) thread
extern "C" void field(float* out, int w, int h, int gdim,
                      unsigned long long seed0) {
  const int groups = ((w + gdim - 1) / gdim) * ((h + gdim - 1) / gdim);
  const uint64_t identity[2] = {1, 0};
  for (int tid = 0; tid < groups * kLanes; ++tid)
    walk_segment(out, w, h, gdim, identity, 1, 1 << 30, seed0, tid);
}

// lane `lane`'s state after n serial steps, and after the jump by q
extern "C" void lane_state(unsigned long long seed0, unsigned long long seed1,
                           int lane, int n, unsigned long long* out) {
  Lane st = seed_lane(seed0, seed1, lane);
  for (int i = 0; i < n; ++i) next(st);
  out[0] = st.s0;
  out[1] = st.s1;
}

extern "C" void lane_jumped(unsigned long long seed0, unsigned long long seed1,
                            int lane, unsigned long long q_lo,
                            unsigned long long q_hi, unsigned long long* out) {
  const Lane st = jump(seed_lane(seed0, seed1, lane), q_lo, q_hi);
  out[0] = st.s0;
  out[1] = st.s1;
}

// the segmented launch: every thread of K12's grid in turn
extern "C" void segmented_field(float* out, int w, int h, int gdim,
                                unsigned long long seed0,
                                const unsigned long long* table, int segments,
                                int seg, int threads) {
  for (int tid = 0; tid < threads; ++tid)
    walk_segment(out, w, h, gdim, reinterpret_cast<const uint64_t*>(table),
                 segments, seg, seed0, tid);
}
"""


@pytest.fixture(scope="module")
def noise_shim(tmp_path_factory):
    d = tmp_path_factory.mktemp("noise_math")
    src = d / "shim.cpp"
    src.write_text(NOISE_SHIM)
    lib = d / "libnoise_math.so"
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-Wall", "-Werror",
         "-I", build.CSRC_DIR, "-o", str(lib), str(src)],
        check=True, capture_output=True, timeout=120,
    )
    lib = ctypes.CDLL(str(lib))
    lib.split_mix.argtypes = [ctypes.c_ulonglong]
    lib.split_mix.restype = ctypes.c_ulonglong
    lib.lane_steps.argtypes = [ctypes.c_ulonglong, ctypes.c_ulonglong,
                               ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.field.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [
        ctypes.c_ulonglong]
    lib.lane_state.argtypes = [ctypes.c_ulonglong, ctypes.c_ulonglong,
                               ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.lane_jumped.argtypes = [ctypes.c_ulonglong, ctypes.c_ulonglong,
                                ctypes.c_int, ctypes.c_ulonglong,
                                ctypes.c_ulonglong, ctypes.c_void_p]
    lib.segmented_field.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [
        ctypes.c_ulonglong, ctypes.c_void_p] + [ctypes.c_int] * 3
    return lib


def test_split_mix_and_xorshift_match_numpy(noise_shim):
    """SplitMix64 and the XorShift128+ step of csrc/noise_math.cuh, bit
    for bit the JAX package's numpy versions, at the u64 extremes."""
    zs = np.array([0, 1, 2**63, 2**64 - 1, 0x9E3779B97F4A7C15,
                   0x123456789ABCDEF0], dtype=np.uint64)
    with np.errstate(over="ignore"):
        want = jax_features._split_mix_64(zs)
    got = [noise_shim.split_mix(int(z)) for z in zs]
    assert got == [int(v) for v in want]
    for seed0, seed1 in ((0, 0), (2**64 - 1, 5), ((3 << 32) + 2, 256 << 32)):
        batches = jax_features._xorshift_batches(seed0, seed1, 40)
        lanes = batches.view("<u8").reshape(40, 8)
        for lane in range(8):
            out = np.zeros(40, dtype=np.uint64)
            noise_shim.lane_steps(seed0, seed1, lane, 40, out.ctypes.data)
            np.testing.assert_array_equal(out, lanes[:, lane])


@pytest.mark.parametrize("w,h,gdim", FIELD_CASES)
def test_kernel_walk_is_the_jax_field(noise_shim, w, h, gdim):
    """K12's walk (walk_segment for every group and lane with each lane's
    walk in one segment, in any order: each writes its own samples) gives
    the JAX package's field bit for bit:
    partial groups at the right and bottom edges, W % 16 != 0, one
    group, widths under one batch."""
    want = jax_features._noise_field(_Header(w, h, gdim), 2, 1)
    got = np.full((3, h, w), np.nan, dtype=np.float32)
    noise_shim.field(got.ctypes.data, w, h, gdim, noise_seed0(2, 1))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# -- K12's jump-ahead: chi, the jump table, the jump, the segmented walk ----

JUMPS = [0, 1, 127, 128, 129, 4095, 12_288, 196_607]


def _seeded_states(n, seed):
    """n random XorShift128+ states (nonzero) from a numpy seed."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**64, (n, 2), dtype=np.uint64, endpoint=False)
    return [(int(a), int(b) | 1) for a, b in words]


def _mulmod(a, b, chi):
    """a * b mod chi over GF(2), bit by bit: the test's own arithmetic."""
    r = 0
    for i in range(b.bit_length()):
        if b >> i & 1:
            r ^= a << i
    for i in range(r.bit_length() - 1, 127, -1):
        if r >> i & 1:
            r ^= chi << (i - 128)
    return r


def _x_pow_mod(n, chi):
    """x^n mod chi by square-and-multiply."""
    result, base = 1, 2
    while n:
        if n & 1:
            result = _mulmod(result, base, chi)
        base = _mulmod(base, base, chi)
        n >>= 1
    return result


def _row(table, j):
    return int(table[j, 0]) | int(table[j, 1]) << 64


def test_chi_annihilates_the_step():
    """chi as the port computes it (Berlekamp-Massey over the
    recurrence) has degree 128 and chi(T) s = 0 on seeded random states;
    the state map is the JAX package's step (its sums, lane by lane)."""
    chi = noise_ops.characteristic_polynomial()
    assert chi.bit_length() == 129 and chi & 1
    for s in _seeded_states(6, 11):
        acc, t = (0, 0), s
        for i in range(129):
            if chi >> i & 1:
                acc = (acc[0] ^ t[0], acc[1] ^ t[1])
            t = noise_ops.xorshift_state_step(*t)
        assert acc == (0, 0)
    seed0, seed1 = (3 << 32) + 2, 256 << 32
    lanes = jax_features._xorshift_batches(seed0, seed1, 20).view(
        "<u8").reshape(20, 8)
    with np.errstate(over="ignore"):
        s0 = noise_ops._split_mix_64(np.uint64(seed0) + noise_ops._GOLDEN)
        s1 = noise_ops._split_mix_64(np.uint64(seed1) + noise_ops._GOLDEN)
        for lane in range(8):
            st = (int(s0), int(s1))
            for b in range(20):
                assert (st[0] + st[1]) % 2**64 == int(lanes[b, lane])
                st = noise_ops.xorshift_state_step(*st)
            s0, s1 = (noise_ops._split_mix_64(s0),
                      noise_ops._split_mix_64(s1))


@pytest.mark.parametrize("n", JUMPS)
def test_jump_table_and_jump(noise_shim, n):
    """The jump table's q_n (row 1 of the table of seg n, row 2 of seg
    n // 2 where n is even) is x^n mod chi by square-and-multiply, and the
    shim's jump by it from each of lanes 0-7 is n serial steps."""
    chi = noise_ops.characteristic_polynomial()
    want = _x_pow_mod(n, chi)
    if n == 0:
        q = _row(noise_ops.jump_table(5, 1), 0)
    else:
        table = noise_ops.jump_table(n, 3)
        q = _row(table, 1)
        assert _row(table, 2) == _x_pow_mod(2 * n, chi)
        if n % 2 == 0:
            assert _row(noise_ops.jump_table(n // 2, 3), 2) == q
    assert q == want
    serial, jumped = np.zeros(2, np.uint64), np.zeros(2, np.uint64)
    for (seed0, seed1), lane in zip(_seeded_states(8, n), range(8)):
        noise_shim.lane_state(seed0, seed1, lane, n, serial.ctypes.data)
        noise_shim.lane_jumped(seed0, seed1, lane, q & (2**64 - 1), q >> 64,
                               jumped.ctypes.data)
        np.testing.assert_array_equal(jumped, serial)


def test_jump_table_rows_are_powers():
    """Every row of a table of seg 7 (a few hundred, extended in two calls)
    is x^(7 j) mod chi."""
    chi = noise_ops.characteristic_polynomial()
    short = noise_ops.jump_table(7, 40)
    table = noise_ops.jump_table(7, 300)
    np.testing.assert_array_equal(table[:40], short)
    for j in range(300):
        assert _row(table, j) == _x_pow_mod(7 * j, chi)


@pytest.mark.parametrize("seg", [7, 16])
@pytest.mark.parametrize("w,h,gdim", FIELD_CASES)
def test_segmented_walk_is_the_jax_field(noise_shim, w, h, gdim, seg):
    """K12's launch (walk_segment for every thread of its grid, in any
    order: each writes its own samples) with segments of 7 or 16 batches,
    so that segments cross rows and channels and the last one is short,
    gives the JAX package's field bit for bit."""
    from jxl_oxide_tpu_torch.ops.cuda.noise import launch_shape

    segments, threads = launch_shape(w, h, gdim, seg)
    table = np.ascontiguousarray(noise_ops.jump_table(seg, segments))
    want = jax_features._noise_field(_Header(w, h, gdim), 2, 1)
    got = np.full((3, h, w), np.nan, dtype=np.float32)
    noise_shim.segmented_field(got.ctypes.data, w, h, gdim, noise_seed0(2, 1),
                               table.ctypes.data, segments, seg, threads)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


class _FakeDevice:
    type, index = "cuda", 1


class _FakeOut:
    """A stand-in for a [3, 40, 70] float32 tensor on cuda:1."""

    shape = (3, 40, 70)
    device = _FakeDevice()

    def data_ptr(self):
        return 0x1000


def test_k12_launch_runs_on_outs_device(monkeypatch):
    """ops/cuda/noise.py `launch` makes out's device current around the
    kernel's launch (and restores the one before), takes that device's
    current stream, and asks for the jump table on that device."""
    from jxl_oxide_tpu_torch.ops.cuda import noise as k12

    events = []

    class Table:
        shape = (9, 2)

        def data_ptr(self):
            return 0x2000

    def device_table(seg, segments, device):
        events.append(("table", seg, segments, device.index))
        return Table()

    def exchange(index):
        events.append(("exchange", index))
        return 0

    def fn(*args):
        events.append(("launch", args))
        return 0

    monkeypatch.setattr(k12, "_fn", lambda: fn)
    monkeypatch.setattr(k12, "_device_table", device_table)
    monkeypatch.setattr(torch.cuda, "_exchange_device", exchange)
    monkeypatch.setattr(torch.cuda, "_maybe_exchange_device",
                        lambda index: events.append(("restore", index)))
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: events.append(("stream", index)) or 77,
                        raising=False)
    k12.launch(_FakeOut(), 128, 5, seg=16)
    segments, _ = k12.launch_shape(70, 40, 128, 16)
    assert events == [
        ("table", 16, segments, 1), ("exchange", 1), ("stream", 1),
        ("launch", (0x1000, 70, 40, 128, 5, 0x2000, 9, 16, 77)),
        ("restore", 0)]


def test_clear_program_caches_drops_the_jump_tables():
    from jxl_oxide_tpu_torch import clear_program_caches
    from jxl_oxide_tpu_torch.ops.cuda import noise as k12

    k12._tables[(16, torch.device("cpu"))] = torch.zeros(3, 2,
                                                         dtype=torch.int64)
    clear_program_caches()
    assert not k12._tables


# -- noise and spline rendering ---------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_symmetric_pad_is_numpy_symmetric(n):
    x = np.arange(3 * n * (n + 1), dtype=np.float32).reshape(3, n, n + 1)
    got = symmetric_pad2(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(
        got, np.pad(x, ((0, 0), (2, 2), (2, 2)), mode="symmetric"))


def test_interp_lut_saturates_as_the_reference():
    lut9 = np.asarray(LUT + [LUT[7]], dtype=np.float32)
    v = np.array([0.0, 0.3, 1.0, 6.99, 7.0, 7.5, 12.0, np.inf, np.nan, 3e9],
                 dtype=np.float32)
    want = jax_features._interp_lut(lut9, v.copy())
    got = features._interp_lut(torch.from_numpy(lut9), torch.from_numpy(v))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape,full,gdim,corr", [
    ((40, 40), (40, 40), 128, None),
    ((30, 70), (30, 70), 128, (0.25, 1.5)),
    ((1, 2), (1, 2), 128, None),
    ((3, 3), (3, 3), 128, None),
    # sample-resolution planes: the full-resolution field's corner
    ((20, 33), (40, 66), 128, None),
    ((64, 64), (256, 256), 256, (-0.5, 0.75)),
])
def test_render_noise_matches_jax(shape, full, gdim, corr):
    rng = np.random.default_rng(sum(shape))
    planes = [(rng.random(shape) * 1.4 - 0.2).astype(np.float32)
              for _ in range(3)]
    planes[0][0, 0] = np.nan  # saturates to the LUT's first entry
    if shape[1] > 1:
        planes[1][0, 1] = 1e30
    header = _Header(full[1], full[0], gdim)
    want = [p.copy() for p in planes]
    jax_features.render_noise(want, header, 3, 1, corr, LUT)
    got = [torch.from_numpy(p.copy()) for p in planes]
    features.render_noise(got, header, 3, 1, corr, LUT)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=FEAT_TOL, rtol=0,
                                   equal_nan=True)


@pytest.mark.parametrize("upsampling,quant_adjust", [(1, 2), (1, -3),
                                                     (2, 0), (4, 2)])
def test_render_spline_matches_jax(upsampling, quant_adjust):
    data = splines_stream(48, 48, upsampling, quant_adjust=quant_adjust)
    ours, ref = lf_globals(data)
    side = -(-48 // upsampling)
    rng = np.random.default_rng(upsampling)
    planes = [rng.random((side, side)).astype(np.float32) for _ in range(3)]
    for corr in (None, (0.5, -0.75)):
        want = [p.copy() for p in planes]
        jax_features.render_spline(want, ref.splines, corr, 48, 48)
        got = [torch.from_numpy(p.copy()) for p in planes]
        features.render_spline(got, ours.splines, corr, 48, 48)
        for g, w, p in zip(got, want, planes):
            assert not np.array_equal(w, p)  # the splines drew
            np.testing.assert_allclose(g.numpy(), w, atol=FEAT_TOL, rtol=0)


# -- the feature pass and its seed counters ---------------------------------

@pytest.mark.parametrize("is_keyframe,counters", [
    (True, (0, 0, None)),
    (True, (4, 2, 3)),
    (False, (5, 2, 3)),
    (False, (4, 0, None)),
])
def test_noise_seed_counters_match_the_jax_context(is_keyframe, counters):
    """The feature pass of both RenderContexts with the counters a cone
    render sets (frame index, keyframes before it, the last keyframe's
    index), on a noise frame made a keyframe or not by hand (no in-repo
    encoder writes noise on a frame that is not the last): the same
    visible/invisible seeds, so the same noise."""
    data = noise_stream()
    ours = JxlImage.from_bytes(data, device="cpu")
    ref = tp.jax_image(data)
    outs = []
    for img, ctx_mod, render_mod, args in (
            (ours, torch_context, torch_render, ("cpu",)),
            (ref, jax_context, jax_render, ())):
        frame = img._frames[0]
        frame.header.is_last = is_keyframe
        frame.header.duration = 0
        assert frame.header.is_keyframe == is_keyframe
        fr = render_mod.render_frame(frame, *args)
        ctx = ctx_mod.RenderContext(img.image_header, *args)
        (ctx._frame_counter, ctx._num_prev_keyframes,
         ctx._last_keyframe_idx) = counters
        ctx._apply_features(fr, frame)
        outs.append([np.asarray(p) for p in fr.color])
    for got, want in zip(*outs):
        np.testing.assert_allclose(got, want, atol=FEAT_TOL, rtol=0)


def _counting(monkeypatch, module):
    """The counters each add_frame of `module`'s RenderContext starts
    with, in order."""
    seen = []
    real = module.RenderContext.add_frame

    def add_frame(self, frame, *args, **kwargs):
        seen.append((self._frame_counter, self._num_prev_keyframes,
                     self._last_keyframe_idx))
        return real(self, frame, *args, **kwargs)

    monkeypatch.setattr(module.RenderContext, "add_frame", add_frame)
    return seen


def test_cone_replays_the_counters(monkeypatch):
    """A cone render sets each frame's counters from the headers, as the
    JAX package's does: the last keyframe of a Blend chain first (its
    cone is every frame), then an earlier one, on fresh images; and a
    reference-only frame before a keyframe."""
    from test_torch_animation import blend_stream
    from test_torch_patches import mode_stream

    ours = _counting(monkeypatch, torch_context)
    ref = _counting(monkeypatch, jax_context)
    for data in (blend_stream(True, False, frames=3), mode_stream(1)):
        img, jimg = JxlImage.from_bytes(data, device="cpu"), tp.jax_image(
            data)
        for k in range(img.num_keyframes - 1, -1, -1):
            img.render_frame(k)
            jimg.render_frame(k)
    assert ours == ref
    assert (2, 2, 1) in ours


# -- decodes ----------------------------------------------------------------

@pytest.mark.parametrize("make", [
    lambda: noise_stream(),
    lambda: splines_stream(),
    lambda: splines_stream(64, 64, 2, noise=True),
    lambda: splines_stream(48, 40, 4, noise=True, seed=5),
    # greyscale: splines and noise touch three colour planes only
    lambda: encode_jxl_modular(
        [np.random.default_rng(6).integers(0, 256, (32, 32))],
        bit_depth=8, noise_lut=LUT),
    # noise on an upsampled, filtered frame
    lambda: encode_jxl_modular(
        [np.random.default_rng(7).integers(0, 256, (32, 32))
         for _ in range(3)], bit_depth=8, noise_lut=LUT, gabor=True,
        epf_iters=1, image_size=(64, 64), upsampling=2),
], ids=["noise", "splines", "up2_splines_noise", "up4_splines_noise",
        "grey_noise", "up2_noise_epf"])
def test_feature_streams_decode_as_jax(make):
    tp.assert_keyframes_match(make(), exact=False)


def test_features_up2_1024_fixture():
    """The committed features_up2_1024 (splines, noise and x2 upsampling
    of a gaborish + EPF 2 frame): its reference is the JAX decode, the
    port on the CPU is within 1 LSB of it, and it renders its features
    at 512^2 from a 1024^2 noise field of one group."""
    data, ref = tp.fixture("features_up2_1024")
    img = JxlImage.from_bytes(data, device="cpu")
    header = img._frames[0].header
    assert (header.upsampling, header.group_dim) == (2, 1024)
    assert header.flags.noise and header.flags.splines
    assert header.restoration_filter.epf.iters == 2
    assert ref.shape == (1024, 1024, 3)
    assert tp.max_lsb(img.render_frame(0).to_u8(), ref) <= 1
