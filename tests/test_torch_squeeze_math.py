"""The squeeze kernel's arithmetic and walk (jxl_oxide_tpu_torch/csrc/
squeeze_math.cuh), built for the CPU with g++ through a small C shim,
against the plain torch inverse squeeze (ops/modular_tail.py).

The shim walks the lines as csrc/modular_squeeze.cu does, with the
header's clamped load positions, ring indices and stage layout: the
vertical kernel's column loop (each avg sample read once, as the step
before's `next`; the loads of 16 steps, clamped at the end, before their
walk), and the horizontal kernel's blocks of 32 rows: the copy warp's
loads into a ring of stages (TMA's zero fill or cp.async's clamped
positions, into the 128-byte swizzled layout), the walker's 16-byte reads
of its row, its walk and its writes into a ring of output stages, the
drain, and every barrier wait held against the phase parity the kernel
waits on. Only the copies themselves, the barriers and the launch are
left to the card (tests/test_torch_cuda.py, chip_smoke.py). The chain
probe's walk (csrc/squeeze_probe.cu) is held against its plain torch
twin (ops/cuda/squeeze_measure.py).

A second build of the same header with g++'s undefined-behaviour
sanitizer runs the arithmetic at the INT32 extremes in a child process:
it fails on any signed overflow, which nvcc may assume never happens.

Tolerance: none. The squeeze is integer arithmetic, equal bit for bit.
"""

import ctypes
import os
import subprocess

import numpy as np
import pytest
import torch

from jxl_oxide_tpu_torch.ops import modular_tail as mt
from jxl_oxide_tpu_torch.ops.cuda import build
from jxl_oxide_tpu_torch.ops.cuda import squeeze_measure as sm

SHIM = r"""
#include <stdint.h>
#include <vector>

#include "squeeze_math.cuh"

using namespace jxl_squeeze;

extern "C" void tendency_host(const int32_t* a, const int32_t* b,
                              const int32_t* c, int32_t* out, int n) {
  for (int i = 0; i < n; ++i) out[i] = tendency(a[i], b[i], c[i]);
}

// the chain probe's walk of one line (csrc/squeeze_probe.cu)
extern "C" uint32_t probe_line(const int32_t* tab_avg, const int32_t* tab_res,
                               int line, int rounds) {
  int32_t a[kProbeSpan], r[kProbeSpan];
  probe_load(tab_avg, tab_res, line, a, r);
  int32_t left = a[0];
  return probe_walk(a, r, rounds, &left);
}

extern "C" int probe_span() { return kProbeSpan; }

// the vertical kernel, one column after another: the loads of each chunk
// of kVChunk steps (clamped at the end), then its walk
extern "C" void squeeze_v_host(const int32_t* avg, const int32_t* res,
                               int32_t* out, int width, int na, int nr) {
  const size_t w = width;
  for (int x = 0; x < width; ++x) {
    int32_t left = avg[x], cur = left;
    for (int k0 = 0; k0 < nr; k0 += kVChunk) {
      int32_t r[kVChunk], next[kVChunk];
      for (int j = 0; j < kVChunk; ++j) {
        const int k = chunk_step(k0, j, nr);
        r[j] = res[k * w + x];
        next[j] = avg[next_index(k, na) * w + x];
      }
      for (int j = 0; j < kVChunk && k0 + j < nr; ++j) {
        const int k = k0 + j;
        int32_t first, second;
        unsqueeze_step(cur, r[j], next[j], &left, &first, &second);
        out[2 * k * w + x] = first;
        out[(2 * k + 1) * w + x] = second;
        cur = next[j];
      }
    }
    if (na > nr) out[2 * nr * w + x] = avg[(na - 1) * w + x];
  }
}

// The horizontal kernel's block, in its order: the copy warp fills the
// input ring kInStages tiles ahead (tma: zeros past the plane, as TMA
// fills; else each lane's clamped column of every clamped row), the
// walker reads each row of a stage through tile_word (16-byte chunks, as
// its vector loads), walks it, and writes 16-byte pairs of steps into an
// output stage, and the copy warp drains that stage. Every barrier wait is
// held against the phases completed so far and the parity ring_phase
// gives; a stage must hold the tile the walker expects. Returns 0, or
// -(1 + the tile) at the first wait that would not pass.
static bool passes(int completed, int want, uint32_t parity) {
  // try_wait.parity(p) passes once the phase of parity p has completed: the
  // barrier's current phase (the count completed) then has the other parity
  return completed == want && static_cast<uint32_t>(completed & 1) != parity;
}

extern "C" int squeeze_h_host(const int32_t* avg, const int32_t* res,
                              int32_t* out, int height, int na, int nr,
                              int tma) {
  const size_t n = static_cast<size_t>(na) + nr;
  const int tiles = num_tiles(nr);
  std::vector<int32_t> in(kInStages * kStageWords, -5);
  std::vector<int32_t> outs(kOutStages * kOutWords, -6);
  for (int row0 = 0; row0 < height; row0 += kRows) {
    const int rows = height - row0 < kRows ? height - row0 : kRows;
    int full[kInStages] = {}, empty[kInStages] = {}, held[kInStages] = {};
    int ofull[kOutStages] = {}, oempty[kOutStages] = {};
    int32_t left[kRows] = {};
    if (na > nr)
      for (int lane = 0; lane < rows; ++lane)
        out[(row0 + lane) * n + n - 1] =
            avg[(size_t)(row0 + lane) * na + na - 1];
    auto load = [&](int t) {
      const int s = ring_slot(t, kInStages), x0 = t * kCols;
      int32_t* st = &in[s * kStageWords];
      for (int lane = 0; lane < kCols; ++lane)
        for (int r = 0; r < kRows; ++r) {
          int32_t va, vr;
          if (tma) {
            const int y = row0 + r, c = x0 + lane;
            va = y < height && c < na ? avg[(size_t)y * na + c] : 0;
            vr = y < height && c < nr ? res[(size_t)y * nr + c] : 0;
          } else {
            const size_t y = clamp_row(row0 + r, height);
            const int c = tile_col(x0, nr, lane);
            va = avg[y * na + c];
            vr = res[y * nr + c];
          }
          st[tile_word(r, lane)] = va;
          st[kPlaneWords + tile_word(r, lane)] = vr;
        }
      for (int lane = 0; lane < kRows; ++lane) {
        const size_t y = clamp_row(row0 + lane, height);
        st[kNextWord + lane] =
            avg[y * na + next_index(x0 + tile_cols(x0, nr) - 1, na)];
      }
      held[s] = t;
      ++full[s];
    };
    for (int t = 0; t < kInStages && t < tiles; ++t) load(t);
    for (int t = 0; t < tiles; ++t) {
      const int s = ring_slot(t, kInStages), o = ring_slot(t, kOutStages);
      const int cols = tile_cols(t * kCols, nr);
      // the walker
      if (!passes(full[s], t / kInStages + 1, ring_phase(t, kInStages)) ||
          held[s] != t)
        return -1 - t;
      if (t >= kOutStages &&
          !passes(oempty[o], (t - kOutStages) / kOutStages + 1,
                  ring_phase(t - kOutStages, kOutStages)))
        return -1 - t;
      const int32_t* st = &in[s * kStageWords];
      for (int lane = 0; lane < kRows; ++lane) {
        int32_t* os = &outs[o * kOutWords + lane * kOutStride];
        if (t == 0) left[lane] = st[tile_word(lane, 0)];
        if (cols == kCols) {
          int32_t av[kCols], rv[kCols];
          for (int q = 0; q < kCols / 4; ++q)
            for (int i = 0; i < 4; ++i) {
              av[4 * q + i] = st[tile_word(lane, 4 * q) + i];
              rv[4 * q + i] = st[kPlaneWords + tile_word(lane, 4 * q) + i];
            }
          const int32_t last_next = st[kNextWord + lane];
          for (int j = 0; j < kCols; j += 2) {
            int32_t f0, s0, f1, s1;
            unsqueeze_step(av[j], rv[j], av[j + 1], &left[lane], &f0, &s0);
            unsqueeze_step(av[j + 1], rv[j + 1],
                           j + 2 < kCols ? av[j + 2] : last_next, &left[lane],
                           &f1, &s1);
            const int32_t pair[4] = {f0, s0, f1, s1};
            for (int i = 0; i < 4; ++i) os[2 * j + i] = pair[i];
          }
        } else {
          for (int j = 0; j < cols; ++j) {
            const int32_t next = j + 1 < cols ? st[tile_word(lane, j + 1)]
                                              : st[kNextWord + lane];
            int32_t first, second;
            unsqueeze_step(st[tile_word(lane, j)],
                           st[kPlaneWords + tile_word(lane, j)], next,
                           &left[lane], &first, &second);
            os[2 * j] = first;
            os[2 * j + 1] = second;
          }
        }
      }
      ++empty[s];
      ++ofull[o];
      // the copy warp
      if (t + kInStages < tiles) {
        if (!passes(empty[s], t / kInStages + 1, ring_phase(t, kInStages)))
          return -1 - t;
        load(t + kInStages);
      }
      if (!passes(ofull[o], t / kOutStages + 1, ring_phase(t, kOutStages)))
        return -1 - t;
      const int32_t* os = &outs[o * kOutWords];
      for (int r = 0; r < rows; ++r)
        for (int lane = 0; lane < 2 * kCols; ++lane)
          if (lane < 2 * cols)
            out[(row0 + r) * n + 2 * t * kCols + lane] =
                os[r * kOutStride + lane];
      ++oempty[o];
    }
  }
  return 0;
}

extern "C" int tile_word_host(int row, int col) { return tile_word(row, col); }

extern "C" int layout_host(int* out) {
  out[0] = kRows; out[1] = kCols; out[2] = kPlaneWords; out[3] = kNextWord;
  out[4] = kStageWords; out[5] = kOutStride; out[6] = kOutWords;
  out[7] = kInStages; out[8] = kOutStages;
  return 9;
}
"""

# every triple of these through tendency, and squeezes of planes drawn
# from them, under the undefined-behaviour sanitizer
UBSAN_MAIN = r"""
#include <stdint.h>
#include <stdio.h>

#include "squeeze_math.cuh"

using namespace jxl_squeeze;

int main() {
  const int32_t v[] = {INT32_MIN, INT32_MIN + 1, INT32_MIN / 2, -13, -1, 0,
                       1, 12, INT32_MAX / 2, INT32_MAX - 1, INT32_MAX};
  const int n = sizeof(v) / sizeof(v[0]);
  uint32_t sum = 0;
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j)
      for (int k = 0; k < n; ++k) {
        sum += static_cast<uint32_t>(tendency(v[i], v[j], v[k]));
        for (int r = 0; r < n; ++r) {
          int32_t left = v[r], first, second;
          unsqueeze_step(v[i], v[j], v[k], &left, &first, &second);
          sum += static_cast<uint32_t>(first) + static_cast<uint32_t>(second);
        }
      }
  printf("%u\n", sum);
  return 0;
}
"""

I32 = np.iinfo(np.int32)
EDGES = np.array([I32.min, I32.min + 1, I32.min // 2, -13, -1, 0, 1, 12,
                  I32.max // 2, I32.max - 1, I32.max], dtype=np.int32)


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    d = tmp_path_factory.mktemp("squeeze_math")
    src = d / "shim.cpp"
    src.write_text(SHIM)
    lib = d / "libsqueeze_math.so"
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
         "-I", build.CSRC_DIR, "-o", str(lib), str(src)],
        check=True, capture_output=True, timeout=120,
    )
    lib = ctypes.CDLL(str(lib))
    lib.tendency_host.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int]
    lib.layout_host.argtypes = [ctypes.c_void_p]
    lib.probe_line.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
    lib.probe_line.restype = ctypes.c_uint32
    lib.squeeze_v_host.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
    lib.squeeze_h_host.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
    return lib


def _planes(shape_avg, shape_res, seed, extremes):
    rng = np.random.default_rng(seed)
    if extremes:
        return (rng.choice(EDGES, shape_avg), rng.choice(EDGES, shape_res))
    return (rng.integers(-(1 << 12), 1 << 12, shape_avg).astype(np.int32),
            rng.integers(-(1 << 12), 1 << 12, shape_res).astype(np.int32))


def test_tendency_matches_plain_at_int32_edges(shim):
    a, b, c = (np.ascontiguousarray(x.ravel()) for x in
               np.meshgrid(EDGES, EDGES, EDGES, indexing="ij"))
    rng = np.random.default_rng(0)
    a, b, c = (np.concatenate([x, rng.integers(I32.min, I32.max, 4096,
                                               dtype=np.int64
                                               ).astype(np.int32)])
               for x in (a, b, c))
    out = np.empty_like(a)
    shim.tendency_host(a.ctypes.data, b.ctypes.data, c.ctypes.data,
                       out.ctypes.data, a.size)
    want = mt._tendency(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    np.testing.assert_array_equal(out, want)


# n odd and even, one and two squeezed positions, whole and partial
# 32-column tiles and 32-row blocks, one line; na % 4 of 0, 1, 2 and 3
# (only 0 with nr % 4 == 0 takes TMA), more tiles than ring stages, a last
# tile that is whole with n odd
@pytest.mark.parametrize("lines,n", [(1, 2), (3, 3), (33, 64), (40, 65),
                                     (5, 66), (64, 130), (1, 131), (70, 1),
                                     (7, 70), (31, 68), (9, 136), (3, 257),
                                     (40, 300), (2, 193), (20, 264)])
@pytest.mark.parametrize("horizontal", [True, False])
@pytest.mark.parametrize("extremes", [False, True])
def test_squeeze_walk_matches_plain(shim, lines, n, horizontal, extremes):
    na, nr = (n + 1) // 2, n // 2
    if horizontal:
        avg, res = _planes((lines, na), (lines, nr), n + lines, extremes)
    else:
        avg, res = _planes((na, lines), (nr, lines), n + lines, extremes)
    want = (mt.inv_squeeze_h if horizontal else mt.inv_squeeze_v)(
        torch.from_numpy(avg), torch.from_numpy(res)).numpy()
    if nr == 0:
        np.testing.assert_array_equal(want, avg)
        return
    if not horizontal:
        out = np.full(want.shape, -7, dtype=np.int32)
        shim.squeeze_v_host(avg.ctypes.data, res.ctypes.data,
                            out.ctypes.data, lines, na, nr)
        np.testing.assert_array_equal(out, want)
        return
    # the cp.async copy always, TMA's where rows are 16-byte multiples
    for tma in (0, 1) if na % 4 == 0 and nr % 4 == 0 else (0,):
        out = np.full(want.shape, -7, dtype=np.int32)
        assert shim.squeeze_h_host(avg.ctypes.data, res.ctypes.data,
                                   out.ctypes.data, lines, na, nr, tma) == 0
        np.testing.assert_array_equal(out, want)


def test_stage_layout_is_tma_swizzle_and_conflict_free(shim):
    """tile_word is TMA's 128-byte swizzle of a dense 32 x 32 int32 tile
    on a 1024-byte aligned base (byte address bits 4-6 XOR bits 7-9); the
    walker's 16-byte reads of one chunk of its row, 8 lanes (rows) a
    phase, and its 16-byte writes into an output stage's padded rows, hit
    8 different 4-bank groups; every stage starts 1024-byte aligned."""
    lay = (ctypes.c_int * 16)()
    assert shim.layout_host(lay) == 9
    rows, cols, plane, next_word, stage, ostride, owords = lay[:7]
    assert (rows, cols) == (32, 32) and plane == rows * cols
    assert next_word == 2 * plane and next_word + rows <= stage
    assert stage * 4 % 1024 == 0 and plane * 4 % 1024 == 0
    assert ostride * 4 % 16 == 0 and owords == rows * ostride
    words = np.array([[shim.tile_word_host(r, c) for c in range(cols)]
                      for r in range(rows)])
    assert sorted(words.ravel()) == list(range(plane))
    dense = (np.arange(rows)[:, None] * cols + np.arange(cols)) * 4
    np.testing.assert_array_equal(words * 4,
                                  dense ^ (((dense >> 7) & 7) << 4))
    for q in range(cols // 4):
        for r0 in range(0, rows, 8):
            group = words[r0:r0 + 8, 4 * q] % 32 // 4
            assert len(set(group)) == 8
    for j in range(0, 2 * cols, 4):
        group = (np.arange(8) * ostride + j) % 32 // 4
        assert len(set(group)) == 8


@pytest.mark.parametrize("seed,lines,rounds", [(0, 40, 3), (5, 17, 1)])
def test_probe_walk_matches_plain(shim, seed, lines, rounds):
    """The chain probe's checksums (csrc/squeeze_probe.cu, its walk in
    squeeze_math.cuh) against the same walk in plain torch."""
    assert shim.probe_span() == sm.PROBE_SPAN
    tab_avg, tab_res = sm.probe_tables(seed)
    got = np.array([shim.probe_line(tab_avg.ctypes.data, tab_res.ctypes.data,
                                    line, rounds) for line in range(lines)],
                   dtype=np.uint32).view(np.int32)
    want = sm.probe_checksums(tab_avg, tab_res, lines, rounds).numpy()
    np.testing.assert_array_equal(got, want)


def test_arithmetic_has_no_signed_overflow(tmp_path):
    src = tmp_path / "ubsan.cpp"
    src.write_text(UBSAN_MAIN)
    exe = tmp_path / "ubsan"
    subprocess.run(
        ["g++", "-O1", "-std=c++17", "-fsanitize=undefined",
         "-fno-sanitize-recover=all", "-I", build.CSRC_DIR, "-o", str(exe),
         str(src)],
        check=True, capture_output=True, timeout=120,
    )
    run = subprocess.run([str(exe)], capture_output=True, text=True,
                         timeout=120)
    assert run.returncode == 0 and "runtime error" not in run.stderr, (
        run.stderr)


def test_overflow_check_sees_an_overflow(tmp_path):
    """The sanitizer build fails where the arithmetic is left signed."""
    src = tmp_path / "bad.cpp"
    src.write_text(UBSAN_MAIN.replace(
        '#include "squeeze_math.cuh"',
        '#include "squeeze_math.cuh"\n'
        'static int32_t signed_add(int32_t a, int32_t b) { return a + b; }'
    ).replace("sum += static_cast<uint32_t>(tendency(v[i], v[j], v[k]));",
              "sum += static_cast<uint32_t>(signed_add(v[i], v[j]));"))
    exe = tmp_path / "bad"
    subprocess.run(
        ["g++", "-O1", "-std=c++17", "-fsanitize=undefined",
         "-fno-sanitize-recover=all", "-I", build.CSRC_DIR, "-o", str(exe),
         str(src)],
        check=True, capture_output=True, timeout=120,
    )
    run = subprocess.run([str(exe)], capture_output=True, text=True,
                         timeout=120)
    assert run.returncode != 0 and "signed integer overflow" in run.stderr


def test_kernel_sources_are_in_the_package():
    for name in build.SOURCES["modular_squeeze"]:
        assert os.path.isfile(os.path.join(build.CSRC_DIR, name))


def test_probe_sources_are_in_the_package():
    for name in build.SOURCES["squeeze_probe"]:
        assert os.path.isfile(os.path.join(build.CSRC_DIR, name))

