"""The squeeze kernel's arithmetic and walk (jxl_oxide_tpu_torch/csrc/
squeeze_math.cuh), built for the CPU with g++ through a small C shim,
against the plain torch inverse squeeze (ops/modular_tail.py).

The shim walks the lines as csrc/modular_squeeze.cu does, with the
header's clamped load positions: the vertical kernel's column loop (each
avg sample read once, as the step before's `next`; the loads of 16 steps,
clamped at the end, before their walk), and the horizontal kernel's
blocks of 32 rows through tiles of 32 squeezed columns, each lane loading
its column of every row and its own row's `next` of the tile's last step.
Only the order in which the card issues the loads, the shared-memory
staging and the launch are left to the card (tests/test_torch_cuda.py,
chip_smoke.py).

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

SHIM = r"""
#include <stdint.h>
#include <vector>

#include "squeeze_math.cuh"

using namespace jxl_squeeze;

extern "C" void tendency_host(const int32_t* a, const int32_t* b,
                              const int32_t* c, int32_t* out, int n) {
  for (int i = 0; i < n; ++i) out[i] = tendency(a[i], b[i], c[i]);
}

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

// the horizontal kernel: blocks of kRows rows, tiles of kCols columns;
// lane l loads column tile_col(l) of every block row (clamp_row) and its
// own row's next of the tile's last step
extern "C" void squeeze_h_host(const int32_t* avg, const int32_t* res,
                               int32_t* out, int height, int na, int nr) {
  const size_t n = static_cast<size_t>(na) + nr;
  const int stride = kCols + 1, ostride = 2 * kCols + 1;
  std::vector<int32_t> s_avg(kRows * stride), s_res(kRows * stride);
  std::vector<int32_t> s_out(kRows * ostride), left(kRows), tn(kRows);
  for (int row0 = 0; row0 < height; row0 += kRows) {
    const int rows = height - row0 < kRows ? height - row0 : kRows;
    for (int r = 0; r < rows; ++r) left[r] = avg[(size_t)(row0 + r) * na];
    for (int x0 = 0; x0 < nr; x0 += kCols) {
      const int cols = tile_cols(x0, nr);
      for (int lane = 0; lane < kRows; ++lane) {
        const int c = tile_col(x0, nr, lane);
        for (int r = 0; r < kRows; ++r) {
          const size_t y = clamp_row(row0 + r, height);
          s_avg[r * stride + lane] = avg[y * na + c];
          s_res[r * stride + lane] = res[y * nr + c];
        }
        const size_t y = clamp_row(row0 + lane, height);
        tn[lane] = avg[y * na + next_index(x0 + cols - 1, na)];
      }
      for (int r = 0; r < rows; ++r)
        for (int j = 0; j < cols; ++j) {
          const int32_t next =
              j + 1 < cols ? s_avg[r * stride + j + 1] : tn[r];
          int32_t first, second;
          unsqueeze_step(s_avg[r * stride + j], s_res[r * stride + j], next,
                         &left[r], &first, &second);
          s_out[r * ostride + 2 * j] = first;
          s_out[r * ostride + 2 * j + 1] = second;
        }
      for (int r = 0; r < rows; ++r)
        for (int i = 0; i < 2 * cols; ++i)
          out[(size_t)(row0 + r) * n + 2 * x0 + i] = s_out[r * ostride + i];
    }
    if (na > nr)
      for (int r = 0; r < rows; ++r)
        out[(size_t)(row0 + r) * n + n - 1] =
            avg[(size_t)(row0 + r) * na + na - 1];
  }
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
    for fn in (lib.squeeze_h_host, lib.squeeze_v_host):
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
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
# 32-column tiles and 32-row blocks, one line
@pytest.mark.parametrize("lines,n", [(1, 2), (3, 3), (33, 64), (40, 65),
                                     (5, 66), (64, 130), (1, 131), (70, 1)])
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
    out = np.full(want.shape, -7, dtype=np.int32)
    fn = shim.squeeze_h_host if horizontal else shim.squeeze_v_host
    fn(avg.ctypes.data, res.ctypes.data, out.ctypes.data, lines, na, nr)
    np.testing.assert_array_equal(out, want)


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

