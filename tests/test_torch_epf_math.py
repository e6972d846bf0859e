"""The EPF kernel's arithmetic and tiling (jxl_oxide_tpu_torch/csrc/
epf_math.cuh), built for the CPU with g++ through a small C shim, against
the plain torch epf_step.

The shim walks the tiles as csrc/epf.cu does: it fills each tile's box
with the in-frame cells and zeros elsewhere (what the copy engine writes),
applies the mirror fix-up only where `tile_is_edge` says so, fills each
group's two D planes with the header's `fill_group` for every thread of
the block and accumulates each column run of pixels with the header's
functions, in the kernel's order. Only the copy engine, the shared-memory
ring and the launch of csrc/epf.cu are left to the card. The header
divides exactly where the card takes one approximate reciprocal of the
weight sum, so the card's rounding of it is checked only on the card
(tests/test_torch_cuda.py).

Tolerance: atol 2e-5, the EPF bound of tests/test_color.py.
"""

import ctypes
import os
import subprocess

import numpy as np
import pytest
import torch

import torch_parity as tp
from jxl_oxide_tpu_torch.ops.cuda import build
from jxl_oxide_tpu_torch.ops.cuda.epf import kernel_params
from jxl_oxide_tpu_torch.ops.filters import epf_step

SHIM = r"""
#include <algorithm>
#include <cmath>
#include <limits>
#include <vector>

#include "epf_math.cuh"

using namespace jxl_epf;

template <int STEP>
static void tile_pass(const float* in, const float* sigma, float* out, int h,
                      int w, int y0, int x0, const Params& prm) {
  const long plane = static_cast<long>(h) * w;
  const float nan = std::numeric_limits<float>::quiet_NaN();
  // the box and the floats past it that a fill may read and discard
  std::vector<float> box(3 * kBoxPlane + kFillOverread, nan);
  std::vector<float> sig(kTile * kTile), d(kGroup * kDPlane);
  // the copy: in-frame cells, zeros elsewhere
  for (int ch = 0; ch < 3; ++ch)
    for (int r = -kPad; r < kTile + kPad; ++r)
      for (int c = -kColPad; c < kTile + kColPad; ++c) {
        const int gy = y0 + r, gx = x0 + c;
        const bool in_frame = gy >= 0 && gy < h && gx >= 0 && gx < w;
        box[ch * kBoxPlane + box_index(r, c)] =
            in_frame ? in[ch * plane + static_cast<long>(gy) * w + gx] : 0.0f;
      }
  for (int r = 0; r < kTile; ++r)
    for (int c = 0; c < kTile; ++c) {
      const int gy = y0 + r, gx = x0 + c;
      sig[r * kTile + c] =
          gy < h && gx < w ? sigma[static_cast<long>(gy) * w + gx] : 0.0f;
    }
  if (tile_is_edge(y0, x0, h, w))
    for (int i = 0; i < kBoxPlane; ++i) {
      const int src = halo_source(i / kBoxW - kPad, i % kBoxW - kColPad, y0,
                                  x0, h, w);
      if (src >= 0)
        for (int ch = 0; ch < 3; ++ch)
          box[ch * kBoxPlane + i] = box[ch * kBoxPlane + src];
    }
  // one column run per kernel thread
  std::vector<Acc> acc(kTile * kTile);
  std::vector<float> nis(kTile * kTile);
  for (int r = 0; r < kTile; ++r)
    for (int c = 0; c < kTile; ++c) {
      acc[c * kTile + r] = acc_init(box.data(), box_index(r, c));
      nis[c * kTile + r] =
          neg_inv_sigma(sig[r * kTile + c], is_border(r, c), prm);
    }
  const int group = STEP == 2 ? 1 : kGroup;
  for (int j = 0; j < num_pairs(STEP); j += group) {
    if (STEP != 2) {
      // the group's D planes, filled by every thread of the block; a cell
      // that no run fills stays NaN and poisons the pixels that read it
      std::fill(d.begin(), d.end(), nan);
      for (int tid = 0; tid < kThreads; ++tid)
        fill_group<STEP>(box.data(), d.data(), j, tid, prm);
    }
    for (int c = 0; c < kTile; ++c)
      for (int r0 = 0; r0 < kTile; r0 += kRun) {
        Acc* a = &acc[c * kTile + r0];
        const float* n = &nis[c * kTile + r0];
        if (STEP == 2) {
          accumulate_pair_direct(a, box.data(), r0, c, pair_kx(STEP, j),
                                 pair_ky(STEP, j), n, prm);
        } else {
          accumulate_pair<STEP>(a, box.data(), d.data(), r0, c,
                                pair_kx(STEP, j), pair_ky(STEP, j), n);
          accumulate_pair<STEP>(a, box.data(), d.data() + kDPlane, r0, c,
                                pair_kx(STEP, j + 1), pair_ky(STEP, j + 1), n);
        }
      }
  }
  for (int r = 0; r < kTile && y0 + r < h; ++r)
    for (int c = 0; c < kTile && x0 + c < w; ++c) {
      float o[3];
      finish(acc[c * kTile + r], sig[r * kTile + c], box.data(),
             box_index(r, c), o);
      for (int ch = 0; ch < 3; ++ch)
        out[ch * plane + static_cast<long>(y0 + r) * w + x0 + c] = o[ch];
    }
}

// How many fill threads store each cell of group j's two D planes
// (count: kGroup * kDPlane). Each thread's fill_group runs alone into
// NaN-poisoned planes with a kDPlane margin on both sides; returns the
// number of stores into the margins.
template <int STEP>
static int fill_cover_step(int j, int* count) {
  const float nan = std::numeric_limits<float>::quiet_NaN();
  const std::vector<float> box(3 * kBoxPlane + kFillOverread, 0.0f);
  std::vector<float> d((kGroup + 2) * kDPlane);
  const Params prm{{1.0f, 1.0f, 1.0f}, 1.0f, 1.0f, -1.0f};
  int bad = 0;
  for (int tid = 0; tid < kThreads; ++tid) {
    std::fill(d.begin(), d.end(), nan);
    fill_group<STEP>(box.data(), d.data() + kDPlane, j, tid, prm);
    for (int i = 0; i < (kGroup + 2) * kDPlane; ++i) {
      if (std::isnan(d[i])) continue;
      if (i < kDPlane || i >= (kGroup + 1) * kDPlane)
        ++bad;
      else
        ++count[i - kDPlane];
    }
  }
  return bad;
}

extern "C" int fill_cover(int step, int j, int* count) {
  return step == 0 ? fill_cover_step<0>(j, count) : fill_cover_step<1>(j, count);
}

extern "C" int epf_host(const float* in, const float* sigma, float* out,
                        int h, int w, int step, float cs0, float cs1,
                        float cs2, float sm_border, float sm_plain,
                        float neg_k) {
  const Params prm{{cs0, cs1, cs2}, sm_border, sm_plain, neg_k};
  for (int t = 0; t < num_tiles(h, w); ++t) {
    int y0, x0;
    tile_origin(t, w, &y0, &x0);
    switch (step) {
      case 0: tile_pass<0>(in, sigma, out, h, w, y0, x0, prm); break;
      case 1: tile_pass<1>(in, sigma, out, h, w, y0, x0, prm); break;
      case 2: tile_pass<2>(in, sigma, out, h, w, y0, x0, prm); break;
      default: return 1;
    }
  }
  return 0;
}

// Geometry of every tile of an h x w frame: per pixel, how many tiles
// cover it (cover, h*w); per tile, tile_is_edge and whether any halo cell
// takes a fix-up (edge, fixed; num_tiles each). Returns the number of
// fix-up sources outside the frame or the box (0 when all is well).
extern "C" int tile_geometry(int h, int w, int* cover, int* edge,
                             int* fixed) {
  int bad = 0;
  for (int t = 0; t < num_tiles(h, w); ++t) {
    int y0, x0;
    tile_origin(t, w, &y0, &x0);
    for (int r = 0; r < kTile; ++r)
      for (int c = 0; c < kTile; ++c)
        if (y0 + r < h && x0 + c < w) ++cover[(y0 + r) * w + x0 + c];
    edge[t] = tile_is_edge(y0, x0, h, w);
    fixed[t] = 0;
    for (int r = -kPad; r < kTile + kPad; ++r)
      for (int c = -kColPad; c < kTile + kColPad; ++c) {
        const int src = halo_source(r, c, y0, x0, h, w);
        if (src < 0) continue;
        fixed[t] = 1;
        const int sr = src / kBoxW - kPad, sc = src % kBoxW - kColPad;
        const int gy = y0 + sr, gx = x0 + sc;
        if (src >= kBoxPlane || gy < 0 || gy >= h || gx < 0 || gx >= w ||
            gy != mirror(y0 + r, h) || gx != mirror(x0 + c, w))
          ++bad;
      }
  }
  return bad;
}

extern "C" int tiles_of(int h, int w) { return num_tiles(h, w); }
"""

CS = (40.0, 5.0, 3.5)
BSM = 2.0 / 3.0


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    d = tmp_path_factory.mktemp("epf_math")
    src = d / "shim.cpp"
    src.write_text(SHIM)
    lib = d / "libepf_math.so"
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
         "-I", build.CSRC_DIR, "-o", str(lib), str(src)],
        check=True, capture_output=True, timeout=120,
    )
    lib = ctypes.CDLL(str(lib))
    lib.epf_host.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                             + [ctypes.c_float] * 6)
    lib.epf_host.restype = ctypes.c_int
    lib.tile_geometry.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
    lib.tile_geometry.restype = ctypes.c_int
    lib.tiles_of.argtypes = [ctypes.c_int] * 2
    lib.tiles_of.restype = ctypes.c_int
    lib.fill_cover.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.fill_cover.restype = ctypes.c_int
    return lib


# (3, 200, 262) has interior tiles; in (3, 200, 194) and (3, 130, 262)
# some tiles' halo leaves the frame by one pixel on one axis only
@pytest.mark.parametrize("shape", [(3, 150, 40), (3, 37, 64), (3, 2, 5),
                                   (3, 1, 1), (3, 5, 2), (3, 200, 262),
                                   (3, 200, 194), (3, 130, 262)])
@pytest.mark.parametrize("step,mult", [(0, 1.65), (1, 1.0), (2, 2.35)])
def test_epf_math_matches_plain_epf_step(shim, shape, step, mult):
    planes, sigma = tp.epf_inputs(shape, seed=sum(shape) + step)
    out = np.empty_like(planes)
    _, h, w = shape
    rc = shim.epf_host(planes.ctypes.data, sigma.ctypes.data,
                       out.ctypes.data, h, w, step,
                       *kernel_params(CS, mult, BSM))
    assert rc == 0
    ref = epf_step(torch.from_numpy(planes), torch.from_numpy(sigma), step,
                   CS, mult, BSM).numpy()
    if h * w >= 1024:
        # the inputs exercise the filter: most filtered pixels move
        moved = np.abs(ref - planes).max(axis=0) > 1e-5
        assert moved[sigma >= 0.3].mean() > 0.3
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=0)


@pytest.mark.parametrize("hw", [(1, 1), (2, 5), (37, 1030), (150, 42),
                                (1024, 1024), (200, 194), (130, 262)])
def test_tiles_cover_once_and_only_edge_tiles_fix_up(shim, hw):
    h, w = hw
    n = shim.tiles_of(h, w)
    cover = np.zeros((h, w), np.int32)
    edge = np.zeros(n, np.int32)
    fixed = np.zeros(n, np.int32)
    bad = shim.tile_geometry(h, w, cover.ctypes.data, edge.ctypes.data,
                             fixed.ctypes.data)
    assert bad == 0, "a fix-up source lies outside the frame or the box"
    assert (cover == 1).all()
    # exactly the tiles within 3 px of an edge take the fix-up
    np.testing.assert_array_equal(edge, fixed)
    tiles_x = -(-w // 64)
    t = np.arange(n)
    y0, x0 = (t // tiles_x) * 64, (t % tiles_x) * 64
    near = (y0 < 3) | (x0 < 3) | (y0 + 67 > h) | (x0 + 67 > w)
    np.testing.assert_array_equal(edge.astype(bool), near)
    if h >= 200 and w >= 200:
        assert not edge.all(), "no interior tile at this size"


# the tap pairs of each fill group, as epf_math.cuh orders them
FILL_GROUPS = {
    (0, 0): ((0, -2), (0, -1)),
    (0, 2): ((-1, -1), (1, -1)),
    (0, 4): ((-2, 0), (-1, 0)),
    (1, 0): ((0, -1), (-1, 0)),
}


@pytest.mark.parametrize("step,j", sorted(FILL_GROUPS))
def test_fill_runs_store_each_d_cell_once(shim, step, j):
    """The block's fill threads store every D cell that the group's taps
    read, each by one thread, and nothing outside the two planes. The
    cells read: D_k around p and around p - k, for p in the 64x64 tile and
    the five offsets of DIST."""
    count = np.zeros((2, 70, 70), np.int32)
    assert shim.fill_cover(step, j, count.ctypes.data) == 0
    need = np.zeros((70, 70), bool)
    for kx, ky in FILL_GROUPS[(step, j)]:
        for sy, sx in ((0, 0), (-ky, -kx)):
            for iy, ix in ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)):
                y, x = 3 + sy + iy, 3 + sx + ix
                need[y:y + 64, x:x + 64] = True
    rows, cols = np.nonzero(need)
    want = np.zeros((70, 70), np.int32)
    want[rows.min():rows.max() + 1, cols.min():cols.max() + 1] = 1
    np.testing.assert_array_equal(count[0], want)
    np.testing.assert_array_equal(count[1], want)


def test_kernel_sources_are_in_the_package():
    assert os.path.isfile(os.path.join(build.CSRC_DIR, "epf.cu"))
    assert os.path.isfile(os.path.join(build.CSRC_DIR, "epf_math.cuh"))
