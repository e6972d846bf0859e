// Arithmetic of the inverse squeeze (squeeze.rs inverse_h_i32_base and
// tendency_i32), shared by the CUDA kernel (modular_squeeze.cu) and a host
// build that the CPU tests compile with g++ (tests/test_torch_squeeze_math.py).
// The host build walks the lines and tiles in the kernel's order with these
// functions, so only the copies and the launch are left to the card.
//
// Every sum and product wraps at 32 bits, as the reference's Wrapping<i32>
// and the JAX package's jnp int32 do. Signed overflow is undefined in C++
// and nvcc may assume it never happens, so the wrapping operations are done
// on uint32_t and converted back; the conversion of a uint32_t above
// INT32_MAX to int32_t is modular (defined in C++20, and what g++ and nvcc
// do in C++17). The divisions are C++'s `/`, which truncates toward zero,
// applied to the already-wrapped numerator: exactly what
// jxl_oxide_tpu/ops/modular_tail.py _trunc_div_i32 and _trunc_div2 build
// from floor division and shifts. No right shift of a negative value is
// used. The comparisons are signed, on the wrapped values.
#pragma once

#include <stddef.h>
#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#endif

namespace jxl_squeeze {

// The horizontal kernel: blocks of one copy warp and one walker warp take
// kRows rows (a walker thread each) through tiles of kCols squeezed
// columns, staged in shared memory.
constexpr int kRows = 32;
constexpr int kCols = 32;
// stages of the input ring (a tile's avg, residual and each row's `next`
// of its last step) and of the output ring (a tile's 2 x kCols outputs a
// row)
constexpr int kInStages = 3;
constexpr int kOutStages = 2;
// An input stage, in 32-bit words: the avg tile, the residual tile, each
// kRows x kCols dense with 128-byte rows swizzled as TMA's
// CU_TENSOR_MAP_SWIZZLE_128B writes them (tile_word), then the rows'
// `next`. Stages are 1024-byte multiples, the swizzle's period.
constexpr int kPlaneWords = kRows * kCols;
constexpr int kNextWord = 2 * kPlaneWords;
constexpr int kStageWords = (kNextWord + kRows + 255) / 256 * 256;
// An output stage: kRows rows of 2 x kCols outputs, padded so a row starts
// 16 bytes (4 banks) after the one before it.
constexpr int kOutStride = 2 * kCols + 4;
constexpr int kOutWords = kRows * kOutStride;
static_assert(kCols == 32, "tile_word swizzles 128-byte rows");
// Threads per block of the vertical kernel, one column each, and the steps
// whose loads a thread issues together, a chunk ahead of its walk.
constexpr int kVThreads = 32;
constexpr int kVChunk = 16;

__host__ __device__ inline int32_t wadd(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__host__ __device__ inline int32_t wsub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}

__host__ __device__ inline int32_t wmul(int32_t a, uint32_t k) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) * k);
}

// squeeze.rs tendency_i32, written as the JAX twin writes it: both
// candidates and the case selected at the end, with no branch (a branch in
// the chain costs the card more than the second candidate). x1 and x2 are
// quotients by 12, so x +- (x & 1) cannot overflow; two_ab is even, so
// two_ab + 1 cannot either, but two_ab - 1 can (two_ab = INT32_MIN) and
// wraps.
__host__ __device__ inline int32_t tendency(int32_t a, int32_t b, int32_t c) {
  const int32_t two_ab = wmul(wsub(a, b), 2);
  const int32_t two_bc = wmul(wsub(b, c), 2);
  const int32_t base = wsub(wsub(wmul(a, 4), wmul(c, 3)), b);  // 4a - 3c - b
  int32_t x1 = wadd(base, 6) / 12;
  x1 = x1 - (x1 & 1) > two_ab ? wadd(two_ab, 1) : x1;
  x1 = x1 + (x1 & 1) > two_bc ? two_bc : x1;
  int32_t x2 = wsub(base, 6) / 12;
  x2 = x2 + (x2 & 1) < two_ab ? wsub(two_ab, 1) : x2;
  x2 = x2 - (x2 & 1) < two_bc ? two_bc : x2;
  const bool falling = a >= b && b >= c;
  const bool rising = a <= b && b <= c;
  return falling ? x1 : (rising ? x2 : 0);
}

// One step of the recurrence at squeezed position k: avg = avg[k],
// res = residual[k], next = avg[next_index(k)], left = the previous step's
// second output (avg[0] before the first step). Writes out[2k] (first) and
// out[2k + 1] (second); second becomes the next step's left.
__host__ __device__ inline void unsqueeze_step(int32_t avg, int32_t res,
                                               int32_t next, int32_t* left,
                                               int32_t* first,
                                               int32_t* second) {
  const int32_t diff = wadd(res, tendency(*left, avg, next));
  const int32_t f = wadd(avg, diff / 2);
  const int32_t s = wsub(f, diff);
  *first = f;
  *second = s;
  *left = s;
}

// The avg position whose value is step k's `next`: k + 1, clamped to the
// last avg position (na avg positions; na is nr or nr + 1).
__host__ __device__ inline int next_index(int k, int na) {
  return k + 1 < na ? k + 1 : na - 1;
}

// The chain probe (squeeze_probe.cu), a measurement that no decode runs:
// a line's walk over kProbeSpan avg and residual values held in registers,
// cycled through `rounds` times. Line l holds a[j] = tab_avg[(l + j) %
// kProbeSpan] and r[j] = tab_res[(l + j) % kProbeSpan].
constexpr int kProbeSpan = 16;

__host__ __device__ inline void probe_load(const int32_t* tab_avg,
                                           const int32_t* tab_res, int line,
                                           int32_t (&a)[kProbeSpan],
                                           int32_t (&r)[kProbeSpan]) {
  for (int j = 0; j < kProbeSpan; ++j) {
    a[j] = tab_avg[(line + j) % kProbeSpan];
    r[j] = tab_res[(line + j) % kProbeSpan];
  }
}

// rounds x kProbeSpan steps from left (a[0] at first): step j takes avg
// a[j], residual r[j] and next a[j + 1] (a[0] after the last). Returns the
// wrapping sum of every step's two outputs; left ends as the last second.
__host__ __device__ inline uint32_t probe_walk(
    const int32_t (&a)[kProbeSpan], const int32_t (&r)[kProbeSpan],
    int rounds, int32_t* left) {
  uint32_t sum = 0;
  for (int k = 0; k < rounds; ++k) {
#pragma unroll
    for (int j = 0; j < kProbeSpan; ++j) {
      int32_t first, second;
      unsqueeze_step(a[j], r[j], a[(j + 1) % kProbeSpan], left, &first,
                     &second);
      sum += static_cast<uint32_t>(first) + static_cast<uint32_t>(second);
    }
  }
  return sum;
}

// Squeezed positions in the horizontal kernel's tile starting at x0.
__host__ __device__ inline int tile_cols(int x0, int nr) {
  return nr - x0 < kCols ? nr - x0 : kCols;
}

// Tiles of the horizontal kernel along a row of nr squeezed positions.
__host__ __device__ inline int num_tiles(int nr) {
  return (nr + kCols - 1) / kCols;
}

// The stage of a ring of `stages` that tile t uses, and the parity of the
// phase of that stage's barriers that tile t completes.
__host__ __device__ inline int ring_slot(int t, int stages) {
  return t % stages;
}

__host__ __device__ inline uint32_t ring_phase(int t, int stages) {
  return static_cast<uint32_t>(t / stages) & 1u;
}

// The word of tile element (row, col) in a stage's avg or residual tile:
// the 16-byte chunk col / 4 of the row's 128 bytes moves to chunk
// (col / 4) ^ (row % 8) (TMA's 128-byte swizzle on a 1024-byte aligned
// tile). A thread per row then reads chunk q of its row, and each 8 rows
// of a warp's 16-byte reads hit 8 different chunks: all 32 banks.
__host__ __device__ inline int tile_word(int row, int col) {
  return row * kCols + ((((col >> 2) ^ row) & 7) << 2) + (col & 3);
}

// Rows that TMA may copy: 16-byte multiples (the bases are checked apart).
__host__ __device__ inline bool tma_rows(int na, int nr) {
  return na % 4 == 0 && nr % 4 == 0;
}

// The squeezed position that `lane` loads for the tile at x0: lanes past
// the tile's last position load that one again (in bounds, unused).
__host__ __device__ inline int tile_col(int x0, int nr, int lane) {
  const int cols = tile_cols(x0, nr);
  return x0 + (lane < cols ? lane : cols - 1);
}

// The row a load of block row `row` reads: rows past the plane read its
// last row again (in bounds, unused).
__host__ __device__ inline int clamp_row(int row, int height) {
  return row < height ? row : height - 1;
}

// The step whose samples load j of the vertical kernel's chunk at k0
// reads: steps past the last read the last again (in bounds, unused).
__host__ __device__ inline int chunk_step(int k0, int j, int nr) {
  return k0 + j < nr ? k0 + j : nr - 1;
}

}  // namespace jxl_squeeze
