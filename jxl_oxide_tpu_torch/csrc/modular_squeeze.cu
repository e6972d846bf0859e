// The inverse squeeze of lossless Modular (squeeze.rs inverse_h_i32_base and
// inverse_v), on int32 planes, written for Hopper (sm_90a).
//
// Replaces jxl_oxide_tpu/ops/modular_tail.py:82 _inv_squeeze_h_core, a
// lax.scan (not a Pallas kernel) reached from inv_squeeze_h_device and
// inv_squeeze_v_device; same contract as ops/modular_tail.py inv_squeeze_h
// and inv_squeeze_v: avg holds the na = ceil(n / 2) averages and residual the
// nr = floor(n / 2) residuals of each line along the squeezed axis, and the
// output holds the n = na + nr samples. One launch per squeezed channel on
// the caller's stream.
//
// What bounds it on the card: it must read avg and the residual once and
// write the output once, about 8 B per output sample (2 MiB + 2 MiB read and
// 4 MiB written for a 1024^2 plane, 2.5 us at 3.35 TB/s). It will not come
// near that: the recurrence is sequential along the squeezed axis (the second
// output of step k is the left neighbour in the tendency of step k + 1), a
// chain of some twenty dependent integer operations per step, and parallel
// only across lines. The loop-carried chain, not bytes, sets its time: n / 2
// steps of that chain, however many lines there are.
//
// Design: one thread per line walks the squeezed axis in order.
//  - Vertical squeeze (planes [n, width], lines are columns): a thread owns
//    a column, so at each step the threads of a warp read and write
//    neighbouring addresses, and every access is coalesced. The avg sample
//    of step k + 1 is the `next` that step k loaded, so each avg sample is
//    read once. A thread loads its samples 16 steps at a time, one chunk
//    ahead: the next chunk's loads are in flight while it walks this one.
//  - Horizontal squeeze (planes [height, n], lines are rows): staged column
//    tiles through shared memory, not a transpose around the vertical kernel
//    (that would move every byte two more times). One warp per block takes
//    32 rows through tiles of 32 squeezed columns. Lane l holds column l of
//    the tile for each of the 32 rows in registers (one coalesced 128-B load
//    per row and plane) and writes them into shared memory; the loads of the
//    next tile are then issued, and stay in flight while each thread reads
//    its own row of this tile into registers and walks it; the warp writes
//    each row's 64 output samples back coalesced. Rows of the shared tiles
//    have an odd length, so a thread per row reads and writes them without
//    bank conflicts.
//  - No branch and no memory access waits on the chain: the tendency
//    selects between its two candidates (squeeze_math.cuh), offsets are
//    32-bit, and the walks over whole chunks and tiles are unrolled.
//  - The arithmetic, wrapping at 32 bits without signed overflow, and the
//    clamped load positions are in squeeze_math.cuh, which the CPU tests
//    build with g++.
// With one thread per line the card is underfilled: a 1024-line plane runs
// 1024 threads in 32 blocks, one warp on each of 32 SMs.
#include <cuda_runtime.h>
#include <stdint.h>

#include "squeeze_math.cuh"

namespace {

using namespace jxl_squeeze;

// Offsets are int: the wrapper (ops/cuda/squeeze.py) keeps every plane
// under 2^31 samples, and 64-bit address arithmetic costs the chain's warp
// issue slots.

// The samples of the vertical kernel's chunk at k0 for column x.
__device__ __forceinline__ void load_chunk(const int32_t* __restrict__ avg,
                                           const int32_t* __restrict__ res,
                                           int w, int x, int k0, int na,
                                           int nr, int32_t (&r)[kVChunk],
                                           int32_t (&next)[kVChunk]) {
#pragma unroll
  for (int j = 0; j < kVChunk; ++j) {
    const int k = chunk_step(k0, j, nr);
    r[j] = res[k * w + x];
    next[j] = avg[next_index(k, na) * w + x];
  }
}

// One step of the vertical kernel: step k of column x.
__device__ __forceinline__ void v_step(int32_t* __restrict__ out, int w,
                                       int x, int k, int32_t r, int32_t next,
                                       int32_t* cur, int32_t* left) {
  int32_t first, second;
  unsqueeze_step(*cur, r, next, left, &first, &second);
  out[2 * k * w + x] = first;
  out[(2 * k + 1) * w + x] = second;
  // avg[k + 1]: next_index(k) is k + 1 for every k < nr - 1
  *cur = next;
}

__global__ void __launch_bounds__(kVThreads)
    inv_squeeze_v_kernel(const int32_t* __restrict__ avg,
                         const int32_t* __restrict__ res,
                         int32_t* __restrict__ out, int w, int na, int nr) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= w) return;
  int32_t left = avg[x];
  int32_t cur = left;
  int32_t r[kVChunk], next[kVChunk];
  load_chunk(avg, res, w, x, 0, na, nr, r, next);
  int k0 = 0;
  // whole chunks: the next chunk's loads in flight during the walk
  for (; k0 + kVChunk <= nr; k0 += kVChunk) {
    int32_t cr[kVChunk], cn[kVChunk];
#pragma unroll
    for (int j = 0; j < kVChunk; ++j) {
      cr[j] = r[j];
      cn[j] = next[j];
    }
    if (k0 + kVChunk < nr)
      load_chunk(avg, res, w, x, k0 + kVChunk, na, nr, r, next);
#pragma unroll
    for (int j = 0; j < kVChunk; ++j)
      v_step(out, w, x, k0 + j, cr[j], cn[j], &cur, &left);
  }
  // the last, partial chunk, loaded by the last whole one (or above)
#pragma unroll
  for (int j = 0; j < kVChunk; ++j)
    if (k0 + j < nr) v_step(out, w, x, k0 + j, r[j], next[j], &cur, &left);
  if (na > nr) out[2 * nr * w + x] = avg[(na - 1) * w + x];
}

// Lane `lane`'s loads of the horizontal kernel's tile at x0: its column of
// each of the block's rows (avg and residual), and its own row's `next` of
// the tile's last step.
__device__ __forceinline__ void load_tile(const int32_t* __restrict__ avg,
                                          const int32_t* __restrict__ res,
                                          int height, int na, int nr,
                                          int row0, int lane, int x0,
                                          int32_t (&ta)[kRows],
                                          int32_t (&tr)[kRows],
                                          int32_t* tn) {
  const int c = tile_col(x0, nr, lane);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int y = clamp_row(row0 + r, height);
    ta[r] = avg[y * na + c];
    tr[r] = res[y * nr + c];
  }
  const int y = clamp_row(row0 + lane, height);
  *tn = avg[y * na + next_index(x0 + tile_cols(x0, nr) - 1, na)];
}

__global__ void __launch_bounds__(kRows)
    inv_squeeze_h_kernel(const int32_t* __restrict__ avg,
                         const int32_t* __restrict__ res,
                         int32_t* __restrict__ out, int height, int na,
                         int nr) {
  // rows of an odd length: a thread per row reads and writes its own row
  // without bank conflicts
  __shared__ int32_t s_avg[kRows][kCols + 1];
  __shared__ int32_t s_res[kRows][kCols + 1];
  __shared__ int32_t s_out[kRows][2 * kCols + 1];
  const int lane = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int rows = height - row0 < kRows ? height - row0 : kRows;
  const int n = na + nr;
  const int row = row0 + lane;
  int32_t left = lane < rows ? avg[row * na] : 0;
  int32_t ta[kRows], tr[kRows], tn;
  load_tile(avg, res, height, na, nr, row0, lane, 0, ta, tr, &tn);
  for (int x0 = 0; x0 < nr; x0 += kCols) {
    const int cols = tile_cols(x0, nr);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      s_avg[r][lane] = ta[r];
      s_res[r][lane] = tr[r];
    }
    const int32_t last_next = tn;
    __syncwarp();
    if (x0 + kCols < nr)
      load_tile(avg, res, height, na, nr, row0, lane, x0 + kCols, ta, tr,
                &tn);
    if (lane < rows && cols == kCols) {
      // the thread's row of the tile in registers first: its shared-memory
      // reads all in flight together, none on the chain
      int32_t a[kCols], r[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        a[j] = s_avg[lane][j];
        r[j] = s_res[lane][j];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        int32_t first, second;
        unsqueeze_step(a[j], r[j], j + 1 < kCols ? a[j + 1] : last_next,
                       &left, &first, &second);
        s_out[lane][2 * j] = first;
        s_out[lane][2 * j + 1] = second;
      }
    } else if (lane < rows) {
      // the last, partial tile
      for (int j = 0; j < cols; ++j) {
        int32_t first, second;
        unsqueeze_step(s_avg[lane][j], s_res[lane][j],
                       j + 1 < cols ? s_avg[lane][j + 1] : last_next, &left,
                       &first, &second);
        s_out[lane][2 * j] = first;
        s_out[lane][2 * j + 1] = second;
      }
    }
    __syncwarp();
    for (int r = 0; r < rows; ++r) {
      int32_t* orow = out + (row0 + r) * n + 2 * x0;
      for (int i = lane; i < 2 * cols; i += kRows) orow[i] = s_out[r][i];
    }
    __syncwarp();
  }
  if (na > nr && lane < rows) out[row * n + n - 1] = avg[row * na + na - 1];
}

}  // namespace

// C entry, bound with ctypes: pointers and the stream as void*. `lines`
// lines of na averages and nr residuals along the squeezed axis (na is nr
// or nr + 1, nr > 0); horizontal: planes [lines, na], [lines, nr] ->
// [lines, na + nr]; vertical: [na, lines], [nr, lines] -> [na + nr, lines].
// Returns 0 once launched, else a cudaError_t (cudaGetLastError after the
// launch).
extern "C" int jxl_inv_squeeze(const void* avg, const void* res, void* out,
                               int lines, int na, int nr, int horizontal,
                               void* stream) {
  if (lines <= 0 || nr <= 0 || (na != nr && na != nr + 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* a = static_cast<const int32_t*>(avg);
  const int32_t* r = static_cast<const int32_t*>(res);
  int32_t* o = static_cast<int32_t*>(out);
  if (horizontal) {
    inv_squeeze_h_kernel<<<(lines + kRows - 1) / kRows, kRows, 0, s>>>(
        a, r, o, lines, na, nr);
  } else {
    inv_squeeze_v_kernel<<<(lines + kVThreads - 1) / kVThreads, kVThreads, 0,
                           s>>>(a, r, o, lines, na, nr);
  }
  return static_cast<int>(cudaGetLastError());
}
