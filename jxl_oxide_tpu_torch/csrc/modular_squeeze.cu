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
// What bounds it on the card: not its bytes (8 B per output sample, 2.5 us
// for a 1024^2 plane at 3.35 TB/s) but its loop-carried chain. The second
// output of step k is the left neighbour in the tendency of step k + 1, so a
// line takes (its nr steps) x (one step's dependent chain), however many
// lines run beside it. The chain is 18 instructions a step in this SASS
// (tools/squeeze_sass.py), and the chain probe (squeeze_probe.cu: the same
// step with its operands in registers, nothing else) takes 107 SM cycles,
// 54.5 ns, a step on an H100 at 700 W: the bound is nr x 54.5 ns, 0.028 ms
// for a 1024^2 plane's horizontal squeeze.
//
// Design, one thread per line walking the squeezed axis in order:
//  - Vertical squeeze (planes [n, width], lines are columns): a thread owns
//    a column, so at each step the threads of a warp read and write
//    neighbouring addresses, and every access is coalesced. The avg sample
//    of step k + 1 is the `next` that step k loaded, so each avg sample is
//    read once. A thread loads its samples 16 steps at a time, one chunk
//    ahead: the next chunk's loads are in flight while it walks this one.
//  - Horizontal squeeze (planes [height, n], lines are rows): blocks of two
//    warps take 32 rows through tiles of 32 squeezed columns, and the warp
//    that walks does nothing but walk. A copy warp fills a ring of three
//    input stages ahead of the walk (each: the tile's avg and residual, and
//    each row's `next` of the tile's last step), completing on mbarriers;
//    and drains a ring of two output stages to device memory with its own
//    coalesced stores (a row's 64 outputs, two 128-byte stores). The walker
//    warp, a thread per row, waits on a stage's barrier, reads its row into
//    registers (16 16-byte shared loads), releases the stage, walks 32
//    steps, and writes its 64 outputs into an output stage (16-byte shared
//    stores) and arrives on that stage's barrier. It issues no global load
//    or store, and the copies, address arithmetic and drains that stalled
//    the one warp of the earlier design between its walks run on another
//    warp, which the SM schedules on another sub-partition.
//  - The copies: where rows are 16-byte multiples (na % 4 == 0 and
//    nr % 4 == 0) and both bases 16-byte aligned, one TMA copy per plane
//    (cp.async.bulk.tensor through a tensor map, 128-byte swizzle, rows past
//    the plane filled with zeros); else 4-byte cp.async from each lane
//    (rows and columns past the plane clamp to the last, unused). `next`
//    is a 4-byte cp.async per row. Both complete on the stage's barrier
//    (cp.async.mbarrier.arrive.noinc).
//  - Bank conflicts: TMA writes a dense 32 x 32 tile, so column j of every
//    row would sit in one bank. With the 128-byte swizzle (16-byte chunk c
//    of row r at chunk c ^ (r % 8), squeeze_math.cuh tile_word) a row's
//    16-byte reads, 8 lanes a phase, hit 8 different chunks: no conflict.
//    cp.async writes the same swizzled layout, so the walker reads one. The
//    output stage pads its rows by 16 bytes for the same reason.
//  - No branch and no memory access waits on the chain: the tendency
//    selects between its two candidates (squeeze_math.cuh), offsets are
//    32-bit, and the walks over whole chunks and tiles are unrolled.
//  - The arithmetic, wrapping at 32 bits without signed overflow, the ring
//    and swizzle indices and the clamped load positions are in
//    squeeze_math.cuh, which the CPU tests build with g++ and walk in this
//    kernel's order.
// A 1024-row plane runs 32 blocks of 64 threads, one walker on each of 32
// SMs; dynamic shared memory 46,160 bytes a block.
#include <cuda.h>
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(int32_t* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async4(int32_t* dst, const int32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// One arrival on bar once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

struct HArgs {
  const int32_t* avg;
  const int32_t* res;
  int32_t* out;
  int height, na, nr;
};

// The barriers of the horizontal kernel's rings: `full` completes when a
// stage's copies have landed (32 cp.async arrivals, and the TMA thread's
// expect_tx), `empty` when the walker has read it (32 arrivals); `ofull`
// when the walker has written an output stage, `oempty` when the copy warp
// has read it back (32 arrivals each).
struct Rings {
  int32_t* in;
  int32_t* out;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* ofull;
  uint64_t* oempty;
};

// The copy warp's loads of tile t into stage st: the avg and residual
// tiles, and the `next` of lane's row.
template <bool kTma>
__device__ __forceinline__ void load_stage(const HArgs& a,
                                           const CUtensorMap* map_avg,
                                           const CUtensorMap* map_res,
                                           int32_t* st, uint64_t* full,
                                           int row0, int t, int lane) {
  const int x0 = t * kCols;
  if (kTma) {
    if (lane == 0) {
      mbar_expect_tx(full, 2 * kPlaneWords * sizeof(int32_t));
      tma_load_2d(st, map_avg, x0, row0, full);
      tma_load_2d(st + kPlaneWords, map_res, x0, row0, full);
    }
  } else {
    const int c = tile_col(x0, a.nr, lane);
#pragma unroll 8
    for (int r = 0; r < kRows; ++r) {
      const int y = clamp_row(row0 + r, a.height);
      cp_async4(st + tile_word(r, lane), a.avg + y * a.na + c);
      cp_async4(st + kPlaneWords + tile_word(r, lane), a.res + y * a.nr + c);
    }
  }
  const int y = clamp_row(row0 + lane, a.height);
  cp_async4(st + kNextWord + lane,
            a.avg + y * a.na +
                next_index(x0 + tile_cols(x0, a.nr) - 1, a.na));
  cp_async_arrive(full);
}

// Warp 0: the last avg sample of each row when n is odd, the input ring
// filled kInStages tiles ahead of the walker, and each output stage drained
// once the walker has written it.
template <bool kTma>
__device__ __forceinline__ void copy_warp(const HArgs& a,
                                          const CUtensorMap* map_avg,
                                          const CUtensorMap* map_res,
                                          const Rings& g, int row0, int lane) {
  const int tiles = num_tiles(a.nr);
  const int n = a.na + a.nr;
  const int rows = a.height - row0 < kRows ? a.height - row0 : kRows;
  if (a.na > a.nr && lane < rows)
    a.out[(row0 + lane) * n + n - 1] = a.avg[(row0 + lane) * a.na + a.na - 1];
  for (int t = 0; t < kInStages && t < tiles; ++t)
    load_stage<kTma>(a, map_avg, map_res, g.in + t * kStageWords, &g.full[t],
                     row0, t, lane);
  for (int t = 0; t < tiles; ++t) {
    const int s = ring_slot(t, kInStages);
    if (t + kInStages < tiles) {
      mbar_wait(&g.empty[s], ring_phase(t, kInStages));
      load_stage<kTma>(a, map_avg, map_res, g.in + s * kStageWords,
                       &g.full[s], row0, t + kInStages, lane);
    }
    const int o = ring_slot(t, kOutStages);
    mbar_wait(&g.ofull[o], ring_phase(t, kOutStages));
    const int32_t* os = g.out + o * kOutWords;
    const int w = 2 * tile_cols(t * kCols, a.nr);
    int32_t* orow = a.out + row0 * n + 2 * t * kCols;
#pragma unroll 8
    for (int r = 0; r < rows; ++r) {
      if (lane < w) orow[r * n + lane] = os[r * kOutStride + lane];
      if (lane + 32 < w) orow[r * n + lane + 32] = os[r * kOutStride + lane + 32];
    }
    mbar_arrive(&g.oempty[o]);
  }
}

// Warp 1, a thread per row: each tile read from its stage, walked, and
// written to an output stage; no global memory access.
__device__ __forceinline__ void walker_warp(const HArgs& a, const Rings& g,
                                            int lane) {
  const int tiles = num_tiles(a.nr);
  int32_t left = 0;
  for (int t = 0; t < tiles; ++t) {
    const int s = ring_slot(t, kInStages);
    const int o = ring_slot(t, kOutStages);
    const int32_t* st = g.in + s * kStageWords;
    int32_t* os = g.out + o * kOutWords + lane * kOutStride;
    const int cols = tile_cols(t * kCols, a.nr);
    mbar_wait(&g.full[s], ring_phase(t, kInStages));
    if (t == 0) left = st[tile_word(lane, 0)];
    if (cols == kCols) {
      // the row in registers first, then the stage goes back to the copy
      // warp while the walk runs on registers alone
      int32_t av[kCols], rv[kCols];
#pragma unroll
      for (int q = 0; q < kCols / 4; ++q) {
        const int4 x =
            *reinterpret_cast<const int4*>(st + tile_word(lane, 4 * q));
        const int4 y = *reinterpret_cast<const int4*>(
            st + kPlaneWords + tile_word(lane, 4 * q));
        av[4 * q] = x.x; av[4 * q + 1] = x.y;
        av[4 * q + 2] = x.z; av[4 * q + 3] = x.w;
        rv[4 * q] = y.x; rv[4 * q + 1] = y.y;
        rv[4 * q + 2] = y.z; rv[4 * q + 3] = y.w;
      }
      const int32_t last_next = st[kNextWord + lane];
      mbar_arrive(&g.empty[s]);
      if (t >= kOutStages)
        mbar_wait(&g.oempty[o], ring_phase(t - kOutStages, kOutStages));
#pragma unroll
      for (int j = 0; j < kCols; j += 2) {
        int32_t f0, s0, f1, s1;
        unsqueeze_step(av[j], rv[j], av[j + 1], &left, &f0, &s0);
        unsqueeze_step(av[j + 1], rv[j + 1],
                       j + 2 < kCols ? av[j + 2] : last_next, &left, &f1,
                       &s1);
        *reinterpret_cast<int4*>(os + 2 * j) = make_int4(f0, s0, f1, s1);
      }
    } else {
      // the last, partial tile
      if (t >= kOutStages)
        mbar_wait(&g.oempty[o], ring_phase(t - kOutStages, kOutStages));
      for (int j = 0; j < cols; ++j) {
        const int32_t next = j + 1 < cols ? st[tile_word(lane, j + 1)]
                                          : st[kNextWord + lane];
        int32_t first, second;
        unsqueeze_step(st[tile_word(lane, j)],
                       st[kPlaneWords + tile_word(lane, j)], next, &left,
                       &first, &second);
        os[2 * j] = first;
        os[2 * j + 1] = second;
      }
      mbar_arrive(&g.empty[s]);
    }
    mbar_arrive(&g.ofull[o]);
  }
}

constexpr int kHThreads = 64;
// the rings, their barriers, and room to align the ring to 1024 bytes
constexpr size_t kHSmemBytes =
    1024 + sizeof(int32_t) * (kInStages * kStageWords + kOutStages * kOutWords) +
    sizeof(uint64_t) * 2 * (kInStages + kOutStages);

template <bool kTma>
__global__ void __launch_bounds__(kHThreads)
    inv_squeeze_h_kernel(const __grid_constant__ CUtensorMap map_avg,
                         const __grid_constant__ CUtensorMap map_res,
                         const HArgs a) {
  extern __shared__ unsigned char smem_raw[];
  int32_t* in = reinterpret_cast<int32_t*>(
      smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024));
  int32_t* out = in + kInStages * kStageWords;
  uint64_t* bars = reinterpret_cast<uint64_t*>(out + kOutStages * kOutWords);
  const Rings g{in, out, bars, bars + kInStages, bars + 2 * kInStages,
                bars + 2 * kInStages + kOutStages};
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    if (kTma) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(&map_avg))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(&map_res))
                   : "memory");
    }
    for (int i = 0; i < kInStages; ++i) {
      mbar_init(&g.full[i], kTma ? 33 : 32);
      mbar_init(&g.empty[i], 32);
    }
    for (int i = 0; i < kOutStages; ++i) {
      mbar_init(&g.ofull[i], 32);
      mbar_init(&g.oempty[i], 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (warp == 0)
    copy_warp<kTma>(a, &map_avg, &map_res, g, blockIdx.x * kRows, lane);
  else
    walker_warp(a, g, lane);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched at run time so the library does not link
// libcuda; null where libcuda has none.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A [lines, width] int32 plane as a tensor map of 32 x 32 boxes, swizzled
// 128 bytes; 0, or 1000 + the CUresult.
int encode(CUtensorMap* map, const int32_t* plane, int lines, int width) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(width),
                              static_cast<cuuint64_t>(lines)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(width) * 4};
  const cuuint32_t box[2] = {kCols, kRows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encoder()(
      map, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, const_cast<int32_t*>(plane),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + static_cast<int>(r);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int launch_h(const HArgs& a, cudaStream_t s) {
  const int blocks = (a.height + kRows - 1) / kRows;
  CUtensorMap map_avg{}, map_res{};
  if (tma_rows(a.na, a.nr) && aligned16(a.avg) && aligned16(a.res)) {
    if (encoder() == nullptr) return -1;
    int err = encode(&map_avg, a.avg, a.height, a.na);
    if (err == 0) err = encode(&map_res, a.res, a.height, a.nr);
    if (err != 0) return err;
    inv_squeeze_h_kernel<true><<<blocks, kHThreads, kHSmemBytes, s>>>(
        map_avg, map_res, a);
  } else {
    inv_squeeze_h_kernel<false><<<blocks, kHThreads, kHSmemBytes, s>>>(
        map_avg, map_res, a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry, bound with ctypes: pointers and the stream as void*. `lines`
// lines of na averages and nr residuals along the squeezed axis (na is nr
// or nr + 1, nr > 0); horizontal: planes [lines, na], [lines, nr] ->
// [lines, na + nr]; vertical: [na, lines], [nr, lines] -> [na + nr, lines].
// Returns 0 once launched, else a cudaError_t (cudaGetLastError after the
// launch), 1000 + the CUresult of a failed tensor-map encoding, or -1 when
// libcuda has no encoder.
extern "C" int jxl_inv_squeeze(const void* avg, const void* res, void* out,
                               int lines, int na, int nr, int horizontal,
                               void* stream) {
  if (lines <= 0 || nr <= 0 || (na != nr && na != nr + 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* a = static_cast<const int32_t*>(avg);
  const int32_t* r = static_cast<const int32_t*>(res);
  int32_t* o = static_cast<int32_t*>(out);
  if (horizontal) return launch_h(HArgs{a, r, o, lines, na, nr}, s);
  inv_squeeze_v_kernel<<<(lines + kVThreads - 1) / kVThreads, kVThreads, 0,
                         s>>>(a, r, o, lines, na, nr);
  return static_cast<int>(cudaGetLastError());
}
