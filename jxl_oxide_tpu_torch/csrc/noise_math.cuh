// The noise field's random bits (jxl-render features/noise.rs:403-452):
// SplitMix64 seeding and the XorShift128+ step of one lane, the jump of a
// lane's state ahead by n steps, and where a lane's batch lands in the
// field. Shared by the CUDA kernel (noise.cu) and a host build that the
// CPU tests compile with g++ (tests/test_torch_features.py), which walks
// every lane, whole or in jumped segments, with these functions and holds
// the field bit for bit against the JAX package's numpy walk.
#pragma once

#include <stdint.h>
#include <string.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#endif

namespace jxl_noise {

// Lanes of one group's generator: each batch is 8 u64 sums, 16 u32s.
constexpr int kLanes = 8;
constexpr uint64_t kGolden = 0x9E3779B97F4A7C15ull;

__host__ __device__ inline uint64_t split_mix_64(uint64_t z) {
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

struct Lane {
  uint64_t s0, s1;
};

// Lane `lane` of the generator seeded with (seed0, seed1): lane 0 takes
// SplitMix64 of each seed plus the golden ratio, lane i SplitMix64 of
// lane i - 1's.
__host__ __device__ inline Lane seed_lane(uint64_t seed0, uint64_t seed1,
                                          int lane) {
  Lane st{split_mix_64(seed0 + kGolden), split_mix_64(seed1 + kGolden)};
  for (int i = 0; i < lane; ++i) {
    st.s0 = split_mix_64(st.s0);
    st.s1 = split_mix_64(st.s1);
  }
  return st;
}

// One XorShift128+ step: returns s0 + s1 and advances the state.
__host__ __device__ inline uint64_t next(Lane& st) {
  const uint64_t t0 = st.s1;
  uint64_t t1 = st.s0;
  const uint64_t out = t1 + t0;
  st.s0 = t0;
  t1 ^= t1 << 23;
  st.s1 = t1 ^ (t0 ^ (t1 >> 18) ^ (t0 >> 5));
  return out;
}

// The uniform float in [1, 2) of 23 random bits: (bits >> 9) | 1.0f.
__host__ __device__ inline float to_unit_float(uint32_t bits) {
  const uint32_t u = (bits >> 9) | 0x3F800000u;
#ifdef __CUDA_ARCH__
  return __uint_as_float(u);
#else
  float f;
  memcpy(&f, &u, sizeof f);
  return f;
#endif
}

// A group of the frame: origin, size, and wn2, the batches of one row
// (16 samples a batch, the row padded to a whole batch).
struct Group {
  int x0, y0, gw, gh, wn2;
};

// Group g of a width x height frame cut into group_dim squares, in raster
// order.
__host__ __device__ inline Group group_of(int g, int width, int height,
                                          int group_dim) {
  const int per_row = (width + group_dim - 1) / group_dim;
  Group gr;
  gr.x0 = (g % per_row) * group_dim;
  gr.y0 = (g / per_row) * group_dim;
  gr.gw = width - gr.x0 < group_dim ? width - gr.x0 : group_dim;
  gr.gh = height - gr.y0 < group_dim ? height - gr.y0 : group_dim;
  gr.wn2 = (gr.gw + 2 * kLanes - 1) / (2 * kLanes);
  return gr;
}

// The group's seed1: its origin, x0 in the high word.
__host__ __device__ inline uint64_t group_seed(const Group& gr) {
  return (static_cast<uint64_t>(gr.x0) << 32) + static_cast<uint64_t>(gr.y0);
}

// The state n steps on from `st`, given q = x^n mod chi as its bits 0-63
// (q_lo) and 64-127 (q_hi), chi being the step's characteristic
// polynomial (ops/noise.py `characteristic_polynomial`): by Cayley-Hamilton
// T^n = sum_i q_i T^i, so 128 steps of `next` from `st`, each state XORed
// into the result under a mask made from its bit of q. No branch on q:
// every thread of a warp runs the same 128 steps. The mask of bit i of a
// 32-bit word is that bit shifted to the sign and spread by an arithmetic
// shift; unrolled, both shifts are by constants.
__host__ __device__ inline Lane jump(Lane st, uint64_t q_lo, uint64_t q_hi) {
  Lane acc{0, 0};
  for (int w = 0; w < 4; ++w) {
    // no array indexed by w: that would live in local memory
    const uint64_t half = w < 2 ? q_lo : q_hi;
    const uint32_t word = static_cast<uint32_t>(w & 1 ? half >> 32 : half);
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
    for (int i = 0; i < 32; ++i) {
      const uint32_t m32 = static_cast<uint32_t>(
          static_cast<int32_t>(word << (31 - i)) >> 31);
      const uint64_t m = (static_cast<uint64_t>(m32) << 32) | m32;
      acc.s0 ^= st.s0 & m;
      acc.s1 ^= st.s1 & m;
      next(st);
    }
  }
  return acc;
}

// The batches of one group a lane walks: wn2 * gh * 3.
__host__ __device__ inline int lane_batches(const Group& gr) {
  return gr.wn2 * gr.gh * 3;
}

// One batch's sum as two samples at p[0] and p[1], low half first; as one
// 8-byte store on the card where `kPairs` says p is 8-byte aligned.
template <bool kPairs>
__host__ __device__ inline void store_batch(float* p, uint64_t v) {
  const float lo = to_unit_float(static_cast<uint32_t>(v));
  const float hi = to_unit_float(static_cast<uint32_t>(v >> 32));
#ifdef __CUDA_ARCH__
  if (kPairs) {
    *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
    return;
  }
#endif
  p[0] = lo;
  p[1] = hi;
}

// Batches b0 .. b0 + n - 1 of lane `lane`'s walk over group `gr`, from
// `st`, the lane's state at batch b0. Batch b = (c * gh + r) * wn2 + k
// writes its sum as two samples at columns 16 k + 2 lane and
// 16 k + 2 lane + 1 of row r of channel c (low half first), where they
// fall inside the group. `out` is the [3, height, width] field. Row by
// row: the batches whose 16 samples all fall inside the group store
// without a check; only a row's last batch in a group whose width is no
// multiple of 16 checks its columns. kPairs: every batch's first column
// is 8-byte aligned (`out` aligned, even width and group origin).
template <bool kPairs>
__host__ __device__ inline void walk_batches(float* out, int width,
                                             int height, const Group& gr,
                                             Lane st, int lane, int b0,
                                             int n) {
  const long plane = static_cast<long>(width) * height;
  const int full = gr.gw / 16;
  int k = b0 % gr.wn2;
  int cr = b0 / gr.wn2;  // c * gh + r
  while (n > 0) {
    const int c = cr / gr.gh;
    float* row = out + c * plane +
                 static_cast<long>(gr.y0 + cr - c * gr.gh) * width + gr.x0 +
                 2 * lane;
    const int end = gr.wn2 - k < n ? gr.wn2 : k + n;
    n -= end - k;
    for (const int mid = end < full ? end : full; k < mid; ++k)
      store_batch<kPairs>(row + 16 * k, next(st));
    for (; k < end; ++k) {
      const uint64_t v = next(st);
      const int col = 16 * k + 2 * lane;
      if (col < gr.gw) row[16 * k] = to_unit_float(static_cast<uint32_t>(v));
      if (col + 1 < gr.gw)
        row[16 * k + 1] = to_unit_float(static_cast<uint32_t>(v >> 32));
    }
    k = 0;
    ++cr;
  }
}

// Thread `tid` of K12's launch over a width x height field in group_dim
// squares, each lane's walk cut into `segments` segments of `seg` batches
// (group 0's walk, the longest): lane tid % 8, segment j = (tid / 8) %
// segments, group (tid / 8) / segments. It seeds its lane, jumps to batch
// j * seg with row j of `table` (q = x^(j seg) mod chi as two u64s), and
// walks at most seg batches. A segment past its group's walk (a partial
// group at the right or bottom edge walks fewer) does nothing.
__host__ __device__ inline void walk_segment(float* out, int width,
                                             int height, int group_dim,
                                             const uint64_t* table,
                                             int segments, int seg,
                                             uint64_t seed0, int tid) {
  const int lane = tid % kLanes;
  const int rest = tid / kLanes;
  const int j = rest % segments;
  const Group gr = group_of(rest / segments, width, height, group_dim);
  const int b0 = j * seg;
  const int count = lane_batches(gr);
  if (b0 >= count) return;
  const Lane st = jump(seed_lane(seed0, group_seed(gr), lane), table[2 * j],
                       table[2 * j + 1]);
  const int n = count - b0 < seg ? count - b0 : seg;
  if ((reinterpret_cast<uintptr_t>(out) & 7) == 0 && width % 2 == 0 &&
      group_dim % 2 == 0)
    walk_batches<true>(out, width, height, gr, st, lane, b0, n);
  else
    walk_batches<false>(out, width, height, gr, st, lane, b0, n);
}

}  // namespace jxl_noise
