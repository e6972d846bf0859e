// The noise field's random bits (jxl-render features/noise.rs:403-452):
// SplitMix64 seeding and the XorShift128+ step of one lane, and where a
// lane's batch lands in the field. Shared by the CUDA kernel (noise.cu)
// and a host build that the CPU tests compile with g++
// (tests/test_torch_features.py), which walks every lane with these
// functions and holds the field bit for bit against the JAX package's
// numpy walk.
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

// Lane `lane`'s walk over group `gr`: batches b = (c * gh + r) * wn2 + k,
// in order, each sum written as two samples at columns 16 k + 2 lane and
// 16 k + 2 lane + 1 of row r of channel c (low half first), where they
// fall inside the group. `out` is the [3, height, width] field.
__host__ __device__ inline void walk_lane(float* out, int width, int height,
                                          const Group& gr, uint64_t seed0,
                                          int lane) {
  Lane st = seed_lane(seed0, group_seed(gr), lane);
  const long plane = static_cast<long>(width) * height;
  for (int c = 0; c < 3; ++c) {
    for (int r = 0; r < gr.gh; ++r) {
      float* row = out + c * plane + static_cast<long>(gr.y0 + r) * width +
                   gr.x0;
      for (int k = 0; k < gr.wn2; ++k) {
        const uint64_t v = next(st);
        const int col = 16 * k + 2 * lane;
        if (col < gr.gw) row[col] = to_unit_float(static_cast<uint32_t>(v));
        if (col + 1 < gr.gw)
          row[col + 1] = to_unit_float(static_cast<uint32_t>(v >> 32));
      }
    }
  }
}

}  // namespace jxl_noise
