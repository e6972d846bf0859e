// K12: the noise field of one frame (jxl-render features/noise.rs:403-452)
// on the card. The JAX package builds it on the host, one Python loop
// step per batch, group by group (jxl_oxide_tpu/render/features.py:392-440
// `_noise_field`); it has no TPU kernel. The plain version is
// ops/noise.py `noise_field_plain` (numpy), bit for bit this kernel.
//
// CUDA C++ and not Triton: the work is a 64-bit integer recurrence per
// lane (XorShift128+) with table reads, neither an elementwise pass nor a
// reduction.
//
// What bounds the function: bytes. The field is 12 B a pixel of writes
// (3.8 us at 1024^2 at 3.35 TB/s) and 20 integer operations a step (1.6 M
// steps at 1024^2, 0.5 us at 67 T/s). But a lane's steps are serial:
// wn2 * gh * 3 of them, 196,608 for a 1024^2 group and 12,288 for a 256^2
// one. One thread per (group, lane) takes steps x one step's latency:
// 4.48 ms for the 1024^2 group on an H100 (22.77 ns a step).
//
// What the design does: it cuts each lane's walk into segments of `seg`
// batches and runs one thread per (group, lane, segment). XorShift128+
// is linear over GF(2), so a thread reaches its segment's start j * seg by
// a jump (noise_math.cuh `jump`: 128 steps and masked XORs, driven by
// q = x^(j seg) mod chi from a table built on the host, ops/noise.py
// `jump_table`), then walks at most seg steps. One table serves every
// group and lane of a frame. Lanes are the fastest thread index, so one
// warp's stores of a batch are 64 contiguous bytes of a row for each of
// its four segments, one 8-byte store a lane where rows are aligned.
//
// What bounds the kernel now: a thread's 128 + seg steps, about 18
// instructions a jump step and 20 a walk step in the SASS. With few warps
// an SM (12,288 threads at 1024^2) their latency sets the time; with many,
// the card's integer instruction rate over all threads' steps,
// (1 + 128 / seg) x the function's. ops/cuda/noise.py `segment_steps` picks
// seg between the two from rates measured on the card (its note;
// chip_smoke.py `phase_noise` sweeps seg on every run).
#include <cuda_runtime.h>
#include <stdint.h>

#include "noise_math.cuh"

namespace {

constexpr int kThreads = 64;

__global__ void __launch_bounds__(kThreads)
    noise_field_kernel(float* out, int width, int height, int group_dim,
                       const uint64_t* __restrict__ table, int segments,
                       int seg, int threads, uint64_t seed0) {
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  if (tid < threads)
    jxl_noise::walk_segment(out, width, height, group_dim, table, segments,
                            seg, seed0, tid);
}

}  // namespace

// C entry, bound with ctypes: the [3, height, width] float32 output, the
// jump table ([table_len, 2] u64, row j = x^(j seg) mod chi), the segment
// length and the stream as void*; returns 0 once launched, else a
// cudaError_t. The table must hold a row for each segment of group 0's
// walk (the largest group).
extern "C" int jxl_noise_field(void* out, int width, int height,
                               int group_dim, unsigned long long seed0,
                               const void* table, int table_len, int seg,
                               void* stream) {
  if (width <= 0 || height <= 0 || group_dim <= 0 || seg <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const jxl_noise::Group g0 = jxl_noise::group_of(0, width, height, group_dim);
  const long segments = (jxl_noise::lane_batches(g0) + seg - 1L) / seg;
  const long groups = static_cast<long>((width + group_dim - 1) / group_dim) *
                      ((height + group_dim - 1) / group_dim);
  const long threads = groups * segments * jxl_noise::kLanes;
  if (segments > table_len || threads >= (1L << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  noise_field_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), width, height, group_dim,
      static_cast<const uint64_t*>(table), static_cast<int>(segments), seg,
      static_cast<int>(threads), seed0);
  return static_cast<int>(cudaGetLastError());
}
