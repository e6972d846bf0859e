// K12: the noise field of one frame (jxl-render features/noise.rs:403-452)
// on the card. The JAX package builds it on the host, one Python loop
// step per batch, group by group (jxl_oxide_tpu/render/features.py:392-440
// `_noise_field`); it has no TPU kernel. The plain version is
// ops/noise.py `noise_field_plain` (numpy), bit for bit this kernel.
//
// CUDA C++ and not Triton: the work is a 64-bit integer recurrence per
// lane (XorShift128+), serial along each lane's walk, neither an
// elementwise pass nor a reduction. Each group's 8 lanes are independent
// sequences, so the kernel runs one thread per (group, lane), and each
// thread walks its wn2 * gh * 3 batches and writes its two floats a batch
// straight into the [3, H, W] float32 field.
//
// What bounds it: the walk, not the bytes. The field is 12 B a pixel of
// writes (3.8 us at 1024^2 at 3.35 TB/s), but a lane's steps are serial:
// wn2 * gh * 3 = 12,288 of them for a 256^2 group, whatever the frame's
// size, each a chain of 64-bit shifts and xors (two 32-bit halves each).
// The time is that chain's latency times the steps. A jump-ahead that
// splits each lane's walk into independent pieces would cut it (not done:
// a simple kernel that is right first).
#include <cuda_runtime.h>
#include <stdint.h>

#include "noise_math.cuh"

namespace {

// One warp is four groups' lanes: a 1024^2 frame of 256^2 groups spreads
// over four SMs.
constexpr int kThreads = 32;

__global__ void __launch_bounds__(kThreads)
    noise_field_kernel(float* out, int width, int height, int group_dim,
                       int num_groups, uint64_t seed0) {
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  const int g = tid / jxl_noise::kLanes;
  if (g >= num_groups) return;
  const jxl_noise::Group gr = jxl_noise::group_of(g, width, height, group_dim);
  jxl_noise::walk_lane(out, width, height, gr, seed0, tid % jxl_noise::kLanes);
}

}  // namespace

// C entry, bound with ctypes: the [3, height, width] float32 output and
// the stream as void*; returns 0 once launched, else a cudaError_t.
extern "C" int jxl_noise_field(void* out, int width, int height,
                               int group_dim, unsigned long long seed0,
                               void* stream) {
  if (width <= 0 || height <= 0 || group_dim <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long groups = static_cast<long>((width + group_dim - 1) / group_dim) *
                      ((height + group_dim - 1) / group_dim);
  if (groups * jxl_noise::kLanes >= (1L << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = static_cast<int>(groups) * jxl_noise::kLanes;
  const int blocks = (threads + kThreads - 1) / kThreads;
  noise_field_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), width, height, group_dim,
      static_cast<int>(groups), seed0);
  return static_cast<int>(cudaGetLastError());
}
