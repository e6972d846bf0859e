// The squeeze's chain probe: how long one step of the inverse-squeeze
// recurrence takes on this card when nothing but the recurrence runs. A
// measurement library (ops/cuda/squeeze_measure.py); no decode calls it.
//
// The squeeze kernel (modular_squeeze.cu) walks each line in order: step
// k's second output is step k + 1's left neighbour in the tendency, so a
// line takes at least (its steps) x (the latency of one step's dependent
// chain), however many lines run beside it. This probe runs that chain,
// jxl_squeeze::unsqueeze_step from squeeze_math.cuh, alone: one thread per
// line walks rounds x kProbeSpan steps over avg and residual values held in
// registers (probe_load, probe_walk), so no step waits on memory, and writes
// only a per-line checksum of its outputs (which keeps the walk from being
// dropped; the CPU tests and chip_smoke.py hold it against the same walk in
// plain torch) and the SM cycles of its walk (clock64). Blocks of 32
// threads, one warp each, as the squeeze kernel's walking warps: 32 lines
// are one warp on one SM, 1024 lines 32 warps on 32 SMs.
#include <cuda_runtime.h>
#include <stdint.h>

#include "squeeze_math.cuh"

namespace {

using namespace jxl_squeeze;

constexpr int kProbeThreads = 32;

__global__ void __launch_bounds__(kProbeThreads)
    squeeze_probe_kernel(const int32_t* __restrict__ tab_avg,
                         const int32_t* __restrict__ tab_res, int lines,
                         int rounds, int32_t* __restrict__ checksum,
                         long long* __restrict__ cycles) {
  const int line = blockIdx.x * blockDim.x + threadIdx.x;
  if (line >= lines) return;
  int32_t a[kProbeSpan], r[kProbeSpan];
  probe_load(tab_avg, tab_res, line, a, r);
  int32_t left = a[0];
  const long long t0 = clock64();
  uint32_t sum = probe_walk(a, r, rounds, &left);
  // the second clock read waits for the walk's result
  asm volatile("" : "+r"(sum));
  const long long t1 = clock64();
  checksum[line] = static_cast<int32_t>(sum);
  cycles[line] = t1 - t0;
}

}  // namespace

// C entry, bound with ctypes: tab_avg and tab_res hold kProbeSpan int32
// each; checksum [lines] int32 and cycles [lines] int64 are written.
// Returns 0 once launched, else a cudaError_t.
extern "C" int jxl_squeeze_probe(const void* tab_avg, const void* tab_res,
                                 int lines, int rounds, void* checksum,
                                 void* cycles, void* stream) {
  if (lines <= 0 || rounds <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  squeeze_probe_kernel<<<(lines + kProbeThreads - 1) / kProbeThreads,
                         kProbeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tab_avg),
      static_cast<const int32_t*>(tab_res), lines, rounds,
      static_cast<int32_t*>(checksum), static_cast<long long*>(cycles));
  return static_cast<int>(cudaGetLastError());
}

// kProbeSpan, for the wrapper's check of its tables.
extern "C" int jxl_squeeze_probe_span() { return kProbeSpan; }
