// Whole DataCenterEnv episodes on an NVIDIA Hopper card (sm_90a).
//
// Replaces the Pallas TPU kernel sustaingym_tpu/ops/pallas/dc_rollout.py::
// fused_dc_segment (_kernel): per env and hour, a VCC (drawn in the kernel
// or prescribed), the VCC fluid queue min(queue + arrivals, a C), the carbon
// cost executed x MOER and, at each 24-hour boundary, the delay penalty
// max(0, 0.97 sum arrivals - C sum a) of envs/datacenter/env.py::step_core.
//
// What bounds it. Bytes: each env step writes 6 float rows (a, executed,
// queue, reward, carbon cost, delay penalty), 24 bytes, against ~15 float
// operations, so the output stream (4.23 GB at 262144 x 672) sets the time
// at the memory rate. The inputs are small: the padded (month, hour,
// [arrivals, MOER]) table (156 KB, L2-resident) and a month index per env.
//
// Design. One thread per env loops over the T hours of its episode, with
// its three carries (queue, day VCC sum, day arrivals) in registers. It
// reads the hour's [arrivals, MOER] pair straight from the table by month
// index, where the TPU kernel read it from a block the slice-gather kernel
// had packed: the same numbers, without writing and reading the block.
// Output is (6, T, B), env-minor, so the threads of a warp store
// consecutive floats. The TPU layout (envs on 128 lanes, `il` interleaved
// groups, 8 padded output rows) does not carry over.
//
// Numerics. The plain version (ops/cuda/dc_rollout.py::dc_segment_ref) runs
// the same float32 operations one PyTorch op at a time; this file is built
// with -fmad=false, so 0.97 day_arr - day_vcc is a rounded product and a
// rounded difference, as there. The dynamics are min, max, add, multiply
// and select, so kernel and plain version agree bit for bit.
//
// Random draws: Philox4x32-10 (philox.cuh), one call per env for four
// hours, counted by (hour / 4, env, stream 3): a = U[0, 1) from the top 23
// bits, the env's Box(0, 1) action space, as the TPU kernel's RNG mode.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kHoursPerDay = 24;
constexpr float kCapacity = 1.0f;
constexpr float kDelayFactor = 0.97f;

__global__ void __launch_bounds__(kThreads)
dc_segment_kernel(const float2* __restrict__ table, int rows_per_month,
                  const int64_t* __restrict__ months,
                  const float* __restrict__ acts, int B, int T, uint64_t seed,
                  float* __restrict__ out) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= B) return;
  const uint2 key = philox_key(seed);
  const float2* rows = table + (size_t)months[e] * rows_per_month;
  const size_t row_stride = (size_t)T * B;  // between output rows
  float queue = 0.0f, day_vcc = 0.0f, day_arr = 0.0f;
  uint4 bits = make_uint4(0u, 0u, 0u, 0u);

  for (int t = 0; t < T; ++t) {
    float a;
    if (acts != nullptr) {
      a = fminf(fmaxf(acts[(size_t)t * B + e], 0.0f), 1.0f);
    } else {
      if ((t & 3) == 0)
        bits = philox4x32_10(make_uint4((uint32_t)(t >> 2), (uint32_t)e, 3u, 0u),
                             key);
      const int w = t & 3;
      a = uniform01(w == 0 ? bits.x : w == 1 ? bits.y : w == 2 ? bits.z : bits.w);
    }
    const float2 x = rows[t];  // (arrivals, MOER) of hour t
    const float backlog = queue + x.x;
    const float executed = fminf(backlog, a * kCapacity);
    queue = backlog - executed;
    const float carbon = executed * x.y;
    day_vcc = day_vcc + a;
    day_arr = day_arr + x.x;
    const bool boundary = (t + 1) % kHoursPerDay == 0;
    const float delay =
        boundary ? fmaxf(kDelayFactor * day_arr - kCapacity * day_vcc, 0.0f)
                 : 0.0f;
    const float reward = -(carbon + delay);
    if (boundary) {
      day_vcc = 0.0f;
      day_arr = 0.0f;
    }
    // rows: a | executed | queue | reward | carbon cost | delay penalty
    float* o = out + (size_t)t * B + e;
    o[0] = a;
    o[row_stride] = executed;
    o[2 * row_stride] = queue;
    o[3 * row_stride] = reward;
    o[4 * row_stride] = carbon;
    o[5 * row_stride] = delay;
  }
}

}  // namespace

// ---- plain C interface (loaded with ctypes; returns a cudaError_t) ----

extern "C" int dc_segment_launch(const float* table, int rows_per_month,
                                 const int64_t* months, const float* acts,
                                 int B, int T, uint64_t seed, float* out,
                                 void* stream) {
  if (B <= 0 || T <= 0 || T > rows_per_month) return (int)cudaErrorInvalidValue;
  const int grid = (B + kThreads - 1) / kThreads;
  dc_segment_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float2*>(table), rows_per_month, months, acts, B,
      T, seed, out);
  return (int)cudaGetLastError();
}
