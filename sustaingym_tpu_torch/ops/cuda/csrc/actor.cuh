// The PPO actor inside the policy-in-kernel episode kernels (ev_rollout.cu,
// building_rollout.cu): the dense layers over a tile of envs and the
// Box-Muller normal draws, as the JAX package shares its `_normal_bits`
// between its EV and building policy kernels.
//
// A CTA owns a tile of kTile envs. Its obs and hidden tiles live in shared
// memory, so the bf16 weights are read from L2 once per tile per step, not
// once per env. The dense layers are plain FMA loops with f32 accumulation;
// bf16 rounding happens exactly where the JAX kernels cast (obs, h1, h2).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kTile = 16;  // envs per CTA in the policy kernels
constexpr int kEpt = 8;    // envs per thread in the MLP loops

// The actor's weights, as parallel.ppo.ActorCritic packed by
// ops/cuda/ev_rollout.py::pack_policy_weights.
struct Actor {
  const __nv_bfloat16* w1;  // (D, H) = trunk1 (din, dout)
  const float* b1;          // (H)
  const __nv_bfloat16* w2;  // (H, H)
  const float* b2;          // (H)
  const __nv_bfloat16* wm;  // (H, n)
  const float* bm;          // (n)
  const float* sigma;       // (n) exp(log_std)
  int D, H;
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// out[e][j] = act(bias[j] + sum_i in[e][i] * w[i][j]) for the tile's envs;
// with act_tanh the output is tanh rounded to bf16 (the next matmul's
// operand).
__device__ void tile_dense(const float* in, int ld_in, int din,
                           const __nv_bfloat16* __restrict__ w, int dout,
                           const float* __restrict__ bias, float* out,
                           int ld_out, bool act_tanh) {
  for (int item = threadIdx.x; item < dout * (kTile / kEpt); item += blockDim.x) {
    const int j = item % dout, g = item / dout;
    const float* x = in + g * kEpt * ld_in;
    float acc[kEpt];
#pragma unroll
    for (int q = 0; q < kEpt; ++q) acc[q] = 0.0f;
    for (int i = 0; i < din; ++i) {
      const float wv = __bfloat162float(w[(size_t)i * dout + j]);
#pragma unroll
      for (int q = 0; q < kEpt; ++q) acc[q] += x[q * ld_in + i] * wv;
    }
    const float b = bias[j];
#pragma unroll
    for (int q = 0; q < kEpt; ++q) {
      const float v = acc[q] + b;
      out[(g * kEpt + q) * ld_out + j] = act_tanh ? bf16_round(tanhf(v)) : v;
    }
  }
}

// Two standard normals from one Philox block by Box-Muller; log1p(-u1)
// keeps u1 = 0 finite.
__device__ __forceinline__ float2 box_muller(uint4 r) {
  const float tau = (float)(2.0 * 3.14159265358979323846);
  return make_float2(
      sqrtf(-2.0f * log1pf(-uniform01(r.x))) * cosf(tau * uniform01(r.y)),
      sqrtf(-2.0f * log1pf(-uniform01(r.z))) * cosf(tau * uniform01(r.w)));
}

}  // namespace
