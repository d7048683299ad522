// The PPO actor inside the policy-in-kernel episode kernels (ev_rollout.cu,
// building_rollout.cu): the dense layers over a tile of 16 envs on the
// tensor cores, and the Box-Muller normal draws, as the JAX package shares
// its `_normal_bits` between its EV and building policy kernels.
//
// What bounds it. 2 (D H + H H + H n) flops per env step (234 kflop for EV
// at H = 256), whose weights (~240 KB bf16) are the one large operand; at
// the bf16 tensor-core rate the actor of a whole 8192 x 288 EV rollout is
// ~0.6 ms. The first version ran the layers as float FMAs with one
// shared-memory load per FMA (~9 TFLOP/s, ~35 ms of the EV kernel). On the
// tensor cores the weights' traffic is what is left: each 16-env tile reads
// all of them from L2 at every step, 35 GB for an 8192 x 288 EV rollout.
//
// Design. Each layer is a (16 envs x din) x (din x dout) product on
// mma.sync m16n8k16, bf16 in, float32 sums: the tile's envs are M (one m16
// tile), the layer's outputs N, its inputs k. The obs and hidden tiles live
// in shared memory as bf16 (the JAX kernels cast obs, h1 and h2 to bf16 at
// these points, so the rounding points do not move), padded to a multiple
// of 16 columns with a row stride of an odd multiple of 16 bytes, and
// ldmatrix reads them as A fragments. The weights are B fragments, read from
// L2 as one 16-byte load per lane per k16 step and n16 column pair, in the
// fragment order ops/cuda/ev_rollout.py::pack_policy_weights writes (two
// steps in flight per warp). Warp w computes column pairs w, w + warps, ...
// The tensor core sums each k16 step's products from zero and the step's
// sum is added to the float32 sums in registers, rounding to nearest:
// chaining the sums through the tensor core's own accumulation (which does
// not round to nearest) moved mu enough to flip an EV pilot quantization
// against the plain version within the first 12 steps. Bias, tanh and the
// bf16 rounding run in the epilogue, on the sums in registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "philox.cuh"

namespace {

constexpr int kTile = 16;  // envs per CTA in the policy kernels: one m16 tile

// row stride (elements) of a bf16 tile of `cols` columns
__host__ __device__ constexpr int tile_ld(int cols) { return pad16(cols) + 8; }

// The actor's weights, as parallel.ppo.ActorCritic packed by
// ops/cuda/ev_rollout.py::pack_policy_weights: each dense weight (din, dout)
// zero-padded to multiples of 16 and laid out as [dout / 16][din / 16][32
// lanes][8 bf16], lane 4g + t holding b0 and b1 of the n8 tile 2p, then of
// the tile 2p + 1, for column pair p and k16 step kc.
struct Actor {
  const uint4* w1;      // (D, H)
  const float* b1;      // (H)
  const uint4* w2;      // (H, H)
  const float* b2;      // (H)
  const uint4* wm;      // (H, n)
  const float* bm;      // (n)
  const float* sigma;   // (n) exp(log_std)
  int D, H;
};

constexpr int kSteps = 2;  // k16 steps of weights in flight per warp

// out[e][j] = act(bias[j] + sum_i in[e][i] w[i][j]) for the tile's 16 envs,
// j < pad16(dout) (padded columns get 0). `in` is a bf16 tile of din
// (padded to 16) columns with row stride ld_in; with kTanh the output is
// tanh rounded to a bf16 tile (the next layer's input), else float32.
template <bool kTanh>
__device__ void tile_dense(const __nv_bfloat16* in, int ld_in, int din,
                           const uint4* __restrict__ w, int dout,
                           const float* __restrict__ bias, void* out, int ld_out) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int kc_n = pad16(din) / 16, pairs = pad16(dout) / 16;
  const __nv_bfloat16* a_row = in + (lane & 15) * ld_in + ((lane >> 4) << 3);
  for (int p = threadIdx.x >> 5; p < pairs; p += blockDim.x >> 5) {
    float acc[2][4] = {};
    const uint4* wp = w + (size_t)p * kc_n * 32 + lane;
    for (int k0 = 0; k0 < kc_n; k0 += kSteps) {
      uint4 b[kSteps];
#pragma unroll
      for (int s = 0; s < kSteps; ++s)
        b[s] = k0 + s < kc_n ? __ldg(wp + (k0 + s) * 32) : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        if (k0 + s < kc_n) {
          uint32_t a[4];
          ldsm_x4(a, a_row + 16 * (k0 + s));
          add_mma(acc[0], a, b[s].x, b[s].y);
          add_mma(acc[1], a, b[s].z, b[s].w);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 16 * p + 8 * h + 2 * t;
      const float c0 = j < dout ? bias[j] : 0.0f;
      const float c1 = j + 1 < dout ? bias[j + 1] : 0.0f;
      if constexpr (kTanh) {
        __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + j;
        *reinterpret_cast<__nv_bfloat162*>(o + g * ld_out) =
            __floats2bfloat162_rn(tanhf(acc[h][0] + c0), tanhf(acc[h][1] + c1));
        *reinterpret_cast<__nv_bfloat162*>(o + (g + 8) * ld_out) =
            __floats2bfloat162_rn(tanhf(acc[h][2] + c0), tanhf(acc[h][3] + c1));
      } else {
        float* o = static_cast<float*>(out) + j;
        o[g * ld_out] = acc[h][0] + c0;
        o[g * ld_out + 1] = acc[h][1] + c1;
        o[(g + 8) * ld_out] = acc[h][2] + c0;
        o[(g + 8) * ld_out + 1] = acc[h][3] + c1;
      }
    }
  }
}

// Shared-memory tiles of the actor for one CTA, carved from `base`
// (16-byte aligned): obs (D columns), h1 and h2 (H) in bf16, mu (n) in
// float32. Padding columns of obs are zeroed here; h1, h2 and mu are
// written whole by tile_dense.
struct ActorTiles {
  __nv_bfloat16 *obs, *h1, *h2;
  float* mu;
  int ld_obs, ld_h, ld_mu;
};

__host__ __device__ inline size_t actor_tiles_bytes(int D, int H, int n) {
  return (size_t)kTile * (2 * (tile_ld(D) + 2 * tile_ld(H)) + 4 * tile_ld(n));
}

__device__ inline ActorTiles carve_actor_tiles(unsigned char* base, int D, int H,
                                               int n) {
  ActorTiles s;
  s.ld_obs = tile_ld(D);
  s.ld_h = tile_ld(H);
  s.ld_mu = tile_ld(n);
  s.obs = reinterpret_cast<__nv_bfloat16*>(base);
  s.h1 = s.obs + kTile * s.ld_obs;
  s.h2 = s.h1 + kTile * s.ld_h;
  s.mu = reinterpret_cast<float*>(s.h2 + kTile * s.ld_h);
  for (int i = threadIdx.x; i < kTile * s.ld_obs; i += blockDim.x)
    s.obs[i] = __float2bfloat16_rn(0.0f);
  return s;
}

// mu = actor(obs) for the tile: the three layers with a block barrier after
// each (the caller syncs before, once the obs rows are written).
__device__ inline void actor_forward(const Actor& ac, const ActorTiles& s, int n) {
  tile_dense<true>(s.obs, s.ld_obs, ac.D, ac.w1, ac.H, ac.b1, s.h1, s.ld_h);
  __syncthreads();
  tile_dense<true>(s.h1, s.ld_h, ac.H, ac.w2, ac.H, ac.b2, s.h2, s.ld_h);
  __syncthreads();
  tile_dense<false>(s.h2, s.ld_h, ac.H, ac.wm, n, ac.bm, s.mu, s.ld_mu);
  __syncthreads();
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
