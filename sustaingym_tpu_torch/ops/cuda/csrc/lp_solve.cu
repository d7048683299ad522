// The whole fixed-iteration PDHG solve of a batch of paired-form LPs on an
// NVIDIA Hopper card (sm_90a).
//
// Replaces the Pallas TPU kernel sustaingym_tpu/ops/pallas/lp_solve.py::
// pdhg_solve_paired (_kernel): all iterations of the preconditioned
// Chambolle-Pock iteration of ops/lp.py::solve_lp for operators with equality
// rows A (me, n) and a paired block S (ms, n) (+S x <= hp, -S x <= hm), no
// residual G rows, relax 1, bf16 matrix-product operands with float32 sums:
//
//   grad = c + A' bf16(y) + S' bf16(zp - zm)
//   x+   = clip(x - tau grad, 0, ub);  xb = 2 x+ - x
//   y+   = y + sigma_a (A bf16(xb) - b)
//   s    = S bf16(xb)
//   zp+  = max(0, zp + sigma_s (s - hp));  zm+ = max(0, zm + sigma_s (-s - hm))
//
// from x0 clipped to [0, ub] and zp0, zm0 clipped at 0.
//
// What bounds it. Operations: each iteration is 4 n (me + ms) flops per env
// (89.6 kflop on the SCED operator, n = 140, me = 4, ms = 156), against
// 4 (4 n + 3 me + 6 ms) = 6 KB of problem data and solution per env and
// solve. At the market's 40 warm iterations the arithmetic takes ~2 times
// the bytes' time at the bf16 tensor-core rate, and ~30 times at the
// float32 rate that this first kernel runs at (float FMAs on bf16-rounded
// operands).
//
// Design. A CTA holds kEnvs envs and one thread per variable and per dual
// row (blockDim >= max(n, me + ms), 160 threads on SCED). The operator
// K = [A; S] is loaded once per CTA into shared memory as bf16 (45 KB on
// SCED), rows padded to a stride whose half is odd, so that the column walk
// of phase 1 (thread j reads K[k][j]) and the row walk of phase 2 (thread r
// reads K[r][j..j+1] as one 32-bit word) are both free of bank conflicts
// with one copy of K. Each thread keeps its variable's x, c, ub and its
// row's duals and right-hand sides for the CTA's envs in registers across
// all iterations; the only shared vectors are the bf16-rounded duals
// w[k][env] and the bf16-rounded x-bar xb[j][env], read as broadcast float4
// loads. Only the problem data and the solution touch device memory. The
// products are laid out as K (rows x k) times a (k x envs) panel, envs as
// the N dimension, the shape an mma.sync / wgmma version would take.
//
// The grid is one CTA per kEnvs envs, any B (a ragged last CTA masks its
// stores). Two __syncthreads per iteration separate the phases.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kEnvs = 8;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// acc[e] += m * v[e] for the kEnvs values of one panel row (16-byte aligned)
__device__ __forceinline__ void axpy_row(float (&acc)[kEnvs], float m,
                                         const float* __restrict__ v) {
  const float4 lo = reinterpret_cast<const float4*>(v)[0];
  const float4 hi = reinterpret_cast<const float4*>(v)[1];
  acc[0] += m * lo.x;
  acc[1] += m * lo.y;
  acc[2] += m * lo.z;
  acc[3] += m * lo.w;
  acc[4] += m * hi.x;
  acc[5] += m * hi.y;
  acc[6] += m * hi.z;
  acc[7] += m * hi.w;
}

struct Problem {
  const float *c, *b, *hp, *hm, *ub, *x0, *y0, *zp0, *zm0;
  float *x, *y, *zp, *zm;
  int ub_stride;  // 0: one ub row shared by every env; n: one per env
};

__global__ void pdhg_paired_kernel(const __nv_bfloat16* __restrict__ K,
                                   const float* __restrict__ tau,
                                   const float* __restrict__ sig, Problem p,
                                   int n, int me, int ms, int B, int iters,
                                   int kstride, int ks_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = me + ms;
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  float* w = reinterpret_cast<float*>(smem + ks_bytes);  // (R, kEnvs)
  float* xb = w + (size_t)R * kEnvs;                      // (n, kEnvs)
  const int tid = threadIdx.x;
  const int e0 = blockIdx.x * kEnvs;
  const int ne = min(kEnvs, B - e0);

  for (int i = tid; i < R * n; i += blockDim.x)
    Ks[(i / n) * kstride + i % n] = K[i];

  // thread tid owns variable j = tid and dual row r = tid
  const int j = tid, r = tid;
  float xv[kEnvs], cv[kEnvs], ubv[kEnvs];
  float tj = 0.0f;
#pragma unroll
  for (int e = 0; e < kEnvs; ++e) xv[e] = cv[e] = ubv[e] = 0.0f;
  if (j < n) {
    tj = tau[j];
#pragma unroll
    for (int e = 0; e < kEnvs; ++e) {
      if (e >= ne) break;
      const size_t g = (size_t)(e0 + e) * n + j;
      ubv[e] = p.ub[(size_t)(e0 + e) * p.ub_stride + j];
      cv[e] = p.c[g];
      xv[e] = fminf(fmaxf(p.x0[g], 0.0f), ubv[e]);
    }
  }
  // row r < me: d1 = y, h1 = b; me <= r < R: d1 = zp, d2 = zm, h1 = hp,
  // h2 = hm
  float d1[kEnvs], d2[kEnvs], h1[kEnvs], h2[kEnvs];
  float sr = 0.0f;
#pragma unroll
  for (int e = 0; e < kEnvs; ++e) d1[e] = d2[e] = h1[e] = h2[e] = 0.0f;
  if (r < R) {
    sr = sig[r];
#pragma unroll
    for (int e = 0; e < kEnvs; ++e) {
      if (e >= ne) break;
      if (r < me) {
        const size_t g = (size_t)(e0 + e) * me + r;
        d1[e] = p.y0[g];
        h1[e] = p.b[g];
      } else {
        const size_t g = (size_t)(e0 + e) * ms + (r - me);
        d1[e] = fmaxf(p.zp0[g], 0.0f);
        d2[e] = fmaxf(p.zm0[g], 0.0f);
        h1[e] = p.hp[g];
        h2[e] = p.hm[g];
      }
    }
#pragma unroll
    for (int e = 0; e < kEnvs; ++e)
      w[r * kEnvs + e] = bf16_round(r < me ? d1[e] : d1[e] - d2[e]);
  }
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    // ---- phase 1: gradient and primal step (thread j) ----
    if (j < n) {
      float ga[kEnvs], gs[kEnvs];
#pragma unroll
      for (int e = 0; e < kEnvs; ++e) ga[e] = gs[e] = 0.0f;
      for (int k = 0; k < me; ++k)
        axpy_row(ga, __bfloat162float(Ks[k * kstride + j]), w + k * kEnvs);
      for (int k = me; k < R; ++k)
        axpy_row(gs, __bfloat162float(Ks[k * kstride + j]), w + k * kEnvs);
#pragma unroll
      for (int e = 0; e < kEnvs; ++e) {
        const float grad = (cv[e] + ga[e]) + gs[e];
        const float xn = fminf(fmaxf(xv[e] - tj * grad, 0.0f), ubv[e]);
        xb[j * kEnvs + e] = bf16_round(2.0f * xn - xv[e]);
        xv[e] = xn;
      }
    }
    __syncthreads();
    // ---- phase 2: the products with x-bar and the dual steps (thread r) --
    if (r < R) {
      float acc[kEnvs];
#pragma unroll
      for (int e = 0; e < kEnvs; ++e) acc[e] = 0.0f;
      const __nv_bfloat162* row =
          reinterpret_cast<const __nv_bfloat162*>(Ks + r * kstride);
      for (int jj = 0; jj < n / 2; ++jj) {
        const float2 m = __bfloat1622float2(row[jj]);
        axpy_row(acc, m.x, xb + (2 * jj) * kEnvs);
        axpy_row(acc, m.y, xb + (2 * jj + 1) * kEnvs);
      }
      if (n & 1)
        axpy_row(acc, __bfloat162float(Ks[r * kstride + n - 1]),
                 xb + (n - 1) * kEnvs);
      if (r < me) {
#pragma unroll
        for (int e = 0; e < kEnvs; ++e) {
          d1[e] = d1[e] + sr * (acc[e] - h1[e]);
          w[r * kEnvs + e] = bf16_round(d1[e]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < kEnvs; ++e) {
          d1[e] = fmaxf(d1[e] + sr * (acc[e] - h1[e]), 0.0f);
          d2[e] = fmaxf(d2[e] + sr * (-acc[e] - h2[e]), 0.0f);
          w[r * kEnvs + e] = bf16_round(d1[e] - d2[e]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int e = 0; e < kEnvs; ++e) {
    if (e >= ne) break;
    if (j < n) p.x[(size_t)(e0 + e) * n + j] = xv[e];
    if (r < me) {
      p.y[(size_t)(e0 + e) * me + r] = d1[e];
    } else if (r < R) {
      const size_t g = (size_t)(e0 + e) * ms + (r - me);
      p.zp[g] = d1[e];
      p.zm[g] = d2[e];
    }
  }
}

}  // namespace

// ---- plain C interface (loaded with ctypes; returns a cudaError_t) ----

extern "C" int pdhg_solve_paired_launch(
    const void* K, const float* tau, const float* sig, const float* c,
    const float* b, const float* hp, const float* hm, const float* ub,
    int ub_stride, const float* x0, const float* y0, const float* zp0,
    const float* zm0, int n, int me, int ms, int B, int iters, float* x,
    float* y, float* zp, float* zm, void* stream) {
  const int R = me + ms;
  const int threads = ((n > R ? n : R) + 31) / 32 * 32;
  if (B <= 0 || n <= 0 || me < 0 || ms < 0 || iters < 0 || threads > 1024)
    return (int)cudaErrorInvalidValue;
  // row stride of K in shared memory: even (32-bit pairs), half odd (the
  // row walk of phase 2 is then conflict-free)
  int kstride = (n + 1) / 2 * 2;
  if ((kstride / 2) % 2 == 0) kstride += 2;
  const int ks_bytes = (R * kstride * 2 + 15) / 16 * 16;
  const int smem = ks_bytes + (R + n) * kEnvs * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      pdhg_paired_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const Problem p{c, b, hp, hm, ub, x0, y0, zp0, zm0, x, y, zp, zm, ub_stride};
  const int grid = (B + kEnvs - 1) / kEnvs;
  pdhg_paired_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(K), tau, sig, p, n, me, ms, B, iters,
      kstride, ks_bytes);
  return (int)cudaGetLastError();
}
