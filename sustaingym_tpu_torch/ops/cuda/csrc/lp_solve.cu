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
// What bounds it. Each iteration is 4 n (me + ms) flops per env (89.6 kflop
// on the SCED operator, n = 140, me = 4, ms = 156) against 4 (4 n + 3 me +
// 6 ms) = 6 KB of problem data and solution per env and solve: at the
// market's 40 warm iterations the products at the bf16 tensor-core rate take
// ~2 times the bytes' time. But the iterations are dependent, so what a
// launch at B = 4096 waits on is the latency of 40 (or 200) rounds of two
// products, each a chain of k16 steps, two block barriers and the
// elementwise steps between them; the first version of this kernel ran the
// products as float FMAs on bf16-rounded operands, one shared-memory load
// per FMA, 8 envs per CTA, ~25 us per iteration.
//
// Design. Both products run on the tensor cores (mma.sync m16n8k16, bf16 in,
// float32 sums) with the operator rows as M and the CTA's E = 32 envs as N
// (four n8 tiles):
//   grad (n x E) = c + K'_A w_A + K'_S w_S      (M = variables, k = dual rows)
//   s    (R x E) = K xb                         (M = dual rows,  k = variables)
// K = [A; S] (pack_pdhg_operands' Kp) is padded with zero rows and columns to
// multiples of 16, the A and S blocks each on their own (so the A' and S'
// sums stay apart, as in the math above), and copied once per CTA into shared
// memory as bf16 with a row stride that is an odd multiple of 16 bytes.
// ldmatrix reads it as K's fragments for the dual products and, with .trans,
// as K''s for the gradient, so one copy serves both and K is never read from
// device memory again. Warp w owns the variable tile w and the dual-row tile
// w (16 rows each, all E envs): its primal state (x, c, ub, tau) and dual
// state (y or zp / zm, b or hp / hm, sigma) stay in registers for the whole
// solve, in the accumulator layout of its mma tiles, so the clip, the
// extrapolation and the dual steps run where the sums land. The only shared
// vectors are the two bf16 panels the math rounds anyway, bf16(w) (E x R)
// and bf16(xb) (E x n), stored env-major so that ldmatrix gives the B
// fragments; two __syncthreads per iteration separate the phases. At B =
// 4096 the grid is 128 CTAs, about one wave on 132 SMs.
//
// What bounds this design. By the op count, shared memory: every warp reads
// the whole bf16 panel for its product, so an SM reads ~300 KB per
// iteration (K's fragments once, the panels once per warp), ~2400 cycles
// at 128 bytes a cycle, against ~800 cycles of mma. Iterations take about
// twice that, and a version without the panel loads or without the
// barriers was no faster: what is left is each warp's chain of k16 steps
// (ldmatrix, mma, the float32 adds) with 11 warps per SM to hide it. The
// 11-warp CTA leaves 168 registers a thread (three warps share a
// scheduler's 16K), a little under the state's needs: ptxas spills ~100
// bytes.
//
// Larger operators (12 to 22 tiles of 16 rows or variables: the SCED
// operators of horizons 5 to 8) take E = 16 with two tiles per warp: the
// same registers per thread, fewer warps. The ragged last CTA masks its
// loads and stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kMaxWarps = 11;
constexpr int kMaxSmem = 232448;  // bytes of shared memory a CTA may use

struct Problem {
  const float *c, *b, *hp, *hm, *ub, *x0, *y0, *zp0, *zm0;
  float *x, *y, *zp, *zm;
  const int* budget;  // (B,) per-env iterations (kPerEnv), else unused
  int ub_stride;      // 0: one ub row shared by every env; n: one per env
};

// Problem sizes and their 16-padded tile counts: mt1 variable tiles, mt2
// dual-row tiles of which the first kA hold the A rows.
struct Dims {
  int n, me, ms, B, iters;
  int mt1, mt2, kA;
};

// acc[nb] += A (16 x 16, from shared memory at a_row) * B[k0:k0+16, envs of
// n tile nb], B stored env-major with row stride ldb. The tensor core sums
// the chunk's 16 products from zero and the chunk's sum is added to acc in
// float32, rounding to nearest: chaining acc through the tensor core's own
// accumulation (which does not round to nearest) drifted further from the
// plain version's sums (and from float64 ones) on the SCED problems.
template <int NT, bool kTrans>
__device__ __forceinline__ void chunk_mma(float (&acc)[NT][4],
                                          const __nv_bfloat16* a_row,
                                          const __nv_bfloat16* b, int ldb,
                                          int k0, int lane) {
  uint32_t a[4];
  if (kTrans)
    ldsm_x4_trans(a, a_row);
  else
    ldsm_x4(a, a_row);
  const int kk = k0 + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int nb = 0; nb < NT; nb += 2) {
    uint32_t f[4];
    ldsm_x4(f, b + (8 * nb + (lane & 7) + ((lane >> 4) << 3)) * ldb + kk);
    add_mma(acc[nb], a, f[0], f[1]);
    add_mma(acc[nb + 1], a, f[2], f[3]);
  }
}

// E = 8 NT envs per CTA (NT even); warp w owns variable and dual-row tiles
// w + s W, s < TPW, for the W warps of the CTA. kPerEnv: each env runs
// p.budget[e] iterations, else every env runs d.iters.
template <int NT, int TPW, bool kPerEnv>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
pdhg_paired_kernel(const __nv_bfloat16* __restrict__ Kp,
                   const float* __restrict__ tau, const float* __restrict__ sig,
                   Problem p, Dims d) {
  constexpr int E = 8 * NT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = d.n, me = d.me, ms = d.ms, B = d.B;
  const int n_p = 16 * d.mt1, Rp = 16 * d.mt2, me_p = 16 * d.kA;
  const int ldk = n_p + 8, ldw = Rp + 8, ldx = n_p + 8;
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [Rp][ldk]
  __nv_bfloat16* ws = Ks + Rp * ldk;  // bf16(w)  [E][ldw]
  __nv_bfloat16* xs = ws + E * ldw;   // bf16(xb) [E][ldx]
  int* bs = reinterpret_cast<int*>(xs + E * ldx);  // budgets [E] (kPerEnv)
  const int W = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int e0 = blockIdx.x * E;

  const int chunks = n_p / 8;  // 16-byte chunks per operator row
  for (int i = threadIdx.x; i < Rp * chunks; i += blockDim.x)
    *reinterpret_cast<uint4*>(Ks + (i / chunks) * ldk + (i % chunks) * 8) =
        reinterpret_cast<const uint4*>(Kp)[i];

  // element (s, nb, q) of a thread's tiles: row 16 i + g + 8 (q >> 1), env
  // 8 nb + 2 t + (q & 1), for its tile i = warp + s W
  float xv[TPW][NT][4], cv[TPW][NT][4], ubv[TPW][NT][4], tj[TPW][2];
  float d1[TPW][NT][4], d2[TPW][NT][4], h1[TPW][NT][4], h2[TPW][NT][4], sr[TPW][2];
#pragma unroll
  for (int s = 0; s < TPW; ++s) {
    const int i = warp + s * W;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 16 * i + g + 8 * h, rp = j;
      tj[s][h] = j < n ? tau[j] : 0.0f;
      const int ra = rp < me ? rp : -1;
      const int rs = (rp >= me_p && rp - me_p < ms) ? rp - me_p : -1;
      sr[s][h] = ra >= 0 ? sig[ra] : rs >= 0 ? sig[me + rs] : 0.0f;
    }
#pragma unroll
    for (int nb = 0; nb < NT; ++nb) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = 16 * i + g + 8 * (q >> 1);
        const int el = 8 * nb + 2 * t + (q & 1), e = e0 + el;
        const bool live = e < B;
        float x = 0.0f, c = 0.0f, u = 0.0f;
        if (live && row < n) {
          const size_t gi = (size_t)e * n + row;
          u = p.ub[(size_t)e * p.ub_stride + row];
          c = p.c[gi];
          x = fminf(fmaxf(p.x0[gi], 0.0f), u);
        }
        xv[s][nb][q] = x;
        cv[s][nb][q] = c;
        ubv[s][nb][q] = u;
        // dual row rp = row: an A row below me_p, else an S row
        float a1 = 0.0f, a2 = 0.0f, k1 = 0.0f, k2 = 0.0f;
        if (live && row < me) {
          const size_t gi = (size_t)e * me + row;
          a1 = p.y0[gi];
          k1 = p.b[gi];
        } else if (live && row >= me_p && row - me_p < ms) {
          const size_t gi = (size_t)e * ms + (row - me_p);
          a1 = fmaxf(p.zp0[gi], 0.0f);
          a2 = fmaxf(p.zm0[gi], 0.0f);
          k1 = p.hp[gi];
          k2 = p.hm[gi];
        }
        d1[s][nb][q] = a1;
        d2[s][nb][q] = a2;
        h1[s][nb][q] = k1;
        h2[s][nb][q] = k2;
        if (i < d.mt2)
          ws[el * ldw + row] = __float2bfloat16_rn(row < me_p ? a1 : a1 - a2);
      }
    }
  }
  if constexpr (kPerEnv) {
    for (int el = threadIdx.x; el < E; el += blockDim.x)
      bs[el] = e0 + el < B ? max(p.budget[e0 + el], 0) : 0;
  }
  __syncthreads();

  int iters = d.iters;
  if constexpr (kPerEnv) {
    iters = 0;
    for (int el = 0; el < E; ++el) iters = max(iters, bs[el]);
  }

  for (int it = 0; it < iters; ++it) {
    // bit 2 nb + c: the thread's env 8 nb + 2 t + c still iterates
    unsigned live = 0;
    if constexpr (kPerEnv) {
#pragma unroll
      for (int j = 0; j < 2 * NT; ++j)
        live |= (unsigned)(it < bs[8 * (j >> 1) + 2 * t + (j & 1)]) << j;
    }
    // ---- phase 1: grad = (c + A' w_A) + S' w_S and the primal step ----
#pragma unroll
    for (int s = 0; s < TPW; ++s) {
      const int i = warp + s * W;
      if (i < d.mt1) {
        float ga[NT][4] = {}, gs[NT][4] = {};
        // K' tile (variables 16 i.., dual rows 16 kc..): K read transposed
        const __nv_bfloat16* a_row =
            Ks + ((lane & 7) + ((lane >> 4) << 3)) * ldk + 16 * i + ((lane >> 3) & 1) * 8;
        for (int kc = 0; kc < d.kA; ++kc)
          chunk_mma<NT, true>(ga, a_row + 16 * kc * ldk, ws, ldw, 16 * kc, lane);
        for (int kc = d.kA; kc < d.mt2; ++kc)
          chunk_mma<NT, true>(gs, a_row + 16 * kc * ldk, ws, ldw, 16 * kc, lane);
#pragma unroll
        for (int nb = 0; nb < NT; ++nb) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float grad = (cv[s][nb][q] + ga[nb][q]) + gs[nb][q];
            const float xo = xv[s][nb][q];
            float xn = fminf(fmaxf(xo - tj[s][q >> 1] * grad, 0.0f), ubv[s][nb][q]);
            if constexpr (kPerEnv) {
              if (!((live >> (2 * nb + (q & 1))) & 1u)) xn = xo;
            }
            xs[(8 * nb + 2 * t + (q & 1)) * ldx + 16 * i + g + 8 * (q >> 1)] =
                __float2bfloat16_rn(2.0f * xn - xo);
            xv[s][nb][q] = xn;
          }
        }
      }
    }
    __syncthreads();
    // ---- phase 2: s = K bf16(xb) and the dual steps ----
#pragma unroll
    for (int s = 0; s < TPW; ++s) {
      const int i = warp + s * W;
      if (i < d.mt2) {
        float acc[NT][4] = {};
        const __nv_bfloat16* a_row = Ks + (16 * i + (lane & 15)) * ldk + ((lane >> 4) << 3);
        for (int kc = 0; kc < d.mt1; ++kc)
          chunk_mma<NT, false>(acc, a_row + 16 * kc, xs, ldx, 16 * kc, lane);
        const bool a_rows = i < d.kA;
#pragma unroll
        for (int nb = 0; nb < NT; ++nb) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float sg = sr[s][q >> 1], v = acc[nb][q];
            bool on = true;
            if constexpr (kPerEnv) on = (live >> (2 * nb + (q & 1))) & 1u;
            float w;
            if (a_rows) {
              if (on) d1[s][nb][q] = d1[s][nb][q] + sg * (v - h1[s][nb][q]);
              w = d1[s][nb][q];
            } else {
              if (on) {
                d1[s][nb][q] = fmaxf(d1[s][nb][q] + sg * (v - h1[s][nb][q]), 0.0f);
                d2[s][nb][q] = fmaxf(d2[s][nb][q] + sg * (-v - h2[s][nb][q]), 0.0f);
              }
              w = d1[s][nb][q] - d2[s][nb][q];
            }
            ws[(8 * nb + 2 * t + (q & 1)) * ldw + 16 * i + g + 8 * (q >> 1)] =
                __float2bfloat16_rn(w);
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int s = 0; s < TPW; ++s) {
    const int i = warp + s * W;
#pragma unroll
    for (int nb = 0; nb < NT; ++nb) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = 16 * i + g + 8 * (q >> 1);
        const int e = e0 + 8 * nb + 2 * t + (q & 1);
        if (e >= B) continue;
        if (row < n) p.x[(size_t)e * n + row] = xv[s][nb][q];
        if (row < me) {
          p.y[(size_t)e * me + row] = d1[s][nb][q];
        } else if (row >= me_p && row - me_p < ms) {
          const size_t gi = (size_t)e * ms + (row - me_p);
          p.zp[gi] = d1[s][nb][q];
          p.zm[gi] = d2[s][nb][q];
        }
      }
    }
  }
}

// Launches the (NT, TPW, kPerEnv) instance if its warps and shared memory
// fit, or with `ctas` set, stores how many of its CTAs an SM holds and its
// envs per CTA instead; returns -1 if they do not fit.
template <int NT, int TPW, bool kPerEnv>
int launch(const __nv_bfloat16* Kp, const float* tau, const float* sig,
           const Problem& p, const Dims& d, cudaStream_t stream, int* ctas,
           int* envs) {
  constexpr int E = 8 * NT;
  const int mt = d.mt1 > d.mt2 ? d.mt1 : d.mt2;
  const int warps = (mt + TPW - 1) / TPW;
  const int n_p = 16 * d.mt1, Rp = 16 * d.mt2;
  const int smem = 2 * (Rp * (n_p + 8) + E * (Rp + 8) + E * (n_p + 8)) +
                   (kPerEnv ? 4 * E : 0);
  if (warps > kMaxWarps || smem > kMaxSmem) return -1;
  cudaError_t err = cudaFuncSetAttribute(pdhg_paired_kernel<NT, TPW, kPerEnv>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (ctas != nullptr) {
    *envs = E;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas, pdhg_paired_kernel<NT, TPW, kPerEnv>, warps * 32, smem);
  }
  const int grid = (d.B + E - 1) / E;
  pdhg_paired_kernel<NT, TPW, kPerEnv><<<grid, warps * 32, smem, stream>>>(Kp, tau, sig, p, d);
  return (int)cudaGetLastError();
}

// The first instance that fits the operator: E = 32 envs a CTA, then 16.
template <bool kPerEnv>
int dispatch(const __nv_bfloat16* Kp, const float* tau, const float* sig,
             const Problem& p, const Dims& d, cudaStream_t stream,
             int* ctas = nullptr, int* envs = nullptr) {
  int err = launch<4, 1, kPerEnv>(Kp, tau, sig, p, d, stream, ctas, envs);
  if (err < 0) err = launch<2, 2, kPerEnv>(Kp, tau, sig, p, d, stream, ctas, envs);
  return err < 0 ? (int)cudaErrorInvalidValue : err;
}

Dims dims(int n, int me, int ms, int B, int iters) {
  return Dims{n, me, ms, B, iters, pad16(n) / 16, (pad16(me) + pad16(ms)) / 16,
              pad16(me) / 16};
}

}  // namespace

// ---- plain C interface (loaded with ctypes; returns a cudaError_t) ----

// Kp: (pad16(me) + pad16(ms), pad16(n)) bf16, the A rows then the S rows,
// each block zero-padded (ops/cuda/lp_solve.py::pack_pdhg_operands).
// budget: null (every env runs `iters`) or (B,) int32 per-env budgets on
// the device (negative ones run 0 iterations; `iters` is then unused).
extern "C" int pdhg_solve_paired_launch(
    const void* Kp, const float* tau, const float* sig, const float* c,
    const float* b, const float* hp, const float* hm, const float* ub,
    int ub_stride, const float* x0, const float* y0, const float* zp0,
    const float* zm0, int n, int me, int ms, int B, int iters,
    const int* budget, float* x, float* y, float* zp, float* zm,
    void* stream) {
  if (B <= 0 || n <= 0 || me < 0 || ms < 0 || iters < 0)
    return (int)cudaErrorInvalidValue;
  const Problem p{c, b, hp, hm, ub, x0, y0, zp0, zm0, x, y, zp, zm, budget,
                  ub_stride};
  const auto* K = static_cast<const __nv_bfloat16*>(Kp);
  const Dims d = dims(n, me, ms, B, iters);
  if (budget != nullptr)
    return dispatch<true>(K, tau, sig, p, d, (cudaStream_t)stream);
  return dispatch<false>(K, tau, sig, p, d, (cudaStream_t)stream);
}

// CTAs of the instance pdhg_solve_paired_launch takes for (n, me, ms)
// resident per SM, and its envs per CTA.
extern "C" int pdhg_solve_paired_ctas_per_sm(int n, int me, int ms, int* ctas,
                                             int* envs) {
  if (n <= 0 || me < 0 || ms < 0) return (int)cudaErrorInvalidValue;
  return dispatch<false>(nullptr, nullptr, nullptr, Problem{},
                         dims(n, me, ms, 1, 0), nullptr, ctas, envs);
}
