// Whole BuildingEnv episode segments on an NVIDIA Hopper card (sm_90a).
//
// Replaces the two Pallas TPU kernels of
// sustaingym_tpu/ops/pallas/building_rollout.py:
//   building_segment_kernel        <- fused_building_segment (_kernel), the
//                                     simulation tier
//   building_policy_segment_kernel <- fused_building_policy_segment
//                                     (_policy_kernel), the PPO rollout with
//                                     the 2-layer tanh actor inside
//
// Per env step both do: the occupant-heat polynomial of the mean zone
// temperature and the metabolism, the RC update [A_d | BD_d] @ [x; occ,
// ground, out, a, ghi], and the p = 2 power and comfort costs.
//
// What bounds them. The simulation kernel does 4n^2 + 18n + 27 float
// operations per env step (279 at n = 6 zones) and writes (2n + 7) floats
// (obs, zone temperatures, reward, comfort, power: 76 bytes), 3.7
// operations per byte against the card's ~20 float32 operations per byte
// of memory rate, so its output stream bounds it (11.5 GB at 524288 x 288,
// 3.43 ms at 3.35 TB/s). The inputs are small: the padded (T + 288, 4)
// exogenous table (1.7 MB, L2-resident) and an epoch per env. The policy
// kernel is bound by the actor: 2 (D H + H H + H n) = 139 kFLOP per env
// step at H = 256, n = 6, D = n + 4, against 44 bytes written.
//
// Design.
//  * Simulation: one thread per env loops over the T steps with its zone
//    temperatures in registers; the kernel is a template on n (1..8), so the
//    zone loops unroll. The operator, target and ac sit in shared memory
//    (every thread reads the same word: broadcasts). The step's exogenous
//    row is one float4 read straight from the padded table at epoch + t,
//    where the TPU kernel read a block the slice gather had packed: the same
//    numbers, without writing and reading the block, and none of the TPU's
//    (nb, il, T, 4, W) lane transposes. The kernel writes the TimeStep's own
//    tensors (obs (T, B, n + 4), zone temperatures (T, B, n), reward, comfort
//    level and power consumption (T, B)), so no assembly pass follows. A
//    warp's obs and temperature rows of a step are contiguous in memory, so
//    each thread stages its rows in shared memory and the warp writes them
//    out as coalesced runs: a thread storing its own rows strides 40 and 24
//    bytes across the warp, and then each store instruction touches ~32
//    sectors for 128 useful bytes.
//  * Policy: a CTA owns 64 envs, four m16 tiles, so 8192 envs are 128 CTAs,
//    one wave on 132 SMs. It copies the actor's fragment-ordered weights
//    (~144 KB at H = 256, n = 6), biases, sigma and the env's operator into
//    shared memory once; the first design (one 16-env tile per CTA, 1.94
//    waves) read every weight from L2 at every tile and step, a serial chain
//    of L2 round trips at 6% of the bf16 peak. Thread l < 64 keeps env l's
//    state in registers and writes its bf16 obs row into shared memory; the
//    16 warps run the actor (dense_tiles: the three layers on the tensor
//    cores, a warp applying each B fragment of its column pair to all four
//    tiles; layer 3's one pair split over the tiles); thread l then samples
//    u, squashes a = tanh(u) ac (the JAX kernel's form) and steps its env.
//    The obs at step t is step t-1's emitted obs; at t = 0 the reset obs.
//    Where the weights do not fit beside the activation tiles (H above
//    ~280), the leading k16 steps of each column pair stay resident and the
//    rest is read from L2 in the same loop; where even the 64-env tiles do
//    not fit, a CTA takes 32 or 16 envs (Plan, chosen by the launcher from
//    the card's shared memory).
//  * Numerics: the env step rounds after every operation (__fmul_rn,
//    __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn) in the order of the plain
//    version (ops/cuda/building_rollout.py::segment_step), so the simulation
//    kernel and its plain version agree bit for bit; the actor keeps its
//    FMAs. No fast-math: IEEE tanhf, log1pf, cosf.
//  * Random draws: Philox4x32-10 (philox.cuh) counted by (step, env, zone
//    group, stream), so the draws do not depend on launch geometry: four
//    uniform actions (2u - 1) ac per call, two Box-Muller normals per call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "actor.cuh"
#include "philox.cuh"

namespace {

constexpr int kMaxZones = 8;
constexpr int kSimThreads = 256;
constexpr int kSimBlocks = 2;  // CTAs per SM the register budget must allow

// occupant sensible-heat polynomial (envs/building/env.py OCCU_COEF)
constexpr float kC0 = 6.461927f, kC1 = 0.946892f, kC2 = 0.0000255737f,
                kC3 = 0.0627909f, kC4 = 0.0000589172f, kC5 = 0.19855f,
                kC6 = 0.000940018f, kC7 = 0.00000149532f;

struct Env {
  const float* m;       // (n, 2n + 4) [A_d | BD_d]: x(n), occ, ground, out, a(n), ghi
  const float* target;  // (n)
  const float* ac;      // (n)
  float q_rate, beta;
  const float4* table;  // (rows) [out, ground, ghi, metabolism]
  const int64_t* epochs;
  int B, T;
};

// Floats of the operator, target and ac of n zones in shared memory,
// rounded up to 16 bytes.
__host__ __device__ constexpr int env_floats(int n) {
  return (n * (2 * n + 4) + 2 * n + 3) / 4 * 4;
}

// Copies the operator, target and ac into shared memory.
template <int N>
__device__ void load_env(const Env& env, float* m_s) {
  constexpr int K = 2 * N + 4;
  for (int i = threadIdx.x; i < N * K + 2 * N; i += blockDim.x)
    m_s[i] = i < N * K ? env.m[i]
                       : i < N * K + N ? env.target[i - N * K]
                                       : env.ac[i - N * K - N];
}

__device__ __forceinline__ float occupower(float avg, float meta) {
  const float t2 = __fmul_rn(avg, avg);
  const float meta2 = __fmul_rn(meta, meta);
  float r = __fadd_rn(kC0, __fmul_rn(kC1, meta));
  r = __fadd_rn(r, __fmul_rn(kC2, meta2));
  r = __fsub_rn(r, __fmul_rn(__fmul_rn(kC3, avg), meta));
  r = __fadd_rn(r, __fmul_rn(__fmul_rn(kC4, avg), meta2));
  r = __fsub_rn(r, __fmul_rn(kC5, t2));
  r = __fadd_rn(r, __fmul_rn(__fmul_rn(kC6, t2), meta));
  return __fsub_rn(r, __fmul_rn(__fmul_rn(kC7, t2), meta2));
}

template <int N>
__device__ __forceinline__ float mean_occupower(const float (&x)[N], float meta) {
  float s = x[0];
#pragma unroll
  for (int i = 1; i < N; ++i) s = __fadd_rn(s, x[i]);
  return occupower(__fdiv_rn(s, (float)N), meta);
}

// One env step from zone temperatures x and actions a under the exogenous
// row w; x becomes x_new. `env_s` holds the operator, then target, then ac.
template <int N>
__device__ __forceinline__ void env_step(const float* env_s, float q_rate,
                                         float beta, float (&x)[N],
                                         const float (&a)[N], float4 w,
                                         float& occ, float& comfort_cost,
                                         float& power_cost) {
  constexpr int K = 2 * N + 4;
  const float* target = env_s + N * K;
  const float* ac = target + N;
  occ = mean_occupower<N>(x, w.w);
  float xn[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float* mi = env_s + i * K;
    float acc = __fmul_rn(x[0], mi[0]);
#pragma unroll
    for (int j = 1; j < N; ++j) acc = __fadd_rn(acc, __fmul_rn(x[j], mi[j]));
    acc = __fadd_rn(acc, __fmul_rn(occ, mi[N]));
    acc = __fadd_rn(acc, __fmul_rn(w.y, mi[N + 1]));  // ground
    acc = __fadd_rn(acc, __fmul_rn(w.x, mi[N + 2]));  // out
#pragma unroll
    for (int j = 0; j < N; ++j) acc = __fadd_rn(acc, __fmul_rn(a[j], mi[N + 3 + j]));
    xn[i] = __fadd_rn(acc, __fmul_rn(w.z, mi[2 * N + 3]));  // ghi
  }
  float p = __fmul_rn(a[0], a[0]);
  float c;
  {
    const float d = __fmul_rn(__fsub_rn(xn[0], target[0]), ac[0]);
    c = __fmul_rn(d, d);
  }
#pragma unroll
  for (int i = 1; i < N; ++i) {
    p = __fadd_rn(p, __fmul_rn(a[i], a[i]));
    const float d = __fmul_rn(__fsub_rn(xn[i], target[i]), ac[i]);
    c = __fadd_rn(c, __fmul_rn(d, d));
  }
  comfort_cost = __fmul_rn(__fsqrt_rn(c), beta);
  power_cost = __fmul_rn(__fsqrt_rn(p), q_rate);
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = xn[i];
}

template <int N>
__global__ void __launch_bounds__(kSimThreads, kSimBlocks)
building_segment_kernel(Env env, const float* __restrict__ acts, uint64_t seed,
                        float* __restrict__ obs, float* __restrict__ temps,
                        float* __restrict__ reward, float* __restrict__ comfort,
                        float* __restrict__ power, float* __restrict__ acts_out) {
  constexpr int K = 2 * N + 4, OW = N + 4;
  __shared__ float env_s[N * K + 2 * N];
  // a warp's obs rows, then its zone temperature rows, for one step
  __shared__ float stage[kSimThreads / 32][32 * (OW + N)];
  load_env<N>(env, env_s);
  __syncthreads();
  const int B = env.B, lane = threadIdx.x & 31;
  const int e0 = blockIdx.x * kSimThreads + (threadIdx.x & ~31);  // warp's first env
  if (e0 >= B) return;  // whole warps only: no block-wide sync follows
  const int e = e0 + lane;
  const bool live = e < B;
  const int nlive = min(32, B - e0);
  float* so = stage[threadIdx.x >> 5];
  float* st = so + 32 * OW;
  const float* ac = env_s + N * K + N;
  float x[N];
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = env_s[N * K + i];  // the target
  const uint2 key = philox_key(seed);
  const float4* rows = env.table + (live ? env.epochs[e] : 0);

  for (int t = 0; t < env.T; ++t) {
    const size_t te = (size_t)t * B + e;
    float a[N];
    if (acts != nullptr) {
#pragma unroll
      for (int i = 0; i < N; ++i) a[i] = live ? acts[te * N + i] : 0.0f;
    } else {
#pragma unroll
      for (int g = 0; g < (N + 3) / 4; ++g) {
        const uint4 r = philox4x32_10(
            make_uint4((uint32_t)t, (uint32_t)e, (uint32_t)g, 5u), key);
        const uint32_t bits[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (4 * g + k < N)
            a[4 * g + k] = __fmul_rn(
                __fsub_rn(__fmul_rn(2.0f, uniform01(bits[k])), 1.0f), ac[4 * g + k]);
      }
    }
    if (acts_out != nullptr && live) {
#pragma unroll
      for (int i = 0; i < N; ++i) acts_out[te * N + i] = a[i];
    }
    const float4 w = rows[t];
    float occ, cc, pc;
    env_step<N>(env_s, env.q_rate, env.beta, x, a, w, occ, cc, pc);
    // stage the warp's rows, then write them out as contiguous runs
#pragma unroll
    for (int i = 0; i < N; ++i) {
      so[lane * OW + i] = x[i];
      st[lane * N + i] = x[i];
    }
    so[lane * OW + N] = w.x;
    so[lane * OW + N + 1] = w.y;
    so[lane * OW + N + 2] = w.z;
    so[lane * OW + N + 3] = __fdiv_rn(occ, 1000.0f);
    __syncwarp();
    float* ob = obs + ((size_t)t * B + e0) * OW;
    for (int j = lane; j < nlive * OW; j += 32) ob[j] = so[j];
    float* zt = temps + ((size_t)t * B + e0) * N;
    for (int j = lane; j < nlive * N; j += 32) zt[j] = st[j];
    __syncwarp();
    if (live) {
      reward[te] = -__fadd_rn(pc, cc);
      comfort[te] = -cc;
      power[te] = -pc;
    }
  }
}

// ---- the policy kernel: actor weights resident in shared memory ----------

constexpr int kPolicyWarps = 16;
constexpr int kMaxTiles = 4;  // m16 env tiles per CTA: 64 envs
constexpr int kStager = kMaxTiles * kTile;  // first thread of the stagers

// Where building_policy_segment_kernel's operands sit in shared memory;
// choose_plan below picks it.
struct Plan {
  int tiles;       // m16 env tiles per CTA (4, 2 or 1)
  int bias;        // 1: b1 and b2 in shared memory, 0: read from global
  int k1, k2, k3;  // resident k16 steps per column pair of w1, w2, wm
};

__host__ __device__ inline size_t align16(size_t bytes) { return (bytes + 15) / 16 * 16; }

// Byte offsets of the weights' resident fragments ([pair][k16 step][32
// lanes] uint4 each), the biases, sigma, the env's operator | target | ac,
// the staged exogenous rows and normals of two steps ([2][envs] float4,
// then [2][envs][n] float) and the actor's bf16 tiles (obs, h1, h2; mu in
// float32 over h1, which layer 3 no longer reads), in that order; `total`
// is the CTA's dynamic shared memory.
struct Layout {
  size_t w1, w2, wm, b1, b2, bm, sigma, env, stage, obs, h1, h2, total;
  int ld_obs, ld_h, ld_mu;
};

__host__ __device__ inline Layout policy_layout(int D, int H, int n, int env_floats,
                                                const Plan& pl) {
  Layout s;
  const size_t frag = 32 * sizeof(uint4);  // one k16 step of one column pair
  const int envs = kTile * pl.tiles, pairs = pad16(H) / 16, pairs_m = pad16(n) / 16;
  s.ld_obs = tile_ld(D);
  s.ld_h = tile_ld(H);
  s.ld_mu = tile_ld(n);
  size_t o = 0;
  s.w1 = o; o += pairs * pl.k1 * frag;
  s.w2 = o; o += pairs * pl.k2 * frag;
  s.wm = o; o += pairs_m * pl.k3 * frag;
  s.b1 = o; o += pl.bias * align16(sizeof(float) * H);
  s.b2 = o; o += pl.bias * align16(sizeof(float) * H);
  s.bm = o; o += align16(sizeof(float) * n);
  s.sigma = o; o += align16(sizeof(float) * n);
  s.env = o; o += align16(sizeof(float) * env_floats);
  s.stage = o; o += align16(2 * envs * (sizeof(float4) + sizeof(float) * n));
  s.obs = o; o += align16(2 * envs * s.ld_obs);
  const size_t h = 2 * envs * s.ld_h, mu = 4 * envs * s.ld_mu;
  s.h1 = o; o += align16(h > mu ? h : mu);
  s.h2 = o; o += align16(h);
  s.total = o;
  return s;
}

// The plan for an actor (D, H, n) in `limit` bytes of shared memory: the
// most env tiles per CTA (4, 2 or 1) whose activation tiles fit, then b1
// and b2 if they fit, then as many leading k16 steps of each column pair of
// w1, wm and w2, in that order, as fit beside them (the rest is read from
// L2). False if one tile does not fit.
bool choose_plan(int D, int H, int n, size_t limit, Plan& pl) {
  const size_t frag = 32 * sizeof(uint4);
  pl = Plan{kMaxTiles, 0, 0, 0, 0};
  while (policy_layout(D, H, n, env_floats(n), pl).total > limit) {
    if (pl.tiles == 1) return false;
    pl.tiles /= 2;
  }
  pl.bias = 1;
  if (policy_layout(D, H, n, env_floats(n), pl).total > limit) pl.bias = 0;
  size_t room = limit - policy_layout(D, H, n, env_floats(n), pl).total;
  // the leading steps of `kc` that fit in `room`, `step` bytes each
  auto fit = [&room](int kc, size_t step) {
    const int k = room / step < (size_t)kc ? (int)(room / step) : kc;
    room -= k * step;
    return k;
  };
  const size_t pair_step = frag * (pad16(H) / 16);
  pl.k1 = fit(pad16(D) / 16, pair_step);
  pl.k3 = fit(pad16(H) / 16, frag * (pad16(n) / 16));
  pl.k2 = fit(pad16(H) / 16, pair_step);
  return true;
}

// Copies the leading `kres` k16 steps of each of `pairs` column pairs of a
// fragment-ordered weight (kc_n steps a pair) into shared memory.
__device__ void copy_resident(const uint4* __restrict__ w, uint4* ws, int pairs,
                              int kc_n, int kres) {
  const int per_pair = kres * 32;
  for (int i = threadIdx.x; i < pairs * per_pair; i += blockDim.x)
    ws[i] = __ldg(w + (size_t)(i / per_pair) * kc_n * 32 + i % per_pair);
}

// out[e][j] = act(bias[j] + sum_i in[e][i] w[i][j]) over the CTA's env
// tiles, as actor.cuh's tile_dense computes it for one tile: the same k16
// order, add_mma per step, bias, tanhf and bf16 rounding. The work items
// are (column pair, group of NT m16 tiles), `groups` groups a pair: a warp
// applies each B fragment of its pair to its NT tiles (layer 3's single
// pair takes NT = 1, so that `groups` warps share it). NT is a template
// parameter, so no branch guards the warp-synchronous ldmatrix and mma.
// Step kc of pair p comes from shared memory `ws` when kc < kres, else from
// `w` in global memory (L2): one generic load either way.
template <bool kTanh, int NT>
__device__ void dense_tiles(const __nv_bfloat16* in, int ld_in, int din,
                           const uint4* ws, int kres, const uint4* __restrict__ w,
                           int dout, const float* bias, void* out, int ld_out,
                           int groups) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int kc_n = pad16(din) / 16, pairs = pad16(dout) / 16;
  const __nv_bfloat16* a_lane = in + (lane & 15) * ld_in + ((lane >> 4) << 3);
  for (int item = threadIdx.x >> 5; item < pairs * groups;
       item += blockDim.x >> 5) {
    const int p = item / groups, t0 = item % groups * NT;
    float acc[NT][2][4] = {};
    const uint4* wsp = ws + (size_t)p * kres * 32 + lane;
    const uint4* wp = w + (size_t)p * kc_n * 32 + lane;
    const __nv_bfloat16* a_row = a_lane + t0 * kTile * ld_in;
    for (int k0 = 0; k0 < kc_n; k0 += kSteps) {
      uint4 b[kSteps];
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        const int kc = k0 + s;
        b[s] = kc < kc_n ? *(kc < kres ? wsp + kc * 32 : wp + kc * 32)
                         : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        if (k0 + s < kc_n) {
#pragma unroll
          for (int m = 0; m < NT; ++m) {
            uint32_t a[4];
            ldsm_x4(a, a_row + m * kTile * ld_in + 16 * (k0 + s));
            add_mma(acc[m][0], a, b[s].x, b[s].y);
            add_mma(acc[m][1], a, b[s].z, b[s].w);
          }
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 16 * p + 8 * h + 2 * t;
      const float c0 = j < dout ? bias[j] : 0.0f;
      const float c1 = j + 1 < dout ? bias[j + 1] : 0.0f;
#pragma unroll
      for (int m = 0; m < NT; ++m) {
        const int r = (t0 + m) * kTile + g;
        if constexpr (kTanh) {
          __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + j;
          *reinterpret_cast<__nv_bfloat162*>(o + r * ld_out) = __floats2bfloat162_rn(
              tanhf(acc[m][h][0] + c0), tanhf(acc[m][h][1] + c1));
          *reinterpret_cast<__nv_bfloat162*>(o + (r + 8) * ld_out) =
              __floats2bfloat162_rn(tanhf(acc[m][h][2] + c0),
                                    tanhf(acc[m][h][3] + c1));
        } else {
          float* o = static_cast<float*>(out) + j;
          o[r * ld_out] = acc[m][h][0] + c0;
          o[r * ld_out + 1] = acc[m][h][1] + c1;
          o[(r + 8) * ld_out] = acc[m][h][2] + c0;
          o[(r + 8) * ld_out + 1] = acc[m][h][3] + c1;
        }
      }
    }
  }
}

// A hidden layer (tanh, bf16 out) over all `tiles` tiles of the CTA, each
// warp's pair on every tile.
__device__ __forceinline__ void hidden_layer(const __nv_bfloat16* in, int ld_in,
                                             int din, const uint4* ws, int kres,
                                             const uint4* w, int dout,
                                             const float* bias, __nv_bfloat16* out,
                                             int ld_out, int tiles) {
  if (tiles == kMaxTiles)
    dense_tiles<true, kMaxTiles>(in, ld_in, din, ws, kres, w, dout, bias, out, ld_out, 1);
  else if (tiles == 2)
    dense_tiles<true, 2>(in, ld_in, din, ws, kres, w, dout, bias, out, ld_out, 1);
  else
    dense_tiles<true, 1>(in, ld_in, din, ws, kres, w, dout, bias, out, ld_out, 1);
}

// Env `j` of the CTA's inputs of step t, staged for its stepping thread
// in buffer t & 1: the exogenous row, and the n normals (prescribed, or
// Box-Muller draws counted by (zone pair, step, global env e0 + e, stream
// 1): a launch over a slice of a global batch draws that slice's numbers).
template <int N>
__device__ __forceinline__ void stage_inputs(float4* wbuf, float* zbuf, int j,
                                             int envs, const float4* rows,
                                             const float* noise, uint2 key,
                                             int t, int e, int B, int e0) {
  const int slot = (t & 1) * envs + j;
  wbuf[slot] = rows[t];
  float* z = zbuf + slot * N;
  if (noise != nullptr) {
#pragma unroll
    for (int i = 0; i < N; ++i) z[i] = noise[((size_t)t * B + e) * N + i];
  } else {
#pragma unroll
    for (int g = 0; g < (N + 1) / 2; ++g) {
      const float2 p = box_muller(
          philox4x32_10(make_uint4((uint32_t)g, (uint32_t)t, (uint32_t)(e0 + e), 1u),
                        key));
      z[2 * g] = p.x;
      if (2 * g + 1 < N) z[2 * g + 1] = p.y;
    }
  }
}

template <int N>
__global__ void __launch_bounds__(kPolicyWarps * 32, 1)
building_policy_segment_kernel(Env env, Actor act, Plan pl,
                               const float* __restrict__ noise, uint64_t seed,
                               int env_offset, float* __restrict__ out,
                               __nv_bfloat16* __restrict__ lrn) {
  constexpr int K = 2 * N + 4, D = N + 4, LW = 2 * N + 4;
  extern __shared__ uint4 smem4[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem4);
  const int B = env.B, H = act.H, envs = kTile * pl.tiles;
  const Layout lay = policy_layout(D, H, N, env_floats(N), pl);
  uint4* w1s = reinterpret_cast<uint4*>(base + lay.w1);
  uint4* w2s = reinterpret_cast<uint4*>(base + lay.w2);
  uint4* wms = reinterpret_cast<uint4*>(base + lay.wm);
  float* b1s = reinterpret_cast<float*>(base + lay.b1);
  float* b2s = reinterpret_cast<float*>(base + lay.b2);
  float* bms = reinterpret_cast<float*>(base + lay.bm);
  float* sigma = reinterpret_cast<float*>(base + lay.sigma);
  float* env_s = reinterpret_cast<float*>(base + lay.env);  // operator | target | ac
  float4* wbuf = reinterpret_cast<float4*>(base + lay.stage);
  float* zbuf = reinterpret_cast<float*>(base + lay.stage + 2 * envs * sizeof(float4));
  __nv_bfloat16* obs = reinterpret_cast<__nv_bfloat16*>(base + lay.obs);
  __nv_bfloat16* h1 = reinterpret_cast<__nv_bfloat16*>(base + lay.h1);
  __nv_bfloat16* h2 = reinterpret_cast<__nv_bfloat16*>(base + lay.h2);
  float* mu = reinterpret_cast<float*>(base + lay.h1);

  // ---- once per CTA: the weights' resident steps, biases, sigma, env
  const int pairs = pad16(H) / 16, kc1 = pad16(D) / 16, kc2 = pad16(H) / 16;
  copy_resident(act.w1, w1s, pairs, kc1, pl.k1);
  copy_resident(act.w2, w2s, pairs, kc2, pl.k2);
  copy_resident(act.wm, wms, pad16(N) / 16, kc2, pl.k3);
  for (int i = threadIdx.x; i < pl.bias * H; i += blockDim.x) {
    b1s[i] = act.b1[i];
    b2s[i] = act.b2[i];
  }
  const float* b1 = pl.bias ? b1s : act.b1;
  const float* b2 = pl.bias ? b2s : act.b2;
  if (threadIdx.x < N) {
    bms[threadIdx.x] = act.bm[threadIdx.x];
    sigma[threadIdx.x] = act.sigma[threadIdx.x];
  }
  load_env<N>(env, env_s);
  for (int i = threadIdx.x; i < envs * lay.ld_obs; i += blockDim.x)
    obs[i] = __float2bfloat16_rn(0.0f);  // the padding columns stay 0
  __syncthreads();

  const float* ac = env_s + N * K + N;
  const int l = threadIdx.x;
  const int e = blockIdx.x * envs + l;
  const bool mine = l < envs;  // this thread steps env l of the CTA
  const bool live = mine && e < B;
  const uint2 key = philox_key(seed);
  const float4* rows = env.table + (live ? env.epochs[e] : 0);
  // threads kStager + j stage env j's next inputs while env j steps: the
  // draws and the row's load leave the stepping thread's serial path
  const int j = l - kStager, ej = blockIdx.x * envs + j;
  const bool stager = j >= 0 && j < envs && ej < B;
  const float4* stage_rows = env.table + (stager ? env.epochs[ej] : 0);
  if (stager) stage_inputs<N>(wbuf, zbuf, j, envs, stage_rows, noise, key, 0, ej, B,
                              env_offset);
  float x[N];
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = env_s[N * K + i];
  // the reset obs: the epoch's row and the occupant heat of the target
  float4 prev = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float prev_occ = 0.0f;
  if (live) {
    prev = rows[0];
    prev_occ = mean_occupower<N>(x, prev.w);
  }

  for (int t = 0; t < env.T; ++t) {
    if (mine) {
      // the obs row into the actor's tile and the learner block
      __nv_bfloat16 ob[D];
#pragma unroll
      for (int i = 0; i < N; ++i) ob[i] = __float2bfloat16_rn(x[i]);
      ob[N] = __float2bfloat16_rn(prev.x);
      ob[N + 1] = __float2bfloat16_rn(prev.y);
      ob[N + 2] = __float2bfloat16_rn(prev.z);
      ob[N + 3] = __float2bfloat16_rn(__fmul_rn(prev_occ, 0.001f));
      __nv_bfloat16* tile_row = obs + l * lay.ld_obs;
      __nv_bfloat16* lrow = lrn + ((size_t)t * B + e) * LW;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        tile_row[i] = ob[i];
        if (live) lrow[i] = ob[i];
      }
    }
    __syncthreads();
    hidden_layer(obs, lay.ld_obs, D, w1s, pl.k1, act.w1, H, b1, h1, lay.ld_h,
                 pl.tiles);
    __syncthreads();
    hidden_layer(h1, lay.ld_h, H, w2s, pl.k2, act.w2, H, b2, h2, lay.ld_h, pl.tiles);
    __syncthreads();
    dense_tiles<false, 1>(h2, lay.ld_h, H, wms, pl.k3, act.wm, N, bms, mu,
                          lay.ld_mu, pl.tiles);
    __syncthreads();
    if (stager && t + 1 < env.T)
      stage_inputs<N>(wbuf, zbuf, j, envs, stage_rows, noise, key, t + 1, ej, B,
                      env_offset);
    if (live) {
      const size_t te = (size_t)t * B + e;
      __nv_bfloat16* lrow = lrn + te * LW;
      const int slot = (t & 1) * envs + l;
      const float* z = zbuf + slot * N;
      float a[N];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float u = __fadd_rn(mu[l * lay.ld_mu + i], __fmul_rn(sigma[i], z[i]));
        lrow[D + i] = __float2bfloat16_rn(u);
        a[i] = __fmul_rn(tanhf(u), ac[i]);
      }
      const float4 w = wbuf[slot];
      float occ, cc, pc;
      env_step<N>(env_s, env.q_rate, env.beta, x, a, w, occ, cc, pc);
      float* o = out + te * 3;
      o[0] = -__fadd_rn(pc, cc);
      o[1] = cc;
      o[2] = pc;
      prev = w;
      prev_occ = occ;
    }
  }
}

template <int N>
int segment_launch(const Env& env, const float* acts, uint64_t seed, float* obs,
                   float* temps, float* reward, float* comfort, float* power,
                   float* acts_out, cudaStream_t stream) {
  const int grid = (env.B + kSimThreads - 1) / kSimThreads;
  building_segment_kernel<N><<<grid, kSimThreads, 0, stream>>>(
      env, acts, seed, obs, temps, reward, comfort, power, acts_out);
  return (int)cudaGetLastError();
}

// The dynamic shared memory one CTA may opt in to on the current card
cudaError_t smem_limit(int* limit) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

template <int N>
int policy_launch(const Env& env, const Actor& act, const Plan& pl,
                  const float* noise, uint64_t seed, int env_offset, float* out,
                  __nv_bfloat16* lrn, cudaStream_t stream) {
  const size_t smem = policy_layout(N + 4, act.H, N, env_floats(N), pl).total;
  int limit = 0;
  cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(building_policy_segment_kernel<N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int envs = kTile * pl.tiles;
  const int grid = (env.B + envs - 1) / envs;
  building_policy_segment_kernel<N><<<grid, kPolicyWarps * 32, smem, stream>>>(
      env, act, pl, noise, seed, env_offset, out, lrn);
  return (int)cudaGetLastError();
}

// CTAs of building_policy_segment_kernel<N> resident per SM under a plan
// that takes `smem` bytes
template <int N>
int policy_occupancy(size_t smem, int* ctas) {
  const cudaError_t err = cudaFuncSetAttribute(
      building_policy_segment_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, building_policy_segment_kernel<N>, kPolicyWarps * 32, smem);
}

using SegmentFn = int (*)(const Env&, const float*, uint64_t, float*, float*,
                          float*, float*, float*, float*, cudaStream_t);
using PolicyFn = int (*)(const Env&, const Actor&, const Plan&, const float*,
                         uint64_t, int, float*, __nv_bfloat16*, cudaStream_t);
using OccupancyFn = int (*)(size_t, int*);
constexpr SegmentFn kSegment[kMaxZones] = {
    segment_launch<1>, segment_launch<2>, segment_launch<3>, segment_launch<4>,
    segment_launch<5>, segment_launch<6>, segment_launch<7>, segment_launch<8>};
constexpr PolicyFn kPolicy[kMaxZones] = {
    policy_launch<1>, policy_launch<2>, policy_launch<3>, policy_launch<4>,
    policy_launch<5>, policy_launch<6>, policy_launch<7>, policy_launch<8>};
constexpr OccupancyFn kPolicyOccupancy[kMaxZones] = {
    policy_occupancy<1>, policy_occupancy<2>, policy_occupancy<3>,
    policy_occupancy<4>, policy_occupancy<5>, policy_occupancy<6>,
    policy_occupancy<7>, policy_occupancy<8>};

bool bad_env(int n, const float* table, int rows, int B, int T) {
  return n < 1 || n > kMaxZones || B <= 0 || T <= 0 || T > rows ||
         (reinterpret_cast<uintptr_t>(table) & 15u) != 0;
}

// A plan given from outside names 1, 2 or 4 tiles and at most each
// weight's k16 steps.
bool bad_plan(int n, int H, const Plan& pl) {
  const int kc1 = pad16(n + 4) / 16, kc2 = pad16(H) / 16;
  return H <= 0 || (pl.tiles != 1 && pl.tiles != 2 && pl.tiles != kMaxTiles) ||
         (pl.bias != 0 && pl.bias != 1) ||
         pl.k1 < 0 || pl.k1 > kc1 || pl.k2 < 0 || pl.k2 > kc2 || pl.k3 < 0 ||
         pl.k3 > kc2;
}

}  // namespace

// ---- plain C interface (loaded with ctypes; returns a cudaError_t) ----

extern "C" int building_segment_launch(
    const float* m, const float* target, const float* ac, float q_rate,
    float beta, int n, const float* table, int rows, const int64_t* epochs,
    int B, int T, const float* acts, uint64_t seed, float* obs, float* temps,
    float* reward, float* comfort, float* power, float* acts_out,
    void* stream) {
  if (bad_env(n, table, rows, B, T)) return (int)cudaErrorInvalidValue;
  const Env env{m, target, ac, q_rate, beta,
                reinterpret_cast<const float4*>(table), epochs, B, T};
  return kSegment[n - 1](env, acts, seed, obs, temps, reward, comfort, power,
                         acts_out, (cudaStream_t)stream);
}

extern "C" int building_policy_segment_launch(
    const float* m, const float* target, const float* ac, float q_rate,
    float beta, int n, const float* table, int rows, const int64_t* epochs,
    int B, int T, const void* w1, const float* b1, const void* w2,
    const float* b2, const void* wm, const float* bm, const float* sigma,
    int H, const float* noise, uint64_t seed, int env_offset, float* out,
    __nv_bfloat16* lrn, void* stream) {
  if (bad_env(n, table, rows, B, T) || H <= 0 || env_offset < 0)
    return (int)cudaErrorInvalidValue;
  int limit = 0;
  const cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return (int)err;
  Plan pl;
  if (!choose_plan(n + 4, H, n, limit, pl)) return (int)cudaErrorInvalidValue;
  const Env env{m, target, ac, q_rate, beta,
                reinterpret_cast<const float4*>(table), epochs, B, T};
  const Actor act{static_cast<const uint4*>(w1), b1, static_cast<const uint4*>(w2),
                  b2, static_cast<const uint4*>(wm), bm, sigma, n + 4, H};
  return kPolicy[n - 1](env, act, pl, noise, seed, env_offset, out, lrn,
                        (cudaStream_t)stream);
}

// building_policy_segment_launch under a plan given by the caller instead
// of choose_plan's, for tests that hold plans against each other.
extern "C" int building_policy_segment_launch_plan(
    const float* m, const float* target, const float* ac, float q_rate,
    float beta, int n, const float* table, int rows, const int64_t* epochs,
    int B, int T, const void* w1, const float* b1, const void* w2,
    const float* b2, const void* wm, const float* bm, const float* sigma,
    int H, int tiles, int bias, int k1, int k2, int k3, const float* noise,
    uint64_t seed, int env_offset, float* out, __nv_bfloat16* lrn, void* stream) {
  const Plan pl{tiles, bias, k1, k2, k3};
  if (bad_env(n, table, rows, B, T) || bad_plan(n, H, pl) || env_offset < 0)
    return (int)cudaErrorInvalidValue;
  const Env env{m, target, ac, q_rate, beta,
                reinterpret_cast<const float4*>(table), epochs, B, T};
  const Actor act{static_cast<const uint4*>(w1), b1, static_cast<const uint4*>(w2),
                  b2, static_cast<const uint4*>(wm), bm, sigma, n + 4, H};
  return kPolicy[n - 1](env, act, pl, noise, seed, env_offset, out, lrn,
                        (cudaStream_t)stream);
}

// The plan building_policy_segment_launch takes on the current card for n
// zones and H hidden units, its shared memory and the CTAs of that plan
// resident per SM.
extern "C" int building_policy_segment_plan(int n, int H, int* ctas, int* tiles,
                                            int* bias, int* k1, int* k2, int* k3,
                                            int* smem) {
  if (n < 1 || n > kMaxZones || H <= 0) return (int)cudaErrorInvalidValue;
  int limit = 0;
  const cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return (int)err;
  Plan pl;
  if (!choose_plan(n + 4, H, n, limit, pl)) return (int)cudaErrorInvalidValue;
  *tiles = pl.tiles;
  *bias = pl.bias;
  *k1 = pl.k1;
  *k2 = pl.k2;
  *k3 = pl.k3;
  *smem = (int)policy_layout(n + 4, H, n, env_floats(n), pl).total;
  return kPolicyOccupancy[n - 1](*smem, ctas);
}
