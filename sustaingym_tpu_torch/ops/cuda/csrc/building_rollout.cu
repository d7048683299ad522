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
//  * Policy: a CTA owns kTile envs (actor.cuh, shared with ev_rollout.cu).
//    Thread l < kTile keeps env l's state in registers and writes its bf16
//    obs row into shared memory; all 512 threads run the actor over the
//    tile (its three layers on the tensor cores, the weights read from L2
//    once per tile per step); thread l then samples u, squashes a = tanh(u)
//    ac (the JAX kernel's form) and steps its env. The obs at step t is step
//    t-1's emitted obs; at t = 0 the reset obs.
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

// Floats of the operator, target and ac in shared memory, rounded up to
// 16 bytes.
template <int N>
__host__ __device__ constexpr int env_floats() {
  return (N * (2 * N + 4) + 2 * N + 3) / 4 * 4;
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

template <int N>
__global__ void __launch_bounds__(kTile * 32)
building_policy_segment_kernel(Env env, Actor act, const float* __restrict__ noise,
                               uint64_t seed, float* __restrict__ out,
                               __nv_bfloat16* __restrict__ lrn) {
  constexpr int K = 2 * N + 4, D = N + 4, LW = 2 * N + 4;
  extern __shared__ float smem[];
  const int B = env.B;
  float* env_s = smem;  // operator | target | ac, then the actor's tiles
  const ActorTiles at = carve_actor_tiles(
      reinterpret_cast<unsigned char*>(smem + env_floats<N>()), D, act.H, N);
  load_env<N>(env, env_s);
  __syncthreads();
  const float* ac = env_s + N * K + N;
  const int l = threadIdx.x;
  const int e = blockIdx.x * kTile + l;
  const bool mine = l < kTile;             // this thread steps env l
  const bool live = mine && e < B;
  const uint2 key = philox_key(seed);
  const float4* rows = env.table + (live ? env.epochs[e] : 0);
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
      __nv_bfloat16* ob = at.obs + l * at.ld_obs;
#pragma unroll
      for (int i = 0; i < N; ++i) ob[i] = __float2bfloat16_rn(x[i]);
      ob[N] = __float2bfloat16_rn(prev.x);
      ob[N + 1] = __float2bfloat16_rn(prev.y);
      ob[N + 2] = __float2bfloat16_rn(prev.z);
      ob[N + 3] = __float2bfloat16_rn(__fmul_rn(prev_occ, 0.001f));
    }
    __syncthreads();
    actor_forward(act, at, N);
    if (live) {
      const size_t te = (size_t)t * B + e;
      __nv_bfloat16* lrow = lrn + te * LW;
#pragma unroll
      for (int i = 0; i < D; ++i) lrow[i] = at.obs[l * at.ld_obs + i];
      float z[N];
      if (noise != nullptr) {
#pragma unroll
        for (int i = 0; i < N; ++i) z[i] = noise[te * N + i];
      } else {
#pragma unroll
        for (int g = 0; g < (N + 1) / 2; ++g) {
          const float2 p = box_muller(
              philox4x32_10(make_uint4((uint32_t)g, (uint32_t)t, (uint32_t)e, 1u), key));
          z[2 * g] = p.x;
          if (2 * g + 1 < N) z[2 * g + 1] = p.y;
        }
      }
      float a[N];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float u = __fadd_rn(at.mu[l * at.ld_mu + i], __fmul_rn(act.sigma[i], z[i]));
        lrow[D + i] = __float2bfloat16_rn(u);
        a[i] = __fmul_rn(tanhf(u), ac[i]);
      }
      const float4 w = rows[t];
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

template <int N>
int policy_launch(const Env& env, const Actor& act, const float* noise,
                  uint64_t seed, float* out, __nv_bfloat16* lrn,
                  cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * env_floats<N>() + actor_tiles_bytes(N + 4, act.H, N);
  const cudaError_t err = cudaFuncSetAttribute(
      building_policy_segment_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (env.B + kTile - 1) / kTile;
  building_policy_segment_kernel<N><<<grid, kTile * 32, smem, stream>>>(
      env, act, noise, seed, out, lrn);
  return (int)cudaGetLastError();
}

using SegmentFn = int (*)(const Env&, const float*, uint64_t, float*, float*,
                          float*, float*, float*, float*, cudaStream_t);
using PolicyFn = int (*)(const Env&, const Actor&, const float*, uint64_t, float*,
                         __nv_bfloat16*, cudaStream_t);
constexpr SegmentFn kSegment[kMaxZones] = {
    segment_launch<1>, segment_launch<2>, segment_launch<3>, segment_launch<4>,
    segment_launch<5>, segment_launch<6>, segment_launch<7>, segment_launch<8>};
constexpr PolicyFn kPolicy[kMaxZones] = {
    policy_launch<1>, policy_launch<2>, policy_launch<3>, policy_launch<4>,
    policy_launch<5>, policy_launch<6>, policy_launch<7>, policy_launch<8>};

bool bad_env(int n, const float* table, int rows, int B, int T) {
  return n < 1 || n > kMaxZones || B <= 0 || T <= 0 || T > rows ||
         (reinterpret_cast<uintptr_t>(table) & 15u) != 0;
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
    int H, const float* noise, uint64_t seed, float* out, __nv_bfloat16* lrn,
    void* stream) {
  if (bad_env(n, table, rows, B, T) || H <= 0) return (int)cudaErrorInvalidValue;
  const Env env{m, target, ac, q_rate, beta,
                reinterpret_cast<const float4*>(table), epochs, B, T};
  const Actor act{static_cast<const uint4*>(w1), b1, static_cast<const uint4*>(w2),
                  b2, static_cast<const uint4*>(wm), bm, sigma, n + 4, H};
  return kPolicy[n - 1](env, act, noise, seed, out, lrn, (cudaStream_t)stream);
}
