// Whole EVChargingEnv episode segments on an NVIDIA Hopper card (sm_90a).
//
// Replaces the two Pallas TPU kernels of
// sustaingym_tpu/ops/pallas/ev_rollout.py:
//   ev_segment_kernel        <- fused_ev_segment (_kernel), the simulation tier
//   ev_policy_segment_kernel <- fused_ev_policy_segment (_policy_kernel), the
//                               PPO rollout with the 2-layer tanh actor inside
//
// What bounds them. Per env step the dual-FISTA projection runs `iters`
// (15) dependent iterations of two skinny mat-vecs (C' y over <= 32 cone
// rows, C xbar over <= 64 stations); the reward adds one more C mat-vec.
// The simulation kernel's second operator, over-relaxed ADMM (the TPU
// kernel's `admm`, proj_method="admm"), runs `iters` (30) iterations of
// C' y, a dense K rhs (n x n) and C x.
// That is a chain of warp-synchronous FMAs, not a bandwidth problem: one
// day-table row (~0.7 KB, L2-resident: the whole table is ~37 MB) and 16
// bytes of output per env step. The policy kernel adds the actor MLP,
// ~2*(D*H + H*H + H*n) = 234 kFLOP per env step at H = 256, whose weights
// (~233 KB bf16) are the one large operand.
//
// Design.
//  * One warp per env. Lane l owns stations l and l + 32 (n <= 64) and cone
//    row l (2m <= 32 rows, interleaved Re/Im per cone as in ops/qp.py), so
//    a cone's (Re, Im) pair sits in lanes (2c, 2c+1) and its norm is one
//    __shfl_xor. Station state (plugged, departure, est. departure, demand)
//    stays in registers for the whole segment.
//  * Simulation kernel: the cone operator in registers (RegCone). The
//    kernel is bound by its instruction issue: read from shared memory,
//    each FISTA iteration's two mat-vecs cost a load per term and operand,
//    ~436 instructions an iteration at caltech's 54 stations and 16 cone
//    rows (82 ms at 32768 x 288). A lane holds its two stations' columns
//    of C for the whole launch; y comes back from shared memory as float4
//    broadcasts, and C x is a reduce-scatter of the lanes' partials by
//    shuffles: ~250 instructions an iteration. The kernel is a template on
//    m2 rounded up to 8, so each site holds only the columns it has. Each
//    step's projection stops at its fixed point (fista<true>), after one
//    iteration in nearly every step of random actions, and skips C' y
//    where y is 0 in every lane.
//  * Policy kernel: the cone operator lives in shared memory twice
//    (SharedCone; fista<false> and env_step<false> run the same body):
//    station-major for C xbar (lane = cone row reads consecutive words) and
//    cone-major for C' y (lane = station reads consecutive words), so
//    neither mat-vec has bank conflicts. Mat-vec operands go through a
//    per-warp shared buffer. Its 64-register budget leaves no room for the
//    columns.
//  * The day table is indexed directly, table[day_b, t], instead of the TPU
//    kernel's one-hot matmul day select.
//  * Policy kernel: a CTA owns a tile of kTile = 16 envs (one warp each).
//    Per step the warps write their bf16 obs rows, the whole CTA runs the
//    actor (actor.cuh, shared with building_rollout.cu: the three layers on
//    the tensor cores, the weights read from L2 once per tile per step),
//    and each warp samples and steps its env. With the actor off the FMA
//    pipes the env step, the projection's dependent chain of shared-memory
//    mat-vecs, warp shuffles and syncs, is what the kernel spends its time
//    on, so it needs resident warps to hide that latency: the kernel is
//    held to 64 registers a thread and ~50 KB of shared memory a CTA
//    (bf16 tiles), two 512-thread CTAs (32 warps) per SM. 8192 envs are
//    512 CTAs, 1.94 waves of 264 on 132 SMs (the first kernel ran one CTA
//    per SM: 3.9 waves of 16 warps).
//  * ADMM (its own simulation kernel, ev_admm_segment_kernel): 30
//    iterations of C' y, K rhs (n x n) and C x, no early stop. It is bound
//    by shared memory, whose loads cost about by the bytes they bring the
//    lanes, a broadcast not much less (tools/smem_rates.py on the H100, in
//    loads of one word a lane: a float4 broadcast 2.2, a float4 a lane 4,
//    a shuffle 1).
//    One env a warp read K's two words and rhs[j] into every lane for
//    every j, 3n loads feeding 2n FMAs a lane. So a warp steps four envs
//    with the one-env lane map (lane l: stations l and l+32, cone row l of
//    each), and each load serves four envs: K sits in shared memory in
//    pairs of columns (one float4 a lane: K[s0, j], K[s1, j], K[s0, j+1],
//    K[s1, j+1]), the rhs and y go through the warp's scratch env-minor
//    (one float4 broadcast: four envs' rhs[j]), C x's partials are rotated
//    per lane so its reduce-scatter needs no selects, and C' y reads C's
//    columns from a CTA copy, which keeps the kernel at 168 registers: 3
//    CTAs of 4 warps a SM, 48 envs. Every sum keeps the one-env kernel's
//    operands and order, and its roundings are written out (fmaf), so each
//    env's outputs are the one-env kernel's bit for bit. rho and alpha are
//    kernel arguments.
//  * Random draws: counter-based Philox4x32-10 (philox.cuh) keyed by the
//    caller's seed and counted by (lane, step, env, stream), so the draws do
//    not depend on launch geometry. The policy kernel counts the global env
//    index (env_offset + e): a data-parallel rank's launch over its slice
//    of the global batch draws that slice's numbers.
//  * No fast-math: rintf (round half to even, like jnp.round), IEEE sqrtf
//    and division.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "actor.cuh"
#include "philox.cuh"

namespace {

constexpr int kMaxStations = 64;
constexpr int kMaxConeRows = 32;
constexpr unsigned kFull = 0xffffffffu;

// env constants, evaluated in double exactly as envs/evcharging/env.py does
constexpr double kVoltage = 208.0;
constexpr double kAPersToKwh = (1.0 / 60.0) * (kVoltage / 1000.0) * 5.0;
constexpr double kProfitFactor = kAPersToKwh * (0.15 * 0.20);
constexpr double kViolationFactor = kAPersToKwh * 0.001;
constexpr double kCarbonCostFactor = kAPersToKwh * (30.85 / 1000.0);
constexpr double kMaxTimestep = 288.0;

// offsets 16 .. 1, unrolled
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int b = 4; b >= 0; --b) v += __shfl_xor_sync(kFull, v, 1 << b);
  return v;
}

struct Operators {
  const float* C;      // (m2, n) interleaved Re/Im cone rows
  const float* radii;  // (m)
  const float* step;   // (m) dual step sizes (null for ADMM)
  const float* mags;   // (m) cone limits (amps)
  const float* minp;   // (n) min pilots (6 = CC, 8 = AV)
  int n, m2, iters, restart, project;
};

// Shared-memory copies of C; see the file comment.
struct SharedC {
  float* cjk;  // [kMaxStations][kMaxConeRows]
  float* ckj;  // [kMaxConeRows][kMaxStations]
};

__device__ void load_operator(const Operators& op, SharedC sc) {
  for (int i = threadIdx.x; i < kMaxStations * kMaxConeRows; i += blockDim.x) {
    const int k = i / kMaxStations, j = i % kMaxStations;
    const float v = (k < op.m2 && j < op.n) ? op.C[k * op.n + j] : 0.0f;
    sc.ckj[k * kMaxStations + j] = v;
    sc.cjk[j * kMaxConeRows + k] = v;
  }
}

// Per-lane view of one env: two station slots and one cone row.
struct Lane {
  int lane, s0, s1;
  bool v0, v1, crow;
  float minp0, minp1;
  float t2, tr, mag_lim;  // cone row constants (0 outside the cones)
};

__device__ Lane make_lane(const Operators& op) {
  Lane L;
  L.lane = threadIdx.x & 31;
  L.s0 = L.lane;
  L.s1 = L.lane + 32;
  L.v0 = L.s0 < op.n;
  L.v1 = L.s1 < op.n;
  L.crow = L.lane < op.m2;
  L.minp0 = L.v0 ? op.minp[L.s0] : 0.0f;
  L.minp1 = L.v1 ? op.minp[L.s1] : 0.0f;
  const int c = L.lane >> 1;
  const bool dual = L.crow && op.step != nullptr;
  L.t2 = dual ? op.step[c] : 0.0f;
  L.tr = dual ? op.step[c] * op.radii[c] : 0.0f;
  L.mag_lim = L.crow ? op.mags[c] : 0.0f;
  return L;
}

// The policy kernel's cone operator: C in shared memory (SharedC), the
// mat-vecs' operands through the warp's scratch (xs: 64 stations, ys: 32
// cone rows). RegCone below has the same interface; ct_y returns the
// mat-vecs it ran.
struct SharedCone {
  const Operators& op;
  SharedC sc;
  float *xs, *ys;

  // C' y for the lane's two stations; y is the lane's cone-row value
  __device__ __forceinline__ int ct_y(float y, const Lane& L, float& d0,
                                      float& d1) const {
    __syncwarp();
    ys[L.lane] = y;
    __syncwarp();
    d0 = 0.0f;
    d1 = 0.0f;
    for (int k = 0; k < op.m2; ++k) {
      const float yk = ys[k];
      d0 += sc.ckj[k * kMaxStations + L.s0] * yk;
      d1 += sc.ckj[k * kMaxStations + L.s1] * yk;
    }
    return 1;
  }

  // (C x)[lane] for the lane's cone row from the lane's two station values
  __device__ __forceinline__ float c_x(float x0, float x1, const Lane& L) const {
    xs[L.s0] = x0;
    xs[L.s1] = x1;
    __syncwarp();
    float acc = 0.0f;
    if (L.crow)
      for (int j = 0; j < op.n; ++j) acc += sc.cjk[j * kMaxConeRows + L.lane] * xs[j];
    return acc;
  }
};

// Norm of this lane's cone pair (Re in the even lane, Im in the odd one).
__device__ __forceinline__ float pair_norm_sq(float v, int lane) {
  const float p = __shfl_xor_sync(kFull, v, 1);
  const float re = (lane & 1) ? p : v;
  const float im = (lane & 1) ? v : p;
  return re * re + im * im;
}

// Station state of one env, in this lane's registers.
struct Stations {
  bool pl0, pl1;
  int dep0, dep1, est0, est1;
  float dem0, dem1;
};

__device__ __forceinline__ float quantize(float a, float minp) {
  const float amps = a * 32.0f;
  const float cc = amps >= 6.0f ? rintf(amps) : 0.0f;
  const float av = rintf(amps / 8.0f) * 8.0f;
  return minp == 6.0f ? cc : av;
}

// Two-stage battery (env.py battery_charge); returns the rate in A and
// lowers the demand by the energy delivered.
__device__ __forceinline__ float charge(float pilot, bool plugged, float& dem) {
  const float pilot_kw = pilot * (float)kVoltage / 1000.0f;
  const float soc = 1.0f - dem / 100.0f;
  const float taper = 100.0f * (1.0f - soc) / 0.2f;
  const float cap_kw = soc < 0.8f ? 100.0f : taper;
  float power = fminf(pilot_kw, cap_kw);
  power = fminf(power, dem * 12.0f);
  power = plugged ? fmaxf(power, 0.0f) : 0.0f;
  dem = dem - power * (float)(5.0 / 60.0);
  return power * 1000.0f / (float)kVoltage;
}

// ---- the simulation kernel's projection: the cone operator in registers --
//
// Lane l keeps the two columns of C it needs, C[0:m2, l] and C[0:m2, l+32],
// in registers for the whole launch (MP = m2 rounded up to 8; zero past m2
// and past n). C' y reads y back from the warp's scratch as float4
// broadcasts and sums k = 0 .. m2-1 with one FMA per term, the order of
// SharedCone::ct_y, so d0 and d1 come out as there (the zero columns past
// m2 add exact zeros). C x forms each lane's partials C[k, l] x_l +
// C[k, l+32] x_{l+32} for all k and reduce-scatters them across the warp
// (reduce_scatter below), so that cone row k ends in lane k as in
// SharedCone::c_x.

// One halving step of reduce_scatter at lane bit O, then the next: a lane
// keeps the half of v[0:2 O] that its bit O selects and adds its partner's
// copy of that half (O shuffles). O is a template parameter so that every
// index of v is a constant: a register, not a select over registers.
template <int O, int W>
__device__ __forceinline__ void halve(float (&v)[W], int lane) {
  if constexpr (O >= 1) {
    const bool hi = lane & O;
#pragma unroll
    for (int j = 0; j < O; ++j) {
      const float send = hi ? v[j] : v[O + j];
      const float keep = hi ? v[O + j] : v[j];
      v[j] = keep + __shfl_xor_sync(kFull, send, O);
    }
    halve<O / 2>(v, lane);
  }
}

// Sums v[0:W] over the warp's lanes and leaves the sum of row (lane % W)
// in the lane: log2(W) halving steps (W - 1 shuffles), then a butterfly
// over the lane bits above W (16 rows: 16 shuffles in all; 8 rows: 9).
template <int W>
__device__ __forceinline__ float reduce_scatter(float (&v)[W], int lane) {
  halve<W / 2>(v, lane);
  float s = v[0];
#pragma unroll
  for (int b = 0; b < 5; ++b)
    if ((1 << b) >= W) s += __shfl_xor_sync(kFull, s, 1 << b);
  return s;
}

template <int MP>
struct RegCone {
  float c0[MP], c1[MP];  // C[k, s0], C[k, s1]
  float4* ys;            // the warp's scratch: y[0:MP]

  __device__ __forceinline__ void load(const Operators& op, const Lane& L,
                                       float4* scratch) {
    ys = scratch;
#pragma unroll
    for (int k = 0; k < MP; ++k) {
      c0[k] = (k < op.m2 && L.v0) ? op.C[k * op.n + L.s0] : 0.0f;
      c1[k] = (k < op.m2 && L.v1) ? op.C[k * op.n + L.s1] : 0.0f;
    }
  }

  // C' y for the lane's two stations; y is the lane's cone-row value (0
  // outside the cones). When y is 0 in every lane, every term is a zero and
  // the sums +0, as the loop would leave them: no mat-vec runs.
  __device__ __forceinline__ int ct_y(float y, const Lane& L, float& d0,
                                      float& d1) const {
    d0 = 0.0f;
    d1 = 0.0f;
    if (__all_sync(kFull, y == 0.0f)) return 0;
    __syncwarp();
    if (L.lane < MP) reinterpret_cast<float*>(ys)[L.lane] = y;
    __syncwarp();
#pragma unroll
    for (int q = 0; q < MP / 4; ++q) {
      const float4 y4 = ys[q];
      const float yk[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        d0 = fmaf(c0[4 * q + i], yk[i], d0);
        d1 = fmaf(c1[4 * q + i], yk[i], d1);
      }
    }
    return 1;
  }

  // (C x)[lane] from the lane's two station values
  __device__ __forceinline__ float c_x(float x0, float x1, const Lane& L) const {
    const int lane = L.lane;
    float part[MP];
#pragma unroll
    for (int k = 0; k < MP; ++k) part[k] = fmaf(c1[k], x1, c0[k] * x0);
    float r = 0.0f;
#pragma unroll
    for (int base = 0; base + 16 <= MP; base += 16) {
      float v[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) v[k] = part[base + k];
      const float s = reduce_scatter<16>(v, lane);
      if (base == 0 || lane >= base) r = s;
    }
    if constexpr (MP % 16 == 8) {
      constexpr int base = MP - 8;
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = part[base + k];
      const float s = reduce_scatter<8>(v, lane);
      if (base == 0 || lane >= base) r = s;
    }
    return r;
  }
};

// Preconditioned dual-FISTA with gradient restart (ops/qp.py::project)
// on a cone operator (SharedCone or RegCone; inlined: RegCone's columns must
// stay in registers, not go to the stack with a reference to the cone); a
// and ub are this lane's two stations. With kStop, the loop stops once an
// iteration leaves every lane's lam where the one before left it (lam_new
// == lam == lam_prev: in most env steps lam stays 0, no cone binding): the
// iterations left would repeat it exactly (y = lam + beta * 0 = lam, so the
// same x, w and lam, and no restart), so the result is that of all
// `iters`. Returns the mat-vecs with C that it ran.
template <bool kStop, class Cone>
__device__ __forceinline__ int fista(const Operators& op, const Cone& cone,
                                     const Lane& L, float a0, float a1,
                                     float ub0, float ub1, float& x0, float& x1) {
  float lam = 0.0f, lam_prev = 0.0f, tk = 1.0f;
  float d0, d1;
  int matvecs = 0;
  for (int it = 0; it < op.iters; ++it) {
    float tk1 = 0.5f * (1.0f + sqrtf(1.0f + 4.0f * tk * tk));
    const float beta = (tk - 1.0f) / tk1;
    const float y = lam + beta * (lam - lam_prev);
    matvecs += cone.ct_y(y, L, d0, d1) + 1;  // and C x below
    const float w = y + L.t2 * cone.c_x(fminf(fmaxf(a0 - d0, 0.0f), ub0),
                                        fminf(fmaxf(a1 - d1, 0.0f), ub1), L);
    const float nr = sqrtf(pair_norm_sq(w, L.lane) + 1e-12f);
    const float lam_new = L.crow ? w * fmaxf(0.0f, 1.0f - L.tr / nr) : 0.0f;
    // at it = 0, lam - lam_prev = 0: prog is 0
    if (op.restart && (!kStop || it > 0)) {
      const float prog = warp_sum((lam_new - lam) * (lam - lam_prev));
      if (prog < 0.0f) tk1 = 1.0f;
    }
    const bool fixed = kStop && __all_sync(kFull, lam_new == lam && lam == lam_prev);
    lam_prev = lam;
    lam = lam_new;
    tk = tk1;
    if (fixed) break;
  }
  matvecs += cone.ct_y(lam, L, d0, d1);
  x0 = fminf(fmaxf(a0 - d0, 0.0f), ub0);
  x1 = fminf(fmaxf(a1 - d1, 0.0f), ub1);
  return matvecs;
}

// env_step's projector: dual FISTA (with the fixed-point stop if kStop).
template <bool kStop>
struct FistaProj {
  template <class Cone>
  __device__ __forceinline__ int operator()(const Operators& op, const Cone& cone,
                                            const Lane& L, float a0, float a1,
                                            float ub0, float ub1, float& x0,
                                            float& x1) const {
    return fista<kStop>(op, cone, L, a0, a1, ub0, ub1, x0, x1);
  }
};

// One env step after the action is known: projection (by `proj`),
// quantization, events, battery, reward. Writes (reward, profit, carbon,
// excess) to out4 from lane 0. `row` is table[day, t]: plug_dep | plug_est
// | plug_req | moer(t+1) | ... Returns the mat-vecs with C that it ran.
template <class Proj, class Cone>
__device__ __forceinline__ int env_step(const Operators& op, const Proj& proj,
                                        const Cone& cone, const Lane& L,
                                        Stations& st, float a0, float a1,
                                        const float* row, int t, float* out4) {
  const int n = op.n;
  a0 = L.v0 ? fminf(fmaxf(a0, 0.0f), 1.0f) : 0.0f;
  a1 = L.v1 ? fminf(fmaxf(a1, 0.0f), 1.0f) : 0.0f;
  int matvecs = 1;  // the reward's C p
  if (op.project) {
    // upper bound from the pre-event demands the agent observed
    const float kub = (float)kAPersToKwh;
    const float ub0 = fminf(1.0f, (st.pl0 ? st.dem0 : 0.0f) / kub / 32.0f);
    const float ub1 = fminf(1.0f, (st.pl1 ? st.dem1 : 0.0f) / kub / 32.0f);
    matvecs += proj(op, cone, L, a0, a1, L.v0 ? ub0 : 0.0f, L.v1 ? ub1 : 0.0f,
                    a0, a1);
  }
  const float p0 = L.v0 ? quantize(a0, L.minp0) : 0.0f;
  const float p1 = L.v1 ? quantize(a1, L.minp1) : 0.0f;

  // events at step t: unplug at departure, then arrivals take the slot
  const float dep_in0 = L.v0 ? row[L.s0] : 0.0f;
  const float dep_in1 = L.v1 ? row[L.s1] : 0.0f;
  st.pl0 = st.dep0 == t ? false : st.pl0;
  st.pl1 = st.dep1 == t ? false : st.pl1;
  if (dep_in0 > 0.0f) {
    st.pl0 = true;
    st.dep0 = (int)dep_in0;
    st.est0 = (int)row[n + L.s0];
    st.dem0 = row[2 * n + L.s0];
  }
  if (dep_in1 > 0.0f) {
    st.pl1 = true;
    st.dep1 = (int)dep_in1;
    st.est1 = (int)row[n + L.s1];
    st.dem1 = row[2 * n + L.s1];
  }
  const float r0 = L.v0 ? charge(p0, st.pl0, st.dem0) : 0.0f;
  const float r1 = L.v1 ? charge(p1, st.pl1, st.dem1) : 0.0f;
  const float total_rate = warp_sum(r0 + r1);

  // per-cone aggregate current magnitudes at the quantized pilots
  __syncwarp();
  const float agg = cone.c_x(p0, p1, L);
  const float mag = sqrtf(pair_norm_sq(agg, L.lane));
  // padded cone rows add exactly 0
  const bool cone_head = L.crow && !(L.lane & 1) && L.mag_lim > 0.0f;
  const float excess = warp_sum(cone_head ? fmaxf(mag - L.mag_lim, 0.0f) : 0.0f);

  if (L.lane == 0) {
    const float moer_next0 = row[3 * n];
    const float profit = (float)kProfitFactor * total_rate;
    const float carbon = (float)kCarbonCostFactor * total_rate * moer_next0;
    const float excess_charge = excess * (float)kViolationFactor;
    *reinterpret_cast<float4*>(out4) =
        make_float4(profit - carbon - excess_charge, profit, carbon, excess_charge);
  }
  return matvecs;
}

constexpr int kSimWarps = 8;

// CTAs per SM the register budget of the simulation kernel must allow: 24
// resident warps (<= 80 registers) up to 24 cone rows, 16 warps above
__host__ __device__ constexpr int sim_blocks(int MP) { return MP <= 24 ? 3 : 2; }

// The ADMM operator's host arguments (K null for FISTA).
struct AdmmArgs {
  const float* K;  // (n, n)
  float rho, alpha;
};

// The dual-FISTA simulation kernel, one warp an env (`adm` unused).
template <int MP>
__global__ void __launch_bounds__(kSimWarps * 32, sim_blocks(MP))
ev_segment_kernel(Operators op, AdmmArgs adm, const float* __restrict__ table,
                  int table_w, int rows_per_day, const int64_t* __restrict__ days,
                  int B, int T, const float* __restrict__ acts, uint64_t seed,
                  float* __restrict__ out, float* __restrict__ acts_out,
                  unsigned long long* __restrict__ matvecs_out) {
  __shared__ float4 scratch[kSimWarps][MP / 4];
  const int warp = threadIdx.x >> 5;
  const int e = blockIdx.x * kSimWarps + warp;
  if (e >= B) return;  // whole warps only: no block-wide sync follows
  const Lane L = make_lane(op);
  RegCone<MP> cone;
  cone.load(op, L, scratch[warp]);
  const uint2 key = philox_key(seed);
  const float* day_rows = table + (size_t)days[e] * rows_per_day * table_w;
  Stations st{false, false, 0, 0, 0, 0, 0.0f, 0.0f};
  unsigned long long matvecs = 0;
  for (int t = 0; t < T; ++t) {
    float a0, a1;
    if (acts != nullptr) {
      const float* at = acts + ((size_t)t * B + e) * op.n;
      a0 = L.v0 ? at[L.s0] : 0.0f;
      a1 = L.v1 ? at[L.s1] : 0.0f;
    } else {
      const uint4 r = philox4x32_10(make_uint4(L.lane, t, e, 0u), key);
      a0 = uniform01(r.x);
      a1 = uniform01(r.y);
    }
    if (acts_out != nullptr) {
      float* ao = acts_out + ((size_t)t * B + e) * op.n;
      if (L.v0) ao[L.s0] = fminf(fmaxf(a0, 0.0f), 1.0f);
      if (L.v1) ao[L.s1] = fminf(fmaxf(a1, 0.0f), 1.0f);
    }
    const float* row = day_rows + (size_t)t * table_w;
    float* out4 = out + ((size_t)t * B + e) * 4;
    matvecs += env_step(op, FistaProj<true>{}, cone, L, st, a0, a1, row, t, out4);
  }
  if (matvecs_out != nullptr && L.lane == 0) atomicAdd(matvecs_out, matvecs);
}

// ---- the ADMM simulation kernel: four envs a warp ------------------------
//
// Over-relaxed ADMM (ops/qp.py::_project_admm) on the splitting x = z0
// (box), C x = zc (cones), with K = inv((1+rho) I + rho C'C). A warp steps
// kAdmmEnvs envs together: lane l holds stations (l, l+32) and cone row l
// of each, as the dual kernel's single env, so every expression below is
// the one-env ADMM's, repeated over e in unrolled loops, in its order of
// operations and with the roundings it compiled to (written out with fmaf).
// What the envs share is each load of an operator: a word of K feeds four
// envs' FMAs, and C's columns are held once. See the file comment for why.

constexpr int kAdmmEnvs = 4;    // envs a warp: one float4 of rhs or y
constexpr int kAdmmWarps = 4;   // warps a CTA
constexpr int kAdmmBlocks = 3;  // CTAs a SM (<= 168 registers, no spills)
constexpr int kKChunk = 3;      // K rhs's pairs of columns a loop step
// K's pairs of columns and rs's rows, with one zero pair (two rows) past
// the 64 stations for the last chunk of K rhs
constexpr int kKtPairs = kMaxStations / 2 + 1;
constexpr int kRsRows = kMaxStations + 2;

// One halving step of reduce_scatter on partials held rotated: position i
// of block W holds row i ^ (lane & (W-1)), so at every step a lane keeps
// v[0:O] and sends v[O:2 O], and its partner's v[O + j] is the row of its
// own v[j]. The sums are reduce_scatter's (own + partner's, the same tree)
// without its selects.
template <int O, int W>
__device__ __forceinline__ void halve_rot(float (&v)[W]) {
  if constexpr (O >= 1) {
#pragma unroll
    for (int j = 0; j < O; ++j) v[j] = v[j] + __shfl_xor_sync(kFull, v[O + j], O);
    halve_rot<O / 2>(v);
  }
}

template <int W>
__device__ __forceinline__ float reduce_scatter_rot(float (&v)[W]) {
  halve_rot<W / 2>(v);
  float s = v[0];
#pragma unroll
  for (int b = 0; b < 5; ++b)
    if ((1 << b) >= W) s += __shfl_xor_sync(kFull, s, 1 << b);
  return s;
}

// The ADMM kernel's cone operator for the warp's four envs. The lane holds
// its two columns of C rotated (r0, r1: block row i ^ (lane & (W-1)) at
// position i, blocks of 16 rows and a last one of 8) for C x, whose
// reduce-scatter then needs no selects. C' y reads the columns in row order
// from the CTA's copy cs (registers for them would cost a CTA a SM) and y
// env-minor from the warp's scratch (ys[k] = y[k] of the four envs), and
// sums k = 0 .. MP-1 as RegCone::ct_y does.
template <int MP>
struct AdmmCone {
  float r0[MP], r1[MP];  // C[row, s0], C[row, s1], rotated within each block
  float4* ys;
  const float2* cs;      // shared [MP][32]: (C[k, l], C[k, l+32])

  __device__ __forceinline__ void load(const Operators& op, const Lane& L,
                                       float4* scratch, const float2* cpairs) {
    ys = scratch;
    cs = cpairs;
#pragma unroll
    for (int k = 0; k < MP; ++k) {
      const int base = k & ~15, w = MP - base >= 16 ? 16 : 8;
      const int row = base + ((k - base) ^ (L.lane & (w - 1)));
      r0[k] = (row < op.m2 && L.v0) ? op.C[row * op.n + L.s0] : 0.0f;
      r1[k] = (row < op.m2 && L.v1) ? op.C[row * op.n + L.s1] : 0.0f;
    }
  }

  // C' y for each env's two stations of the lane; y[e] is the lane's
  // cone-row value of env e (0 outside the cones). ran[e] is 0 where y[e]
  // is 0 in every lane: there the one-env kernel runs no mat-vec and leaves
  // the sums +0, which is also what these FMAs leave (C is finite).
  __device__ __forceinline__ void ct_y(const float (&y)[kAdmmEnvs], const Lane& L,
                                       float (&d0)[kAdmmEnvs], float (&d1)[kAdmmEnvs],
                                       int (&ran)[kAdmmEnvs]) const {
#pragma unroll
    for (int e = 0; e < kAdmmEnvs; ++e) ran[e] = __all_sync(kFull, y[e] == 0.0f) ? 0 : 1;
    __syncwarp();
    if (L.lane < MP) ys[L.lane] = make_float4(y[0], y[1], y[2], y[3]);
    __syncwarp();
#pragma unroll
    for (int e = 0; e < kAdmmEnvs; ++e) {
      d0[e] = 0.0f;
      d1[e] = 0.0f;
    }
#pragma unroll
    for (int k = 0; k < MP; ++k) {
      const float2 c = cs[k * 32 + L.lane];
      const float4 y4 = ys[k];
      const float yk[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
      for (int e = 0; e < kAdmmEnvs; ++e) {
        d0[e] = fmaf(c.x, yk[e], d0[e]);
        d1[e] = fmaf(c.y, yk[e], d1[e]);
      }
    }
  }

  // (C x)[lane] of one env from the lane's two station values: RegCone::c_x's
  // partials and sums
  __device__ __forceinline__ float c_x(float x0, float x1, const Lane& L) const {
    float part[MP];
#pragma unroll
    for (int k = 0; k < MP; ++k) part[k] = fmaf(r1[k], x1, r0[k] * x0);
    float r = 0.0f;
#pragma unroll
    for (int base = 0; base + 16 <= MP; base += 16) {
      float v[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) v[k] = part[base + k];
      const float s = reduce_scatter_rot<16>(v);
      if (base == 0 || L.lane >= base) r = s;
    }
    if constexpr (MP % 16 == 8) {
      constexpr int base = MP - 8;
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = part[base + k];
      const float s = reduce_scatter_rot<8>(v);
      if (base == 0 || L.lane >= base) r = s;
    }
    return r;
  }
};

// The projection of a warp's four envs. K is copied once a CTA into shared
// memory in pairs of columns: kt[jp * 32 + l] = (K[l, 2 jp], K[l+32, 2 jp],
// K[l, 2 jp+1], K[l+32, 2 jp+1]), zero past n, so one float4 a lane brings
// two columns of K for the lane's two stations and serves four envs. The
// envs' rhs go through the warp's rs env-minor (rs[j] = rhs[j] of the four
// envs): one float4 broadcast a column.
struct AdmmOp {
  const float4* kt;
  float4* rs;
  float rho, alpha, beta;  // beta = 1 - alpha, rounded in float32
  float rad;               // the lane's cone radius (0 outside the cones)

  // x = K rhs for each env's two stations of the lane: fmaf(K[s, j], rhs[j],
  // x) over j = 0 .. n-1 from 0, as the one-env kernel sums. Terms past n
  // (an odd n, a last chunk) are fmaf(0, 0, x), which leave x as it is (x
  // is never -0).
  __device__ __forceinline__ void k_rhs(const float (&q0)[kAdmmEnvs],
                                        const float (&q1)[kAdmmEnvs], const Lane& L,
                                        int n, float (&x0)[kAdmmEnvs],
                                        float (&x1)[kAdmmEnvs]) const {
    __syncwarp();
    rs[L.s0] = make_float4(q0[0], q0[1], q0[2], q0[3]);
    rs[L.s1] = make_float4(q1[0], q1[1], q1[2], q1[3]);
    __syncwarp();
#pragma unroll
    for (int e = 0; e < kAdmmEnvs; ++e) {
      x0[e] = 0.0f;
      x1[e] = 0.0f;
    }
    const int chunks = ((n + 1) / 2 + kKChunk - 1) / kKChunk;
    for (int c = 0; c < chunks; ++c) {
#pragma unroll
      for (int p = 0; p < kKChunk; ++p) {
        const int jp = kKChunk * c + p;
        const float4 k = kt[jp * 32 + L.lane];
        const float4 ra = rs[2 * jp], rb = rs[2 * jp + 1];
        const float va[4] = {ra.x, ra.y, ra.z, ra.w};
        const float vb[4] = {rb.x, rb.y, rb.z, rb.w};
#pragma unroll
        for (int e = 0; e < kAdmmEnvs; ++e) {
          x0[e] = fmaf(k.x, va[e], x0[e]);
          x1[e] = fmaf(k.y, va[e], x1[e]);
        }
#pragma unroll
        for (int e = 0; e < kAdmmEnvs; ++e) {
          x0[e] = fmaf(k.z, vb[e], x0[e]);
          x1[e] = fmaf(k.w, vb[e], x1[e]);
        }
      }
    }
  }

  // a, ub: the lane's two stations of each env; x gets the projected
  // actions and matvecs the mat-vecs with C run (the K mat-vecs are
  // `iters`). Every cone call is made by all lanes (they shuffle); lanes
  // outside the cones then take 0.
  template <int MP>
  __device__ __forceinline__ void project(
      const Operators& op, const AdmmCone<MP>& cone, const Lane& L,
      const float (&a0)[kAdmmEnvs], const float (&a1)[kAdmmEnvs],
      const float (&ub0)[kAdmmEnvs], const float (&ub1)[kAdmmEnvs],
      float (&x0)[kAdmmEnvs], float (&x1)[kAdmmEnvs],
      int (&matvecs)[kAdmmEnvs]) const {
    constexpr int E = kAdmmEnvs;
    float z00[E], z01[E], u00[E], u01[E], zc[E], uc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      x0[e] = fminf(fmaxf(a0[e], 0.0f), ub0[e]);
      x1[e] = fminf(fmaxf(a1[e], 0.0f), ub1[e]);
      z00[e] = x0[e];
      z01[e] = x1[e];
      u00[e] = 0.0f;
      u01[e] = 0.0f;
      const float c0 = cone.c_x(x0[e], x1[e], L);
      zc[e] = L.crow ? c0 : 0.0f;
      uc[e] = 0.0f;
      matvecs[e] = 1;
    }
    for (int it = 0; it < op.iters; ++it) {
      float y[E], d0[E], d1[E], q0[E], q1[E];
      int ran[E];
#pragma unroll
      for (int e = 0; e < E; ++e) y[e] = zc[e] - uc[e];
      cone.ct_y(y, L, d0, d1, ran);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        matvecs[e] += ran[e] + 1;  // and C x below
        // a + rho (z - u) + rho d, rounded as the one-env kernel does
        q0[e] = fmaf(rho, d0[e], fmaf(rho, z00[e] - u00[e], a0[e]));
        q1[e] = fmaf(rho, d1[e], fmaf(rho, z01[e] - u01[e], a1[e]));
      }
      k_rhs(q0, q1, L, op.n, x0, x1);
      // in phases over the envs, so that their chains of shuffles, square
      // roots and divisions overlap
      float xh0[E], xh1[E], cxh[E], v[E], nsq[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float c = cone.c_x(x0[e], x1[e], L);
        cxh[e] = L.crow ? c : 0.0f;  // C x, then the relaxed one below
      }
#pragma unroll
      for (int e = 0; e < E; ++e) {
        // the one-env kernel's roundings: fused with beta's product
        xh0[e] = fmaf(beta, z00[e], alpha * x0[e]);
        xh1[e] = fmaf(beta, z01[e], alpha * x1[e]);
        cxh[e] = fmaf(beta, zc[e], alpha * cxh[e]);
        z00[e] = fminf(fmaxf(xh0[e] + u00[e], 0.0f), ub0[e]);
        z01[e] = fminf(fmaxf(xh1[e] + u01[e], 0.0f), ub1[e]);
        v[e] = cxh[e] + uc[e];
        nsq[e] = pair_norm_sq(v[e], L.lane);
      }
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float nrm = sqrtf(nsq[e] + 1e-12f);
        zc[e] = L.crow ? v[e] * fminf(1.0f, rad / nrm) : 0.0f;
        u00[e] = u00[e] + xh0[e] - z00[e];
        u01[e] = u01[e] + xh1[e] - z01[e];
        uc[e] = uc[e] + cxh[e] - zc[e];
      }
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      x0[e] = fminf(fmaxf(x0[e], 0.0f), ub0[e]);
      x1[e] = fminf(fmaxf(x1[e], 0.0f), ub1[e]);
    }
  }
};

// env_step's projector in the ADMM kernel: the env's projection, already
// run for the whole warp by AdmmOp::project, and its mat-vecs.
struct Projected {
  float x0, x1;
  int matvecs;

  template <class Cone>
  __device__ __forceinline__ int operator()(const Operators&, const Cone&,
                                            const Lane&, float, float, float,
                                            float, float& p0, float& p1) const {
    p0 = x0;
    p1 = x1;
    return matvecs;
  }
};

template <int MP>
__global__ void __launch_bounds__(kAdmmWarps * 32, kAdmmBlocks)
ev_admm_segment_kernel(Operators op, AdmmArgs adm, const float* __restrict__ table,
                       int table_w, int rows_per_day,
                       const int64_t* __restrict__ days, int B, int T,
                       const float* __restrict__ acts, uint64_t seed,
                       float* __restrict__ out, float* __restrict__ acts_out,
                       unsigned long long* __restrict__ matvecs_out) {
  constexpr int E = kAdmmEnvs;
  __shared__ float4 kt[kKtPairs * 32];
  __shared__ float2 cpairs[MP * 32];
  __shared__ float4 rs[kAdmmWarps][kRsRows];
  __shared__ float4 ys[kAdmmWarps][MP];
  {
    float* ktf = reinterpret_cast<float*>(kt);
    for (int i = threadIdx.x; i < kKtPairs * 32 * 4; i += blockDim.x) {
      const int c = i & 3, l = (i >> 2) & 31, jp = i >> 7;
      const int s = l + 32 * (c & 1), j = 2 * jp + (c >> 1);
      ktf[i] = (s < op.n && j < op.n) ? adm.K[s * op.n + j] : 0.0f;
    }
    for (int i = threadIdx.x; i < MP * 32; i += blockDim.x) {
      const int k = i >> 5, l = i & 31;
      const bool row = k < op.m2;
      cpairs[i] = make_float2(row && l < op.n ? op.C[k * op.n + l] : 0.0f,
                              row && l + 32 < op.n ? op.C[k * op.n + l + 32] : 0.0f);
    }
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int e0 = (blockIdx.x * kAdmmWarps + warp) * E;
  if (e0 >= B) return;  // whole warps only: no block-wide sync follows
  const Lane L = make_lane(op);
  if (L.lane < 2)  // rs's zero rows past the stations
    rs[warp][kMaxStations + L.lane] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  AdmmCone<MP> cone;
  cone.load(op, L, ys[warp], cpairs);
  const AdmmOp admm{kt, rs[warp], adm.rho, adm.alpha, 1.0f - adm.alpha,
                    L.crow ? op.radii[L.lane >> 1] : 0.0f};
  const uint2 key = philox_key(seed);
  // an env past B (the last warp's) runs on zeros and writes nothing
  bool live[E];
  int day[E];
  Stations st[E];
#pragma unroll
  for (int i = 0; i < E; ++i) {
    live[i] = e0 + i < B;
    day[i] = (int)days[live[i] ? e0 + i : e0];
    st[i] = Stations{false, false, 0, 0, 0, 0, 0.0f, 0.0f};
  }
  unsigned long long matvecs = 0;
  const float kub = (float)kAPersToKwh;
  for (int t = 0; t < T; ++t) {
    float a0[E], a1[E], ub0[E], ub1[E], x0[E], x1[E];
    int mv[E];
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int e = e0 + i;
      if (!live[i]) {
        a0[i] = 0.0f;
        a1[i] = 0.0f;
      } else if (acts != nullptr) {
        const float* at = acts + ((size_t)t * B + e) * op.n;
        a0[i] = L.v0 ? at[L.s0] : 0.0f;
        a1[i] = L.v1 ? at[L.s1] : 0.0f;
      } else {
        const uint4 r = philox4x32_10(make_uint4(L.lane, t, e, 0u), key);
        a0[i] = uniform01(r.x);
        a1[i] = uniform01(r.y);
      }
      if (acts_out != nullptr && live[i]) {
        float* ao = acts_out + ((size_t)t * B + e) * op.n;
        if (L.v0) ao[L.s0] = fminf(fmaxf(a0[i], 0.0f), 1.0f);
        if (L.v1) ao[L.s1] = fminf(fmaxf(a1[i], 0.0f), 1.0f);
      }
      // env_step's clamp and upper bound, ahead of the joint projection
      a0[i] = L.v0 ? fminf(fmaxf(a0[i], 0.0f), 1.0f) : 0.0f;
      a1[i] = L.v1 ? fminf(fmaxf(a1[i], 0.0f), 1.0f) : 0.0f;
      const float u0 = fminf(1.0f, (st[i].pl0 ? st[i].dem0 : 0.0f) / kub / 32.0f);
      const float u1 = fminf(1.0f, (st[i].pl1 ? st[i].dem1 : 0.0f) / kub / 32.0f);
      ub0[i] = L.v0 ? u0 : 0.0f;
      ub1[i] = L.v1 ? u1 : 0.0f;
      x0[i] = 0.0f;
      x1[i] = 0.0f;
      mv[i] = 0;
    }
    if (op.project) admm.project(op, cone, L, a0, a1, ub0, ub1, x0, x1, mv);
#pragma unroll
    for (int i = 0; i < E; ++i) {
      if (!live[i]) continue;
      const float* row = table + ((size_t)day[i] * rows_per_day + t) * table_w;
      float* out4 = out + ((size_t)t * B + e0 + i) * 4;
      matvecs += env_step(op, Projected{x0[i], x1[i], mv[i]}, cone, L, st[i], a0[i],
                          a1[i], row, t, out4);
    }
  }
  if (matvecs_out != nullptr && L.lane == 0) atomicAdd(matvecs_out, matvecs);
}

__global__ void __launch_bounds__(kTile * 32, 2)
ev_policy_segment_kernel(Operators op, Actor ac, const float* __restrict__ table,
                         int table_w, int rows_per_day,
                         const float* __restrict__ moer, int moer_w, int k_fc,
                         const int64_t* __restrict__ days, int B, int T,
                         const float* __restrict__ noise, uint64_t seed,
                         int env_offset, float* __restrict__ out,
                         __nv_bfloat16* __restrict__ lrn) {
  extern __shared__ float smem[];  // dynamic: 16-byte aligned
  const int n = op.n, D = ac.D;
  SharedC sc{smem, smem + kMaxStations * kMaxConeRows};
  float* scratch = smem + 2 * kMaxStations * kMaxConeRows;  // [kTile][96]
  const ActorTiles at = carve_actor_tiles(
      reinterpret_cast<unsigned char*>(scratch + kTile * 96), D, ac.H, n);
  load_operator(op, sc);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int e = blockIdx.x * kTile + warp;
  const bool live = e < B;
  const int64_t day = live ? days[e] : 0;
  const int lw = D + n;  // learner row: obs (canonical flat order) | u
  __nv_bfloat16* my_obs = at.obs + warp * at.ld_obs;
  Stations st{false, false, 0, 0, 0, 0, 0.0f, 0.0f};
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    // ---- obs of the pre-event state in bf16, in flat order:
    // timestep | est_departures | demands | prev_moer | forecast
    const float* mrow = moer + ((size_t)day * rows_per_day + t) * moer_w;
    if (lane < n) {
      my_obs[1 + lane] = __float2bfloat16_rn(st.pl0 ? (float)(st.est0 - t) : 0.0f);
      my_obs[1 + n + lane] = __float2bfloat16_rn(st.pl0 ? st.dem0 : 0.0f);
    }
    if (lane + 32 < n) {
      my_obs[33 + lane] = __float2bfloat16_rn(st.pl1 ? (float)(st.est1 - t) : 0.0f);
      my_obs[33 + n + lane] = __float2bfloat16_rn(st.pl1 ? st.dem1 : 0.0f);
    }
    for (int i = lane; i < 1 + k_fc; i += 32)
      my_obs[1 + 2 * n + i] = __float2bfloat16_rn(mrow[i]);
    if (lane == 0) my_obs[0] = __float2bfloat16_rn((float)t / (float)kMaxTimestep);
    __syncthreads();
    actor_forward(ac, at, n);
    if (live) {
      // the lane's constants and scratch are set up again each step, so
      // that they hold no registers through the actor
      const Lane L = make_lane(op);
      float* xs = scratch + warp * 96;
      float* ys = xs + kMaxStations;
      const float* my_mu = at.mu + warp * at.ld_mu;
      __nv_bfloat16* lrow = lrn + ((size_t)t * B + e) * lw;
      for (int i = L.lane; i < D; i += 32) lrow[i] = my_obs[i];
      float z0, z1;
      if (noise != nullptr) {
        const float* nz = noise + ((size_t)t * B + e) * n;
        z0 = L.v0 ? nz[L.s0] : 0.0f;
        z1 = L.v1 ? nz[L.s1] : 0.0f;
      } else {
        // counted by the global env index: a launch over a slice of a
        // global batch draws that slice's numbers
        const float2 z = box_muller(philox4x32_10(
            make_uint4(L.lane, t, (unsigned)(env_offset + e), 1u), philox_key(seed)));
        z0 = z.x;
        z1 = z.y;
      }
      float a0 = 0.0f, a1 = 0.0f;
      if (L.v0) {
        const float u = my_mu[L.s0] + ac.sigma[L.s0] * z0;
        lrow[D + L.s0] = __float2bfloat16_rn(u);
        a0 = tanhf(u) * 0.5f + 0.5f;
      }
      if (L.v1) {
        const float u = my_mu[L.s1] + ac.sigma[L.s1] * z1;
        lrow[D + L.s1] = __float2bfloat16_rn(u);
        a1 = tanhf(u) * 0.5f + 0.5f;
      }
      env_step(op, FistaProj<false>{}, SharedCone{op, sc, xs, ys}, L, st, a0, a1,
               table + ((size_t)day * rows_per_day + t) * table_w, t,
               out + ((size_t)t * B + e) * 4);
    }
  }
}

size_t policy_smem_bytes(int D, int H, int n) {
  return sizeof(float) * (2 * kMaxStations * kMaxConeRows + kTile * 96) +
         actor_tiles_bytes(D, H, n);
}

using SimKernel = void (*)(Operators, AdmmArgs, const float*, int, int,
                           const int64_t*, int, int, const float*, uint64_t,
                           float*, float*, unsigned long long*);
// The simulation kernel's instance for m2 <= 32 cone rows (rounded up to 8)
// and the projection operator: ev_segment_kernel (dual FISTA, one env a
// warp) or ev_admm_segment_kernel (ADMM, kAdmmEnvs envs a warp).
SimKernel sim_kernel(int m2, bool admm) {
  switch ((m2 + 7) / 8) {
    case 0:
    case 1: return admm ? ev_admm_segment_kernel<8> : ev_segment_kernel<8>;
    case 2: return admm ? ev_admm_segment_kernel<16> : ev_segment_kernel<16>;
    case 3: return admm ? ev_admm_segment_kernel<24> : ev_segment_kernel<24>;
    default: return admm ? ev_admm_segment_kernel<32> : ev_segment_kernel<32>;
  }
}

// The simulation kernel's warps a CTA and envs a warp.
int sim_warps(bool admm) { return admm ? kAdmmWarps : kSimWarps; }
int sim_envs(bool admm) { return admm ? kAdmmEnvs : 1; }

}  // namespace

// ---- plain C interface (loaded with ctypes; returns a cudaError_t) ----

// K null: dual FISTA with `step`; K (n, n): ADMM with rho and alpha (step
// null). The projection runs only if `project`.
extern "C" int ev_segment_launch(
    const float* C, const float* radii, const float* step, const float* mags,
    const float* minp, int n, int m2, int iters, int restart, int project,
    const float* K, float rho, float alpha,
    const float* table, int table_w, int rows_per_day, const int64_t* days,
    int B, int T, const float* acts, uint64_t seed, float* out,
    float* acts_out, unsigned long long* matvecs_out, void* stream) {
  if (n > kMaxStations || m2 > kMaxConeRows || B <= 0 || T <= 0 ||
      (K == nullptr && step == nullptr))
    return (int)cudaErrorInvalidValue;
  Operators op{C, radii, step, mags, minp, n, m2, iters, restart, project};
  const bool admm = K != nullptr;
  const int per_cta = sim_warps(admm) * sim_envs(admm);
  const int grid = (B + per_cta - 1) / per_cta;
  sim_kernel(m2, admm)<<<grid, sim_warps(admm) * 32, 0, (cudaStream_t)stream>>>(
      op, AdmmArgs{K, rho, alpha}, table, table_w, rows_per_day, days, B, T,
      acts, seed, out, acts_out, matvecs_out);
  return (int)cudaGetLastError();
}

// The simulation kernel's instance for m2 cone rows and the operator (admm
// != 0: ADMM): CTAs resident per SM, warps a CTA, envs a warp, registers a
// thread and local memory a thread in bytes (spills).
extern "C" int ev_segment_ctas_per_sm(int m2, int admm, int* ctas, int* warps,
                                      int* envs, int* regs, int* local_bytes) {
  if (m2 > kMaxConeRows) return (int)cudaErrorInvalidValue;
  const SimKernel kernel = sim_kernel(m2, admm != 0);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  *warps = sim_warps(admm != 0);
  *envs = sim_envs(admm != 0);
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel,
                                                            *warps * 32, 0);
}

extern "C" int ev_policy_segment_launch(
    const float* C, const float* radii, const float* step, const float* mags,
    const float* minp, int n, int m2, int iters, int restart, int project,
    const void* w1, const float* b1, const void* w2, const float* b2,
    const void* wm, const float* bm, const float* sigma, int D, int H,
    const float* table, int table_w, int rows_per_day, const float* moer,
    int moer_w, int k_fc,
    const int64_t* days, int B, int T, const float* noise, uint64_t seed,
    int env_offset, float* out, __nv_bfloat16* lrn, void* stream) {
  if (n > kMaxStations || m2 > kMaxConeRows || B <= 0 || T <= 0 || env_offset < 0 ||
      D != 2 + 2 * n + k_fc || 1 + k_fc > moer_w)
    return (int)cudaErrorInvalidValue;
  Operators op{C, radii, step, mags, minp, n, m2, iters, restart, project};
  const Actor ac{static_cast<const uint4*>(w1), b1, static_cast<const uint4*>(w2),
                 b2, static_cast<const uint4*>(wm), bm, sigma, D, H};
  const size_t smem = policy_smem_bytes(D, H, n);
  cudaError_t err = cudaFuncSetAttribute(
      ev_policy_segment_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + kTile - 1) / kTile;
  ev_policy_segment_kernel<<<grid, kTile * 32, smem, (cudaStream_t)stream>>>(
      op, ac, table, table_w, rows_per_day, moer, moer_w, k_fc, days, B, T,
      noise, seed, env_offset, out, lrn);
  return (int)cudaGetLastError();
}

// CTAs of ev_policy_segment_kernel resident per SM for an actor (D, H, n).
extern "C" int ev_policy_segment_ctas_per_sm(int D, int H, int n, int* ctas) {
  const size_t smem = policy_smem_bytes(D, H, n);
  const cudaError_t err = cudaFuncSetAttribute(
      ev_policy_segment_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, ev_policy_segment_kernel, kTile * 32, smem);
}
