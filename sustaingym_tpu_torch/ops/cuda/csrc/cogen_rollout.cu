// Whole CogenEnv dispatch days on an NVIDIA Hopper card (sm_90a).
//
// Replaces the Pallas TPU kernel sustaingym_tpu/ops/pallas/cogen_rollout.py::
// fused_cogen_segment (_kernel): per env and step, an action (drawn in the
// kernel or prescribed), the plant surrogate of envs/cogen/plant.py over
// three gas turbines and the steam turbine, the 16 dynamic-constraint
// violations, and the fuel + ramp + non-delivery + violation reward of
// envs/cogen/env.py::step_core.
//
// What bounds it. Bytes: each env step writes 30 float rows (15 action, the
// reward and 14 info terms), 120 bytes, against ~300 float operations of
// surrogate and reward, so the output stream (3.0 GB at 262144 x 96) takes
// longer at the memory rate than the arithmetic at the f32 rate. The
// inputs are small: the padded ambient table (0.77 MB, L2-resident), a
// day index and 15 reset actions per env.
//
// Design. One thread per env loops over the T steps of one day, carrying
// the previous power set points in registers for the ramp term. It reads
// the step's ambient row straight from the padded (day, row, channel)
// table by day index, where the TPU kernel read it from the block the
// slice-gather kernel had packed: the same numbers, without writing and
// reading the block. Output is (30, T, B), env-minor, so the threads of a
// warp store consecutive floats. The TPU layout (envs on 128 lanes, `il`
// interleaved groups, 16 and 32 padded rows) does not carry over.
//
// Numerics. The plain version (ops/cuda/cogen_rollout.py::
// cogen_segment_ref) runs the same float32 operations one PyTorch op at a
// time, so this file is built with -fmad=false (no multiply-add
// contraction), every literal carries an f suffix, plant constants are
// floats rounded once, sums run left to right, divisions are IEEE and the
// powers are powf, as PyTorch's pow. Relus at active constraint boundaries
// times the 1000 penalties amplify any ulp difference, which is why the
// parity bound is rtol 2e-5 / atol 0.2.
//
// Random draws: Philox4x32-10 (philox.cuh) counted by (row group, step,
// env, stream 2): Box components low + u (high - low), switches
// u < 0.5 ? 0 : 1, bays floor(12 u) + 1, as the TPU kernel's RNG mode.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kActs = 15;
constexpr int kThreads = 256;

// flat action bounds (envs/cogen/env.py ACTION_LOW / ACTION_HIGH)
__constant__ float kActLow[kActs] = {
    41.640958739408575f, 0.0f, 0.0f, 403.158098976746f,
    41.4901380260007f, 0.0f, 0.0f, 396.6747280218317f,
    46.46162639456023f, 0.0f, 0.0f, 438.9994717062812f,
    25.653593808895327f, -1218.227252306133f, 1.0f};
__constant__ float kActHigh[kActs] = {
    168.26699084133313f, 1.0f, 1.0f, 819.5712701252007f,
    168.41364372684487f, 1.0f, 1.0f, 817.3514297249753f,
    172.43912889854244f, 1.0f, 1.0f, 870.265011732758f,
    83.53805140752395f, -318.0558547331499f, 12.0f};

// per gas turbine constants of envs/cogen/plant.py
struct GtConst {
  float pwr_hi, fuel_max, hr_lo, hr_hi;
  float pmin_lo, pmin_hi, pmax_lo, pmax_hi;
  float smin_lo, smin_hi, smax_lo, smax_hi;
};
__constant__ GtConst kGt[3] = {
    {168.26699084133313f, 76.69372527575013f, 403.158098976746f,
     819.5712701252007f, 51.226136f, 159.372284f, 104.556475f, 168.765869f,
     297.682785f, 496.926494f, 548.318195f, 849.448828f},
    {168.41364372684487f, 76.5767979002884f, 396.6747280218317f,
     817.3514297249753f, 51.154142f, 159.385700f, 104.663273f, 168.816834f,
     297.101498f, 494.038342f, 550.350075f, 850.610284f},
    {172.43912889854244f, 74.85078517549726f, 438.9994717062812f,
     870.265011732758f, 53.382063f, 163.718997f, 106.848688f, 172.422358f,
     328.001105f, 533.750224f, 594.735073f, 894.579579f}};
constexpr float kDbFuelMax = 18.302679412053344f;
constexpr float kStMaxClip = 193.2981069908212f;
constexpr float kStMinLo = 25.603735384829225f, kStMinHi = 251.5737866469593f;
constexpr float kIpMinLo = -1901.360063349245f, kIpMinHi = -317.85686602279907f;
constexpr float kIpMaxLo = -469.4936696089783f, kIpMaxHi = -317.82291691135345f;
constexpr float kAuxLo = 1.2668176093005532f, kAuxHi = 22.42884599132708f;

struct Penalties {
  float ramp, imbalance, violation;
};

__device__ __forceinline__ float relu(float v) { return fmaxf(v, 0.0f); }
__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ bool is_switch(int i) {
  return i == 1 || i == 2 || i == 5 || i == 6 || i == 9 || i == 10;
}

__global__ void __launch_bounds__(kThreads)
cogen_segment_kernel(const float* __restrict__ amb, int rows_per_day,
                     int chans, const int64_t* __restrict__ days,
                     const float* __restrict__ prev0,
                     const float* __restrict__ acts, Penalties pen, int B,
                     int T, uint64_t seed, float* __restrict__ out) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= B) return;
  const uint2 key = philox_key(seed);
  const float* day_rows = amb + (size_t)days[e] * rows_per_day * chans;
  const size_t row_stride = (size_t)T * B;  // between output rows
  // previous power set points of GT1, GT2, GT3 and ST: action rows 4k
  float prev_pwr[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) prev_pwr[k] = prev0[(size_t)e * kActs + 4 * k];

  for (int t = 0; t < T; ++t) {
    float a[kActs];
    if (acts != nullptr) {
      const float* at = acts + ((size_t)t * B + e) * kActs;
#pragma unroll
      for (int i = 0; i < kActs; ++i) a[i] = at[i];
    } else {
      float u[16];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const uint4 r = philox4x32_10(make_uint4(g, t, e, 2u), key);
        u[4 * g] = uniform01(r.x);
        u[4 * g + 1] = uniform01(r.y);
        u[4 * g + 2] = uniform01(r.z);
        u[4 * g + 3] = uniform01(r.w);
      }
#pragma unroll
      for (int i = 0; i < kActs; ++i)
        a[i] = is_switch(i) ? (u[i] < 0.5f ? 0.0f : 1.0f)
                            : kActLow[i] + u[i] * (kActHigh[i] - kActLow[i]);
      a[14] = floorf(u[14] * 12.0f) + 1.0f;  // cooling-tower bays 1..12
    }

    // ---- plant surrogate (plant.py::plant_model) ----
    const float* row = day_rows + (size_t)t * chans;
    const float tamb = row[0], pamb = row[1], rh = row[2];
    const float tgt_pwr = row[3], tgt_steam = row[4];
    const float pac[3] = {a[1], a[5], a[9]};
    const float evc[3] = {a[2], a[6], a[10]};
    const float pwr[3] = {a[0], a[4], a[8]};
    const float hrs[3] = {a[3], a[7], a[11]};
    const float st_pwr = a[12], ipproc = a[13], nbays = a[14];

    const float depression = 0.35f * fmaxf(tamb - 32.0f, 0.0f) * (1.0f - rh);
    const float pressure_gain = powf(pamb / 14.6f, 0.3f);
    float fuel[3], pmin[3], pmax[3], smin[3], smax[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const GtConst& c = kGt[i];
      const float teff = tamb - 0.85f * evc[i] * depression;
      const float hot = fmaxf(teff - 59.0f, 0.0f);
      const float cold = fmaxf(59.0f - teff, 0.0f);
      pmax[i] = clip(c.pwr_hi * (1.0f - 0.0042f * hot + 0.0006f * cold) *
                         (1.0f + 0.035f * pac[i]) * pressure_gain,
                     c.pmax_lo, c.pmax_hi);
      const float tnorm = clip((teff - 32.0f) / 83.0f, 0.0f, 1.0f);
      pmin[i] = c.pmin_lo + (c.pmin_hi - c.pmin_lo) * 0.45f * powf(tnorm, 1.5f);
      const float load = pwr[i] / c.pwr_hi;
      const float amb_fuel = 1.0f + 0.0015f * hot - 0.0004f * cold;
      const float gt_fuel =
          fminf(fmaxf(c.fuel_max * amb_fuel * (1.0f + 0.02f * pac[i]) *
                          (0.08f + 0.82f * load + 0.10f * (load * load)),
                      0.0f),
                c.fuel_max);
      const float unfired = c.hr_lo * 1.02f + (c.hr_hi * 0.82f - c.hr_lo) * load;
      const float db_steam = fmaxf(hrs[i] - unfired, 0.0f);
      const float db_span = c.hr_hi - unfired + 1e-6f;
      const float db_fuel = clip(kDbFuelMax * db_steam / db_span, 0.0f, kDbFuelMax);
      smin[i] = clip(0.72f * unfired, c.smin_lo, c.smin_hi);
      smax[i] = clip(unfired + 0.22f * c.hr_hi, c.smax_lo, c.smax_hi);
      fuel[i] = gt_fuel + db_fuel;
    }
    const float hr_total = hrs[0] + hrs[1] + hrs[2];
    const float st_max = clip(0.09f * hr_total + 0.05f * (-ipproc) - 40.0f +
                                  1.5f * (nbays - 6.0f),
                              0.0f, kStMaxClip);
    const float st_min = clip(0.03f * hr_total - 20.0f, kStMinLo, kStMinHi);
    const float ipld_min = clip(-0.17f * hr_total + 12.0f, kIpMinLo, kIpMinHi);
    const float ipld_max = clip(-0.18f * hr_total, kIpMaxLo, kIpMaxHi);
    const float plant_fuel = fuel[0] + fuel[1] + fuel[2];
    const float pwr_sum = pwr[0] + pwr[1] + pwr[2];
    const float aux = clip(2.0f + 0.02f * (pwr_sum + st_pwr) + 0.35f * nbays +
                               0.5f * (pac[0] + pac[1] + pac[2]),
                           kAuxLo, kAuxHi);
    const float net_pwr = pwr_sum + st_pwr - aux;
    const float proc_steam = hr_total + ipproc;

    // ---- reward (env.py::step_core) ----
    float ramp[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) ramp[k] = pen.ramp * fabsf(a[4 * k] - prev_pwr[k]);
    const float total_ramp = ramp[0] + ramp[1] + ramp[2] + ramp[3];
    float cv[4];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      cv[i] = pen.violation * (relu(pmin[i] - pwr[i]) + relu(pwr[i] - pmax[i]) +
                               relu(smin[i] - hrs[i]) + relu(hrs[i] - smax[i]));
    cv[3] = pen.violation * (relu(st_min - st_pwr) + relu(st_pwr - st_max) +
                             relu(ipproc - ipld_min) + relu(ipproc - ipld_max));
    const float total_cv = cv[0] + cv[1] + cv[2] + cv[3];
    const float non_delivery =
        pen.imbalance * (relu(tgt_steam - proc_steam) + relu(tgt_pwr - net_pwr));
    const float reward = -(plant_fuel + total_ramp + non_delivery + total_cv);

    // ---- rows: action | reward | fuel x3 | ramp x4 | cv x4 | nd | net | steam
    float* o = out + (size_t)t * B + e;
#pragma unroll
    for (int i = 0; i < kActs; ++i) o[i * row_stride] = a[i];
    o[15 * row_stride] = reward;
#pragma unroll
    for (int i = 0; i < 3; ++i) o[(16 + i) * row_stride] = fuel[i];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      o[(19 + k) * row_stride] = ramp[k];
      o[(23 + k) * row_stride] = cv[k];
    }
    o[27 * row_stride] = non_delivery;
    o[28 * row_stride] = net_pwr;
    o[29 * row_stride] = proc_steam;
#pragma unroll
    for (int k = 0; k < 4; ++k) prev_pwr[k] = a[4 * k];
  }
}

}  // namespace

// ---- plain C interface (loaded with ctypes; returns a cudaError_t) ----

extern "C" int cogen_segment_launch(const float* amb, int rows_per_day,
                                    int chans, const int64_t* days,
                                    const float* prev0, const float* acts,
                                    float ramp_penalty, float imbalance_penalty,
                                    float violation_penalty, int B, int T,
                                    uint64_t seed, float* out, void* stream) {
  if (B <= 0 || T <= 0 || T > rows_per_day || chans < 5)
    return (int)cudaErrorInvalidValue;
  const Penalties pen{ramp_penalty, imbalance_penalty, violation_penalty};
  const int grid = (B + kThreads - 1) / kThreads;
  cogen_segment_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      amb, rows_per_day, chans, days, prev0, acts, pen, B, T, seed, out);
  return (int)cudaGetLastError();
}
