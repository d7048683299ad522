// The clipped-PPO minibatch loss of a diagonal-Gaussian policy head and its
// gradient, in one pass over the rows, on an NVIDIA Hopper card (sm_90a).
// It replaces no TPU kernel: the JAX package leaves this loss to XLA, which
// fuses it; eager PyTorch runs it as ~90 kernels a minibatch.
//
// Inputs: mu (rows, A) and value (rows,) with any row stride (the two parts
// of one (rows, A + 1) head product, read in place), log_std (A,), u
// (rows, A), logp_old, adv and ret (rows,), all float32.
//   a_r     = (adv_r - mean(adv)) / (std(adv) + 1e-8)     population std
//   logp_r  = sum_j -0.5 ((u_rj - mu_rj)^2 / exp(2 ls_j) + 2 ls_j + log 2 pi)
//   ratio_r = exp(logp_r - logp_old_r)
//   m_r     = min(ratio_r a_r, clamp(ratio_r, 1 - eps, 1 + eps) a_r)
//   pg = -mean(m), vf = 0.5 mean((value - ret)^2),
//   ent = sum_j (ls_j + 0.5 log(2 pi e)),
//   loss = pg + vf_coef vf - ent_coef ent,
// and d loss / d mu, d value (written with row strides of their own, so
// that they can fill one (rows, A + 1) gradient of the head product) and
// d log_std, by autograd's rules: the minimum splits a tie in half between
// its operands (inside the clip range the two are equal, so the whole
// gradient flows), the clamp passes the gradient at its bounds, which are
// inclusive, and d log_std adds the entropy's -ent_coef to the log-prob's
// part summed over the rows.
//
// What bounds it. Bytes: mu, u and the five row vectors read once, the
// gradient written once: 16.4 MB at 24576 x 54, 4.9 us at 3.35 TB/s. The
// arithmetic is a few operations an element.
//
// Design. Three launches, no atomics, so the result is the same bit for bit
// from call to call (captured and eager train steps are compared so):
//  1. ppo_loss_moments_kernel: each CTA's (count, mean, M2) of a slice of
//     adv, Welford in a thread, Chan's combination across threads in a
//     fixed tree;
//  2. ppo_loss_row_kernel: one warp takes kRowsPerWarp rows, each lane the
//     elements j = lane, lane + 32, ... of each. First one warp of the CTA
//     combines the moments' partials in one fixed order (every CTA holds
//     the same mean and std). A row's log-prob sum is compensated
//     (TwoSum) and reduced by an xor butterfly, which leaves the same bits
//     in every lane; the row's gradient is written and its d log_std terms
//     are summed a column a lane. Each CTA writes its column sums and its
//     sums of the pg and vf terms as partials, column-major;
//  3. ppo_loss_final_kernel: one CTA, a warp a column, sums the partials in
//     a fixed order and forms the four scalars and d log_std.
// The float32 arithmetic keeps IEEE expf, sqrtf and division (no fast
// math).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                       // row and moment passes
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerCta = kWarps * kRowsPerWarp;
constexpr int kMomentRows = 256;                    // rows per moment CTA
constexpr int kMaxMomentCtas = 1024;
constexpr int kFinalThreads = 1024;
constexpr int kMaxActDim = 1024;  // shared memory: 40 B a column
// log(2 pi) rounded to float32, as PyTorch rounds it in the scoring's
// log-prob: a ratio divides the two, so their terms round alike
constexpr float kLog2Pi = 1.8378770664093453f;
constexpr float kEntTerm = 1.4189385332046727f;     // 0.5 log(2 pi e)
constexpr unsigned kAll = 0xffffffffu;

struct Moments {
  float n, mean, m2;
};

// Chan et al.'s combination of two partial (count, mean, M2).
__device__ __forceinline__ Moments combine(Moments a, Moments b) {
  const float n = a.n + b.n;
  if (n == 0.0f) return a;
  const float delta = b.mean - a.mean;
  const float wb = b.n / n;
  return {n, a.mean + delta * wb, a.m2 + b.m2 + delta * delta * a.n * wb};
}

__device__ __forceinline__ Moments warp_moments(Moments m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Moments o = {__shfl_down_sync(kAll, m.n, off),
                       __shfl_down_sync(kAll, m.mean, off),
                       __shfl_down_sync(kAll, m.m2, off)};
    m = combine(m, o);
  }
  return m;  // lane 0's is the warp's
}

// s + t with its rounding error added to c (Knuth's TwoSum: the error is
// exact, so two lanes that add the same pair in either order agree).
__device__ __forceinline__ void two_sum(float& s, float& c, float t) {
  const float sum = s + t;
  const float tt = sum - s;
  const float err = (s - (sum - tt)) + (t - tt);
  s = sum;
  c += err;
}

// One element's log-prob term.
__device__ __forceinline__ float logp_term(float d, float var, float two_ls) {
  return -0.5f * (d * d / var + two_ls + kLog2Pi);
}

// The butterfly of a compensated sum over the warp: every lane ends with
// the same (s, c).
__device__ __forceinline__ void warp_two_sum(float& s, float& c) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float so = __shfl_xor_sync(kAll, s, off);
    const float co = __shfl_xor_sync(kAll, c, off);
    c += co;
    two_sum(s, c, so);
  }
}

// A row's pg term m and d m / d logp (g), from its log-prob sum s + c.
__device__ __forceinline__ void row_terms(float s, float c, float lp_old,
                                          float adv, float mean, float den,
                                          float lo, float hi, float& m,
                                          float& g) {
  // logp - logp_old, with the compensation added after the difference of
  // the two (near) equal logs
  const float ratio = expf((s - lp_old) + c);
  const float a = (adv - mean) / den;
  const float clipped = ratio < lo ? lo : ratio > hi ? hi : ratio;
  const float s1 = ratio * a, s2 = clipped * a;
  m = (s1 < s2 || s1 != s1) ? s1 : s2;
  // the minimum's split, then the clamp's mask on the second operand
  const float w1 = s1 < s2 ? 1.0f : s1 == s2 ? 0.5f : 0.0f;
  const float w2 = s2 < s1 ? 1.0f : s1 == s2 ? 0.5f : 0.0f;
  const bool inside = ratio >= lo && ratio <= hi;
  g = ratio * a * (w1 + (inside ? w2 : 0.0f));
}

int moment_ctas(int rows) {
  const int need = (rows + kMomentRows - 1) / kMomentRows;
  return need < kMaxMomentCtas ? need : kMaxMomentCtas;
}

int row_ctas(int rows) { return (rows + kRowsPerCta - 1) / kRowsPerCta; }

__global__ void __launch_bounds__(kThreads)
ppo_loss_moments_kernel(const float* __restrict__ adv, int rows, int chunk,
                        float* __restrict__ part) {
  const int lo = blockIdx.x * chunk;
  const int hi = min(rows, lo + chunk);
  Moments m = {0.0f, 0.0f, 0.0f};
  for (int r = lo + threadIdx.x; r < hi; r += kThreads) {
    const float x = adv[r];
    m.n += 1.0f;
    const float d = x - m.mean;
    m.mean += d / m.n;
    m.m2 += d * (x - m.mean);
  }
  __shared__ Moments warps[kWarps];
  m = warp_moments(m);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warps[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kWarps ? warps[lane] : Moments{0.0f, 0.0f, 0.0f};
    m = warp_moments(m);
    if (lane == 0) {
      part[3 * blockIdx.x] = m.n;
      part[3 * blockIdx.x + 1] = m.mean;
      part[3 * blockIdx.x + 2] = m.m2;
    }
  }
}

struct RowArgs {
  const float* mu;
  int64_t mu_stride;
  const float* log_std;
  const float* value;
  int64_t value_stride;
  const float* u;
  const float* logp_old;
  const float* adv;
  const float* ret;
  int rows, A;
  const float* moments;
  int n_moments;
  float clip_lo, clip_hi, vf_coef;
  float* d_mu;
  int64_t d_mu_stride;
  float* d_value;
  int64_t d_value_stride;
  float* part;
};

// Shared memory: var[A], two_ls[A], each warp's column sums [kWarps][A].
__global__ void __launch_bounds__(kThreads)
ppo_loss_row_kernel(const RowArgs p) {
  extern __shared__ float smem[];
  const int A = p.A;
  float* var = smem;
  float* two_ls = smem + A;
  float* acc = smem + 2 * A;
  __shared__ float s_mean, s_den, s_pg[kWarps], s_vf[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * kRowsPerCta + warp * kRowsPerWarp;
  for (int j = threadIdx.x; j < A; j += kThreads) {
    const float t = 2.0f * p.log_std[j];
    two_ls[j] = t;
    var[j] = expf(t);
  }
  if (warp == 0) {
    Moments m = {0.0f, 0.0f, 0.0f};
    for (int q = lane; q < p.n_moments; q += 32)
      m = combine(m, {p.moments[3 * q], p.moments[3 * q + 1],
                      p.moments[3 * q + 2]});
    m = warp_moments(m);
    if (lane == 0) {
      s_mean = m.mean;
      s_den = sqrtf(m.m2 / m.n) + 1e-8f;
    }
  }
  for (int i = threadIdx.x; i < kWarps * A; i += kThreads) acc[i] = 0.0f;
  __syncthreads();
  const float n = (float)p.rows;
  const float mean = s_mean, den = s_den;
  float pg_sum = 0.0f, vf_sum = 0.0f;
  float* col = acc + warp * A;
  for (int k = 0; k < kRowsPerWarp && r0 + k < p.rows; ++k) {
    const int64_t r = r0 + k;
    const float* mrow = p.mu + r * p.mu_stride;
    const float* urow = p.u + r * A;
    float s = 0.0f, c = 0.0f;
    for (int j = lane; j < A; j += 32)
      two_sum(s, c, logp_term(urow[j] - mrow[j], var[j], two_ls[j]));
    warp_two_sum(s, c);
    float m, g;
    row_terms(s, c, p.logp_old[r], p.adv[r], mean, den, p.clip_lo,
              p.clip_hi, m, g);
    const float dlogp = -g / n;
    for (int j = lane; j < A; j += 32) {
      const float dd = urow[j] - mrow[j];
      const float q = dd / var[j];
      p.d_mu[r * p.d_mu_stride + j] = dlogp * q;
      col[j] += g * (dd * q - 1.0f);
    }
    const float dv = p.value[r * p.value_stride] - p.ret[r];
    if (lane == 0) p.d_value[r * p.d_value_stride] = p.vf_coef * dv / n;
    pg_sum += m;
    vf_sum += dv * dv;
  }
  if (lane == 0) {
    s_pg[warp] = pg_sum;
    s_vf[warp] = vf_sum;
  }
  __syncthreads();
  const int ctas = gridDim.x;
  for (int j = threadIdx.x; j < A; j += kThreads) {
    float t = 0.0f;
    for (int w = 0; w < kWarps; ++w) t += acc[w * A + j];
    p.part[(int64_t)j * ctas + blockIdx.x] = t;
  }
  if (threadIdx.x == 0) {
    float pg = 0.0f, vf = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      pg += s_pg[w];
      vf += s_vf[w];
    }
    p.part[(int64_t)A * ctas + blockIdx.x] = pg;
    p.part[(int64_t)(A + 1) * ctas + blockIdx.x] = vf;
  }
}

// out: loss, pg, vf, ent, then d log_std [A].
__global__ void __launch_bounds__(kFinalThreads)
ppo_loss_final_kernel(const float* __restrict__ part, int n_part, int A,
                      int rows, const float* __restrict__ log_std,
                      float vf_coef, float ent_coef,
                      float* __restrict__ out) {
  extern __shared__ float sums[];   // [A + 2]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int col = warp; col < A + 2; col += kFinalThreads / 32) {
    const float* q = part + (int64_t)col * n_part;
    // four running sums, so that four loads are in flight
    float t0 = 0.0f, t1 = 0.0f, t2 = 0.0f, t3 = 0.0f;
    int i = lane;
    for (; i + 96 < n_part; i += 128) {
      t0 += q[i];
      t1 += q[i + 32];
      t2 += q[i + 64];
      t3 += q[i + 96];
    }
    for (; i < n_part; i += 32) t0 += q[i];
    float t = (t0 + t1) + (t2 + t3);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) t += __shfl_down_sync(kAll, t, off);
    if (lane == 0) sums[col] = t;
  }
  __syncthreads();
  const float n = (float)rows;
  for (int j = threadIdx.x; j < A; j += kFinalThreads)
    out[4 + j] = -(sums[j] / n) - ent_coef;
  if (threadIdx.x == 0) {
    float ent = 0.0f;
    for (int j = 0; j < A; ++j) ent += log_std[j] + kEntTerm;
    const float pg = -(sums[A] / n);
    const float vf = 0.5f * (sums[A + 1] / n);
    out[0] = pg + vf_coef * vf - ent_coef * ent;
    out[1] = pg;
    out[2] = vf;
    out[3] = ent;
  }
}

}  // namespace

// ---- plain C interface (loaded with ctypes; returns a cudaError_t) ----

// The floats of the work buffer a call needs for rows x A.
extern "C" int ppo_gauss_loss_workspace(int rows, int A) {
  return 3 * moment_ctas(rows) + (A + 2) * row_ctas(rows);
}

extern "C" int ppo_gauss_loss_launch(
    const float* mu, int64_t mu_stride, const float* log_std,
    const float* value, int64_t value_stride, const float* u,
    const float* logp_old, const float* adv, const float* ret, int rows,
    int A, float clip_lo, float clip_hi, float vf_coef, float ent_coef,
    float* d_mu, int64_t d_mu_stride, float* d_value,
    int64_t d_value_stride, float* work, float* out, void* stream) {
  if (rows <= 0 || rows >= (1 << 24) || A <= 0 || A > kMaxActDim)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int n_moments = moment_ctas(rows);
  const int chunk = (rows + n_moments - 1) / n_moments;
  const int n_part = row_ctas(rows);
  float* moments = work;
  float* part = work + 3 * n_moments;
  ppo_loss_moments_kernel<<<n_moments, kThreads, 0, st>>>(adv, rows, chunk,
                                                          moments);
  const RowArgs args = {mu, mu_stride, log_std, value, value_stride, u,
                        logp_old, adv, ret, rows, A, moments, n_moments,
                        clip_lo, clip_hi, vf_coef, d_mu, d_mu_stride,
                        d_value, d_value_stride, part};
  const size_t row_smem = (2 + kWarps) * A * sizeof(float);
  ppo_loss_row_kernel<<<n_part, kThreads, row_smem, st>>>(args);
  ppo_loss_final_kernel<<<1, kFinalThreads, (A + 2) * sizeof(float), st>>>(
      part, n_part, A, rows, log_std, vf_coef, ent_coef, out);
  return (int)cudaGetLastError();
}
