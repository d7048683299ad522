// The elementwise glue between the GEMMs of the PPO actor-critic's bf16
// trunk (parallel/ppo.py::policy_apply_bf16), forward and backward, on an
// NVIDIA Hopper card (sm_90a). It replaces no TPU kernel: the JAX package
// leaves this glue to XLA, which fuses it into its GEMMs' neighbours; eager
// PyTorch runs it as ~10 memory-bound kernels a hidden layer.
//
// Forward pass of a hidden layer, on the (rows, H) float32 GEMM output a and
// the bias b (H,):
//   y = tanhf(a + b)          float32, kept for the backward (in place of a)
//   h = bf16(y)               round to nearest even, the next GEMM's operand
// With grad off (the scoring pass) y is not stored.
//
// Backward pass of a hidden layer, on the float32 product p = g @ W of the
// layer above (before any rounding) and the saved y:
//   d  = float(bf16(p)) * (1 - y * y)   the pre-activation gradient (in
//                                        place of p): the bf16 cast of the
//                                        gradient and its backward, then
//                                        tanh's backward as autograd has it
//   hf = float(bf16(y))                 the float32 copy of the layer's bf16
//                                        output, the operand of the weight
//                                        gradient above (in place of y)
//   db = sum over the rows of d         the bias gradient
// and, where given, the float32 copy of a bf16 tensor x (the first layer's
// input), for that layer's weight gradient.
//
// What bounds it. Bytes: at 24576 x 256 a forward pass reads 25.2 MB and
// writes 37.7 MB; a backward pass reads 50.3 MB and writes 50.3 MB (and the
// first layer's copy of its 146-wide input 7.2 MB in, 14.4 MB out): ~19 us
// and ~30-36 us at 3.35 TB/s. tanhf is ~20 operations an element, far below
// the card's rate.
//
// Design. Each thread takes 8 consecutive elements of a row: two 16-byte
// float32 loads and stores, one 16-byte bf16 store. A CTA has a multiple of
// H / 8 threads and the grid a multiple of that, so a thread's columns stay
// the same through its grid-stride loop: it loads its 8 biases once, and in
// the backward it sums its 8 columns of d in registers. A CTA then sums its
// threads' columns in a fixed order into one partial row; a second launch
// sums the partial rows of each column (a warp a column, fixed lanes and a
// fixed tree). The backward's grid holds two CTAs an SM, so the second
// launch reads 264 partial rows on 132 SMs, not the forward's ~1000. No atomics: the bias gradient is the same bit for bit from
// call to call (captured and eager train steps are compared so). The
// float32 arithmetic keeps IEEE tanhf (no fast math); d's expression is
// PyTorch's tanh_backward's, so nvcc contracts it alike.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;              // elements a thread takes at a time
constexpr int kMaxHidden = 2048;     // H / 8 threads fit in a CTA
// Forward: CTAs of at most 256 threads, at most 8 an SM. Backward: CTAs of
// at most 512 threads, at most 2 an SM, so that few partial rows of the
// bias sums are left for the second launch to read.
constexpr int kFwdThreads = 256, kFwdCtasPerSm = 8;
constexpr int kBwdThreads = 512, kBwdCtasPerSm = 2;
constexpr int kFinalThreads = 256;   // a warp a column
constexpr unsigned kAll = 0xffffffffu;

// A CTA's threads: the largest multiple of H / 8 up to `most` (H / 8 <=
// 256 <= most).
int cta_threads(int H, int most) {
  const int v = H / kVec;
  return v * (most / v);
}

int grid_ctas(int64_t rows, int H, int threads, int most) {
  const int64_t vecs = rows * (H / kVec);
  const int64_t need = (vecs + threads - 1) / threads;
  return (int)(need < most ? need : most);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <bool kKeep>
__global__ void __launch_bounds__(kFwdThreads)
trunk_fwd_kernel(float* __restrict__ a, const float* __restrict__ bias,
                 uint4* __restrict__ h, int64_t vecs, int H) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int col = (threadIdx.x % (H / kVec)) * kVec;
  float b[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) b[j] = bias[col + j];
  float4* a4 = reinterpret_cast<float4*>(a);
  for (; i < vecs; i += stride) {
    const float4 lo = a4[2 * i], hi = a4[2 * i + 1];
    float y[kVec] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int j = 0; j < kVec; ++j) y[j] = tanhf(y[j] + b[j]);
    if (kKeep) {
      a4[2 * i] = make_float4(y[0], y[1], y[2], y[3]);
      a4[2 * i + 1] = make_float4(y[4], y[5], y[6], y[7]);
    }
    h[i] = make_uint4(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]),
                      pack_bf16(y[4], y[5]), pack_bf16(y[6], y[7]));
  }
}

// Shared memory: each thread group's column sums [threads / (H / 8)][H].
__global__ void __launch_bounds__(kBwdThreads)
trunk_bwd_kernel(float* __restrict__ p, float* __restrict__ y, int64_t vecs,
                 int H, const uint16_t* __restrict__ x,
                 float* __restrict__ xf, int64_t nx,
                 float* __restrict__ part) {
  extern __shared__ float groups[];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int v = H / kVec;
  const int col = (threadIdx.x % v) * kVec;
  float acc[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) acc[j] = 0.0f;
  float4* p4 = reinterpret_cast<float4*>(p);
  float4* y4 = reinterpret_cast<float4*>(y);
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < vecs;
       i += stride) {
    const float4 plo = p4[2 * i], phi = p4[2 * i + 1];
    const float4 ylo = y4[2 * i], yhi = y4[2 * i + 1];
    const float g[kVec] = {plo.x, plo.y, plo.z, plo.w,
                           phi.x, phi.y, phi.z, phi.w};
    const float t[kVec] = {ylo.x, ylo.y, ylo.z, ylo.w,
                           yhi.x, yhi.y, yhi.z, yhi.w};
    float d[kVec], hf[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float a = round_bf16(g[j]), b = t[j];
      d[j] = a * (1.0f - b * b);
      hf[j] = round_bf16(b);
      acc[j] += d[j];
    }
    p4[2 * i] = make_float4(d[0], d[1], d[2], d[3]);
    p4[2 * i + 1] = make_float4(d[4], d[5], d[6], d[7]);
    y4[2 * i] = make_float4(hf[0], hf[1], hf[2], hf[3]);
    y4[2 * i + 1] = make_float4(hf[4], hf[5], hf[6], hf[7]);
  }
  // the CTA's partial row: its thread groups' sums in group order
  const int group = threadIdx.x / v;
#pragma unroll
  for (int j = 0; j < kVec; ++j) groups[group * H + col + j] = acc[j];
  __syncthreads();
  const int n_groups = blockDim.x / v;
  for (int c = threadIdx.x; c < H; c += blockDim.x) {
    float s = 0.0f;
    for (int k = 0; k < n_groups; ++k) s += groups[k * H + c];
    part[(int64_t)blockIdx.x * H + c] = s;
  }
  // the float32 copy of x, 8 elements at a time where both are 16-byte
  // aligned, else one at a time
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (nx == 0) return;
  const bool vec = (((uintptr_t)x | (uintptr_t)xf) & 15) == 0;
  const int64_t nv = vec ? nx / kVec : 0;
  const uint4* x8 = reinterpret_cast<const uint4*>(x);
  float4* xf4 = reinterpret_cast<float4*>(xf);
  for (int64_t i = tid; i < nv; i += stride) {
    const uint4 q = x8[i];
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
    float f[kVec];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      f[2 * j] = __uint_as_float(w[j] << 16);
      f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
    xf4[2 * i] = make_float4(f[0], f[1], f[2], f[3]);
    xf4[2 * i + 1] = make_float4(f[4], f[5], f[6], f[7]);
  }
  for (int64_t i = nv * kVec + tid; i < nx; i += stride)
    xf[i] = __uint_as_float((uint32_t)x[i] << 16);
}

// db[c] = the sum of part[0..n_part)[c]: a warp a column, lane l summing
// the rows l, l + 32, ... in four running sums, then a fixed tree.
__global__ void __launch_bounds__(kFinalThreads)
trunk_bias_kernel(const float* __restrict__ part, int n_part, int H,
                  float* __restrict__ db) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * (kFinalThreads / 32) + warp;
  if (c >= H) return;
  float t0 = 0.0f, t1 = 0.0f, t2 = 0.0f, t3 = 0.0f;
  int i = lane;
  for (; i + 96 < n_part; i += 128) {
    t0 += part[(int64_t)i * H + c];
    t1 += part[(int64_t)(i + 32) * H + c];
    t2 += part[(int64_t)(i + 64) * H + c];
    t3 += part[(int64_t)(i + 96) * H + c];
  }
  for (; i < n_part; i += 32) t0 += part[(int64_t)i * H + c];
  float t = (t0 + t1) + (t2 + t3);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) t += __shfl_down_sync(kAll, t, off);
  if (lane == 0) db[c] = t;
}

bool bad_width(int64_t rows, int H) {
  return rows <= 0 || H < kVec || H > kMaxHidden || H % kVec != 0;
}

}  // namespace

// ---- plain C interface (loaded with ctypes; returns a cudaError_t) ----

// The floats of the backward's partial rows for width H on `sms` SMs.
extern "C" int ppo_trunk_workspace(int H, int sms) {
  return sms * kBwdCtasPerSm * H;
}

// a (rows, H) float32, bias (H,), h (rows, H) bf16 (as uint16), all
// contiguous and 16-byte aligned; keep: store y in place of a.
extern "C" int ppo_trunk_forward_launch(float* a, const float* bias,
                                        uint16_t* h, int64_t rows, int H,
                                        int keep, int sms, void* stream) {
  if (bad_width(rows, H) || sms <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = cta_threads(H, kFwdThreads);
  const int ctas = grid_ctas(rows, H, threads, sms * kFwdCtasPerSm);
  const int64_t vecs = rows * (H / kVec);
  uint4* h8 = reinterpret_cast<uint4*>(h);
  if (keep)
    trunk_fwd_kernel<true><<<ctas, threads, 0, st>>>(a, bias, h8, vecs, H);
  else
    trunk_fwd_kernel<false><<<ctas, threads, 0, st>>>(a, bias, h8, vecs, H);
  return (int)cudaGetLastError();
}

// p, y (rows, H) float32, contiguous and 16-byte aligned, overwritten with
// d and hf; x (nx,) bf16 (as uint16) and xf (nx,) float32, or nx 0; work
// ppo_trunk_workspace(H, sms) floats; db (H,).
extern "C" int ppo_trunk_backward_launch(float* p, float* y, int64_t rows,
                                         int H, const uint16_t* x, float* xf,
                                         int64_t nx, float* work, float* db,
                                         int sms, void* stream) {
  if (bad_width(rows, H) || sms <= 0 || nx < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = cta_threads(H, kBwdThreads);
  const int ctas = grid_ctas(rows, H, threads, sms * kBwdCtasPerSm);
  const int64_t vecs = rows * (H / kVec);
  const size_t smem = (size_t)(threads / (H / kVec)) * H * sizeof(float);
  trunk_bwd_kernel<<<ctas, threads, smem, st>>>(p, y, vecs, H, x, xf, nx,
                                                work);
  const int warps = kFinalThreads / 32;
  trunk_bias_kernel<<<(H + warps - 1) / warps, kFinalThreads, 0, st>>>(
      work, ctas, H, db);
  return (int)cudaGetLastError();
}
