// Batched contiguous row-slice gather on an NVIDIA Hopper card (sm_90a):
//   out[b] = table[starts[b] : starts[b] + length]   for b < B
// with table (R, C) float32 row-major and out (B, length, C).
//
// Replaces both Pallas TPU kernels of sustaingym_tpu/ops/pallas/
// exog_gather.py, which compute this one function:
//   _pallas_slice_gather      (_kernel)      narrow tables, C <= 128
//   _pallas_hbm_slice_gather  (_hbm_kernel)  wide tables, C > 128
//
// What bounds it. Bytes: every output float is written once and the table
// (the cogen ambient pack is 0.77 MB) stays in the 50 MB L2, so the time
// is the output size over the memory rate; there is no arithmetic.
//
// Design. Env b's slice is one contiguous run of length * C floats in the
// table and one in the output, so the gather is a batched memcpy. One warp
// copies one env's run, neighbouring lanes on neighbouring floats; each
// lane issues kUnroll loads before its stores so enough bytes are in
// flight, and the ragged tail is masked. Warps stride over envs, with at
// most enough CTAs to fill every SM once. What the TPU kernels worked
// around does not exist here: lane packing of narrow rows into 128-wide
// tiles and the realigning roll (a GPU load has no tile alignment), the
// VMEM-resident table (L2 keeps it), and the per-env DMA semaphores
// (ordinary loads and stores).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;    // warps per CTA
constexpr int kUnroll = 4;   // loads in flight per lane
constexpr int kCtasPerSm = 8;

__global__ void __launch_bounds__(kWarps * 32)
slice_gather_kernel(const float* __restrict__ table, int cols,
                    const int64_t* __restrict__ starts, int B,
                    int64_t span, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * kWarps;
  for (int b = blockIdx.x * kWarps + (threadIdx.x >> 5); b < B; b += stride) {
    const float* src = table + starts[b] * cols;
    float* dst = out + (int64_t)b * span;
    for (int64_t base = lane; base < span; base += 32 * kUnroll) {
      float v[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int64_t i = base + 32 * k;
        v[k] = i < span ? src[i] : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int64_t i = base + 32 * k;
        if (i < span) dst[i] = v[k];
      }
    }
  }
}

}  // namespace

// ---- plain C interface (loaded with ctypes; returns a cudaError_t) ----

extern "C" int episode_slice_gather_launch(const float* table, int cols,
                                           const int64_t* starts, int B,
                                           int length, float* out,
                                           void* stream) {
  if (B <= 0 || length <= 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int need = (B + kWarps - 1) / kWarps;
  const int grid = need < sms * kCtasPerSm ? need : sms * kCtasPerSm;
  slice_gather_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      table, cols, starts, B, (int64_t)length * cols, out);
  return (int)cudaGetLastError();
}
