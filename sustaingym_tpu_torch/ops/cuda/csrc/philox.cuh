// Counter-based random numbers shared by the episode kernels.
//
// Philox4x32-10: each (counter, key) pair gives four independent 32-bit
// words, so a kernel counts its draws by what they are for (env, step,
// row or lane, stream) and the draws do not depend on launch geometry.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

// U[0, 1) from the top 23 bits, as the TPU kernels' _uniform01
__device__ __forceinline__ float uniform01(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

__device__ __forceinline__ uint2 philox_key(uint64_t seed) {
  return make_uint2((uint32_t)seed, (uint32_t)(seed >> 32));
}

}  // namespace
