#!/usr/bin/env python3
"""Throughput of shared-memory loads and warp shuffles on one CUDA card.

    python3 tools/smem_rates.py

Builds a small CUDA source (below) with ``nvcc`` into a temporary
directory and times, by CUDA events, one kernel per kind of access: 32
warps a SM on every SM, each issuing the same access in an unrolled loop
(the values summed, so nothing is optimized away). Prints, for each kind,
warp instructions a SM a nanosecond and the cost of one instruction in
units of a 4-byte load of distinct words by the 32 lanes (LDS.32, the
fastest), with the card's name and power limit.

The question it answers for the EV ADMM kernel (``ops/cuda/csrc/
ev_rollout.cu``): what does a warp-wide broadcast of a float4 (every lane
reading the same 16 bytes) cost against each lane reading its own float4,
and against a shuffle? Needs the card; exits 1 without one.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

SOURCE = r"""
#include <cuda_runtime.h>
// shared-memory loads that stay where they are written (ld.volatile: none
// is hoisted out of the loop or merged with another)
__device__ __forceinline__ unsigned saddr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ float4 lds128(const float4* p) {
  float4 v;
  asm volatile("ld.volatile.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(saddr(p)));
  return v;
}
__device__ __forceinline__ float2 lds64(const float2* p) {
  float2 v;
  asm volatile("ld.volatile.shared.v2.f32 {%0, %1}, [%2];"
               : "=f"(v.x), "=f"(v.y) : "r"(saddr(p)));
  return v;
}
__device__ __forceinline__ float lds32(const float* p) {
  float v;
  asm volatile("ld.volatile.shared.f32 %0, [%1];" : "=f"(v) : "r"(saddr(p)));
  return v;
}
template <int MODE>
__global__ void rates(float* out, int iters) {
  __shared__ float4 buf[1024];
  for (int i = threadIdx.x; i < 1024; i += blockDim.x)
    buf[i] = make_float4(i, i + 1, i + 2, i + 3);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  float acc = 0.0f, a = lane;
  for (int it = 0; it < iters; ++it) {
    // 8 rows of 32 float4s a step
    const float4* rows = buf + (((threadIdx.x >> 5) + it) & 3) * 8 * 32;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (MODE == 0) {  // float4, every lane the same address
        const float4 v = lds128(rows + u * 32);
        acc += v.x + v.y + v.z + v.w;
      } else if (MODE == 1) {  // float4, lane-consecutive
        const float4 v = lds128(rows + u * 32 + lane);
        acc += v.x + v.y + v.z + v.w;
      } else if (MODE == 2) {  // float, every lane the same address
        acc += lds32(reinterpret_cast<const float*>(rows) + u * 128);
      } else if (MODE == 3) {  // float, lane-consecutive
        acc += lds32(reinterpret_cast<const float*>(rows) + u * 128 + lane);
      } else if (MODE == 4) {  // float2, lane-consecutive
        const float2 v = lds64(reinterpret_cast<const float2*>(rows) + u * 64 + lane);
        acc += v.x + v.y;
      } else {  // a shuffle
        a = __shfl_xor_sync(0xffffffffu, a, 1 << (u & 3)) + 1.0f;
      }
    }
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc + a;
}
extern "C" int run(int mode, float* out, int blocks, int threads, int iters) {
  switch (mode) {
    case 0: rates<0><<<blocks, threads>>>(out, iters); break;
    case 1: rates<1><<<blocks, threads>>>(out, iters); break;
    case 2: rates<2><<<blocks, threads>>>(out, iters); break;
    case 3: rates<3><<<blocks, threads>>>(out, iters); break;
    case 4: rates<4><<<blocks, threads>>>(out, iters); break;
    default: rates<5><<<blocks, threads>>>(out, iters); break;
  }
  return (int)cudaGetLastError();
}
"""

KINDS = ("LDS.128 broadcast", "LDS.128 lane-consecutive", "LDS.32 broadcast",
         "LDS.32 lane-consecutive", "LDS.64 lane-consecutive", "SHFL")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("smem_rates: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    from chip_smoke import card_line
    from sustaingym_tpu_torch.ops.cuda.build import CUDA_FLAGS, nvcc_path

    with tempfile.TemporaryDirectory() as tmp:
        src, lib_path = os.path.join(tmp, "rates.cu"), os.path.join(
            tmp, "librates.so")
        with open(src, "w") as f:
            f.write(SOURCE)
        subprocess.run([nvcc_path(), *CUDA_FLAGS, "-o", lib_path, src],
                       check=True)
        lib = ctypes.CDLL(lib_path)
        lib.run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                            ctypes.c_int, ctypes.c_int]
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        threads, iters = 1024, 20000
        out = torch.empty(sms * threads, device="cuda")
        rates = {}
        for mode, kind in enumerate(KINDS):
            assert lib.run(mode, out.data_ptr(), sms, threads, 10) == 0
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            assert lib.run(mode, out.data_ptr(), sms, threads, iters) == 0
            end.record()
            torch.cuda.synchronize()
            ns = start.elapsed_time(end) * 1e6
            rates[kind] = threads // 32 * iters * 8 / ns
    base = rates["LDS.32 lane-consecutive"]
    for kind, rate in rates.items():
        print(f"{kind:26s} {rate:.4f} warp instructions a SM a ns, "
              f"{base / rate:.2f} LDS.32", flush=True)
    print(json.dumps({"card": card_line(), "per_sm_per_ns": rates}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
