// Warp-level tensor-core building blocks shared by the port's kernels
// (lp_solve.cu, actor.cuh): ldmatrix loads of bf16 tiles from shared memory
// and the m16n8k16 bf16 mma.sync with float32 accumulation.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16), lane l = 4 g + t:
//   A (16 x 16, row-major):  a0 = A[g][2t..2t+1],     a1 = A[g+8][2t..2t+1],
//                            a2 = A[g][2t+8..2t+9],   a3 = A[g+8][2t+8..2t+9]
//   B (16 x 8, "col"):       b0 = B[2t..2t+1][g],     b1 = B[2t+8..2t+9][g]
//   C/D (16 x 8, float32):   c0 = C[g][2t], c1 = C[g][2t+1],
//                            c2 = C[g+8][2t], c3 = C[g+8][2t+1]
// A tile whose rows start 16 bytes apart modulo 32 (a row stride that is an
// odd multiple of 16 bytes) is read by ldmatrix without bank conflicts.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__host__ __device__ constexpr int pad16(int v) { return (v + 15) / 16 * 16; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// register i receives matrix i in the A/B fragment order above.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row))
               : "memory");
}

// The same with each 8x8 matrix transposed: lane 4g + t receives the
// stored matrix's [2t][g] and [2t+1][g].
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row))
               : "memory");
}

// d += A (16 x 16 bf16) * B (16 x 8 bf16), float32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += A * B with the tensor core summing the 16 products from zero and
// the sum added to acc in float32, rounding to nearest.
__device__ __forceinline__ void add_mma(float (&acc)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  float part[4] = {};
  mma_bf16(part, a, b0, b1);
#pragma unroll
  for (int q = 0; q < 4; ++q) acc[q] += part[q];
}

}  // namespace
