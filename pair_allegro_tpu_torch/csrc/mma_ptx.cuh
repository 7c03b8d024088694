// PTX primitives of the tensor-core kernels: the body of K1, K6, K7 and K8,
// K2 and K4 (allegro_mma.cuh), K3 (nequip_conv.cu) and K5 (env_layer_mxu.cu),
// and the product forms the matmul precision policy picks among (Mma).
//
//  * tf32_rna / split_tf32: cvt.rna.tf32.f32 as two integer operations, and
//    the 3xTF32 split x = hi + lo with hi = rna_tf32(x), lo = rna_tf32(x - hi);
//  * mma_tf32: mma.sync.m16n8k8 TF32 with f32 accumulation;
//  * mma_bf16: mma.sync.m16n8k16 bf16 with f32 accumulation (K5's bf16
//    modes; products of bf16 values are exact in f32);
//  * cp_async16 and its commit / wait groups: 16-byte copies global ->
//    shared through L2 only, the bytes past src_bytes zero-filled.
//
// The g++ stand-in build (PAT_STANDIN, never nvcc) replaces them with
// scalar emulations: cp.async by a copy with zero fill, its groups by
// no-ops, and each mma by one gathered lane by lane with warp shuffles.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#ifdef PAT_STANDIN
#include <string.h>
#endif

namespace {

// The product forms of the tensor-core kernels: 3xTF32 on f32 operands
// (f32 accuracy: the matmul precision policies highest and mixed), one
// bf16 pass (default, and every bf16 operand) and bf16x3 (JAX's HIGH:
// kernel_high and high).  allegro_mma.cuh runs them on bf16 fragments,
// nequip_conv.cu on TF32 fragments that carry bf16 values.
enum Mma { TF32X3 = 0, BF16P = 1, BF16X3 = 2 };

// cvt.rna.tf32.f32 by two full-rate integer operations: add half a unit of
// the 11th mantissa bit to the magnitude's bits, clear the 13 bits below
// (Inf and NaN stay as they are)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

#ifndef PAT_STANDIN
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// a: 4 registers of bf16 pairs (rows g, g+8 x k 2t..2t+1, then k + 8), b: 2
// (k 2t..2t+1 and + 8, column g); the low half of a register is the lower k
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes global -> shared through L2 only; the bytes past src_bytes are zeroed
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}
#else
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, const uint32_t* b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k = 0; k < 8; ++k) {
    const int hi = k >> 2, kl = k & 3;
    const float a0 = __uint_as_float(__shfl_sync(~0u, a[2 * hi], g * 4 + kl));
    const float a1 = __uint_as_float(__shfl_sync(~0u, a[2 * hi + 1], g * 4 + kl));
    const float b0 = __uint_as_float(__shfl_sync(~0u, b[hi], 2 * t * 4 + kl));
    const float b1 = __uint_as_float(__shfl_sync(~0u, b[hi], (2 * t + 1) * 4 + kl));
    d[0] = fmaf(a0, b0, d[0]);
    d[1] = fmaf(a0, b1, d[1]);
    d[2] = fmaf(a1, b0, d[2]);
    d[3] = fmaf(a1, b1, d[3]);
  }
}

__device__ __forceinline__ float bf16_half(uint32_t w, int upper) {
  return __uint_as_float(upper ? (w & 0xffff0000u) : (w << 16));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k = 0; k < 16; ++k) {
    const int hi = k >> 3, kl = (k & 7) >> 1, up = k & 1;
    const float a0 = bf16_half(__shfl_sync(~0u, a[2 * hi], g * 4 + kl), up);
    const float a1 = bf16_half(__shfl_sync(~0u, a[2 * hi + 1], g * 4 + kl), up);
    const float b0 = bf16_half(__shfl_sync(~0u, b[hi], 2 * t * 4 + kl), up);
    const float b1 = bf16_half(__shfl_sync(~0u, b[hi], (2 * t + 1) * 4 + kl), up);
    d[0] = fmaf(a0, b0, d[0]);
    d[1] = fmaf(a0, b1, d[1]);
    d[2] = fmaf(a1, b0, d[2]);
    d[3] = fmaf(a1, b1, d[3]);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  memcpy(dst, src, src_bytes);
  memset(reinterpret_cast<char*>(dst) + src_bytes, 0, 16 - src_bytes);
}

__device__ __forceinline__ void cp_async_commit() {}

template <int N>
__device__ __forceinline__ void cp_async_wait() {}
#endif

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

}  // namespace
