// K2: the per-layer env-fused TP + mix of an Allegro layer as a hand-written
// Hopper kernel pair (f32).
//
// Replaces the TPU kernels pair_allegro_tpu/ops/pallas_stack.py
// _env_layer_fwd_kernel / _env_layer_bwd_kernel (entry tp_mix_env_fused_t,
// mode "paths").  On the feature-major (features, E) layout of the TABLE
// edge list, each center's K edges contiguous, the forward computes
//   env = per-center sum_k wz (x) Y / sqrt(avg_n)      (D, C) per center
//   T   = channelwise TP of V with env (3j FMA table)  per output row
//   V'  = per-l3 p-major mix of T;  inv = T[row 0] written c-major
// (row c*P0 + p, the scalar_part order the latent MLP outside reads).  The
// backward takes dV' and the c-major dinv, recomputes env and returns dV,
// dwz = sum_d dA_d Y_d and dY = sum_c dA wz with dA the per-center denv /
// sqrt(avg_n).  Weight cotangents are not computed: the wrapper hands them
// back NaN-filled, as the TPU kernel does.
//
// What bounds it on an H100: operations.  Per edge slot the forward does
// ~8e4 flops (the mix, 2*C*C*35, dominates) against ~1.3 KB moved: ~60
// flops per byte, above the f32 CUDA-core ridge (67 TFLOP/s / 3.35 TB/s =
// 20 flops per byte).
//
// Design (K1's, csrc/fused_layer.cu, without its latent MLP and residual;
// the tiles, the small product and the TP row are allegro_tiles.cuh's):
//  * one thread block owns one whole center, so the env sum (forward) and
//    the denv sum with its broadcast back to the edges (backward) are
//    block-local reductions in shared memory.  The TPU's B = S S^T
//    averaging matmul, its bf16 split and the center padding are not
//    carried over;
//  * the center's K edges are walked in tiles of ET = 32 edges, so one
//    output row's TP (P*C x ET) and the backward's dV tile fit in shared
//    memory at any K: 109 KB at l_max=2, C=32, so two backward blocks share
//    an SM;
//  * exact f32 FMAs on the CUDA cores: each small product gives a thread 4
//    output rows of one edge from broadcast float4 weight loads; the TP runs
//    on thread-owned (channel, edge) cells with no synchronisation;
//  * the dead last layer's dV' arrives as zeros (autograd materialises the
//    unused output's cotangent) and is read as such.
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see ops/env_layer.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "allegro_tiles.cuh"

namespace {

struct K2P {
  const float *V, *wz, *Y, *mix, *mixT, *dout, *dinv;
  const int* meta;
  float *out, *inv, *dV, *dwz, *dY;
  int C, Cout, D, K, E, maxpc, P0;
  float inv_avg;
  int o_env, o_denv, o_V, o_dV, o_T, o_dvo, o_Y, o_wz;
};

// env[d*C + c] = inv_avg * sum over the center's edges of wz[c] * Y[d];
// wzs (C rows) and Ys (D rows) are scratch tiles.
__device__ void center_env(const K2P& p, int center, float* env, float* wzs, float* Ys) {
  const int C = p.C, D = p.D;
  for (int q = threadIdx.x; q < D * C; q += NT) env[q] = 0.f;
  for (int t0 = 0; t0 < p.K; t0 += ET) {
    const int e0 = center * p.K + t0, ne = min(ET, p.K - t0);
    load_tile(p.wz, C, p.E, e0, ne, wzs);
    load_tile(p.Y, D, p.E, e0, ne, Ys);
    __syncthreads();
    for (int q = threadIdx.x; q < D * C; q += NT) {
      const int d = q / C, c = q % C;
      float s = 0.f;
      for (int n = 0; n < ne; ++n) s = fmaf(wzs[c * LD + n], Ys[d * LD + n], s);
      env[q] += s;
    }
    __syncthreads();
  }
  for (int q = threadIdx.x; q < D * C; q += NT) env[q] *= p.inv_avg;
  __syncthreads();
}

__global__ void __launch_bounds__(NT) k2_fwd_kernel(const K2P p) {
  extern __shared__ float sm[];
  const Meta& m = *reinterpret_cast<const Meta*>(sm);
  load_meta(p.meta, reinterpret_cast<int*>(sm));
  const int center = blockIdx.x;
  const int C = p.C, D = p.D, E = p.E;
  float* env = sm + p.o_env;
  float* Vs = sm + p.o_V;
  float* T = sm + p.o_T;
  float* Ys = sm + p.o_Y;
  float* wzs = sm + p.o_wz;

  center_env(p, center, env, wzs, Ys);
  for (int t0 = 0; t0 < p.K; t0 += ET) {
    const int e0 = center * p.K + t0, ne = min(ET, p.K - t0);
    load_tile(p.V, D * C, E, e0, ne, Vs);
    __syncthreads();
    for (int r = 0; r < D; ++r) {
      tp_row(C, m, r, Vs, env, T);
      __syncthreads();
      if (r == 0) {  // inv, c-major: row c*P0 + pp
        for (int q = threadIdx.x; q < p.P0 * C * ET; q += NT) {
          const int row = q / ET, n = q % ET;  // row = pp*C + c
          const int pp = row / C, c = row % C;
          if (n < ne) p.inv[(size_t)(c * p.P0 + pp) * E + e0 + n] = T[row * LD + n];
        }
      }
      gemm_tile(p.mix + m.rowmix[r], m.rowP[r] * C, p.Cout, T,
                p.out + (size_t)r * p.Cout * E + e0, E, m.rownorm[r], ne);
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(NT) k2_bwd_kernel(const K2P p) {
  extern __shared__ float sm[];
  const Meta& m = *reinterpret_cast<const Meta*>(sm);
  load_meta(p.meta, reinterpret_cast<int*>(sm));
  const int center = blockIdx.x;
  const int C = p.C, D = p.D, E = p.E;
  float* env = sm + p.o_env;
  float* denv = sm + p.o_denv;
  float* Vs = sm + p.o_V;
  float* dVs = sm + p.o_dV;
  float* dT = sm + p.o_T;
  float* dVo = sm + p.o_dvo;
  float* Ys = sm + p.o_Y;
  float* wzs = sm + p.o_wz;
  const int c = threadIdx.x % C;
  const int n0 = threadIdx.x / C, nstep = NT / C;

  center_env(p, center, env, wzs, Ys);
  for (int q = threadIdx.x; q < D * C; q += NT) denv[q] = 0.f;

  // pass 1: mix and TP backward per edge tile, denv accumulation
  for (int t0 = 0; t0 < p.K; t0 += ET) {
    const int e0 = center * p.K + t0, ne = min(ET, p.K - t0);
    load_tile(p.V, D * C, E, e0, ne, Vs);
    for (int n = n0; n < ET; n += nstep)
      for (int i = 0; i < D; ++i) dVs[(i * C + c) * LD + n] = 0.f;
    for (int r = 0; r < D; ++r) {
      load_tile(p.dout + (size_t)r * p.Cout * E, p.Cout, E, e0, ne, dVo);
      __syncthreads();
      gemm_tile(p.mixT + m.rowmix[r], p.Cout, m.rowP[r] * C, dVo, dT, LD, m.rownorm[r], ET);
      __syncthreads();
      if (r == 0) {  // + dinv, which arrives c-major (row c*P0 + pp)
        for (int n = n0; n < ET; n += nstep)
          for (int pp = 0; pp < p.P0; ++pp)
            if (n < ne) dT[(pp * C + c) * LD + n] += __ldg(p.dinv + (size_t)(c * p.P0 + pp) * E + e0 + n);
      }
      for (int e = m.rowstart[r]; e < m.rowstart[r + 1]; ++e) {
        const int code = m.ent[e];
        const int pp = code & 255, i = (code >> 8) & 255, j = code >> 16;
        const float w = m.w[e];
        const float ev = env[j * C + c];
        const float* gr = dT + (pp * C + c) * LD;
        const float* Vr = Vs + (i * C + c) * LD;
        float* dVr = dVs + (i * C + c) * LD;
        float acc = 0.f;
        for (int n = n0; n < ET; n += nstep) {
          const float gg = w * gr[n];
          dVr[n] = fmaf(gg, ev, dVr[n]);
          acc = fmaf(gg, Vr[n], acc);
        }
        atomicAdd(&denv[j * C + c], acc);
      }
      __syncthreads();
    }
    for (int q = threadIdx.x; q < D * C * ET; q += NT) {
      const int row = q / ET, n = q % ET;
      if (n < ne) p.dV[(size_t)row * E + e0 + n] = dVs[row * LD + n];
    }
    __syncthreads();
  }

  // pass 2: env backward with the complete per-center denv
  for (int q = threadIdx.x; q < D * C; q += NT) denv[q] *= p.inv_avg;  // = dA
  __syncthreads();
  for (int t0 = 0; t0 < p.K; t0 += ET) {
    const int e0 = center * p.K + t0, ne = min(ET, p.K - t0);
    load_tile(p.wz, C, E, e0, ne, wzs);
    load_tile(p.Y, D, E, e0, ne, Ys);
    __syncthreads();
    for (int q = threadIdx.x; q < C * ET; q += NT) {
      const int cc = q / ET, n = q % ET;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(denv[d * C + cc], Ys[d * LD + n], s);
      if (n < ne) p.dwz[(size_t)cc * E + e0 + n] = s;
    }
    for (int q = threadIdx.x; q < D * ET; q += NT) {
      const int d = q / ET, n = q % ET;
      float s = 0.f;
      for (int cc = 0; cc < C; ++cc) s = fmaf(denv[d * C + cc], wzs[cc * LD + n], s);
      if (n < ne) p.dY[(size_t)d * E + e0 + n] = s;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// words of the Meta table the wrapper builds (checked by the wrapper)
int k2_meta_words() { return META_WORDS; }

// ptrs: V, wz, Y, mix, mixT, meta, dout, dinv, out, inv, dV, dwz, dY
//       (unused ones may be 0)
// dims: C, Cout, D, K, E, maxpc, P0
// Returns 0, a negative code for a shape the kernel does not take, or the
// cudaError_t of the launch.
int k2_launch(int bwd, const unsigned long long* ptrs, const int* dims, float inv_avg,
              void* stream) {
  K2P p{};
  p.V = (const float*)ptrs[0];
  p.wz = (const float*)ptrs[1];
  p.Y = (const float*)ptrs[2];
  p.mix = (const float*)ptrs[3];
  p.mixT = (const float*)ptrs[4];
  p.meta = (const int*)ptrs[5];
  p.dout = (const float*)ptrs[6];
  p.dinv = (const float*)ptrs[7];
  p.out = (float*)ptrs[8];
  p.inv = (float*)ptrs[9];
  p.dV = (float*)ptrs[10];
  p.dwz = (float*)ptrs[11];
  p.dY = (float*)ptrs[12];
  p.C = dims[0];
  p.Cout = dims[1];
  p.D = dims[2];
  p.K = dims[3];
  p.E = dims[4];
  p.maxpc = dims[5];
  p.P0 = dims[6];
  p.inv_avg = inv_avg;
  if (p.D > MAX_D) return -1;
  if (NT % p.C || NT / p.C > ET) return -2;  // thread-owned (c, n) TP cells
  if (p.K < 1 || p.E % p.K) return -3;
  if (p.C % 4 || p.Cout % 4) return -4;

  int off = META_WORDS;
  auto take = [&](int words) {
    const int o = off;
    off += words;
    return o;
  };
  p.o_env = take(p.D * p.C);
  p.o_denv = take(bwd ? p.D * p.C : 0);
  p.o_V = take(p.D * p.C * LD);
  p.o_dV = take(bwd ? p.D * p.C * LD : 0);
  p.o_T = take(p.maxpc * LD);
  p.o_dvo = take(bwd ? p.Cout * LD : 0);
  p.o_Y = take(p.D * LD);
  p.o_wz = take(p.C * LD);
  const size_t smem = (size_t)off * 4;
  if (smem > SMEM_MAX) return -6;

  const int blocks = p.E / p.K;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (bwd) {
    err = cudaFuncSetAttribute(k2_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    k2_bwd_kernel<<<blocks, NT, smem, st>>>(p);
  } else {
    err = cudaFuncSetAttribute(k2_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    k2_fwd_kernel<<<blocks, NT, smem, st>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
