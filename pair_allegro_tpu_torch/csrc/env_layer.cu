// K2: the per-layer env-fused TP + mix of an Allegro layer as a hand-written
// Hopper kernel pair (f32; env_layer_bf16.cu builds this file on bf16
// activations, env_layer_bf16x3.cu and env_layer_onepass.cu on f32 ones with
// the mix in the matmul precision policy's other forms).
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
// What bounds it on an H100: bytes.  Per edge slot the forward does ~8e4
// flops, 92% of them the per-l3 mix (2*C*Cout*35 at l_max=2 with parity,
// C = Cout = 32), against ~1.3 KB moved.  With the mix on the tensor cores
// in 3xTF32 (495/3 TFLOP/s) and the TP and env on the CUDA cores (67
// TFLOP/s), the operations' least time falls under the bytes': 0.290 /
// 0.424 ms forward / backward at E = 340,736 (chip_smoke.py's k2_cost).
//
// Design: K1's layer (csrc/fused_layer.cu) without its wz product, latent
// MLP and residual, on the same pieces (allegro_mma.cuh):
//  * one thread block owns one whole center, so the env sum (forward) and
//    the denv sum with its broadcast back to the edges (backward) are
//    block-local reductions in shared memory.  The TPU's B = S S^T
//    averaging matmul, its bf16 split and the center padding are not
//    carried over;
//  * the center's K edges are walked in tiles of ET = 32 edges, loaded by
//    16-byte cp.async; one output row's TP (P*C x ET) and its mix are
//    done before the next row's;
//  * the TP keeps each path's sum in registers (tp_row_reg); its backward
//    (tp_row_bwd) meets each row's entries in j order, sums denv per run of
//    equal j in registers and reduces it across the warp, so no atomics;
//  * the mix and its transpose run mma.sync m16n8k8 in 3xTF32 (f32
//    accuracy; the build's form, MIX_MMA in allegro_mma.cuh: bf16x3 or one
//    bf16 pass m16n8k16 in the policy's other builds), rows = output features, columns = the tile's edges, the
//    weights staged through a two-stage cp.async ring while the row's TP
//    runs; an l3 block stays in the ring over its 2 l3 + 1 rows (a tile
//    stages 45 KB of mix weights, not 143 KB); the forward writes V'
//    straight from the accumulators to device memory, and the backward
//    loads row r+1's dV' tile and mixT block while row r's TP runs;
//  * the layout takes the product stride LDS_WIDE or LDS_MIN (the kernels
//    are built for each) and the ring that let two blocks share an SM, else
//    the same in the whole shared memory, else LDS_MIN without the ring, so
//    every width the FFMA K2 took is still taken (at the flagship widths
//    the forward at LDS_WIDE, its l3 blocks kept in the ring; the backward
//    at LDS_MIN with a ring that restages them per row);
//  * the dead last layer's dV' arrives as zeros (autograd materialises the
//    unused output's cotangent) and is read as such.
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see ops/env_layer.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "allegro_mma.cuh"

namespace {

// the activations' storage type: f32 here; env_layer_bf16.cu builds this
// file at __nv_bfloat16 (its mix weights then pair-packed bf16 words, its
// products one bf16 tensor-core pass: allegro_mma.cuh prod)
#ifndef K2_ACT
#define K2_ACT float
#endif

template <typename Act>
struct K2T {
  const Act *V, *wz, *Y;
  const float *mix, *mixT;
  const Act *dout, *dinv;
  const int* meta;
  Act *out, *inv, *dV, *dwz, *dY;
  int C, Cout, D, K, E, maxpc, P0;
  float inv_avg;
  // the product tiles' row stride (LDS_WIDE, or LDS_MIN where the layout
  // needs it; the kernels are built for each), the weight ring (words, 0 for
  // none), the region offsets, and whether tiles load by 16-byte cp.async
  int lds, ring, o_ring, o_perm, o_env, o_denv, o_V, o_dV, o_R, vec;
};

// env[d*C + c] = inv_avg * sum over the center's edges of wz[c] * Y[d];
// wzs (C rows) and Ys (D rows) are scratch tiles at stride L.
template <int L, typename Act>
__device__ void center_env(const K2T<Act>& p, int center, float* env, float* wzs, float* Ys) {
  const int C = p.C, D = p.D;
  for (int q = threadIdx.x; q < D * C; q += NT) env[q] = 0.f;
  for (int t0 = 0; t0 < p.K; t0 += ET) {
    const int e0 = center * p.K + t0, ne = min(ET, p.K - t0);
    load_tile_async<true>(p.wz, C, p.E, e0, ne, wzs, L, p.vec);
    load_tile_async<true>(p.Y, D, p.E, e0, ne, Ys, L, p.vec);
    tiles_ready();
    // (d, c) = (q % D, q / D): a warp reads few distinct wz rows
    for (int q = threadIdx.x; q < D * C; q += NT) {
      const int d = q % D, c = q / D;
      float s = 0.f;
      for (int n = 0; n < ne; ++n) s = fmaf(wzs[c * L + n], Ys[d * L + n], s);
      env[d * C + c] += s;
    }
    __syncthreads();
  }
  for (int q = threadIdx.x; q < D * C; q += NT) env[q] *= p.inv_avg;
  __syncthreads();
}

template <int L, typename Act>
__global__ void __launch_bounds__(NT, 2) k2_fwd_kernel(const __grid_constant__ K2T<Act> p) {
  extern __shared__ float sm[];
  load_meta(p.meta, reinterpret_cast<int*>(sm));
  const Meta& m = *reinterpret_cast<const Meta*>(sm);
  const int center = blockIdx.x;
  const int C = p.C, E = p.E;
  float* env = sm + p.o_env;
  float* Vs = sm + p.o_V;
  float* T = sm + p.o_R;  // one row's TP output (rowP*C rows); env's scratch before
  float* ring = sm + p.o_ring;

  center_env<L>(p, center, env, T, T + C * L);
  for (int t0 = 0; t0 < p.K; t0 += ET) {
    const int e0 = center * p.K + t0, ne = min(ET, p.K - t0);
    load_tile_async<true>(p.V, p.D * C, E, e0, ne, Vs, LDV, p.vec);
    tiles_ready();
    for (int r = 0; r < p.D; ++r) {
      const int kd = m.rowP[r] * C;
      // the mix block loads while the TP runs
      if (!resident<Act>(m, r, kd, p.Cout, p.ring))
        stage<Act>(p.mix + wofs<Act>(m.rowmix[r]), kd, p.Cout, ring, p.ring);
      tp_row_reg(C, m, r, Vs, env, T, L);
      __syncthreads();
      if (r == 0) {  // inv, c-major: row c*P0 + pp of T's row pp*C + c
        for (int q = threadIdx.x; q < p.P0 * C * ET; q += NT) {
          const int row = q / ET, n = q % ET;
          const int pp = row / C, c = row % C;
          if (n < ne) st_act(p.inv + (size_t)(c * p.P0 + pp) * E + e0 + n, T[row * L + n]);
        }
      }
      prod<Act>(p.mix + wofs<Act>(m.rowmix[r]), kd, p.Cout, T, L,
                p.out + (size_t)r * p.Cout * E + e0, E, m.rownorm[r], ne, ring, p.ring, true);
      __syncthreads();
    }
  }
}

template <int L, typename Act>
__global__ void __launch_bounds__(NT, 2) k2_bwd_kernel(const __grid_constant__ K2T<Act> p) {
  extern __shared__ float sm[];
  load_meta(p.meta, reinterpret_cast<int*>(sm));
  const Meta& m = *reinterpret_cast<const Meta*>(sm);
  const int center = blockIdx.x;
  const int C = p.C, D = p.D, E = p.E;
  float* env = sm + p.o_env;
  float* denv = sm + p.o_denv;
  float* Vs = sm + p.o_V;
  float* dVs = sm + p.o_dV;
  float* dT = sm + p.o_R;          // one row's dT (rowP*C rows)
  float* dVo = dT + p.maxpc * L;   // one row's dV' tile (Cout rows)
  float* ring = sm + p.o_ring;
  int* perm = reinterpret_cast<int*>(sm + p.o_perm);

  build_jperm(m, D, perm);
  center_env<L>(p, center, env, dT, dT + C * L);
  for (int q = threadIdx.x; q < D * C; q += NT) denv[q] = 0.f;
  // row r's dV' tile and mixT block, loaded ahead of its product
  auto issue_row = [&](int r, int e0, int ne) {
    load_tile_async<true>(p.dout + (size_t)r * p.Cout * E, p.Cout, E, e0, ne, dVo, L, p.vec);
    const int kd = m.rowP[r] * C;
    if (!resident<Act>(m, r, p.Cout, kd, p.ring))
      stage<Act>(p.mixT + wofs<Act>(m.rowmix[r]), p.Cout, kd, ring, p.ring);
  };

  // pass 1: mix and TP backward per edge tile, denv accumulation
  for (int t0 = 0; t0 < p.K; t0 += ET) {
    const int e0 = center * p.K + t0, ne = min(ET, p.K - t0);
    load_tile_async<true>(p.V, D * C, E, e0, ne, Vs, LDV, p.vec);
    for (int q = threadIdx.x; q < D * C * ET; q += NT) dVs[(q / ET) * LDV + q % ET] = 0.f;
    issue_row(0, e0, ne);
    for (int r = 0; r < D; ++r) {
      tiles_ready();
      prod<Act>(p.mixT + wofs<Act>(m.rowmix[r]), p.Cout, m.rowP[r] * C, dVo, L, dT, L,
                m.rownorm[r], ET, ring, p.ring, true);
      __syncthreads();
      if (r + 1 < D) issue_row(r + 1, e0, ne);  // loads while this row's TP runs
      if (r == 0) {  // + dinv, which arrives c-major (row c*P0 + pp)
        for (int q = threadIdx.x; q < p.P0 * C * ET; q += NT) {
          const int row = q / ET, n = q % ET;
          const int pp = row / C, c = row % C;
          if (n < ne) dT[row * L + n] += ld_act(p.dinv + (size_t)(c * p.P0 + pp) * E + e0 + n);
        }
        __syncthreads();
      }
      tp_row_bwd(C, m, perm, r, dT, L, Vs, env, dVs, denv);
      __syncthreads();
    }
    for (int q = threadIdx.x; q < D * C * ET; q += NT) {
      const int row = q / ET, n = q % ET;
      if (n < ne) st_act(p.dV + (size_t)row * E + e0 + n, dVs[row * LDV + n]);
    }
    __syncthreads();
  }

  // pass 2: env backward with the complete per-center denv
  for (int q = threadIdx.x; q < D * C; q += NT) denv[q] *= p.inv_avg;  // = dA
  __syncthreads();
  float* wzs = dT;
  float* Ys = dT + C * L;
  for (int t0 = 0; t0 < p.K; t0 += ET) {
    const int e0 = center * p.K + t0, ne = min(ET, p.K - t0);
    load_tile_async<true>(p.wz, C, E, e0, ne, wzs, L, p.vec);
    load_tile_async<true>(p.Y, D, E, e0, ne, Ys, L, p.vec);
    tiles_ready();
    for (int q = threadIdx.x; q < C * ET; q += NT) {
      const int cc = q / ET, n = q % ET;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(denv[d * C + cc], Ys[d * L + n], s);
      if (n < ne) st_act(p.dwz + (size_t)cc * E + e0 + n, s);
    }
    for (int q = threadIdx.x; q < D * ET; q += NT) {
      const int d = q / ET, n = q % ET;
      float s = 0.f;
      for (int cc = 0; cc < C; ++cc) s = fmaf(denv[d * C + cc], wzs[cc * L + n], s);
      if (n < ne) st_act(p.dY + (size_t)d * E + e0 + n, s);
    }
    __syncthreads();
  }
}

// dims: C, Cout, D, K, E, maxpc, P0
template <typename Act>
void k2_params(K2T<Act>& p, const int* dims) {
  p.C = dims[0];
  p.Cout = dims[1];
  p.D = dims[2];
  p.K = dims[3];
  p.E = dims[4];
  p.maxpc = dims[5];
  p.P0 = dims[6];
}

// Lays out one block at the product tile stride L into p's offsets: the
// tables, env (and denv), the V (and dV) tiles at LDV, a region R of
// product tiles at L (env's wz and Y scratch; T; dT and dV'), each region
// on 16 bytes (cp.async), then the ring: its cap (RING_FWD, RING_BWD) or
// what is left under budget bytes when less, not below RING_MIN, or none
// when ring is false.  Returns the block's bytes, or -6 if it does not fit.
template <typename Act>
int k2_plan(int bwd, K2T<Act>& p, int L, int budget, bool ring) {
  int off = 0;
  auto take = [&](int words) {
    const int o = off;
    off += (words + 3) & ~3;
    return o;
  };
  take(META_WORDS);
  p.o_perm = take(bwd ? MAX_ENT : 0);
  p.o_env = take(p.D * p.C);
  p.o_denv = take(bwd ? p.D * p.C : 0);
  p.o_V = take(p.D * p.C * LDV);
  p.o_dV = take(bwd ? p.D * p.C * LDV : 0);
  const int r_words = max(bwd ? p.maxpc + p.Cout : p.maxpc, p.C + p.D) * L;
  const int left = (budget / 4 - off - r_words) & ~7;
  p.lds = L;
  p.ring = 0;
  if (ring) {
    if (left < RING_MIN) return -6;
    p.ring = min(bwd ? RING_BWD : RING_FWD, left);
  } else if (left < 0) {
    return -6;
  }
  p.o_ring = take(p.ring);
  p.o_R = take(0);
  return (off + r_words) * 4;
}

// Checks the widths and lays out the block (the sum ops/env_layer.py's
// block_layout mirrors): the first that fits of the stride LDS_WIDE, then
// LDS_MIN, each with the ring, in half an SM (two blocks an SM: the
// backward at the flagship widths takes LDS_MIN and a ring too small to
// keep an l3 block, and ran 1.33x faster so on the H100 than one block an
// SM at LDS_WIDE with the block kept, PERF.md), then in the whole shared
// memory; else LDS_MIN without the ring.  Returns the block's bytes, or a
// negative code for a shape the kernel does not take.
template <typename Act>
int k2_layout(int bwd, K2T<Act>& p) {
  if (p.D < 1 || p.D > MAX_D) return -1;
  if (NT % p.C || NT / p.C > ET) return -2;  // the TP's cells (C a multiple of 8)
  if (p.K < 1 || p.E % p.K) return -3;
  if (p.C % 4 || p.Cout % 4) return -4;
  const int budgets[2] = {SHARE2, SMEM_MAX};
  const int strides[2] = {LDS_WIDE, LDS_MIN};
  for (const int budget : budgets)
    for (const int L : strides) {
      const int b = k2_plan(bwd, p, L, budget, true);
      if (b > 0) return b;
    }
  return k2_plan(bwd, p, LDS_MIN, SMEM_MAX, false);
}

bool aligned16(const void* q) { return ((uintptr_t)q & 15) == 0; }

}  // namespace

extern "C" {

// words of the Meta table the wrapper builds (checked by the wrapper)
int k2_meta_words() { return META_WORDS; }

// The shared-memory bytes of a launch at these dims, or the negative
// refusal code (the sum ops/env_layer.py's block_layout mirrors).
int k2_layout_bytes(int bwd, const int* dims) {
  K2T<K2_ACT> p{};
  k2_params(p, dims);
  return k2_layout(bwd, p);
}

// ptrs: V, wz, Y, mix, mixT, meta, dout, dinv, out, inv, dV, dwz, dY
//       (unused ones may be 0)
// dims: C, Cout, D, K, E, maxpc, P0
// Returns 0, a negative code for a shape the kernel does not take (-9: a
// weight not 16-byte aligned), or the cudaError_t of the launch.
int k2_launch(int bwd, const unsigned long long* ptrs, const int* dims, float inv_avg,
              void* stream) {
  using Act = K2_ACT;
  K2T<Act> p{};
  p.V = (const Act*)ptrs[0];
  p.wz = (const Act*)ptrs[1];
  p.Y = (const Act*)ptrs[2];
  p.mix = (const float*)ptrs[3];
  p.mixT = (const float*)ptrs[4];
  p.meta = (const int*)ptrs[5];
  p.dout = (const Act*)ptrs[6];
  p.dinv = (const Act*)ptrs[7];
  p.out = (Act*)ptrs[8];
  p.inv = (Act*)ptrs[9];
  p.dV = (Act*)ptrs[10];
  p.dwz = (Act*)ptrs[11];
  p.dY = (Act*)ptrs[12];
  k2_params(p, dims);
  p.inv_avg = inv_avg;
  const int bytes = k2_layout(bwd, p);
  if (bytes < 0) return bytes;
  if (!aligned16(p.mix) || !aligned16(p.mixT)) return -9;
  p.vec = p.E % 4 == 0 && p.K % 4 == 0 && aligned16(p.V) && aligned16(p.wz) && aligned16(p.Y) &&
          (!bwd || aligned16(p.dout));
  const bool wide = p.lds == LDS_WIDE;
  void (*kernel)(const K2T<Act>) =
      bwd ? (wide ? k2_bwd_kernel<LDS_WIDE, Act> : k2_bwd_kernel<LDS_MIN, Act>)
          : (wide ? k2_fwd_kernel<LDS_WIDE, Act> : k2_fwd_kernel<LDS_MIN, Act>);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<p.E / p.K, NT, (size_t)bytes, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
