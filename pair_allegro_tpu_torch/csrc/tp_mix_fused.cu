// K4: the per-edge TP + mix of an Allegro layer as a hand-written Hopper
// kernel pair (f32).
//
// Replaces the TPU kernels pair_allegro_tpu/ops/pallas_tp.py _fwd_kernel /
// _bwd_kernel (entries tp_mix_fused / tp_mix_fused_t).  On the (D, C, E)
// layout, with env already on the edges (every edge independent), the
// forward computes per edge
//   T   = channelwise TP of V with env (3j FMA table)     per output row
//   V'  = per-l3 mix of T (the tree's c-major leaves, row c*P + p)
//   inv = T[row 0], written edge-major as (E, C*P0), column c*P0 + p
// and the backward takes dV' and the (E, C*P0) dinv and returns
//   dT = W dV' / sqrt(P*C) (+ dinv at row 0),
//   dV[i] += w dT env[j],  denv[j] += w dT V[i].
// Weight cotangents are not computed: the wrapper hands them back
// NaN-filled, as the TPU kernel does.
//
// What bounds it on an H100: at l_max=2 with parity and C = Cout = 32 the
// forward does ~7.7e4 flops per edge (the mix, 2*C*Cout*35, dominates)
// against ~3.8 KB moved, the backward ~8.2e4 against ~6.1 KB: 20 and 13
// flops per byte, at and below the f32 CUDA-core ridge (67 TFLOP/s / 3.35
// TB/s = 20), so both operations and bytes bound it.
//
// Design (K2's, csrc/env_layer.cu, without the per-center aggregation; the
// tiles, the small product and the Meta table are allegro_tiles.cuh's):
//  * one thread block owns one tile of TW consecutive edges; edges are
//    independent, so blocks share nothing and nothing is atomic.  The tail
//    tile is masked, so E need not be a multiple of the tile;
//  * TW is 32, 16 or 8: the launcher takes the widest tile whose shared
//    memory lets two blocks share an SM, else the widest that fits (at
//    flagship widths the forward's 97 KB at TW = 32, the backward's 94 KB
//    at TW = 16; l_max = 3 at C = 64 fits at TW = 8);
//  * the TP runs on thread-owned (channel, edge) cells and writes T's rows
//    c-major, so the mix reads the tree's c-major leaves as they are (the
//    backward reads their transposes) and T's first row is the invariants
//    in scalar_part's order;
//  * exact f32 FMAs on the CUDA cores (no TF32, no tensor cores);
//  * the dead last layer's dV' arrives as zeros (autograd materialises the
//    unused output's cotangent) and is read as such.
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see ops/tp_mix_fused.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "allegro_tiles.cuh"

namespace {

struct K4P {
  const float *V, *env, *mix, *mixT, *dout, *dinv;
  const int* meta;
  float *out, *inv, *dV, *denv;
  int C, Cout, D, E, maxpc, P0;
  int o_V, o_env, o_dV, o_denv, o_T, o_dvo;
};

template <int TW>
__global__ void __launch_bounds__(NT) k4_fwd_kernel(const K4P p) {
  constexpr int TLD = TW + 1;
  extern __shared__ float sm[];
  const Meta& m = *reinterpret_cast<const Meta*>(sm);
  load_meta(p.meta, reinterpret_cast<int*>(sm));
  const int C = p.C, D = p.D, E = p.E;
  const int e0 = blockIdx.x * TW, ne = min(TW, E - e0);
  float* Vs = sm + p.o_V;
  float* envs = sm + p.o_env;
  float* T = sm + p.o_T;

  load_tile<TW>(p.V, D * C, E, e0, ne, Vs);
  load_tile<TW>(p.env, D * C, E, e0, ne, envs);
  __syncthreads();
  for (int r = 0; r < D; ++r) {
    tp_row_edges<TW>(C, m, r, Vs, envs, T);
    __syncthreads();
    if (r == 0) {  // inv (E, C*P0): column c*P0 + pp is T's row
      const int cp0 = C * p.P0;
      for (int q = threadIdx.x; q < ne * cp0; q += NT) {
        const int n = q / cp0, col = q % cp0;
        p.inv[(size_t)(e0 + n) * cp0 + col] = T[col * TLD + n];
      }
    }
    gemm_tile<TW>(p.mix + m.rowmix[r], m.rowP[r] * C, p.Cout, T,
                  p.out + (size_t)r * p.Cout * E + e0, E, m.rownorm[r], ne);
    __syncthreads();
  }
}

template <int TW>
__global__ void __launch_bounds__(NT) k4_bwd_kernel(const K4P p) {
  constexpr int TLD = TW + 1;
  extern __shared__ float sm[];
  const Meta& m = *reinterpret_cast<const Meta*>(sm);
  load_meta(p.meta, reinterpret_cast<int*>(sm));
  const int C = p.C, D = p.D, E = p.E;
  const int e0 = blockIdx.x * TW, ne = min(TW, E - e0);
  float* Vs = sm + p.o_V;
  float* envs = sm + p.o_env;
  float* dVs = sm + p.o_dV;
  float* denvs = sm + p.o_denv;
  float* dT = sm + p.o_T;
  float* dVo = sm + p.o_dvo;

  load_tile<TW>(p.V, D * C, E, e0, ne, Vs);
  load_tile<TW>(p.env, D * C, E, e0, ne, envs);
  for (int q = threadIdx.x; q < D * C * TW; q += NT) {
    const int row = q / TW, n = q % TW;
    dVs[row * TLD + n] = 0.f;
    denvs[row * TLD + n] = 0.f;
  }
  for (int r = 0; r < D; ++r) {
    load_tile<TW>(p.dout + (size_t)r * p.Cout * E, p.Cout, E, e0, ne, dVo);
    __syncthreads();
    gemm_tile<TW>(p.mixT + m.rowmix[r], p.Cout, m.rowP[r] * C, dVo, dT, TLD, m.rownorm[r], TW);
    __syncthreads();
    if (r == 0) {  // + dinv, which arrives (E, C*P0): column c*P0 + pp is dT's row
      const int cp0 = C * p.P0;
      for (int q = threadIdx.x; q < ne * cp0; q += NT) {
        const int n = q / cp0, col = q % cp0;
        dT[col * TLD + n] += __ldg(p.dinv + (size_t)(e0 + n) * cp0 + col);
      }
      __syncthreads();
    }
    const int P = m.rowP[r];
    for (int q = threadIdx.x; q < C * TW; q += NT) {
      const int c = q / TW, n = q % TW;
      const float* g = dT + c * P * TLD + n;
      for (int e = m.rowstart[r]; e < m.rowstart[r + 1]; ++e) {
        const int code = m.ent[e];
        const int pp = code & 255, i = (code >> 8) & 255, j = code >> 16;
        const float gg = m.w[e] * g[pp * TLD];
        const int vi = (i * C + c) * TLD + n, vj = (j * C + c) * TLD + n;
        dVs[vi] = fmaf(gg, envs[vj], dVs[vi]);
        denvs[vj] = fmaf(gg, Vs[vi], denvs[vj]);
      }
    }
    __syncthreads();
  }
  for (int q = threadIdx.x; q < D * C * TW; q += NT) {
    const int row = q / TW, n = q % TW;
    if (n < ne) {
      p.dV[(size_t)row * E + e0 + n] = dVs[row * TLD + n];
      p.denv[(size_t)row * E + e0 + n] = denvs[row * TLD + n];
    }
  }
}

// shared-memory layout of one block at tile width TW; returns its bytes
size_t layout(K4P& p, int TW, bool bwd) {
  const int tld = TW + 1;
  int off = META_WORDS;
  auto take = [&](int words) {
    const int o = off;
    off += words;
    return o;
  };
  p.o_V = take(p.D * p.C * tld);
  p.o_env = take(p.D * p.C * tld);
  p.o_dV = take(bwd ? p.D * p.C * tld : 0);
  p.o_denv = take(bwd ? p.D * p.C * tld : 0);
  p.o_T = take(p.maxpc * tld);
  p.o_dvo = take(bwd ? p.Cout * tld : 0);
  return (size_t)off * 4;
}

// the widest tile (32, 16, 8) whose block lets two blocks share an SM, else
// the widest that fits at all; 0 if none does
int pick_tile(K4P& p, bool bwd) {
  for (int share = 2; share >= 1; --share)
    for (int tw = 32; tw >= 8; tw /= 2)
      if (layout(p, tw, bwd) <= (size_t)SMEM_MAX / share) return tw;
  return 0;
}

template <int TW>
int run(bool bwd, K4P p, cudaStream_t st) {
  const size_t smem = layout(p, TW, bwd);
  const int blocks = (p.E + TW - 1) / TW;
  cudaError_t err;
  if (bwd) {
    err = cudaFuncSetAttribute(k4_bwd_kernel<TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    k4_bwd_kernel<TW><<<blocks, NT, smem, st>>>(p);
  } else {
    err = cudaFuncSetAttribute(k4_fwd_kernel<TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    k4_fwd_kernel<TW><<<blocks, NT, smem, st>>>(p);
  }
  return (int)cudaGetLastError();
}

// dims: C, Cout, D, E, maxpc, P0.  Returns 0 or the negative code of a
// shape the kernel does not take.
int parse(K4P& p, const int* dims) {
  p.C = dims[0];
  p.Cout = dims[1];
  p.D = dims[2];
  p.E = dims[3];
  p.maxpc = dims[4];
  p.P0 = dims[5];
  if (p.D < 1 || p.D > MAX_D) return -1;
  if (p.E < 1) return -3;
  if (p.C < 4 || p.C % 4 || p.Cout < 4 || p.Cout % 4) return -4;  // float4 weight rows
  return 0;
}

}  // namespace

extern "C" {

// words of the Meta table the wrapper builds (checked by the wrapper)
int k4_meta_words() { return META_WORDS; }

// The edge tile a launch with these dims takes (32, 16 or 8), or a
// negative code: -1 D, -3 E, -4 C or Cout, -6 shared memory.
int k4_tile(int bwd, const int* dims) {
  K4P p{};
  const int rc = parse(p, dims);
  if (rc) return rc;
  const int tw = pick_tile(p, bwd != 0);
  return tw ? tw : -6;
}

// ptrs: V, env, mix, mixT, meta, dout, dinv, out, inv, dV, denv (unused
//       ones may be 0)
// dims: C, Cout, D, E, maxpc, P0
// Returns 0, a negative code for a shape the kernel does not take (see
// k4_tile), or the cudaError_t of the launch.
int k4_launch(int bwd, const unsigned long long* ptrs, const int* dims, void* stream) {
  K4P p{};
  const int tw = k4_tile(bwd, dims);
  if (tw < 0) return tw;
  parse(p, dims);
  p.V = (const float*)ptrs[0];
  p.env = (const float*)ptrs[1];
  p.mix = (const float*)ptrs[2];
  p.mixT = (const float*)ptrs[3];
  p.meta = (const int*)ptrs[4];
  p.dout = (const float*)ptrs[5];
  p.dinv = (const float*)ptrs[6];
  p.out = (float*)ptrs[7];
  p.inv = (float*)ptrs[8];
  p.dV = (float*)ptrs[9];
  p.denv = (float*)ptrs[10];
  cudaStream_t st = (cudaStream_t)stream;
  if (tw == 32) return run<32>(bwd != 0, p, st);
  if (tw == 16) return run<16>(bwd != 0, p, st);
  return run<8>(bwd != 0, p, st);
}

}  // extern "C"
