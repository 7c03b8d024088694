// K1: one whole Allegro layer as a hand-written Hopper kernel pair (f32).
//
// Replaces the TPU kernels pair_allegro_tpu/ops/pallas_stack.py
// _layer1_fwd_kernel / _layer1_bwd_kernel (entry allegro_layer_fused_t).
// On the feature-major (features, E) layout of the TABLE edge list, where
// each center's K edges are contiguous, the forward computes
//   wz  = (Wenv^T x) / sqrt(ns) * u                        (C, E)
//   env = per-center sum_k wz (x) Y / sqrt(avg_n)          (D, C) per center
//   T   = channelwise TP of V with env (3j FMA table)      per output row
//   V'  = per-l3 p-major mix of T;  inv = T[row 0] (p-major)
//   x'  = (x + MLP([x; inv]) * u) / sqrt(2)
// in three forms: first_v (V0 = pT * Y built in the body), middle, and last
// (no V output and no mix).  The backward recomputes what the reverse needs
// and returns dx, dV (dpT when first_v), dY and du.  Weight cotangents are
// not computed: the wrapper hands them back NaN-filled, as the TPU kernel
// does.
//
// What bounds it on an H100: operations.  Per edge slot and layer the
// forward does ~1.2e5 flops (the per-l3 mix, 2*C*C*35, dominates, then the
// latent MLP) against ~2.9 KB moved: ~40 flops per byte, above the f32
// CUDA-core ridge (67 TFLOP/s / 3.35 TB/s = 20 flops per byte).
//
// Design:
//  * one thread block owns one whole center, so the per-center env sum
//    (forward) and the denv sum (backward) are block-local reductions in
//    shared memory: no atomics in device memory and no second launch.  The
//    TPU form of that reduction (a B = S S^T averaging matmul over 128-lane
//    blocks, its bf16 split, the center padding) is not carried over;
//  * the center's K edges are walked in tiles of ET = 32 edges, so the TP
//    output of one output row (P*C rows x ET) fits in shared memory at any
//    K: the whole TP output of a K=64 center (35 x 32 x 64 floats, 287 KB)
//    would not;
//  * products are exact f32 FMAs on the CUDA cores (no TF32, no tensor
//    cores): in each small matrix product a warp computes 32 edges of 4
//    output rows, reading the weights as broadcast float4 loads;
//  * the TP runs on thread-owned (channel, edge) cells, so it needs no
//    synchronisation; the 3j table (83 entries at l_max=2 with parity) and
//    the row tables sit in shared memory.
// The tiles, the small product and the TP row are in allegro_tiles.cuh,
// shared with K2 (env_layer.cu).
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see ops/fused_layer.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "allegro_tiles.cuh"

namespace {

constexpr float SILU_C = 1.6790564307512243f;
constexpr float R2 = 0.70710678118654752f;

struct K1P {
  const float *x, *V, *Y, *u, *envw, *envwT, *lat, *latT, *mix, *mixT, *dxo, *dvo;
  const int* meta;
  float *xo, *vo, *dx, *dV, *dY, *du;
  int ns, C, Cout, D, K, E, nlat, first_v, last, maxw, maxpc, in0;
  float inv_avg, cns;
  int o_env, o_denv, o_cat, o_V, o_pT, o_Y, o_u, o_du, o_R;
};

__device__ __forceinline__ float silu(float z) { return z / (1.0f + expf(-z)); }

__device__ __forceinline__ float dsilu(float z) {
  const float s = 1.0f / (1.0f + expf(-z));
  return s * (1.0f + z * (1.0f - s));
}

// env[d*C + c] = inv_avg * sum over the center's edges of wz[c] * Y[d];
// xs (ns rows), Ys, us and wz (C rows) are scratch tiles.
__device__ void center_env(const K1P& p, int center, float* env, float* xs, float* Ys,
                           float* us, float* wz) {
  const int C = p.C, D = p.D;
  for (int q = threadIdx.x; q < D * C; q += NT) env[q] = 0.f;
  for (int t0 = 0; t0 < p.K; t0 += ET) {
    const int e0 = center * p.K + t0, ne = min(ET, p.K - t0);
    load_tile(p.x, p.ns, p.E, e0, ne, xs);
    load_tile(p.Y, D, p.E, e0, ne, Ys);
    load_tile(p.u, 1, p.E, e0, ne, us);
    __syncthreads();
    gemm_tile(p.envw, p.ns, C, xs, wz, LD, p.cns, ET);
    __syncthreads();
    for (int q = threadIdx.x; q < D * C; q += NT) {
      const int d = q / C, c = q % C;
      float s = 0.f;
      for (int n = 0; n < ne; ++n) s = fmaf(wz[c * LD + n] * us[n], Ys[d * LD + n], s);
      env[q] += s;
    }
    __syncthreads();
  }
  for (int q = threadIdx.x; q < D * C; q += NT) env[q] *= p.inv_avg;
  __syncthreads();
}

// x (into cat rows [0, ns)), Y, u and V (built from pT when first_v)
__device__ void load_edges(const K1P& p, int e0, int ne, float* cat, float* Ys, float* us,
                           float* Vs, float* pTs) {
  const int C = p.C, D = p.D;
  load_tile(p.x, p.ns, p.E, e0, ne, cat);
  load_tile(p.Y, D, p.E, e0, ne, Ys);
  load_tile(p.u, 1, p.E, e0, ne, us);
  if (p.first_v) {
    load_tile(p.V, C, p.E, e0, ne, pTs);
    __syncthreads();
    for (int q = threadIdx.x; q < D * C * ET; q += NT) {
      const int row = q / ET, n = q % ET;
      Vs[row * LD + n] = pTs[(row % C) * LD + n] * Ys[(row / C) * LD + n];
    }
  } else {
    load_tile(p.V, D * C, p.E, e0, ne, Vs);
  }
  __syncthreads();
}

// latent MLP forward on one tile: input cat (in0 rows), hidden activations
// ping-pong through hA/hB; pre-activations saved into zs when given; the
// output (ns rows) goes to out.
__device__ void latent_fwd(const K1P& p, const Meta& m, const float* cat, float* hA,
                           float* hB, float* zs, float* out) {
  const float* hin = cat;
  for (int li = 0; li < p.nlat; ++li) {
    const int din = m.latdim[li], dout = m.latdim[li + 1];
    const bool hidden = li < p.nlat - 1;
    float* h = (li & 1) ? hB : hA;
    float* z = !hidden ? out : (zs ? zs + (size_t)li * p.maxw * LD : h);
    gemm_tile(p.lat + m.latoff[li], din, dout, hin, z, LD, rsqrtf((float)din), ET);
    __syncthreads();
    if (hidden) {
      for (int q = threadIdx.x; q < dout * ET; q += NT) {
        const int row = q / ET, n = q % ET;
        h[row * LD + n] = silu(z[row * LD + n]) * SILU_C;
      }
      __syncthreads();
      hin = h;
    }
  }
}

__global__ void __launch_bounds__(NT) k1_fwd_kernel(const K1P p) {
  extern __shared__ float sm[];
  const Meta& m = *reinterpret_cast<const Meta*>(sm);
  load_meta(p.meta, reinterpret_cast<int*>(sm));
  const int center = blockIdx.x;
  float* env = sm + p.o_env;
  float* cat = sm + p.o_cat;
  float* Vs = sm + p.o_V;
  float* pTs = sm + p.o_pT;
  float* Ys = sm + p.o_Y;
  float* us = sm + p.o_u;
  float* R = sm + p.o_R;

  center_env(p, center, env, cat, Ys, us, R);
  const int nrows = p.last ? 1 : p.D;
  float* hA = R;
  float* hB = R + p.maxw * LD;
  float* xn = R + 2 * p.maxw * LD;
  for (int t0 = 0; t0 < p.K; t0 += ET) {
    const int e0 = center * p.K + t0, ne = min(ET, p.K - t0);
    load_edges(p, e0, ne, cat, Ys, us, Vs, pTs);
    for (int r = 0; r < nrows; ++r) {
      float* T = r == 0 ? cat + p.ns * LD : R;  // row 0 is inv (p-major)
      tp_row(p.C, m, r, Vs, env, T);
      __syncthreads();
      if (!p.last) {
        gemm_tile(p.mix + m.rowmix[r], m.rowP[r] * p.C, p.Cout, T,
                  p.vo + (size_t)r * p.Cout * p.E + e0, p.E, m.rownorm[r], ne);
        __syncthreads();
      }
    }
    latent_fwd(p, m, cat, hA, hB, nullptr, xn);
    for (int q = threadIdx.x; q < p.ns * ET; q += NT) {
      const int s = q / ET, n = q % ET;
      if (n < ne) p.xo[(size_t)s * p.E + e0 + n] = (cat[s * LD + n] + xn[s * LD + n] * us[n]) * R2;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(NT) k1_bwd_kernel(const K1P p) {
  extern __shared__ float sm[];
  const Meta& m = *reinterpret_cast<const Meta*>(sm);
  load_meta(p.meta, reinterpret_cast<int*>(sm));
  const int center = blockIdx.x;
  const int C = p.C, D = p.D, ns = p.ns, E = p.E;
  float* env = sm + p.o_env;
  float* denv = sm + p.o_denv;
  float* cat = sm + p.o_cat;
  float* Vs = sm + p.o_V;
  float* pTs = sm + p.o_pT;
  float* Ys = sm + p.o_Y;
  float* us = sm + p.o_u;
  float* dus = sm + p.o_du;
  float* R = sm + p.o_R;
  // phase-1 scratch: latent forward + backward
  const int gw = max(p.in0, p.maxw);
  float* dxo = R;
  float* xn = dxo + ns * LD;
  float* zs = xn + ns * LD;
  float* gA = zs + (p.nlat - 1) * p.maxw * LD;
  float* gB = gA + gw * LD;
  // phase-2 scratch (aliases phase 1): TP / mix backward
  float* dVs = R;
  float* dT = dVs + D * C * LD;
  float* dVo = dT + p.maxpc * LD;
  const int c = threadIdx.x % C;
  const int n0 = threadIdx.x / C, nstep = NT / C;

  center_env(p, center, env, cat, Ys, us, R);
  for (int q = threadIdx.x; q < D * C; q += NT) denv[q] = 0.f;
  const int nrows = p.last ? 1 : D;

  // pass 1: latent forward + backward, TP/mix backward, denv accumulation
  for (int t0 = 0; t0 < p.K; t0 += ET) {
    const int e0 = center * p.K + t0, ne = min(ET, p.K - t0);
    load_edges(p, e0, ne, cat, Ys, us, Vs, pTs);
    load_tile(p.dxo, ns, E, e0, ne, dxo);
    tp_row(p.C, m, 0, Vs, env, cat + ns * LD);
    __syncthreads();
    latent_fwd(p, m, cat, gA, gB, zs, xn);
    for (int n = threadIdx.x; n < ET; n += NT) {
      float s = 0.f;
      for (int q = 0; q < ns; ++q) s = fmaf(dxo[q * LD + n], xn[q * LD + n], s);
      dus[n] = s * R2;
    }
    for (int q = threadIdx.x; q < ns * ET; q += NT) {
      const int s = q / ET, n = q % ET;
      gA[s * LD + n] = dxo[s * LD + n] * us[n] * R2;
    }
    __syncthreads();
    float* g = gA;
    float* g2 = gB;
    for (int li = p.nlat - 1; li >= 0; --li) {
      const int din = m.latdim[li], dout = m.latdim[li + 1];
      if (li < p.nlat - 1) {
        const float* z = zs + (size_t)li * p.maxw * LD;
        for (int q = threadIdx.x; q < dout * ET; q += NT) {
          const int row = q / ET, n = q % ET;
          g[row * LD + n] *= dsilu(z[row * LD + n]) * SILU_C;
        }
        __syncthreads();
      }
      gemm_tile(p.latT + m.latoff[li], dout, din, g, g2, LD, rsqrtf((float)din), ET);
      __syncthreads();
      float* tmp = g;
      g = g2;
      g2 = tmp;
    }
    // g = dcat (in0 rows).  The dx and du partials go to device memory and
    // are completed in pass 2 by this same block; dinv moves into the dead
    // inv rows of cat so that phase 2 may reuse the scratch.
    for (int q = threadIdx.x; q < ns * ET; q += NT) {
      const int s = q / ET, n = q % ET;
      if (n < ne) p.dx[(size_t)s * E + e0 + n] = dxo[s * LD + n] * R2 + g[s * LD + n];
    }
    for (int n = threadIdx.x; n < ne; n += NT) p.du[e0 + n] = dus[n];
    for (int q = threadIdx.x; q < (p.in0 - ns) * ET; q += NT) {
      const int row = ns + q / ET, n = q % ET;
      cat[row * LD + n] = g[row * LD + n];
    }
    __syncthreads();
    const float* dinv = cat + ns * LD;
    for (int n = n0; n < ET; n += nstep)
      for (int i = 0; i < D; ++i) dVs[(i * C + c) * LD + n] = 0.f;
    for (int r = 0; r < nrows; ++r) {
      const float* dTr = dinv;
      if (!p.last) {
        load_tile(p.dvo + (size_t)r * p.Cout * E, p.Cout, E, e0, ne, dVo);
        __syncthreads();
        gemm_tile(p.mixT + m.rowmix[r], p.Cout, m.rowP[r] * C, dVo, dT, LD, m.rownorm[r], ET);
        __syncthreads();
        if (r == 0) {
          for (int n = n0; n < ET; n += nstep)
            for (int pp = 0; pp < m.rowP[0]; ++pp)
              dT[(pp * C + c) * LD + n] += dinv[(pp * C + c) * LD + n];
        }
        dTr = dT;
      }
      for (int e = m.rowstart[r]; e < m.rowstart[r + 1]; ++e) {
        const int code = m.ent[e];
        const int pp = code & 255, i = (code >> 8) & 255, j = code >> 16;
        const float w = m.w[e];
        const float ev = env[j * C + c];
        const float* gr = dTr + (pp * C + c) * LD;
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
    if (p.first_v) {
      for (int q = threadIdx.x; q < C * ET; q += NT) {  // dpT = sum_d dV0[d] * Y[d]
        const int cc = q / ET, n = q % ET;
        float s = 0.f;
        for (int d = 0; d < D; ++d) s = fmaf(dVs[(d * C + cc) * LD + n], Ys[d * LD + n], s);
        if (n < ne) p.dV[(size_t)cc * E + e0 + n] = s;
      }
      for (int q = threadIdx.x; q < D * ET; q += NT) {  // dY = sum_c dV0[d] * pT
        const int d = q / ET, n = q % ET;
        float s = 0.f;
        for (int cc = 0; cc < C; ++cc) s = fmaf(dVs[(d * C + cc) * LD + n], pTs[cc * LD + n], s);
        if (n < ne) p.dY[(size_t)d * E + e0 + n] = s;
      }
    } else {
      for (int q = threadIdx.x; q < D * C * ET; q += NT) {
        const int row = q / ET, n = q % ET;
        if (n < ne) p.dV[(size_t)row * E + e0 + n] = dVs[row * LD + n];
      }
      for (int q = threadIdx.x; q < D * ET; q += NT) {
        const int d = q / ET, n = q % ET;
        if (n < ne) p.dY[(size_t)d * E + e0 + n] = 0.f;
      }
    }
    __syncthreads();
  }

  // pass 2: env backward with the complete per-center denv
  for (int q = threadIdx.x; q < D * C; q += NT) denv[q] *= p.inv_avg;  // = dA
  __syncthreads();
  float* wz0 = R;
  float* dwz = R + C * LD;
  float* dxa = dwz + C * LD;
  for (int t0 = 0; t0 < p.K; t0 += ET) {
    const int e0 = center * p.K + t0, ne = min(ET, p.K - t0);
    load_tile(p.x, ns, E, e0, ne, cat);
    load_tile(p.Y, D, E, e0, ne, Ys);
    load_tile(p.u, 1, E, e0, ne, us);
    __syncthreads();
    gemm_tile(p.envw, ns, C, cat, wz0, LD, p.cns, ET);
    for (int q = threadIdx.x; q < C * ET; q += NT) {
      const int cc = q / ET, n = q % ET;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(denv[d * C + cc], Ys[d * LD + n], s);
      dwz[cc * LD + n] = s;
    }
    __syncthreads();
    for (int q = threadIdx.x; q < D * ET; q += NT) {
      const int d = q / ET, n = q % ET;
      float s = 0.f;
      for (int cc = 0; cc < C; ++cc) s = fmaf(denv[d * C + cc], wz0[cc * LD + n], s);
      if (n < ne) p.dY[(size_t)d * E + e0 + n] += s * us[n];
    }
    for (int n = threadIdx.x; n < ne; n += NT) {
      float s = 0.f;
      for (int cc = 0; cc < C; ++cc) s = fmaf(dwz[cc * LD + n], wz0[cc * LD + n], s);
      p.du[e0 + n] += s;
    }
    __syncthreads();
    for (int q = threadIdx.x; q < C * ET; q += NT) {
      const int cc = q / ET, n = q % ET;
      dwz[cc * LD + n] *= us[n];
    }
    __syncthreads();
    gemm_tile(p.envwT, C, ns, dwz, dxa, LD, p.cns, ET);
    __syncthreads();
    for (int q = threadIdx.x; q < ns * ET; q += NT) {
      const int s = q / ET, n = q % ET;
      if (n < ne) p.dx[(size_t)s * E + e0 + n] += dxa[s * LD + n];
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// words of the Meta table the wrapper builds (checked by the wrapper)
int k1_meta_words() { return META_WORDS; }

// ptrs: x, V, Y, u, envw, envwT, lat, latT, mix, mixT, dxo, dvo, meta,
//       xo, vo, dx, dV, dY, du  (unused ones may be 0)
// dims: ns, C, Cout, D, K, E, nlat, first_v, last, maxw, maxpc, in0
// Returns 0, a negative code for a shape the kernel does not take, or the
// cudaError_t of the launch.
int k1_launch(int bwd, const unsigned long long* ptrs, const int* dims, float inv_avg,
              void* stream) {
  K1P p{};
  p.x = (const float*)ptrs[0];
  p.V = (const float*)ptrs[1];
  p.Y = (const float*)ptrs[2];
  p.u = (const float*)ptrs[3];
  p.envw = (const float*)ptrs[4];
  p.envwT = (const float*)ptrs[5];
  p.lat = (const float*)ptrs[6];
  p.latT = (const float*)ptrs[7];
  p.mix = (const float*)ptrs[8];
  p.mixT = (const float*)ptrs[9];
  p.dxo = (const float*)ptrs[10];
  p.dvo = (const float*)ptrs[11];
  p.meta = (const int*)ptrs[12];
  p.xo = (float*)ptrs[13];
  p.vo = (float*)ptrs[14];
  p.dx = (float*)ptrs[15];
  p.dV = (float*)ptrs[16];
  p.dY = (float*)ptrs[17];
  p.du = (float*)ptrs[18];
  p.ns = dims[0];
  p.C = dims[1];
  p.Cout = dims[2];
  p.D = dims[3];
  p.K = dims[4];
  p.E = dims[5];
  p.nlat = dims[6];
  p.first_v = dims[7];
  p.last = dims[8];
  p.maxw = dims[9];
  p.maxpc = dims[10];
  p.in0 = dims[11];
  p.inv_avg = inv_avg;
  p.cns = 1.0f / sqrtf((float)p.ns);
  if (p.D > MAX_D || p.nlat < 1 || p.nlat > MAX_LAT) return -1;
  if (NT % p.C || NT / p.C > ET) return -2;  // thread-owned (c, n) TP cells
  if (p.K < 1 || p.E % p.K) return -3;
  if (p.ns % 4 || p.C % 4 || p.Cout % 4 || p.in0 % 4 || p.maxw % 4) return -4;
  if (!p.last && p.Cout != p.C) return -5;

  int off = META_WORDS;
  auto take = [&](int words) {
    const int o = off;
    off += words;
    return o;
  };
  p.o_env = take(p.D * p.C);
  p.o_denv = take(bwd ? p.D * p.C : 0);
  p.o_cat = take(p.in0 * LD);
  p.o_V = take(p.D * p.C * LD);
  p.o_pT = take(p.first_v ? p.C * LD : 0);
  p.o_Y = take(p.D * LD);
  p.o_u = take(LD);
  p.o_du = take(bwd ? LD : 0);
  p.o_R = take(0);
  int r_rows = p.C;  // center_env scratch
  if (bwd) {
    const int gw = p.in0 > p.maxw ? p.in0 : p.maxw;
    const int ph1 = 2 * p.ns + (p.nlat - 1) * p.maxw + 2 * gw;
    const int ph2 = p.D * p.C + p.maxpc + p.Cout;
    const int ph3 = 2 * p.C + p.ns;
    r_rows = ph1 > r_rows ? ph1 : r_rows;
    r_rows = ph2 > r_rows ? ph2 : r_rows;
    r_rows = ph3 > r_rows ? ph3 : r_rows;
  } else {
    const int lat = 2 * p.maxw + p.ns;
    r_rows = p.maxpc > r_rows ? p.maxpc : r_rows;
    r_rows = lat > r_rows ? lat : r_rows;
  }
  off += r_rows * LD;
  const size_t smem = (size_t)off * 4;
  if (smem > SMEM_MAX) return -6;

  const int blocks = p.E / p.K;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (bwd) {
    err = cudaFuncSetAttribute(k1_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    k1_bwd_kernel<<<blocks, NT, smem, st>>>(p);
  } else {
    err = cudaFuncSetAttribute(k1_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    k1_fwd_kernel<<<blocks, NT, smem, st>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
