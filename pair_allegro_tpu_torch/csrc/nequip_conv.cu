// K3: the fused NequIP convolution as a hand-written Hopper kernel pair (f32).
//
// Replaces the TPU kernels pair_allegro_tpu/ops/pallas_nequip.py
// _conv_fwd_kernel / _conv_bwd_kernel (entry nequip_conv_fused).  On the
// edge-major TABLE layout (rows are edges, each center's K rows contiguous;
// hj and agg lanes (d*T + tau)*C + c, radial lanes (tau*P + p)*C + c) the
// forward computes, per message-passing layer,
//   w   = radial_MLP(bessel) * u                              (E, T*P*C)
//   msg = channelwise TP of hj with Y weighted by w, routed to
//         track tau = pi XOR (l2 mod 2)                       (E, D*T*C)
//   agg = per-center sum of msg * inv_avg                     (N, D*T*C)
// and the backward returns dhj, dbessel, du (the gradient of the second
// envelope factor only) and dY.  It recomputes the radial MLP instead of
// storing it, as the TPU kernel does.  Weight cotangents are not computed:
// the wrapper hands them back NaN-filled.
//
// What bounds it on an H100: both, nearly evenly.  At the NequIP bench
// (l_max=1, two tracks, C=64, 2x32 radial MLP) the forward does ~45k flops
// per edge (the 32 x 640 last radial layer is 41k of them) against ~2.1 KB
// read per edge (the gathered hj row is 2 KB): ~21 flops per byte, right at
// the f32 CUDA-core ridge (67 TFLOP/s / 3.35 TB/s = 20 flops per byte).
// The backward does about twice the flops and also writes dhj.
//
// Design:
//  * one thread block owns one whole center, so the K-sum of the forward
//    and the broadcast of the center's cotangent in the backward stay in
//    the block: no atomics in device memory, no second launch.  The TPU's
//    group-indicator matmul, its bf16 split, the bf16x3 dots, the CN block
//    geometry and the center padding are not carried over;
//  * the message is channel-wise ("uvu"): output channel c reads only
//    channel c of hj and the radial columns of channel c.  A thread owns
//    one channel c and every Q-th edge (Q = threads / C), so each warp reads
//    32 consecutive channels of an hj row (coalesced), forms its own
//    channel's T*P radial weights in registers (NE edges at a time, so each
//    weight load feeds NE FMAs) and accumulates agg in registers; the
//    threads of one channel are summed through shared memory at the end;
//  * the radial hidden layers (8 -> 32 -> 32) of a tile of edges are
//    computed once into shared memory and read back as broadcasts;
//  * the TP is unrolled at compile time from the X-macro entry tables in
//    nequip_tp_table.cuh (generated from ops/tp.py:tp_entry_table), so every
//    index is a constant and all per-edge values stay in registers;
//  * the backward's cross-channel reductions (dY, du per edge) go through a
//    warp shuffle and shared-memory atomics; the cross-channel product with
//    the last radial weight (the gradient into the hidden layers) is a
//    block-cooperative product over a shared-memory tile of dw * u, in
//    4 x 4 register blocks from float4 loads, its columns split across
//    thread groups (back_last);
//  * products are exact f32 FMAs on the CUDA cores (no TF32, no tensor
//    cores).  The K x 32 x 640 last radial product per center is the
//    natural wgmma candidate for a later change.
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see ops/nequip_conv.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "nequip_tp_table.cuh"

namespace {

constexpr int NT_MAX = 256;
constexpr int MAX_W = 8;
constexpr int SMEM_MAX = 232448;
constexpr float SILU_C = 1.6790564307512243f;

struct K3P {
  const float *hj, *bes, *u, *Y, *w, *wlT, *dagg;
  float *agg, *dhj, *dbes, *du, *dY;
  int C, K, E, nw, Q, ET, hmax;
  int gstride, nch;  // backward: row stride of the dw * u tile; column groups of back_last
  int wdim[MAX_W + 1];
  int woff[MAX_W];
  float inv_avg;
  // shared-memory offsets (floats)
  int o_bs, o_xa, o_xb, o_z, o_y, o_u, o_red, o_g, o_dy, o_du, o_part;
};

__device__ __forceinline__ float silu(float z) { return z / (1.0f + expf(-z)); }

__device__ __forceinline__ float dsilu(float z) {
  const float s = 1.0f / (1.0f + expf(-z));
  return s * (1.0f + z * (1.0f - s));
}

template <int LMAX, int T>
struct Cfg {
  static constexpr int D = (LMAX + 1) * (LMAX + 1);
  static constexpr int P = LMAX == 1 ? K3_P_L1 : K3_P_L2;
  static constexpr int DT = D * T;
  static constexpr int TP = T * P;
  static constexpr int NE = TP <= 16 ? 4 : 2;  // edges per thread per tile
};

// Loads the tile's bessel rows, u and Y (zero past ne) and runs the radial
// hidden layers; returns the last layer's input (ET x wdim[nw-1]).  With
// keep_z the pre-activations stay in sm + o_z (layer i at i * ET * hmax).
template <int D>
__device__ const float* radial_hidden(const K3P& p, float* sm, int e0, int ne, bool keep_z) {
  const int B = p.wdim[0];
  float* bs = sm + p.o_bs;
  float* ys = sm + p.o_y;
  float* us = sm + p.o_u;
  for (int q = threadIdx.x; q < p.ET * B; q += blockDim.x) {
    const int n = q / B;
    bs[q] = n < ne ? __ldg(p.bes + (size_t)(e0 + n) * B + q % B) : 0.f;
  }
  for (int q = threadIdx.x; q < p.ET * D; q += blockDim.x) {
    const int n = q / D;
    ys[q] = n < ne ? __ldg(p.Y + (size_t)(e0 + n) * D + q % D) : 0.f;
  }
  for (int n = threadIdx.x; n < p.ET; n += blockDim.x) us[n] = n < ne ? __ldg(p.u + e0 + n) : 0.f;
  __syncthreads();
  const float* in = bs;
  for (int i = 0; i + 1 < p.nw; ++i) {
    const int din = p.wdim[i], dout = p.wdim[i + 1];
    const float* W = p.w + p.woff[i];
    const float s = rsqrtf((float)din);
    float* out = sm + ((i & 1) ? p.o_xb : p.o_xa);
    float* zs = sm + p.o_z + i * p.ET * p.hmax;
    for (int q = threadIdx.x; q < p.ET * dout; q += blockDim.x) {
      const int n = q / dout, j = q % dout;
      float acc = 0.f;
      for (int k = 0; k < din; ++k) acc = fmaf(in[n * din + k], __ldg(W + k * dout + j), acc);
      const float z = acc * s;
      if (keep_z) zs[q] = z;
      out[q] = silu(z) * SILU_C;
    }
    __syncthreads();
    in = out;
  }
  return in;
}

// acc[j][t] = sum_k xs[n_j][k] * Wlast[k][t*C + c] for this thread's NE
// edges n_j = q + Q*j of the tile (unscaled).
template <int TP, int NE>
__device__ void radial_last(const K3P& p, const float* xs, int c, int q, float (&acc)[NE][TP]) {
  const int hin = p.wdim[p.nw - 1];
  const int tpc = TP * p.C;
  const float* Wl = p.w + p.woff[p.nw - 1] + c;
#pragma unroll
  for (int j = 0; j < NE; ++j)
#pragma unroll
    for (int t = 0; t < TP; ++t) acc[j][t] = 0.f;
  for (int k = 0; k < hin; ++k) {
    float xv[NE];
#pragma unroll
    for (int j = 0; j < NE; ++j) xv[j] = xs[(q + p.Q * j) * hin + k];
    const float* Wk = Wl + (size_t)k * tpc;
#pragma unroll
    for (int t = 0; t < TP; ++t) {
      const float wv = __ldg(Wk + t * p.C);
#pragma unroll
      for (int j = 0; j < NE; ++j) acc[j][t] = fmaf(xv[j], wv, acc[j][t]);
    }
  }
}

// dx[n][k] = s * sum_col gs[n][col] * WlT[col][k], the gradient into the last
// radial layer's input.  Each thread computes a register block of 4 edges
// (strided by ET/4, so the 4 rows of a warp's loads fall in distinct banks)
// by 4 k over one of nch column groups, from float4 loads of both operands:
// 16 FMAs per 2 loads.  The groups' partial sums meet in shared memory.
__device__ void back_last(const K3P& p, const float* gs, float* part, float* dx, int hin,
                          int tpc, float s) {
  const int ng = p.ET / 4, nk = hin / 4, nb = ng * nk;
  const int c4 = tpc / 4;
  const int per = (c4 + p.nch - 1) / p.nch;
  for (int wi = threadIdx.x; wi < nb * p.nch; wi += blockDim.x) {
    const int b = wi % nb, ch = wi / nb;
    const int g = b / nk, kg = b % nk;
    float a[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) a[i][j] = 0.f;
    const int q1 = min(c4, (ch + 1) * per);
    for (int q = ch * per; q < q1; ++q) {
      float4 gv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        gv[i] = *reinterpret_cast<const float4*>(gs + (g + ng * i) * p.gstride + 4 * q);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float4 wv =
            __ldg(reinterpret_cast<const float4*>(p.wlT + (size_t)(4 * q + cc) * hin + 4 * kg));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float gc = cc == 0 ? gv[i].x : cc == 1 ? gv[i].y : cc == 2 ? gv[i].z : gv[i].w;
          a[i][0] = fmaf(gc, wv.x, a[i][0]);
          a[i][1] = fmaf(gc, wv.y, a[i][1]);
          a[i][2] = fmaf(gc, wv.z, a[i][2]);
          a[i][3] = fmaf(gc, wv.w, a[i][3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[(ch * p.ET + g + ng * i) * hin + 4 * kg + j] = a[i][j];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < p.ET * hin; idx += blockDim.x) {
    float t = 0.f;
    for (int ch = 0; ch < p.nch; ++ch) t += part[ch * p.ET * hin + idx];
    dx[idx] = t * s;
  }
}

// forward: one TP entry for both tracks (pi = 0 lands in tau = l2_odd, pi = 1
// in tau = 1 - l2_odd)
#define K3_FWD(d1, d2, d3, pp, odd, cf)                                                \
  agg[(d3) * T + (T == 2 ? (odd) : 0)] += (cf) * wv[pp] * (h[(d1) * T] * y[d2]);      \
  if constexpr (T == 2) agg[(d3) * T + 1 - (odd)] += (cf) * wv[P + (pp)] * (h[(d1) * T + 1] * y[d2]);

// backward: the same entry's contributions to dh, dw and dY
#define K3_BWD_TRACK(d1, d2, d3, pp, cf, pi, tau)          \
  {                                                        \
    const float gm = (cf) * g[(d3) * T + (tau)];           \
    const float hy = h[(d1) * T + (pi)] * y[d2];           \
    const float gw = gm * wv[(pi) * P + (pp)];             \
    dh[(d1) * T + (pi)] = fmaf(gw, y[d2], dh[(d1) * T + (pi)]); \
    dw[(pi) * P + (pp)] = fmaf(gm, hy, dw[(pi) * P + (pp)]);    \
    dy[d2] = fmaf(gw, h[(d1) * T + (pi)], dy[d2]);              \
  }
#define K3_BWD(d1, d2, d3, pp, odd, cf)                                   \
  K3_BWD_TRACK(d1, d2, d3, pp, cf, 0, (T == 2 ? (odd) : 0))              \
  if constexpr (T == 2) K3_BWD_TRACK(d1, d2, d3, pp, cf, 1, 1 - (odd))

template <int LMAX, int T>
__global__ void __launch_bounds__(NT_MAX) k3_fwd_kernel(const K3P p) {
  using G = Cfg<LMAX, T>;
  constexpr int D = G::D, P = G::P, DT = G::DT, TP = G::TP, NE = G::NE;
  extern __shared__ float sm[];
  const int center = blockIdx.x;
  const int C = p.C;
  const int c = threadIdx.x % C, q = threadIdx.x / C;
  const int df = DT * C;
  const float s_last = rsqrtf((float)p.wdim[p.nw - 1]);
  float agg[DT];
#pragma unroll
  for (int i = 0; i < DT; ++i) agg[i] = 0.f;

  for (int t0 = 0; t0 < p.K; t0 += p.ET) {
    const int e0 = center * p.K + t0, ne = min(p.ET, p.K - t0);
    const float* xs = radial_hidden<D>(p, sm, e0, ne, false);
    float acc[NE][TP];
    radial_last<TP, NE>(p, xs, c, q, acc);
    const float* ys = sm + p.o_y;
    const float* us = sm + p.o_u;
#pragma unroll
    for (int j = 0; j < NE; ++j) {
      const int n = q + p.Q * j;
      if (n < ne) {
        const float* hrow = p.hj + (size_t)(e0 + n) * df + c;
        float h[DT], y[D], wv[TP];
#pragma unroll
        for (int i = 0; i < DT; ++i) h[i] = __ldg(hrow + i * C);
#pragma unroll
        for (int d = 0; d < D; ++d) y[d] = ys[n * D + d];
        const float uu = us[n] * s_last;
#pragma unroll
        for (int t = 0; t < TP; ++t) wv[t] = acc[j][t] * uu;
        if constexpr (LMAX == 1) {
          K3_TP_ENTRIES_L1(K3_FWD)
        } else {
          K3_TP_ENTRIES_L2(K3_FWD)
        }
      }
    }
    __syncthreads();  // the tile's shared buffers are rewritten next
  }
  float* red = sm + p.o_red;
#pragma unroll
  for (int i = 0; i < DT; ++i) red[(q * DT + i) * C + c] = agg[i];
  __syncthreads();
  for (int idx = threadIdx.x; idx < df; idx += blockDim.x) {
    float s = 0.f;
    for (int qq = 0; qq < p.Q; ++qq) s += red[qq * df + idx];
    p.agg[(size_t)center * df + idx] = s * p.inv_avg;
  }
}

template <int LMAX, int T>
__global__ void __launch_bounds__(NT_MAX) k3_bwd_kernel(const K3P p) {
  using G = Cfg<LMAX, T>;
  constexpr int D = G::D, P = G::P, DT = G::DT, TP = G::TP, NE = G::NE;
  extern __shared__ float sm[];
  const int center = blockIdx.x;
  const int C = p.C;
  const int c = threadIdx.x % C, q = threadIdx.x / C;
  const int df = DT * C, tpc = TP * C;
  const int hin = p.wdim[p.nw - 1];
  const float s_last = rsqrtf((float)hin);
  // lanes of one warp that share this thread's edges: min(C, 32)
  const int width = C < 32 ? C : 32;
  float g[DT];  // this center's cotangent of channel c, * inv_avg
#pragma unroll
  for (int i = 0; i < DT; ++i) g[i] = __ldg(p.dagg + (size_t)center * df + i * C + c) * p.inv_avg;
  float* gs = sm + p.o_g;
  float* dys = sm + p.o_dy;
  float* dus = sm + p.o_du;
  const float* ys = sm + p.o_y;
  const float* us = sm + p.o_u;

  for (int t0 = 0; t0 < p.K; t0 += p.ET) {
    const int e0 = center * p.K + t0, ne = min(p.ET, p.K - t0);
    for (int q2 = threadIdx.x; q2 < p.ET * D; q2 += blockDim.x) dys[q2] = 0.f;
    for (int n = threadIdx.x; n < p.ET; n += blockDim.x) dus[n] = 0.f;
    const float* xs = radial_hidden<D>(p, sm, e0, ne, true);
    float acc[NE][TP];
    radial_last<TP, NE>(p, xs, c, q, acc);
#pragma unroll
    for (int j = 0; j < NE; ++j) {
      const int n = q + p.Q * j;
      const bool valid = n < ne;
      const float* hrow = p.hj + (size_t)(e0 + n) * df + c;
      float h[DT], y[D], wv[TP], dh[DT], dw[TP], dy[D];
#pragma unroll
      for (int i = 0; i < DT; ++i) {
        h[i] = valid ? __ldg(hrow + i * C) : 0.f;
        dh[i] = 0.f;
      }
#pragma unroll
      for (int d = 0; d < D; ++d) {
        y[d] = ys[n * D + d];
        dy[d] = 0.f;
      }
      const float uu = us[n];
#pragma unroll
      for (int t = 0; t < TP; ++t) {
        wv[t] = acc[j][t] * s_last * uu;
        dw[t] = 0.f;
      }
      if constexpr (LMAX == 1) {
        K3_TP_ENTRIES_L1(K3_BWD)
      } else {
        K3_TP_ENTRIES_L2(K3_BWD)
      }
      if (valid) {
        float* drow = p.dhj + (size_t)(e0 + n) * df + c;
#pragma unroll
        for (int i = 0; i < DT; ++i) drow[i * C] = dh[i];
      }
      float dup = 0.f;  // du = sum over (pi, p, c) of dw * w_raw
#pragma unroll
      for (int t = 0; t < TP; ++t) {
        dup = fmaf(dw[t], acc[j][t] * s_last, dup);
        gs[n * p.gstride + t * C + c] = dw[t] * uu;
      }
      for (int off = width >> 1; off > 0; off >>= 1) {
        dup += __shfl_xor_sync(0xffffffffu, dup, off);
#pragma unroll
        for (int d = 0; d < D; ++d) dy[d] += __shfl_xor_sync(0xffffffffu, dy[d], off);
      }
      if (c % width == 0) {
        atomicAdd(dus + n, dup);
#pragma unroll
        for (int d = 0; d < D; ++d) atomicAdd(dys + n * D + d, dy[d]);
      }
    }
    __syncthreads();
    // gradient into the last layer's input
    float* dx = sm + p.o_xa;
    float* dx2 = sm + p.o_xb;
    back_last(p, gs, sm + p.o_part, dx, hin, tpc, s_last);
    __syncthreads();
    // back through the hidden layers: dz = dx * silu'(z) * c, dx_i = s * dz W_i^T
    for (int i = p.nw - 2; i >= 0; --i) {
      const int din = p.wdim[i], dout = p.wdim[i + 1];
      const float* W = p.w + p.woff[i];
      const float* zs = sm + p.o_z + i * p.ET * p.hmax;
      const float s = rsqrtf((float)din);
      for (int idx = threadIdx.x; idx < p.ET * dout; idx += blockDim.x)
        dx[idx] *= dsilu(zs[idx]) * SILU_C;
      __syncthreads();
      for (int idx = threadIdx.x; idx < p.ET * din; idx += blockDim.x) {
        const int n = idx / din, k = idx % din;
        float a = 0.f;
        for (int jj = 0; jj < dout; ++jj) a = fmaf(dx[n * dout + jj], __ldg(W + k * dout + jj), a);
        dx2[idx] = a * s;
      }
      __syncthreads();
      float* tmp = dx;
      dx = dx2;
      dx2 = tmp;
    }
    const int B = p.wdim[0];
    for (int idx = threadIdx.x; idx < ne * B; idx += blockDim.x)
      p.dbes[(size_t)e0 * B + idx] = dx[idx];
    for (int idx = threadIdx.x; idx < ne * D; idx += blockDim.x)
      p.dY[(size_t)e0 * D + idx] = dys[idx];
    for (int n = threadIdx.x; n < ne; n += blockDim.x) p.du[e0 + n] = dus[n];
    __syncthreads();
  }
}

template <int LMAX, int T>
int launch(bool bwd, const K3P& p, size_t smem, int blocks, int threads, cudaStream_t st) {
  cudaError_t err;
  if (bwd) {
    err = cudaFuncSetAttribute(k3_bwd_kernel<LMAX, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    k3_bwd_kernel<LMAX, T><<<blocks, threads, smem, st>>>(p);
  } else {
    err = cudaFuncSetAttribute(k3_fwd_kernel<LMAX, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    k3_fwd_kernel<LMAX, T><<<blocks, threads, smem, st>>>(p);
  }
  return (int)cudaGetLastError();
}

template <int LMAX, int T>
int setup_and_launch(bool bwd, K3P& p, cudaStream_t st) {
  using G = Cfg<LMAX, T>;
  const int D = G::D, DT = G::DT, TP = G::TP;
  if (p.wdim[p.nw] != TP * p.C) return -4;
  p.ET = p.Q * G::NE;
  const int hin = p.wdim[p.nw - 1];
  // back_last's float4 blocks: 4 edges x 4 inputs x 4 columns
  if (bwd && (p.ET % 4 || hin % 4 || (TP * p.C) % 4)) return -7;
  p.gstride = TP * p.C + 4;
  const int nb = (p.ET / 4) * (hin / 4);
  p.nch = (!bwd || nb >= NT_MAX) ? 1 : NT_MAX / nb;
  int off = 0;
  auto take = [&](int words) {  // 16-byte aligned regions
    const int o = off;
    off += (words + 3) & ~3;
    return o;
  };
  p.o_bs = take(p.ET * p.wdim[0]);
  p.o_xa = take(p.ET * p.hmax);
  p.o_xb = take(p.ET * p.hmax);
  p.o_z = take(bwd ? (p.nw - 1) * p.ET * p.hmax : 0);
  p.o_y = take(p.ET * D);
  p.o_u = take(p.ET);
  p.o_red = take(bwd ? 0 : p.Q * DT * p.C);
  p.o_g = take(bwd ? p.ET * p.gstride : 0);
  p.o_dy = take(bwd ? p.ET * D : 0);
  p.o_du = take(bwd ? p.ET : 0);
  p.o_part = take(bwd ? p.nch * p.ET * hin : 0);
  const size_t smem = (size_t)off * 4;
  if (smem > SMEM_MAX) return -5;
  return launch<LMAX, T>(bwd, p, smem, p.E / p.K, p.Q * p.C, st);
}

}  // namespace

extern "C" {

// radial MLP weight matrices the kernel takes (checked by the wrapper)
int k3_max_weights() { return MAX_W; }

// ptrs: hj, bes, u, Y, w (flat), wlT, dagg, agg, dhj, dbes, du, dY (unused ones 0)
// dims: C, K, E, nw, wdim[0..nw]
// Returns 0, a negative code for a shape the kernel does not take, or the
// cudaError_t of the launch.
int k3_launch(int bwd, int lmax, int n_tracks, const unsigned long long* ptrs, const int* dims,
              float inv_avg, void* stream) {
  K3P p{};
  p.hj = (const float*)ptrs[0];
  p.bes = (const float*)ptrs[1];
  p.u = (const float*)ptrs[2];
  p.Y = (const float*)ptrs[3];
  p.w = (const float*)ptrs[4];
  p.wlT = (const float*)ptrs[5];
  p.dagg = (const float*)ptrs[6];
  p.agg = (float*)ptrs[7];
  p.dhj = (float*)ptrs[8];
  p.dbes = (float*)ptrs[9];
  p.du = (float*)ptrs[10];
  p.dY = (float*)ptrs[11];
  p.C = dims[0];
  p.K = dims[1];
  p.E = dims[2];
  p.nw = dims[3];
  p.inv_avg = inv_avg;
  if (p.nw < 1 || p.nw > MAX_W) return -1;
  if (p.K < 1 || p.E % p.K) return -2;
  // a channel's threads must share warps evenly: C a multiple of 32, or a
  // power of two below 32
  if (p.C < 1 || p.C > NT_MAX || (p.C % 32 && 32 % p.C)) return -3;
  p.Q = NT_MAX / p.C;
  int off = 0;
  p.hmax = 0;
  for (int i = 0; i <= p.nw; ++i) {
    p.wdim[i] = dims[4 + i];
    if (p.wdim[i] < 1) return -4;
    if (i < p.nw) {
      p.woff[i] = off;
      off += p.wdim[i] * dims[5 + i];
      if (p.wdim[i] > p.hmax) p.hmax = p.wdim[i];
    }
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (lmax == 1 && n_tracks == 1) return setup_and_launch<1, 1>(bwd, p, st);
  if (lmax == 1 && n_tracks == 2) return setup_and_launch<1, 2>(bwd, p, st);
  if (lmax == 2 && n_tracks == 1) return setup_and_launch<2, 1>(bwd, p, st);
  if (lmax == 2 && n_tracks == 2) return setup_and_launch<2, 2>(bwd, p, st);
  return -6;
}

}  // extern "C"
