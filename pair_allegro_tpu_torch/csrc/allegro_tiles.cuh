// Device pieces shared by the Allegro layer kernels K1 (fused_layer.cu), K2
// (env_layer.cu) and K4 (tp_mix_fused.cu): the 3j row table the wrappers
// build, shared tiles of the feature-major (features, E) layout (32 edges
// wide for K1 and K2; K4 also takes 16 and 8), the small matrix product on
// a tile and the channelwise TP of one output row (env per center for K1
// and K2, per edge for K4).
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int ET = 32;      // edges per tile
constexpr int LD = ET + 1;  // row stride of shared tiles (bank spread)
constexpr int NT = 256;     // threads per block
constexpr int MAX_ENT = 512;
constexpr int MAX_D = 16;
constexpr int MAX_LAT = 8;
constexpr int SMEM_MAX = 232448;

// Tables built by the wrapper (the numpy structured dtype of
// ops/fused_layer.py) and copied into shared memory at block start; K2
// leaves the latent fields unused.
struct Meta {
  int n_ent;
  int ent[MAX_ENT];  // p | i << 8 | j << 16, sorted by output row
  float w[MAX_ENT];
  int rowstart[MAX_D + 1];
  int rowP[MAX_D];     // paths feeding the row's l3
  int rowmix[MAX_D];   // float offset of the row's l3 block in mix / mixT
  float rownorm[MAX_D];
  int latdim[MAX_LAT + 1];
  int latoff[MAX_LAT];
};
constexpr int META_WORDS = sizeof(Meta) / 4;

// out[m*ldo + n] = scale * sum_k A[k*M + m] * B[k*(TW+1) + n] for m < M
// (M % 4 == 0, A 16-byte aligned), n < TW; only n < nvalid is written.
template <int TW = ET>
__device__ void gemm_tile(const float* __restrict__ A, int Kd, int M, const float* B,
                          float* out, int ldo, float scale, int nvalid) {
  constexpr int TLD = TW + 1;
  const int groups = (M >> 2) * TW;
  for (int idx = threadIdx.x; idx < groups; idx += NT) {
    const int n = idx % TW;
    const int m0 = (idx / TW) * 4;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    const float* Ak = A + m0;
    const float* Bk = B + n;
#pragma unroll 4
    for (int k = 0; k < Kd; ++k) {
      const float4 w = __ldg(reinterpret_cast<const float4*>(Ak));
      const float b = *Bk;
      a0 = fmaf(w.x, b, a0);
      a1 = fmaf(w.y, b, a1);
      a2 = fmaf(w.z, b, a2);
      a3 = fmaf(w.w, b, a3);
      Ak += M;
      Bk += TLD;
    }
    if (n < nvalid) {
      out[(size_t)(m0 + 0) * ldo + n] = a0 * scale;
      out[(size_t)(m0 + 1) * ldo + n] = a1 * scale;
      out[(size_t)(m0 + 2) * ldo + n] = a2 * scale;
      out[(size_t)(m0 + 3) * ldo + n] = a3 * scale;
    }
  }
}

// dst[r*(TW+1) + n] = src[r*E + e0 + n] for n < ne, 0 for ne <= n < TW
template <int TW = ET>
__device__ void load_tile(const float* __restrict__ src, int rows, int E, int e0, int ne,
                          float* dst) {
  constexpr int TLD = TW + 1;
  for (int q = threadIdx.x; q < rows * TW; q += NT) {
    const int r = q / TW, n = q % TW;
    dst[r * TLD + n] = n < ne ? __ldg(src + (size_t)r * E + e0 + n) : 0.f;
  }
}

__device__ void load_meta(const int* __restrict__ meta, int* s_meta) {
  for (int q = threadIdx.x; q < META_WORDS; q += NT) s_meta[q] = __ldg(meta + q);
  __syncthreads();
}

// T[(pp*C + c)*LD + n] = sum over the 3j entries of output row r of
// w * V[i][c][n] * env[j][c], on thread-owned (c, n) cells.
__device__ void tp_row(int C, const Meta& m, int r, const float* Vs, const float* env, float* T) {
  const int c = threadIdx.x % C;
  const int n0 = threadIdx.x / C, nstep = NT / C;
  const int P = m.rowP[r];
  for (int n = n0; n < ET; n += nstep)
    for (int pp = 0; pp < P; ++pp) T[(pp * C + c) * LD + n] = 0.f;
  for (int e = m.rowstart[r]; e < m.rowstart[r + 1]; ++e) {
    const int code = m.ent[e];
    const int pp = code & 255, i = (code >> 8) & 255, j = code >> 16;
    const float we = m.w[e] * env[j * C + c];
    float* Tr = T + (pp * C + c) * LD;
    const float* Vr = Vs + (i * C + c) * LD;
    for (int n = n0; n < ET; n += nstep) Tr[n] = fmaf(we, Vr[n], Tr[n]);
  }
}

// K4's TP row, with env on the edges: T[(c*P + pp)*(TW+1) + n] = sum over
// the 3j entries of output row r of w * V[i][c][n] * env[j][c][n].  T's
// rows are c-major (the order of the tree's mix leaves and of the
// invariants); each thread owns the cells (c, n) = (q / TW, q % TW), q =
// threadIdx.x + k*NT, so the row needs no synchronisation.
template <int TW>
__device__ void tp_row_edges(int C, const Meta& m, int r, const float* Vs, const float* envs,
                             float* T) {
  constexpr int TLD = TW + 1;
  const int P = m.rowP[r];
  for (int q = threadIdx.x; q < C * TW; q += NT) {
    const int c = q / TW, n = q % TW;
    float* Tc = T + c * P * TLD + n;
    for (int pp = 0; pp < P; ++pp) Tc[pp * TLD] = 0.f;
    for (int e = m.rowstart[r]; e < m.rowstart[r + 1]; ++e) {
      const int code = m.ent[e];
      const int pp = code & 255, i = (code >> 8) & 255, j = code >> 16;
      const float we = m.w[e] * envs[(j * C + c) * TLD + n];
      Tc[pp * TLD] = fmaf(we, Vs[(i * C + c) * TLD + n], Tc[pp * TLD]);
    }
  }
}

}  // namespace
