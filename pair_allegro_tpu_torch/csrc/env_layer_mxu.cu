// K5: K2's function as one product against a folded constant matrix, a
// hand-written Hopper kernel pair (f32 arithmetic, three precisions).
//
// Replaces the TPU kernels pair_allegro_tpu/ops/pallas_stack.py
// _env_layer_mxu_fwd_kernel / _env_layer_mxu_bwd_kernel (entry
// tp_mix_env_fused_t, mode "mxu_*").  On the feature-major TABLE layout,
// per center (K contiguous edges):
//   env = sum_k wz (x) Y / sqrt(avg_n)                           (D, C)
//   O[(ij, c), e] = V[i, c, e] env[j, c]                        (D*D*C, E)
//   V'[(k, c'), e] = sum_(ij, c) Mk[(ij, c), (k, c')] O[(ij, c), e]
//   inv[c*P0 + p, e] = sum of the l3=0 entries (p, i, j, w) of w O
// with Mk the combined TP + mix matrix (ops/tp.combined_tp_mix_matrix, rows
// (ij, c)-major, 2592 x 288 = 3 MB at l_max=2, C=32: it stays in L2).  The
// backward forms dO = Mk dV' (Mt, the transpose, is read), adds the inv
// cotangent, and returns dV = sum_j dO env_j, dwz and dY through the
// per-center denv = sum_i dO V_i, as K2's backward does.
//
// Precision (mode, as pallas_stack.py:_env_mxu_mix defines it): 0
// mxu_highest, f32 products; 1 mxu_bf16x3, hi*hi + hi*lo + lo*hi of bf16
// splits; 2 mxu_bf16, one pass of bf16-rounded operands.  The wrapper
// splits or rounds M; the kernel splits or rounds O (forward) and dV'
// (backward) with __float2bfloat16_rn.  Products of bf16 values are exact
// in f32 and every sum is f32, so the CUDA cores compute exactly what the
// TPU's bf16 matrix passes with f32 accumulation compute, up to the order
// of the sums.  The invariants use the unrounded O; dinv is added in f32.
//
// What bounds it on an H100: operations.  The product is 2*2592*288 = 1.5
// Mflop per edge (6x the TP + mix it replaces) against ~1.3 KB moved.  On
// the CUDA cores the f32 peak (67 TFLOP/s) bounds all three modes; the bf16
// modes' bound at the tensor-core rate is 15x lower, which is where a
// wgmma redesign would go.
//
// Design (a simple CUDA-core version):
//  * one thread block per center, so env and denv are block-local;
//  * O is never whole: it is built in shared memory one (i, j) pair at a
//    time, C rows x an edge tile (64 edges forward, 32 backward), double
//    buffered, and multiplied into register tiles of 4 output rows x 8
//    edges per thread (32 FMAs per float4 weight load and two float4
//    shared loads);
//  * the backward stages dV' (and its bf16 split) for the edge tile once,
//    computes dO one i at a time into shared memory, and reduces it into
//    dV (over j) and denv (over the edges).
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see ops/env_layer_mxu.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_D = 16;
constexpr int MAX_THREADS = 576;
constexpr int SMEM_MAX = 232448;

// l3 = 0 entries per (i, j) pair: p (or -1) and the 3j weight, built by the
// wrapper (numpy structured dtype of ops/env_layer_mxu.py).
struct Inv0 {
  int p[MAX_D * MAX_D];
  float w[MAX_D * MAX_D];
};
constexpr int INV0_WORDS = sizeof(Inv0) / 4;

struct K5P {
  const float *V, *wz, *Y, *Mk, *Mk_lo, *Mt, *Mt_lo, *dout, *dinv;
  const int* inv0;
  float *out, *inv, *dV, *dwz, *dY;
  int C, Cout, D, K, E, P0, M, DDC, et, ld, ntiles;
  float inv_avg;
};

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void fma8(float* acc, float a, const float4& b0, const float4& b1) {
  acc[0] = fmaf(a, b0.x, acc[0]);
  acc[1] = fmaf(a, b0.y, acc[1]);
  acc[2] = fmaf(a, b0.z, acc[2]);
  acc[3] = fmaf(a, b0.w, acc[3]);
  acc[4] = fmaf(a, b1.x, acc[4]);
  acc[5] = fmaf(a, b1.y, acc[5]);
  acc[6] = fmaf(a, b1.z, acc[6]);
  acc[7] = fmaf(a, b1.w, acc[7]);
}

// acc[r][n] += A[r] * B[n] for the 4 x 8 register tile
__device__ __forceinline__ void fma_tile(float (*acc)[8], const float4& a, const float4& b0,
                                         const float4& b1) {
  fma8(acc[0], a.x, b0, b1);
  fma8(acc[1], a.y, b0, b1);
  fma8(acc[2], a.z, b0, b1);
  fma8(acc[3], a.w, b0, b1);
}

__device__ void load_inv0(const K5P& p, int* s) {
  for (int q = threadIdx.x; q < INV0_WORDS; q += blockDim.x) s[q] = __ldg(p.inv0 + q);
}

// env[d*C + c] = inv_avg * sum over the center's K edges of wz[c] * Y[d]
__device__ void center_env(const K5P& p, int center, float* env) {
  const int C = p.C;
  for (int q = threadIdx.x; q < p.D * C; q += blockDim.x) {
    const float* wr = p.wz + (size_t)(q % C) * p.E + (size_t)center * p.K;
    const float* yr = p.Y + (size_t)(q / C) * p.E + (size_t)center * p.K;
    float s = 0.f;
    for (int k = 0; k < p.K; ++k) s = fmaf(__ldg(wr + k), __ldg(yr + k), s);
    env[q] = s * p.inv_avg;
  }
  __syncthreads();
}

// O rows (i, j, c) of pair ch for the edge tile [e0, e0 + ne), rounded or
// split per MODE into Ob / Ol; the unrounded O feeds the invariants (each
// thread owns the same (c, n) cells for every pair, so invS needs no sync).
template <int MODE>
__device__ void build_chunk(const K5P& p, int ch, int e0, int ne, const float* env,
                            const int* ip, const float* iw, float* Ob, float* Ol, float* invS) {
  const int C = p.C, et = p.et, ld = p.ld;
  const int i = ch / p.D, j = ch % p.D;
  const int pe = ip[ch];
  const float we = iw[ch];
  for (int q = threadIdx.x; q < C * et; q += blockDim.x) {
    const int c = q / et, n = q % et;
    const float v = n < ne ? __ldg(p.V + (size_t)(i * C + c) * p.E + e0 + n) : 0.f;
    const float o = v * env[j * C + c];
    if (pe >= 0) invS[(pe * C + c) * et + n] += we * o;
    if (MODE == 0) {
      Ob[c * ld + n] = o;
    } else {
      const float hi = bf16r(o);
      Ob[c * ld + n] = hi;
      if (MODE == 1) Ol[c * ld + n] = bf16r(o - hi);
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(MAX_THREADS) k5_fwd_kernel(const K5P p) {
  extern __shared__ float sm[];
  const int center = blockIdx.x, tid = threadIdx.x;
  const int C = p.C, D = p.D, E = p.E, et = p.et, ld = p.ld, M = p.M;
  int* ip = reinterpret_cast<int*>(sm);
  const float* iw = sm + MAX_D * MAX_D;
  float* env = sm + INV0_WORDS;
  float* Ob = env + D * C;                       // [2][C * ld]
  float* Ol = Ob + 2 * C * ld;                   // [2][C * ld], MODE 1 only
  float* invS = Ol + (MODE == 1 ? 2 * C * ld : 0);  // [P0][C][et]
  load_inv0(p, ip);
  center_env(p, center, env);  // syncs

  const int RG = M / 4;
  const bool active = tid < p.ntiles;
  const int m0 = 4 * (tid % RG), n0 = 8 * (tid / RG);
  const int nch = D * D;
  for (int t0 = 0; t0 < p.K; t0 += et) {
    const int e0 = center * p.K + t0, ne = min(et, p.K - t0);
    for (int q = tid; q < p.P0 * C * et; q += blockDim.x) invS[q] = 0.f;
    __syncthreads();
    build_chunk<MODE>(p, 0, e0, ne, env, ip, iw, Ob, Ol, invS);
    __syncthreads();
    float acc[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int n = 0; n < 8; ++n) acc[r][n] = 0.f;
    for (int ch = 0; ch < nch; ++ch) {
      const int buf = (ch & 1) * C * ld;
      if (ch + 1 < nch)
        build_chunk<MODE>(p, ch + 1, e0, ne, env, ip, iw, Ob + (C * ld - buf),
                          Ol + (C * ld - buf), invS);
      if (active) {
        const float* A = p.Mk + (size_t)ch * C * M + m0;
        const float* Al = MODE == 1 ? p.Mk_lo + (size_t)ch * C * M + m0 : nullptr;
        const float* B = Ob + buf + n0;
        const float* Bl = Ol + buf + n0;
#pragma unroll 2
        for (int c = 0; c < C; ++c) {
          const float4 a = __ldg(reinterpret_cast<const float4*>(A + (size_t)c * M));
          const float4 b0 = *reinterpret_cast<const float4*>(B + c * ld);
          const float4 b1 = *reinterpret_cast<const float4*>(B + c * ld + 4);
          fma_tile(acc, a, b0, b1);
          if (MODE == 1) {
            const float4 al = __ldg(reinterpret_cast<const float4*>(Al + (size_t)c * M));
            const float4 l0 = *reinterpret_cast<const float4*>(Bl + c * ld);
            const float4 l1 = *reinterpret_cast<const float4*>(Bl + c * ld + 4);
            fma_tile(acc, a, l0, l1);
            fma_tile(acc, al, b0, b1);
          }
        }
      }
      __syncthreads();
    }
    if (active) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int n = 0; n < 8; ++n)
          if (n0 + n < ne) p.out[(size_t)(m0 + r) * E + e0 + n0 + n] = acc[r][n];
    }
    for (int q = tid; q < p.P0 * C * et; q += blockDim.x) {  // inv, c-major rows c*P0 + pp
      const int row = q / et, n = q % et;  // row = pp*C + c
      if (n < ne) p.inv[(size_t)((row % C) * p.P0 + row / C) * E + e0 + n] = invS[q];
    }
    __syncthreads();
  }
}

template <int MODE>
__global__ void __launch_bounds__(MAX_THREADS) k5_bwd_kernel(const K5P p) {
  extern __shared__ float sm[];
  const int center = blockIdx.x, tid = threadIdx.x;
  const int C = p.C, D = p.D, E = p.E, et = p.et, ld = p.ld, M = p.M, DC = D * C;
  int* ip = reinterpret_cast<int*>(sm);
  const float* iw = sm + MAX_D * MAX_D;
  float* env = sm + INV0_WORDS;
  float* denv = env + DC;
  float* Dt = denv + DC;                         // dV' tile [M][ld]
  float* Dl = Dt + M * ld;                       // its bf16 remainder, MODE 1 only
  float* Gs = Dl + (MODE == 1 ? M * ld : 0);     // dO rows (j, c) of one i [DC][ld]
  float* Vi = Gs + DC * ld;                      // V rows of that i [C][ld]
  load_inv0(p, ip);
  center_env(p, center, env);  // syncs
  for (int r = tid; r < DC; r += blockDim.x) denv[r] = 0.f;

  const int RG = DC / 4;
  const bool active = tid < p.ntiles;
  const int r0 = 4 * (tid % RG), n0 = 8 * (tid / RG);
  for (int t0 = 0; t0 < p.K; t0 += et) {
    const int e0 = center * p.K + t0, ne = min(et, p.K - t0);
    for (int q = tid; q < M * et; q += blockDim.x) {
      const int m = q / et, n = q % et;
      const float d = n < ne ? __ldg(p.dout + (size_t)m * E + e0 + n) : 0.f;
      if (MODE == 0) {
        Dt[m * ld + n] = d;
      } else {
        const float hi = bf16r(d);
        Dt[m * ld + n] = hi;
        if (MODE == 1) Dl[m * ld + n] = bf16r(d - hi);
      }
    }
    for (int i = 0; i < D; ++i) {
      for (int q = tid; q < C * et; q += blockDim.x) {
        const int c = q / et, n = q % et;
        Vi[c * ld + n] = n < ne ? __ldg(p.V + (size_t)(i * C + c) * E + e0 + n) : 0.f;
      }
      __syncthreads();
      if (active) {
        float acc[4][8];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int n = 0; n < 8; ++n) acc[r][n] = 0.f;
        const float* A = p.Mt + (size_t)i * DC + r0;  // Mt[m*DDC + (i*D + j)*C + c]
        const float* Al = MODE == 1 ? p.Mt_lo + (size_t)i * DC + r0 : nullptr;
        const float* B = Dt + n0;
        const float* Bl = Dl + n0;
#pragma unroll 2
        for (int m = 0; m < M; ++m) {
          const float4 a = __ldg(reinterpret_cast<const float4*>(A + (size_t)m * p.DDC));
          const float4 b0 = *reinterpret_cast<const float4*>(B + m * ld);
          const float4 b1 = *reinterpret_cast<const float4*>(B + m * ld + 4);
          fma_tile(acc, a, b0, b1);
          if (MODE == 1) {
            const float4 al = __ldg(reinterpret_cast<const float4*>(Al + (size_t)m * p.DDC));
            const float4 l0 = *reinterpret_cast<const float4*>(Bl + m * ld);
            const float4 l1 = *reinterpret_cast<const float4*>(Bl + m * ld + 4);
            fma_tile(acc, a, l0, l1);
            fma_tile(acc, al, b0, b1);
          }
        }
        const int ch = i * D + r0 / C;  // the 4 rows share j (C % 4 == 0)
        const int pe = ip[ch];
        const float we = iw[ch];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int c = (r0 + r) % C;
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            float g = acc[r][n];
            if (pe >= 0 && n0 + n < ne)
              g += we * __ldg(p.dinv + (size_t)(c * p.P0 + pe) * E + e0 + n0 + n);
            Gs[(r0 + r) * ld + n0 + n] = g;
          }
        }
      }
      __syncthreads();
      for (int q = tid; q < C * et; q += blockDim.x) {  // dV[i] = sum_j dO[i, j] env[j]
        const int c = q / et, n = q % et;
        float s = 0.f;
        for (int j = 0; j < D; ++j) s = fmaf(Gs[(j * C + c) * ld + n], env[j * C + c], s);
        if (n < ne) p.dV[(size_t)(i * C + c) * E + e0 + n] = s;
      }
      for (int r = tid; r < DC; r += blockDim.x) {  // denv[j] += sum_n dO[i, j] V[i]
        const float* g = Gs + r * ld;
        const float* v = Vi + (r % C) * ld;
        float s = 0.f;
        for (int n = 0; n < et; ++n) s = fmaf(g[n], v[n], s);
        denv[r] += s;
      }
      __syncthreads();
    }
  }

  // env backward with the complete per-center denv
  for (int r = tid; r < DC; r += blockDim.x) denv[r] *= p.inv_avg;  // = dA
  __syncthreads();
  for (int t0 = 0; t0 < p.K; t0 += et) {
    const int e0 = center * p.K + t0, ne = min(et, p.K - t0);
    for (int q = tid; q < C * et; q += blockDim.x) {
      const int c = q / et, n = q % et;
      if (n >= ne) continue;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(denv[d * C + c], __ldg(p.Y + (size_t)d * E + e0 + n), s);
      p.dwz[(size_t)c * E + e0 + n] = s;
    }
    for (int q = tid; q < D * et; q += blockDim.x) {
      const int d = q / et, n = q % et;
      if (n >= ne) continue;
      float s = 0.f;
      for (int c = 0; c < C; ++c) s = fmaf(denv[d * C + c], __ldg(p.wz + (size_t)c * E + e0 + n), s);
      p.dY[(size_t)d * E + e0 + n] = s;
    }
  }
}

template <typename Kern>
int launch(Kern kernel, const K5P& p, size_t smem, int blocks, cudaStream_t st) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = (p.ntiles + 31) / 32 * 32;
  kernel<<<blocks, threads, smem, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// words of the Inv0 table the wrapper builds (checked by the wrapper)
int k5_inv0_words() { return INV0_WORDS; }

// ptrs: V, wz, Y, Mk, Mk_lo, Mt, Mt_lo, inv0, dout, dinv, out, inv, dV,
//       dwz, dY  (unused ones may be 0)
// dims: C, Cout, D, K, E, P0, mode (0 mxu_highest, 1 mxu_bf16x3, 2 mxu_bf16)
// Returns 0, a negative code for a shape the kernel does not take, or the
// cudaError_t of the launch.
int k5_launch(int bwd, const unsigned long long* ptrs, const int* dims, float inv_avg,
              void* stream) {
  K5P p{};
  p.V = (const float*)ptrs[0];
  p.wz = (const float*)ptrs[1];
  p.Y = (const float*)ptrs[2];
  p.Mk = (const float*)ptrs[3];
  p.Mk_lo = (const float*)ptrs[4];
  p.Mt = (const float*)ptrs[5];
  p.Mt_lo = (const float*)ptrs[6];
  p.inv0 = (const int*)ptrs[7];
  p.dout = (const float*)ptrs[8];
  p.dinv = (const float*)ptrs[9];
  p.out = (float*)ptrs[10];
  p.inv = (float*)ptrs[11];
  p.dV = (float*)ptrs[12];
  p.dwz = (float*)ptrs[13];
  p.dY = (float*)ptrs[14];
  p.C = dims[0];
  p.Cout = dims[1];
  p.D = dims[2];
  p.K = dims[3];
  p.E = dims[4];
  p.P0 = dims[5];
  const int mode = dims[6];
  p.inv_avg = inv_avg;
  p.M = p.D * p.Cout;
  p.DDC = p.D * p.D * p.C;
  if (p.D > MAX_D || mode < 0 || mode > 2) return -1;
  if (p.K < 1 || p.E % p.K) return -3;
  if (p.C % 4 || p.Cout % 4) return -4;
  if (mode == 1 && (!p.Mk_lo || !p.Mt_lo)) return -5;

  // the widest edge tile whose 4 x 8 register tiles fit one block of at
  // most MAX_THREADS threads and whose shared memory fits
  const int rows = bwd ? p.D * p.C : p.M;
  const int two = mode == 1 ? 2 : 1;
  size_t smem = 0;
  for (p.et = bwd ? 32 : 64; p.et >= 8; p.et /= 2) {
    p.ld = p.et + 4;
    p.ntiles = rows / 4 * (p.et / 8);
    const size_t words =
        bwd ? INV0_WORDS + 2 * p.D * p.C + (size_t)two * p.M * p.ld + (size_t)p.D * p.C * p.ld +
                  (size_t)p.C * p.ld
            : INV0_WORDS + p.D * p.C + (size_t)2 * two * p.C * p.ld + (size_t)p.P0 * p.C * p.et;
    smem = words * 4;
    if (p.ntiles <= MAX_THREADS && smem <= SMEM_MAX) break;
  }
  if (p.et < 8) return -6;

  const int blocks = p.E / p.K;
  cudaStream_t st = (cudaStream_t)stream;
  if (bwd) {
    if (mode == 0) return launch(k5_bwd_kernel<0>, p, smem, blocks, st);
    if (mode == 1) return launch(k5_bwd_kernel<1>, p, smem, blocks, st);
    return launch(k5_bwd_kernel<2>, p, smem, blocks, st);
  }
  if (mode == 0) return launch(k5_fwd_kernel<0>, p, smem, blocks, st);
  if (mode == 1) return launch(k5_fwd_kernel<1>, p, smem, blocks, st);
  return launch(k5_fwd_kernel<2>, p, smem, blocks, st);
}

}  // extern "C"
