// K5: K2's function as one product against a folded constant matrix, a
// hand-written Hopper kernel pair whose products run on the tensor cores
// (mma.sync) in three precisions.
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
// backward forms dO = Mk dV' one i at a time, adds the inv cotangent, and
// returns dV = sum_j dO env_j, dwz and dY through the per-center
// denv = sum_i dO V_i, as K2's backward does.
//
// Precision (mode, as pallas_stack.py:_env_mxu_mix defines it):
//   0 mxu_highest: f32-accurate products, 3xTF32 on m16n8k8: every operand
//     x = hi + lo with hi = rna_tf32(x) and lo = x - hi, which the tensor
//     cores truncate to TF32, and lo*hi' + hi*lo' + hi*hi' accumulated in
//     f32 (each dropped term ~2^-21 relative);
//   1 mxu_bf16x3: hi*hi + hi*lo + lo*hi of bf16 splits of M and of O (dV'
//     in the backward), bf16 m16n8k16 into f32 accumulators;
//   2 mxu_bf16: one bf16 m16n8k16 pass of the rounded operands.
// Products of bf16 values are exact in f32 and every sum is f32, so the
// bf16 modes compute what the TPU's bf16 passes compute, up to the order of
// the sums.  The invariants use the unrounded O; dinv is added in f32.
//
// What bounds it on an H100: operations.  The product is 2*2592*288 = 1.5
// Mflop per edge each way (3x that in 3xTF32 and bf16x3) against ~1.3 KB
// moved: 3.08 ms at E = 340,736 in 3xTF32 at 495 TFLOP/s, 1.54 / 0.51 ms in
// the bf16 modes at 989.
//
// Design:
//  * one block of 16 warps per center (env and denv block-local), an edge
//    tile of ET = 64; each product's output tile (up to R = 320 rows x 64
//    edges) stays in registers: warps 4 (rows) x 4 (16 edges), each warp up
//    to 5 m16 tiles x 2 n8 tiles, 40 f32 accumulators a thread; wider
//    outputs take several passes of R rows;
//  * A (the matrix) comes in chunks of KC = 32 depth x R rows, laid out by
//    the wrapper chunk after chunk in the order the kernel consumes them
//    (ops/env_layer_mxu.py kernel_layout: zero-padded, f32 for mode 0 and
//    split there at fragment load, bf16 hi (and lo) planes for the bf16
//    modes, so the L2 stream is as large as the f32 matrix or half of it).
//    A cp.async ring of two stages loads chunk s + 1 while chunk s is
//    consumed, with one barrier a chunk;
//  * B is built by the threads in shared memory, edge-major (depth
//    contiguous), double-buffered and already split or rounded for the
//    mode: the forward's O chunk (pair ij, 32 channels) from V and env, the
//    backward's dV' chunk (32 rows of M) from device memory; its loads are
//    issued two chunks ahead into registers, so that they land while a
//    chunk's products run;
//  * forward: one product per pass over all D*D pairs; its epilogue stores
//    V' from the registers; the invariants are summed while pass 0 builds O
//    (thread-owned cells, accumulated in place in inv);
//  * backward: one product per (i, block of at most 64 channels c), its
//    rows (j, c) over all j, depth M; its epilogue adds the dinv terms in
//    registers and reduces dO into dV_i of the block (shared atomics,
//    stored at the product's end) and denv (a shuffle over the edges, then
//    atomics); dwz and dY follow from the complete denv.
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see ops/env_layer_mxu.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_ptx.cuh"

namespace {

constexpr int MAX_D = 16;
constexpr int SMEM_MAX = 232448;
constexpr int NTH = 512;              // threads: 16 warps
constexpr int KC = 32;                // depth of a chunk
constexpr int ETK = 64;               // edges per tile
constexpr int MTW = 5;                // m16 tiles a warp holds
constexpr int WM = 4;                 // warps along the rows (4 along the edges)
constexpr int RMAX = 16 * MTW * WM;   // rows of a pass
constexpr int LDA32 = KC + 4;         // words per staged row, f32
constexpr int LDA16 = KC / 2 + 4;     // words per staged row, bf16 pairs
constexpr int LDE = ETK + 4;          // row stride of the backward's V and dV tiles
constexpr int CB_MAX = 64;            // channels of a backward pass, at most

// l3 = 0 entries per (i, j) pair: p (or -1) and the 3j weight, built by the
// wrapper (numpy structured dtype of ops/env_layer_mxu.py).
struct Inv0 {
  int p[MAX_D * MAX_D];
  float w[MAX_D * MAX_D];
};
constexpr int INV0_WORDS = sizeof(Inv0) / 4;

struct K5P {
  const float *V, *wz, *Y, *dout, *dinv;
  const char* A;  // the direction's kernel layout (chunks in consumption order)
  const int* inv0;
  float *out, *inv, *dV, *dwz, *dY;
  int C, D, K, E, P0, M;
  int R, npass, nq, cbp;  // rows and passes of a product, its chunks, backward channels a pass
  float inv_avg;
};

// Geometry of a direction's products: passes over the output rows, R rows
// each (a multiple of 16, at most RMAX), nq chunks of depth KC each.
// Forward: the D*Cout rows of V' in passes, depth the D*D pairs' channel
// blocks.  Backward: per i, passes over blocks of cbp channels, a pass's
// rows (j, c) j-major over its block (so that dV_i of the block is
// complete at the pass's end), depth the D*Cout rows of dV'.
struct Plan {
  int npass, R, nq, cbp;
};

Plan plan_of(bool bwd, int C, int Cout, int D) {
  Plan q;
  const int M = D * Cout;
  if (bwd) {
    const int cb = RMAX / D < CB_MAX ? RMAX / D : CB_MAX;
    q.npass = (C + cb - 1) / cb;
    q.cbp = (C + q.npass - 1) / q.npass;
    q.R = 16 * ((D * q.cbp + 15) / 16);
    q.nq = (M + KC - 1) / KC;
  } else {
    const int t16 = (M + 15) / 16;
    q.npass = (t16 + RMAX / 16 - 1) / (RMAX / 16);
    q.R = 16 * ((t16 + q.npass - 1) / q.npass);
    q.nq = D * D * ((C + KC - 1) / KC);
    q.cbp = 0;
  }
  return q;
}

template <int MODE>
struct Geo {
  static constexpr int PLANES = MODE == 1 ? 2 : 1;
  static constexpr int LDA = MODE == 0 ? LDA32 : LDA16;
  static constexpr int PPR = MODE == 0 ? 8 : 4;  // 16-byte pieces per chunk row
  static constexpr int BWORDS = (MODE == 0 ? 2 : PLANES) * ETK * LDA;  // one B buffer
  static __host__ __device__ int stage_words(int R) { return PLANES * R * LDA; }
  static __host__ __device__ size_t chunk_bytes(int R) { return (size_t)PLANES * R * PPR * 16; }
};

__host__ __device__ inline int up4(int w) { return (w + 3) & ~3; }

// shared-memory words of a launch (the wrapper's kernel_takes mirrors this)
template <int MODE>
int smem_words(bool bwd, int C, int D, const Plan& q) {
  const int stage = Geo<MODE>::stage_words(q.R);
  int w = INV0_WORDS;
  if (bwd)
    w += 2 * up4(D * C) + 2 * stage + 2 * Geo<MODE>::BWORDS + 2 * q.cbp * LDE;
  else
    w += MAX_D * MAX_D + up4(D * C) + 2 * stage + 2 * Geo<MODE>::BWORDS;
  return w;
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // .x (low half) = a
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 3xTF32 split for K5: hi = rna_tf32(x) and the remainder x - hi passed
// as it is: the tensor cores read a TF32 operand's top 19 bits, so lo is
// truncated there (|x - hi| <= 2^-11 |x|, so its truncation costs at most
// 2^-21 |x|, the order of the dropped lo*lo' term) at two integer
// operations fewer than rounding it
__device__ __forceinline__ void split_tf32_rz(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ void load_inv0(const K5P& p, int* s) {
  for (int q = threadIdx.x; q < INV0_WORDS; q += NTH) s[q] = __ldg(p.inv0 + q);
}

// env[d*C + c] = inv_avg * sum over the center's K edges of wz[c] * Y[d]
__device__ void center_env(const K5P& p, int center, float* env) {
  const int C = p.C;
  for (int q = threadIdx.x; q < p.D * C; q += NTH) {
    const float* wr = p.wz + (size_t)(q % C) * p.E + (size_t)center * p.K;
    const float* yr = p.Y + (size_t)(q / C) * p.E + (size_t)center * p.K;
    float s = 0.f;
    for (int k = 0; k < p.K; ++k) s = fmaf(__ldg(wr + k), __ldg(yr + k), s);
    env[q] = s * p.inv_avg;
  }
}

// Issue chunk s of the direction's layout into a ring stage (one group).
template <int MODE>
__device__ __forceinline__ void stage_a(const K5P& p, int s, uint32_t* stage) {
  using G = Geo<MODE>;
  const char* src = p.A + (size_t)s * G::chunk_bytes(p.R);
  const int n = G::PLANES * p.R * G::PPR;
  for (int q = threadIdx.x; q < n; q += NTH)
    cp_async16(stage + (q / G::PPR) * G::LDA + (q % G::PPR) * 4, src + (size_t)q * 16, 16);
  cp_async_commit();
}

// B chunks are built in two steps so that their device-memory loads overlap
// a chunk's products: fetch (the loads, into NV registers a thread), then,
// after the next chunk's products, store (scale, split or round, write).
// Thread (warp w, lane) owns edge n = 8 (w % 8) + lane % 8 and the depths
// k = kof(u) of its NV values u, with kl = lane / 8 + 4 (w / 8) one of KL:
// KL u + kl in mode 0, pairs 2 (KL (u / 2) + kl) + u % 2 in the bf16
// modes; the same cells for every chunk (so a cell may accumulate in place
// across chunks).
constexpr int NV = KC * ETK / NTH;
constexpr int KL = NTH / ETK;

template <int MODE>
__device__ __forceinline__ int kof(int u) {
  const int kl = ((threadIdx.x & 31) >> 3) + 4 * (threadIdx.x >> 8);
  return MODE == 0 ? KL * u + kl : 2 * (KL * (u >> 1) + kl) + (u & 1);
}

__device__ __forceinline__ int own_n() { return ((threadIdx.x >> 5) & 7) * 8 + (threadIdx.x & 7); }

// Write the thread's values v into B chunk B, edge-major: split (mode 0:
// TF32 hi / lo planes; mode 1: bf16 hi / lo planes) or rounded (mode 2).
template <int MODE>
__device__ __forceinline__ void store_b(uint32_t* B, const float (&v)[NV]) {
  using G = Geo<MODE>;
  uint32_t* row = B + own_n() * G::LDA;
  if (MODE == 0) {
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      uint32_t hi, lo;
      split_tf32_rz(v[u], hi, lo);
      row[kof<MODE>(u)] = hi;
      row[ETK * G::LDA + kof<MODE>(u)] = lo;
    }
  } else {
#pragma unroll
    for (int u = 0; u < NV; u += 2) {
      const int kp = kof<MODE>(u) >> 1;
      row[kp] = pack_bf16(v[u], v[u + 1]);
      if (MODE == 1) row[ETK * G::LDA + kp] = pack_bf16(v[u] - bf16r(v[u]), v[u + 1] - bf16r(v[u + 1]));
    }
  }
}

// acc[mt][nt] += A_s^T-chunk x B-chunk: the warp's m16 tiles (row tiles wm
// + WM mt < mtp) x its two n8 tiles (edges 16 wn + 8 nt), depth KC.
template <int MODE>
__device__ __forceinline__ void chunk_product(const uint32_t* As, const uint32_t* B, int R,
                                              int mtp, float (&acc)[MTW][2][4]) {
  using G = Geo<MODE>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % WM, wn = warp / WM;
  const uint32_t* Bn = B + (wn * 16 + g) * G::LDA;
  if (MODE == 0) {
#pragma unroll
    for (int ks = 0; ks < KC / 8; ++ks) {
      const int k = ks * 8 + t;
      uint32_t bh[2][2], bl[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const uint32_t* b = Bn + nt * 8 * G::LDA;
        bh[nt][0] = b[k];
        bh[nt][1] = b[k + 4];
        bl[nt][0] = b[ETK * G::LDA + k];
        bl[nt][1] = b[ETK * G::LDA + k + 4];
      }
      const float* Af = reinterpret_cast<const float*>(As);
#pragma unroll
      for (int mt = 0; mt < MTW; ++mt) {
        const int tile = wm + WM * mt;
        if (tile < mtp) {
          const float* a = Af + (tile * 16 + g) * G::LDA + k;
          uint32_t ah[4], al[4];
          split_tf32_rz(a[0], ah[0], al[0]);
          split_tf32_rz(a[8 * G::LDA], ah[1], al[1]);
          split_tf32_rz(a[4], ah[2], al[2]);
          split_tf32_rz(a[8 * G::LDA + 4], ah[3], al[3]);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            mma_tf32(acc[mt][nt], al, bh[nt]);
            mma_tf32(acc[mt][nt], ah, bl[nt]);
            mma_tf32(acc[mt][nt], ah, bh[nt]);
          }
        }
      }
    }
  } else {
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      const int kw = ks * 8 + t;
      uint32_t bh[2][2], bl[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const uint32_t* b = Bn + nt * 8 * G::LDA;
        bh[nt][0] = b[kw];
        bh[nt][1] = b[kw + 4];
        if (MODE == 1) {
          bl[nt][0] = b[ETK * G::LDA + kw];
          bl[nt][1] = b[ETK * G::LDA + kw + 4];
        }
      }
#pragma unroll
      for (int mt = 0; mt < MTW; ++mt) {
        const int tile = wm + WM * mt;
        if (tile < mtp) {
          const uint32_t* a = As + (tile * 16 + g) * G::LDA + kw;
          const uint32_t ah[4] = {a[0], a[8 * G::LDA], a[4], a[8 * G::LDA + 4]};
          if (MODE == 1) {
            const uint32_t* b = a + R * G::LDA;  // the lo plane
            const uint32_t al[4] = {b[0], b[8 * G::LDA], b[4], b[8 * G::LDA + 4]};
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              mma_bf16(acc[mt][nt], al, bh[nt]);
              mma_bf16(acc[mt][nt], ah, bl[nt]);
              mma_bf16(acc[mt][nt], ah, bh[nt]);
            }
          } else {
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) mma_bf16(acc[mt][nt], ah, bh[nt]);
          }
        }
      }
    }
  }
}

// Coordinates of a forward chunk (pass p, pair (i, j), channel block cb) and
// of a backward chunk (i, pass pb, block q of M), stepped in the order the
// chunks are consumed without integer division.
struct FwdChunk {
  int cb = 0, j = 0, i = 0, p = 0;
  __device__ __forceinline__ void next(int ncb, int D) {
    if (++cb < ncb) return;
    cb = 0;
    if (++j < D) return;
    j = 0;
    if (++i < D) return;
    i = 0;
    ++p;
  }
};

struct BwdChunk {
  int q = 0, pb = 0, i = 0;
  __device__ __forceinline__ void next(int nq, int npass) {
    if (++q < nq) return;
    q = 0;
    if (++pb < npass) return;
    pb = 0;
    ++i;
  }
};

__device__ __forceinline__ void zero_acc(float (&acc)[MTW][2][4]) {
#pragma unroll
  for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[mt][nt][x] = 0.f;
}

template <int MODE>
__global__ void __launch_bounds__(NTH, 1) k5_fwd_kernel(const K5P p) {
  using G = Geo<MODE>;
  extern __shared__ __align__(16) float sm[];
  const int center = blockIdx.x, tid = threadIdx.x;
  const int C = p.C, D = p.D, E = p.E, DD = p.D * p.D;
  int* ip = reinterpret_cast<int*>(sm);
  const float* iw = sm + MAX_D * MAX_D;
  int* fst = reinterpret_cast<int*>(sm + INV0_WORDS);  // pair ch is its path's first
  float* env = sm + INV0_WORDS + MAX_D * MAX_D;
  uint32_t* ring = reinterpret_cast<uint32_t*>(env + up4(D * C));
  const int sw = G::stage_words(p.R);
  uint32_t* bbuf = ring + 2 * sw;
  load_inv0(p, ip);
  __syncthreads();
  for (int ch = tid; ch < DD; ch += NTH) {
    bool first = ip[ch] >= 0;
    for (int c2 = 0; c2 < ch && first; ++c2) first = ip[c2] != ip[ch];
    fst[ch] = first;
  }
  center_env(p, center, env);

  const int ncb = (C + KC - 1) / KC;
  const int S = p.npass * DD * ncb, mtp = p.R / 16;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wm = warp % WM, wn = warp / WM;
  float acc[MTW][2][4];
  for (int t0 = 0; t0 < p.K; t0 += ETK) {
    const int e0 = center * p.K + t0, ne = min(ETK, p.K - t0);
    // O chunk s: pair ch, channels [cb*KC, cb*KC + KC); pass 0 sums the
    // invariants in place in inv (the thread's own cells)
    const int n = own_n();
    float raw[NV], old[NV];
    auto fetch = [&](const FwdChunk& k) {
      const int ch = k.i * D + k.j, c0 = k.cb * KC, pe = ip[ch];
      const bool acc_inv = k.p == 0 && pe >= 0 && !fst[ch];
#pragma unroll
      for (int u = 0; u < NV; ++u) {
        const int c = c0 + kof<MODE>(u);
        const bool ok = c < C && n < ne;
        raw[u] = ok ? __ldg(p.V + (size_t)(k.i * C + c) * E + e0 + n) : 0.f;
        if (acc_inv && ok) old[u] = p.inv[(size_t)(c * p.P0 + pe) * E + e0 + n];
      }
    };
    auto finish = [&](const FwdChunk& k, uint32_t* B) {
      const int ch = k.i * D + k.j, c0 = k.cb * KC, pe = ip[ch];
      const bool inv_here = k.p == 0 && pe >= 0, first = fst[ch];
      const float we = iw[ch];
      float v[NV];
#pragma unroll
      for (int u = 0; u < NV; ++u) {
        const int c = c0 + kof<MODE>(u);
        const bool ok = c < C && n < ne;
        v[u] = ok ? raw[u] * env[k.j * C + c] : 0.f;
        if (inv_here && ok)
          p.inv[(size_t)(c * p.P0 + pe) * E + e0 + n] = first ? we * v[u] : old[u] + we * v[u];
      }
      store_b<MODE>(B, v);
    };
    zero_acc(acc);
    __syncthreads();  // env and fst ready; every warp is done with the last tile
    FwdChunk k0, k1, k2;  // chunks s, s + 1, s + 2
    stage_a<MODE>(p, 0, ring);
    fetch(k0);
    finish(k0, bbuf);
    k1.next(ncb, D);
    k2 = k1;
    k2.next(ncb, D);
    if (S > 1) fetch(k1);
    for (int s = 0; s < S; ++s) {
      // one barrier a chunk: past it, chunk s has landed and B(s) is built
      // for every warp, and every warp is done with chunk s - 1, whose ring
      // stage and B buffer chunk s + 1 now takes
      cp_async_wait<0>();
      __syncthreads();
      if (s + 1 < S) stage_a<MODE>(p, s + 1, ring + ((s + 1) & 1) * sw);
      chunk_product<MODE>(ring + (s & 1) * sw, bbuf + (s & 1) * G::BWORDS, p.R, mtp, acc);
      if (s + 1 < S) finish(k1, bbuf + ((s + 1) & 1) * G::BWORDS);
      if (s + 2 < S) fetch(k2);
      if (k0.cb == ncb - 1 && k0.j == D - 1 && k0.i == D - 1) {  // the pass's V' rows
        const int r0 = k0.p * p.R;
#pragma unroll
        for (int mt = 0; mt < MTW; ++mt) {
          const int tile = wm + WM * mt;
          if (tile >= mtp) continue;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              const int r = r0 + tile * 16 + g + 8 * (x >> 1), nn = wn * 16 + nt * 8 + 2 * t + (x & 1);
              if (r < p.M && nn < ne) p.out[(size_t)r * E + e0 + nn] = acc[mt][nt][x];
            }
        }
        zero_acc(acc);
      }
      k0 = k1;
      k1 = k2;
      k2.next(ncb, D);
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(NTH, 1) k5_bwd_kernel(const K5P p) {
  using G = Geo<MODE>;
  extern __shared__ __align__(16) float sm[];
  const int center = blockIdx.x, tid = threadIdx.x;
  const int C = p.C, D = p.D, E = p.E;
  int* ip = reinterpret_cast<int*>(sm);
  const float* iw = sm + MAX_D * MAX_D;
  float* env = sm + INV0_WORDS;
  float* denv = env + up4(D * C);
  uint32_t* ring = reinterpret_cast<uint32_t*>(denv + up4(D * C));
  const int sw = G::stage_words(p.R);
  uint32_t* bbuf = ring + 2 * sw;
  float* dVs = reinterpret_cast<float*>(bbuf + 2 * G::BWORDS);  // dV of a pass's channels [cbp][LDE]
  float* Vi = dVs + p.cbp * LDE;                                  // their V [cbp][LDE]
  load_inv0(p, ip);
  center_env(p, center, env);
  for (int r = tid; r < D * C; r += NTH) denv[r] = 0.f;
  for (int q = tid; q < p.cbp * LDE; q += NTH) dVs[q] = 0.f;

  const int S = D * p.npass * p.nq, mtp = p.R / 16;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wm = warp % WM, wn = warp / WM;
  float acc[MTW][2][4];
  for (int t0 = 0; t0 < p.K; t0 += ETK) {
    const int e0 = center * p.K + t0, ne = min(ETK, p.K - t0);
    auto load_vi = [&](const BwdChunk& k) {  // V of the pass's channels
      for (int q = tid; q < p.cbp * ETK; q += NTH) {
        const int cl = q / ETK, nn = q % ETK, c = k.pb * p.cbp + cl;
        Vi[cl * LDE + nn] =
            c < C && nn < ne ? __ldg(p.V + (size_t)(k.i * C + c) * E + e0 + nn) : 0.f;
      }
    };
    // dV' chunk s: rows [q*KC, q*KC + KC) of M
    const int n = own_n();
    float raw[NV];
    auto fetch = [&](const BwdChunk& k) {
      const int m0 = k.q * KC;
#pragma unroll
      for (int u = 0; u < NV; ++u) {
        const int m = m0 + kof<MODE>(u);
        raw[u] = m < p.M && n < ne ? __ldg(p.dout + (size_t)m * E + e0 + n) : 0.f;
      }
    };
    zero_acc(acc);
    __syncthreads();  // env, denv and dVs ready; every warp is done with the last tile
    BwdChunk k0, k1, k2;  // chunks s, s + 1, s + 2
    load_vi(k0);
    stage_a<MODE>(p, 0, ring);
    fetch(k0);
    store_b<MODE>(bbuf, raw);
    k1.next(p.nq, p.npass);
    k2 = k1;
    k2.next(p.nq, p.npass);
    if (S > 1) fetch(k1);
    for (int s = 0; s < S; ++s) {
      cp_async_wait<0>();
      __syncthreads();  // as in the forward
      if (s + 1 < S) stage_a<MODE>(p, s + 1, ring + ((s + 1) & 1) * sw);
      chunk_product<MODE>(ring + (s & 1) * sw, bbuf + (s & 1) * G::BWORDS, p.R, mtp, acc);
      if (s + 1 < S) store_b<MODE>(bbuf + ((s + 1) & 1) * G::BWORDS, raw);
      if (s + 2 < S) fetch(k2);
      if (k0.q == p.nq - 1) {
        // dO rows (j, c) of (i, pass) + the dinv terms -> dV_i and denv
        const int i = k0.i, c0 = k0.pb * p.cbp;
#pragma unroll
        for (int mt = 0; mt < MTW; ++mt) {
          const int tile = wm + WM * mt;
          if (tile >= mtp) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = tile * 16 + g + 8 * h, jr = r / p.cbp, cl = r - jr * p.cbp;
            const bool rv = jr < D && c0 + cl < C;
            const int j = rv ? jr : 0, c = rv ? c0 + cl : 0;
            const int pe = ip[i * D + j];
            const float we = iw[i * D + j], ev = env[j * C + c];
            float part = 0.f;
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int x = 0; x < 2; ++x) {
                const int nn = wn * 16 + nt * 8 + 2 * t + x;
                if (rv && nn < ne) {
                  float v = acc[mt][nt][2 * h + x];
                  if (pe >= 0) v += we * __ldg(p.dinv + (size_t)(c * p.P0 + pe) * E + e0 + nn);
                  atomicAdd(dVs + cl * LDE + nn, v * ev);
                  part = fmaf(v, Vi[cl * LDE + nn], part);
                }
              }
            part += __shfl_xor_sync(~0u, part, 1);
            part += __shfl_xor_sync(~0u, part, 2);
            if (rv && t == 0) atomicAdd(denv + j * C + c, part);
          }
        }
        zero_acc(acc);
        // dV_i of the pass's channels is complete: store it, start the next pass
        __syncthreads();
        for (int q = tid; q < p.cbp * ETK; q += NTH) {
          const int cl = q / ETK, nn = q % ETK, c = c0 + cl;
          if (c < C && nn < ne) p.dV[(size_t)(i * C + c) * E + e0 + nn] = dVs[cl * LDE + nn];
          dVs[cl * LDE + nn] = 0.f;
        }
        if (s + 1 < S) load_vi(k1);
      }
      k0 = k1;
      k1 = k2;
      k2.next(p.nq, p.npass);
    }
  }
  __syncthreads();  // the last epilogue's shared atomics into denv

  // env backward with the complete per-center denv
  for (int r = tid; r < D * C; r += NTH) denv[r] *= p.inv_avg;  // = dA
  __syncthreads();
  for (int t0 = 0; t0 < p.K; t0 += ETK) {
    const int e0 = center * p.K + t0, ne = min(ETK, p.K - t0);
    for (int q = tid; q < C * ETK; q += NTH) {
      const int c = q / ETK, n = q % ETK;
      if (n >= ne) continue;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(denv[d * C + c], __ldg(p.Y + (size_t)d * E + e0 + n), s);
      p.dwz[(size_t)c * E + e0 + n] = s;
    }
    for (int q = tid; q < D * ETK; q += NTH) {
      const int d = q / ETK, n = q % ETK;
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
  kernel<<<blocks, NTH, smem, st>>>(p);
  return (int)cudaGetLastError();
}

int smem_bytes(int mode, bool bwd, int C, int D, const Plan& q) {
  const int w = mode == 0 ? smem_words<0>(bwd, C, D, q)
                          : mode == 1 ? smem_words<1>(bwd, C, D, q) : smem_words<2>(bwd, C, D, q);
  return 4 * w;
}

}  // namespace

extern "C" {

// words of the Inv0 table the wrapper builds (checked by the wrapper)
int k5_inv0_words() { return INV0_WORDS; }

// bytes of a direction's kernel layout, as the launcher reads it: npass *
// (chunks of one pass) chunks of the mode's chunk bytes, times D in the
// backward (ops/env_layer_mxu.py kernel_layout; checked by the wrapper)
long long k5_layout_bytes(int bwd, int C, int Cout, int D, int mode) {
  const Plan q = plan_of(bwd, C, Cout, D);
  const size_t cb = mode == 0 ? Geo<0>::chunk_bytes(q.R)
                              : mode == 1 ? Geo<1>::chunk_bytes(q.R) : Geo<2>::chunk_bytes(q.R);
  return (long long)((bwd ? D : 1) * (size_t)q.npass * q.nq * cb);
}

// shared-memory bytes of a launch (the wrapper's kernel_takes mirrors this)
int k5_smem_bytes(int bwd, int C, int Cout, int D, int mode) {
  return smem_bytes(mode, bwd, C, D, plan_of(bwd, C, Cout, D));
}

// ptrs: V, wz, Y, A (the direction's kernel layout), inv0, dout, dinv, out,
//       inv, dV, dwz, dY  (unused ones may be 0)
// dims: C, Cout, D, K, E, P0, mode (0 mxu_highest, 1 mxu_bf16x3, 2 mxu_bf16)
// Returns 0, a negative code for a shape the kernel does not take, or the
// cudaError_t of the launch.
int k5_launch(int bwd, const unsigned long long* ptrs, const int* dims, float inv_avg,
              void* stream) {
  K5P p{};
  p.V = (const float*)ptrs[0];
  p.wz = (const float*)ptrs[1];
  p.Y = (const float*)ptrs[2];
  p.A = (const char*)ptrs[3];
  p.inv0 = (const int*)ptrs[4];
  p.dout = (const float*)ptrs[5];
  p.dinv = (const float*)ptrs[6];
  p.out = (float*)ptrs[7];
  p.inv = (float*)ptrs[8];
  p.dV = (float*)ptrs[9];
  p.dwz = (float*)ptrs[10];
  p.dY = (float*)ptrs[11];
  p.C = dims[0];
  const int Cout = dims[1];
  p.D = dims[2];
  p.K = dims[3];
  p.E = dims[4];
  p.P0 = dims[5];
  const int mode = dims[6];
  p.inv_avg = inv_avg;
  p.M = p.D * Cout;
  if (p.D < 1 || p.D > MAX_D || mode < 0 || mode > 2 || p.C < 1 || Cout < 1) return -1;
  if (p.K < 1 || p.E % p.K) return -3;
  if (!p.A || ((unsigned long long)p.A & 15)) return -5;
  const Plan q = plan_of(bwd, p.C, Cout, p.D);
  p.npass = q.npass;
  p.R = q.R;
  p.nq = q.nq;
  p.cbp = q.cbp;
  const size_t smem = smem_bytes(mode, bwd, p.C, p.D, q);
  if (smem > SMEM_MAX) return -6;

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
