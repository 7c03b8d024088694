// Tensor-core pieces of the Allegro layer kernels: the layer body
// (allegro_layer.cuh: K1, K6, K7 and K8), K2 (env_layer.cu) and K4
// (tp_mix_fused.cu).  The small products on tensor cores at f32 accuracy,
// weights staged in shared memory by cp.async, cp.async tile loads, and the
// channelwise TP of one output row with its sums in registers, with env per
// center (K1's body, K2) or per edge (K4), forward and backward.
//
// Products.  out (M, TW) = scale * A^T B, A (Kd, M) row-major weights in
// device memory, B (Kd, TW) a shared tile of row stride ldb, TW = 32 edge
// columns (ET; K4 also 16 and 8).  Rows are output features, columns the
// tile's edges, depth the input features; a pass covers MG output rows as
// the 8 warps in 8 / (TW/8) (rows) x TW/8 (8-edge columns), each warp up to
// TW/8 m16n8 tiles, one B fragment reused across them.  Each k-step of 8
// runs mma.sync.m16n8k8 in 3xTF32: every operand a = hi + lo with hi =
// rna_tf32(a), lo = rna_tf32(a - hi), and hi*hi' + hi*lo' + lo*hi'
// accumulated in f32, each dropped term ~2^-22 relative, so the products
// keep f32 accuracy (single-pass TF32 would keep ~2^-11).
//
// Weight staging.  A pass's A columns come into a ring of two stages in
// shared memory in chunks of KC rows (16-byte cp.async.cg, commit / wait
// groups): chunk c+1 loads while the tensor cores consume chunk c.  Rows
// past Kd are zero-filled and B's rows past Kd read as 0, so any depth
// works.  Chunk rows of a multiple-of-32 width are XOR-swizzled by 8 floats
// per row (mod 4), other widths padded to 16k + 8: either way the A
// fragment loads are free of bank conflicts, as B's are at LDS_WIDE (and
// at K4's narrower strides, ps_of).  An A of at most two chunks and one
// pass stays in the ring after the product: the caller may run the next
// product on it again (a mix l3 block over its 2 l3 + 1 rows) or stage it
// ahead (mma_stage) while other work runs.
//
// Wide layers.  Where the tiles leave no room for the ring at LDS_WIDE, the
// layout takes the tile stride LDS_MIN (B fragment loads then conflict, but
// the tiles take less shared memory), and where the ring's least still
// does not fit, no ring: the A fragments are then read from device memory
// through the read-only cache.  So the kernels take every width their FFMA
// forms before them took.  The body and K2 are built for each stride: a
// stride read at run time cost the backward ~9% on the H100 (PERF.md).
//
// bf16 operands (K1 and K2 built on __nv_bfloat16 activations).  The same
// product (mma_tile's BF16P form) runs one mma.sync.m16n8k16 bf16 pass a
// k-step of 16 with f32 accumulation, the rounding of the TPU kernels' bf16
// dots (pallas_stack.py _mm: one pass, f32 accumulation).  Its weights are
// pair-packed by the wrapper: a (Kd, M) matrix is stored as Kd/2 rows of M
// 32-bit words, word (k2, m) holding A[2 k2][m] in its low and A[2 k2 + 1][m]
// in its high half, so the ring stages them unchanged, in half the bytes,
// and an A fragment is the same four word loads as a TF32 one.  B stays an
// f32 shared tile, its pairs rounded to bf16 as the fragments load.
// prod / stage / resident pick the f32 or the bf16 form from the
// activations' storage type.
//
// bf16x3 (the layer body's bf16x3 builds on f32 activations: the TPU
// kernels' Precision.HIGH, written out as pallas_stack.py _mm writes it).
// Each operand is split a = hi + lo with hi = bf16(a), lo = bf16(a - hi),
// and a k-step of 16 runs three m16n8k16 bf16 passes: hi*hi' into acc and
// hi*lo' + lo*hi' into cor, folded in f32 as the 3xTF32 form folds.  The
// wrapper lays A out as hi and lo pair-packed words with their rows
// interleaved (row 2 k2 the hi pairs of A rows 2 k2, 2 k2 + 1; row 2 k2 + 1
// their lo pairs; ops/fused_layer.pack_x3): Kd rows of M words, the f32
// layout's bytes, so the ring, its chunks of KC rows (a multiple of 16
// here) and the tile strides stay as they are.  B's hi and lo pairs are
// made as its fragments load.  Where the ring leaves less than 16 rows a
// stage, the product reads its weights without the ring.
//
// The form is a template parameter (Mma, mma_ptx.cuh): TF32X3, BF16P (one
// pass on pair-packed words) or BF16X3.  prod / stage / resident (K2, K4)
// pick BF16P on bf16 activations and the build's MIX_MMA on f32 ones (the
// precision policy's builds: env_layer_bf16x3.cu, tp_mix_fused_onepass.cu,
// ...); the layer body picks its own form per product (allegro_layer.cuh).
//
// The PTX primitives (mma.sync, cvt.rna.tf32, cp.async and its groups, and
// their g++ stand-in emulations) are in mma_ptx.cuh, which K5 shares.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "allegro_tiles.cuh"
#include "mma_ptx.cuh"

namespace {

constexpr int LDS_WIDE = 40;  // row stride of product tiles: conflict-free B fragments
constexpr int LDS_MIN = 32;   // the stride where the tiles do not fit at LDS_WIDE
constexpr int LDV = 32;       // row stride of the V and dV tiles (TP only, lanes over edges)
constexpr int MG = 128;       // output rows per product pass
// words of the weight ring: at most RING_FWD in a forward launch (two blocks
// an SM at the flagship widths) and RING_BWD in a backward one (one block),
// less where the tiles leave less, but not below RING_MIN (two stages of 8
// rows at the widest pass); 0 where even that does not fit
constexpr int RING_FWD = 4096;
constexpr int RING_BWD = 8192;
constexpr int RING_MIN = 2 * 8 * (MG + 8);

// K4's product tile row stride at TW edge columns: conflict-free B
// fragment loads (k * ldb mod 32 = 0, 8, 16, 24 over the 4 k of a
// fragment).
__host__ __device__ constexpr int ps_of(int tw) { return tw == 32 ? LDS_WIDE : tw == 16 ? 24 : 8; }

// A's stored rows (words of M) per k-step: 8 (TF32X3: k 8; BF16P: k 16), or
// 16 (BF16X3: hi and lo rows of k 16)
template <int FM>
constexpr int KQ = FM == BF16X3 ? 16 : 8;

// Staging geometry of a product pass of width mg: chunk rows (a multiple of
// q, 0 where the ring holds less) and row stride.
struct Chunks {
  int sa, kc, n, q;
  bool swz;
};

__device__ __forceinline__ Chunks chunks(int Kd, int mg, int ring, int q = 8) {
  Chunks c;
  c.q = q;
  c.swz = mg % 32 == 0;
  c.sa = c.swz ? mg : (mg + 15) / 16 * 16 + 8;
  c.kc = (ring / 2 / c.sa) & ~(q - 1);
  c.n = c.kc ? (Kd + c.kc - 1) / c.kc : 0;
  return c;
}

// Whether a product of A (Kd, M) leaves all of A in the ring (one pass, at
// most two chunks), so that the next product on the same A may skip staging.
__device__ __forceinline__ bool ring_holds(int Kd, int M, int ring, int q = 8) {
  if (ring <= 0 || M > MG) return false;
  const Chunks c = chunks(Kd, M, ring, q);
  return c.kc > 0 && c.n <= 2;
}

// Whether row r's mix (or mixT) block is the one the previous row left in
// the ring.
__device__ __forceinline__ bool mix_resident(const Meta& m, int r, int Kd, int M, int rw,
                                             int q = 8) {
  return r > 0 && m.rowmix[r] == m.rowmix[r - 1] && ring_holds(Kd, M, rw, q);
}

// Issue chunk ch of the pass at output rows [g0, g0 + mg) into its stage.
__device__ __forceinline__ void stage_chunk(const float* __restrict__ A, int Kd, int M, int g0,
                                            int mg, const Chunks& c, int ch, float* ring, int rw) {
  float* dst = ring + (ch & 1) * (rw / 2);
  const int k0 = ch * c.kc;
  const int rows = min(c.kc, (Kd - k0 + c.q - 1) & ~(c.q - 1));
  const int q4 = mg >> 2;
  for (int q = threadIdx.x; q < rows * q4; q += NT) {
    const int kk = q / q4, m4 = (q % q4) * 4, k = k0 + kk;
    float* d = dst + kk * c.sa + (c.swz ? (m4 ^ ((kk & 3) << 3)) : m4);
    cp_async16(d, A + (size_t)(k < Kd ? k : 0) * M + g0 + m4, k < Kd ? 16 : 0);
  }
  cp_async_commit();
}

// Stage the first chunks of A (Kd stored rows, M) ahead of mma_tile(...,
// staged = true).
__device__ __forceinline__ void mma_stage(const float* __restrict__ A, int Kd, int M, float* ring,
                                          int rw, int q = 8) {
  if (rw == 0) return;
  const int mg = min(MG, M);
  const Chunks c = chunks(Kd, mg, rw, q);
  if (c.kc == 0) return;
  stage_chunk(A, Kd, M, 0, mg, c, 0, ring, rw);
  if (c.n > 1) stage_chunk(A, Kd, M, 0, mg, c, 1, ring, rw);
}

// The warp's place in a product on a tile of TW edge columns: its row
// group wm (of WM), its first edge column n0, its m16 tiles wm + WM * i for
// i < TW / 8.
template <int TW>
struct WarpTile {
  static constexpr int WN = TW / 8, WM = 8 / WN;
  int wm, n0;
  __device__ WarpTile() : wm((threadIdx.x >> 5) / WN), n0((threadIdx.x >> 5) % WN * 8) {}
};

// Activation storage: f32, or bf16 (rounded to nearest on store).
template <typename T>
constexpr bool IS_BF16 = false;
template <>
constexpr bool IS_BF16<__nv_bfloat16> = true;

__device__ __forceinline__ float ld_act(const float* q) { return *q; }
__device__ __forceinline__ float ld_act(const __nv_bfloat16* q) { return __bfloat162float(*q); }
__device__ __forceinline__ void st_act(float* q, float v) { *q = v; }
__device__ __forceinline__ void st_act(__nv_bfloat16* q, float v) { *q = __float2bfloat16_rn(v); }

// The warp's up to TW/8 m16n8 accumulators of the pass at output row g0 to
// out[r*ldo + n], n < nvalid, times scale.
template <int TW, typename O>
__device__ __forceinline__ void mma_store(const float (&acc)[TW / 8][4], int g0, int m16, int M,
                                          O* out, int ldo, float scale, int nvalid) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const WarpTile<TW> w;
  const int wm = w.wm, n0 = w.n0;
#pragma unroll
  for (int i = 0; i < TW / 8; ++i) {
    const int mt = wm + WarpTile<TW>::WM * i;
    if (mt >= m16) continue;
    const int r0 = g0 + mt * 16 + g, n = n0 + 2 * t;
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r >= M) continue;
      if (n < nvalid) st_act(out + (size_t)r * ldo + n, acc[i][2 * h] * scale);
      if (n + 1 < nvalid) st_act(out + (size_t)r * ldo + n + 1, acc[i][2 * h + 1] * scale);
    }
  }
}

// hi*hi' in acc and the two correction terms in cor, summed before the store
template <int TW>
__device__ __forceinline__ void fold(float (&acc)[TW / 8][4], const float (&cor)[TW / 8][4]) {
#pragma unroll
  for (int i = 0; i < TW / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] += cor[i][j];
}

// Two f32 values of B's column as one bf16 pair (lo in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two f32 values as JAX's bf16 split: the pair of hi = bf16(x) in hi, the
// pair of lo = bf16(x - hi) in lo.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// B's fragment of the lane's k row k (and k + 4) of a k-step, column n:
// TF32X3 two TF32 splits (hi in bh, lo in bl); BF16P two bf16 pairs of pair
// row k (elements 2k, 2k + 1; then + 8) in bh; BF16X3 the same pairs split
// hi (bh) / lo (bl).  Rows past Kr (TF32X3: B's rows; else its pair rows)
// read as 0.
template <int FM>
__device__ __forceinline__ void b_frag(const float* B, int ldb, int k, int Kr, int n,
                                       uint32_t (&bh)[2], uint32_t (&bl)[2]) {
  if constexpr (FM == BF16P) {
    bh[0] = k < Kr ? pack_bf16(B[2 * k * ldb + n], B[(2 * k + 1) * ldb + n]) : 0u;
    bh[1] = k + 4 < Kr ? pack_bf16(B[(2 * k + 8) * ldb + n], B[(2 * k + 9) * ldb + n]) : 0u;
  } else if constexpr (FM == BF16X3) {
    const bool v0 = k < Kr, v1 = k + 4 < Kr;
    split_bf16(v0 ? B[2 * k * ldb + n] : 0.f, v0 ? B[(2 * k + 1) * ldb + n] : 0.f, bh[0], bl[0]);
    split_bf16(v1 ? B[(2 * k + 8) * ldb + n] : 0.f, v1 ? B[(2 * k + 9) * ldb + n] : 0.f, bh[1],
               bl[1]);
  } else {
    split_tf32(k < Kr ? B[k * ldb + n] : 0.f, bh[0], bl[0]);
    split_tf32(k + 4 < Kr ? B[(k + 4) * ldb + n] : 0.f, bh[1], bl[1]);
  }
}

// One m16 tile's k-step from A's fragment values: TF32X3 av (rows m, m + 8
// of k rows k, k + 4) as three TF32 passes into acc (hi*hi') and cor (the
// two correction terms); BF16P the four pair-packed words av in one bf16
// pass; BF16X3 the hi words av and the lo words al in three bf16 passes
// (acc: hi*hi'; cor: hi*lo' + lo*hi').
template <int FM>
__device__ __forceinline__ void k_step(const float (&av)[4], const float (&al)[4],
                                       const uint32_t (&bh)[2], const uint32_t (&bl)[2],
                                       float* acc, float* cor) {
  if constexpr (FM == BF16P) {
    const uint32_t a[4] = {__float_as_uint(av[0]), __float_as_uint(av[1]),
                           __float_as_uint(av[2]), __float_as_uint(av[3])};
    mma_bf16(acc, a, bh);
  } else if constexpr (FM == BF16X3) {
    const uint32_t ah[4] = {__float_as_uint(av[0]), __float_as_uint(av[1]),
                            __float_as_uint(av[2]), __float_as_uint(av[3])};
    const uint32_t a2[4] = {__float_as_uint(al[0]), __float_as_uint(al[1]),
                            __float_as_uint(al[2]), __float_as_uint(al[3])};
    mma_bf16(cor, a2, bh);
    mma_bf16(cor, ah, bl);
    mma_bf16(acc, ah, bh);
  } else {
    uint32_t ah[4], a2[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) split_tf32(av[q], ah[q], a2[q]);
    mma_tf32(cor, a2, bh);
    mma_tf32(cor, ah, bl);
    mma_tf32(acc, ah, bh);
  }
}

// A's stored rows (TF32X3, BF16X3: Kd; BF16P: Kd / 2 pair-packed word rows)
// and B's fragment rows (TF32X3: Kd; the bf16 forms: Kd / 2 pairs).
template <int FM>
__device__ __forceinline__ int stored_rows(int Kd) {
  return FM == BF16P ? Kd >> 1 : Kd;
}

template <int FM>
__device__ __forceinline__ int frag_rows(int Kd) {
  return FM == TF32X3 ? Kd : Kd >> 1;
}

// mma_tile without a ring (rw = 0): the A fragments straight from device
// memory through the read-only cache, rows past Kd and M read as 0.
template <int TW, typename O, int FM>
__device__ void mma_tile_direct(const float* __restrict__ A, int Kd, int M, const float* B,
                                int ldb, O* out, int ldo, float scale, int nvalid) {
  constexpr int TPW = TW / 8, WM = WarpTile<TW>::WM;
  const int Kr = frag_rows<FM>(Kd);
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const WarpTile<TW> w;
  const int wm = w.wm, n0 = w.n0;
  for (int g0 = 0; g0 < M; g0 += MG) {
    const int m16 = (min(MG, M - g0) + 15) >> 4;
    float acc[TPW][4] = {}, cor[TPW][4] = {};
    for (int k0 = 0; k0 < Kr; k0 += 8) {
      const int k = k0 + t;
      const bool v0 = k < Kr, v1 = k + 4 < Kr;
      uint32_t bh[2], bl[2];
      b_frag<FM>(B, ldb, k, Kr, n0 + g, bh, bl);
      // the stored row of fragment row k (BF16X3: its hi row; lo follows)
      const float* A0 = A + (size_t)(FM == BF16X3 ? 2 * k : k) * M;
      const float* A1 = A0 + (FM == BF16X3 ? 8 : 4) * (size_t)M;
#pragma unroll
      for (int i = 0; i < TPW; ++i) {
        const int mt = wm + WM * i;
        if (mt < m16) {
          const int m0 = g0 + mt * 16 + g, m1 = m0 + 8;
          const float av[4] = {v0 && m0 < M ? __ldg(A0 + m0) : 0.f,
                               v0 && m1 < M ? __ldg(A0 + m1) : 0.f,
                               v1 && m0 < M ? __ldg(A1 + m0) : 0.f,
                               v1 && m1 < M ? __ldg(A1 + m1) : 0.f};
          float al[4] = {};
          if constexpr (FM == BF16X3) {
            al[0] = v0 && m0 < M ? __ldg(A0 + M + m0) : 0.f;
            al[1] = v0 && m1 < M ? __ldg(A0 + M + m1) : 0.f;
            al[2] = v1 && m0 < M ? __ldg(A1 + M + m0) : 0.f;
            al[3] = v1 && m1 < M ? __ldg(A1 + M + m1) : 0.f;
          }
          k_step<FM>(av, al, bh, bl, acc[i], cor[i]);
        }
      }
    }
    if constexpr (FM != BF16P) fold<TW>(acc, cor);
    mma_store<TW>(acc, g0, m16, M, out, ldo, scale, nvalid);
  }
}

// out[m*ldo + n] = scale * sum_k A[k*M + m] * B[k*ldb + n] for m < M (M % 4
// == 0, A 16-byte aligned), n < TW; only n < nvalid is written.  staged:
// the first pass's first two chunks are in the ring already (mma_stage, or
// an A that ring_holds left there).  The caller synchronises the block
// before reading out or reusing B or the ring.  FM (Mma): TF32X3, A f32;
// BF16P, A pair-packed (Kd even, Kd / 2 word rows staged and read as the
// f32 form's rows), B rounded to bf16 pairs as it loads, one m16n8k16 pass
// a k-step of 16; BF16X3, A hi / lo pair-packed with interleaved rows (Kd
// even, Kd word rows), B split as it loads, three passes a k-step of 16.
template <int TW = ET, typename O = float, int FM = TF32X3>
__device__ void mma_tile(const float* __restrict__ A, int Kd, int M, const float* B, int ldb,
                         O* out, int ldo, float scale, int nvalid, float* ring, int rw,
                         bool staged = false) {
  constexpr int TPW = TW / 8, WM = WarpTile<TW>::WM, Q = KQ<FM>;
  const int Kr = stored_rows<FM>(Kd);  // A's stored rows
  if (rw == 0 || chunks(Kr, min(MG, M), rw, Q).kc == 0) {
    mma_tile_direct<TW, O, FM>(A, Kd, M, B, ldb, out, ldo, scale, nvalid);
    return;
  }
  const int Kf = frag_rows<FM>(Kd);  // B's fragment rows
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const WarpTile<TW> w;
  const int wm = w.wm, n0 = w.n0;
  for (int g0 = 0; g0 < M; g0 += MG) {
    const int mg = min(MG, M - g0);
    const Chunks c = chunks(Kr, mg, rw, Q);
    const int m16 = (mg + 15) >> 4;
    // the swizzle of the lane's A rows (stage_chunk's, by stored row mod 4):
    // row kk + t (TF32X3, BF16P), hi row kk + 2t and lo row kk + 2t + 1
    // (BF16X3); rows + 4 (+ 8) alike
    const int sw = c.swz ? (FM == BF16X3 ? ((2 * t) & 3) << 3 : t << 3) : 0;
    const int swl = c.swz ? ((2 * t + 1) & 3) << 3 : 0;
    // hi*hi' and the two correction terms in separate accumulators: two
    // independent mma chains per tile
    float acc[TPW][4] = {}, cor[TPW][4] = {};
    if (!(staged && g0 == 0)) {
      stage_chunk(A, Kr, M, g0, mg, c, 0, ring, rw);
      if (c.n > 1) stage_chunk(A, Kr, M, g0, mg, c, 1, ring, rw);
    }
    for (int ch = 0; ch < c.n; ++ch) {
      if (ch + 1 < c.n)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();
      const float* As = ring + (ch & 1) * (rw / 2);
      const int k0 = ch * c.kc, kend = min(c.kc, Kr - k0);
#pragma unroll 2
      for (int kk = 0; kk < kend; kk += Q) {
        uint32_t bh[2], bl[2];
        // B's fragment row: the stored row (TF32X3, BF16P) or the pair row
        // (BF16X3: two stored rows a pair row)
        b_frag<FM>(B, ldb, (FM == BF16X3 ? (k0 + kk) / 2 : k0 + kk) + t, Kf, n0 + g, bh, bl);
        const float* A0 = As + (FM == BF16X3 ? kk + 2 * t : kk + t) * c.sa;
        const float* A1 = A0 + (FM == BF16X3 ? 8 : 4) * c.sa;
#pragma unroll
        for (int i = 0; i < TPW; ++i) {
          const int mt = wm + WM * i;
          if (mt < m16) {
            const int m0 = (mt * 16 + g) ^ sw, m1 = (mt * 16 + g + 8) ^ sw;
            const float av[4] = {A0[m0], A0[m1], A1[m0], A1[m1]};
            float al[4] = {};
            if constexpr (FM == BF16X3) {
              const int l0 = (mt * 16 + g) ^ swl, l1 = (mt * 16 + g + 8) ^ swl;
              al[0] = A0[c.sa + l0];
              al[1] = A0[c.sa + l1];
              al[2] = A1[c.sa + l0];
              al[3] = A1[c.sa + l1];
            }
            k_step<FM>(av, al, bh, bl, acc[i], cor[i]);
          }
        }
      }
      if (ch + 2 < c.n) {
        __syncthreads();  // every warp is done with this stage
        stage_chunk(A, Kr, M, g0, mg, c, ch + 2, ring, rw);
      }
    }
    if constexpr (FM != BF16P) fold<TW>(acc, cor);
    mma_store<TW>(acc, g0, m16, M, out, ldo, scale, nvalid);
    if (g0 + MG < M) __syncthreads();  // the next pass restages the ring
  }
}

// The product, its staging and its ring check in form FM, A's Kd and its
// offsets (the Meta table's, in f32 elements) given as for f32 weights.
template <int FM, int TW = ET, typename O>
__device__ __forceinline__ void prod_f(const float* __restrict__ A, int Kd, int M,
                                       const float* B, int ldb, O* out, int ldo, float scale,
                                       int nvalid, float* ring, int rw, bool staged = false) {
  mma_tile<TW, O, FM>(A, Kd, M, B, ldb, out, ldo, scale, nvalid, ring, rw, staged);
}

template <int FM>
__device__ __forceinline__ void stage_f(const float* __restrict__ A, int Kd, int M, float* ring,
                                        int rw) {
  mma_stage(A, stored_rows<FM>(Kd), M, ring, rw, KQ<FM>);
}

template <int FM>
__device__ __forceinline__ bool resident_f(const Meta& m, int r, int Kd, int M, int rw) {
  return mix_resident(m, r, stored_rows<FM>(Kd), M, rw, KQ<FM>);
}

// A weight matrix's offset in its flat buffer, given in f32 elements (the
// Meta table's): halved in the pair-packed buffer.
template <int FM>
__device__ __forceinline__ int wofs_f(int off) {
  return FM == BF16P ? off >> 1 : off;
}

// The form of K2's and K4's products on f32 activations, the build's
// (MIX_MMA): TF32X3 in env_layer.cu and tp_mix_fused.cu, BF16X3 in their
// *_bf16x3.cu builds, BF16P in their *_onepass.cu builds
#ifndef MIX_MMA
#define MIX_MMA TF32X3
#endif

// The form of the activations' storage type Act: the build's MIX_MMA (f32)
// or BF16P (bf16)
template <typename Act>
constexpr int ACT_FORM = IS_BF16<Act> ? (int)BF16P : (int)MIX_MMA;

// The product on the activations' storage type Act: mma_tile in ACT_FORM
// (f32: A as MIX_MMA lays it out, f32, pack_x3 or pair-packed; bf16: A
// pair-packed).
template <typename Act, int TW = ET, typename O>
__device__ __forceinline__ void prod(const float* __restrict__ A, int Kd, int M, const float* B,
                                     int ldb, O* out, int ldo, float scale, int nvalid,
                                     float* ring, int rw, bool staged = false) {
  mma_tile<TW, O, ACT_FORM<Act>>(A, Kd, M, B, ldb, out, ldo, scale, nvalid, ring, rw, staged);
}

// The rows the ring holds of A (Kd, M) at Act: Kd, or Kd / 2 pair-packed words (BF16P).
template <typename Act>
__device__ __forceinline__ int wrows(int Kd) {
  return stored_rows<ACT_FORM<Act>>(Kd);
}

// wofs_f, stage_f and resident_f of prod's A at Act
template <typename Act>
__device__ __forceinline__ int wofs(int off) {
  return wofs_f<ACT_FORM<Act>>(off);
}

template <typename Act>
__device__ __forceinline__ void stage(const float* __restrict__ A, int Kd, int M, float* ring,
                                      int rw) {
  mma_stage(A, wrows<Act>(Kd), M, ring, rw, KQ<ACT_FORM<Act>>);
}

template <typename Act>
__device__ __forceinline__ bool resident(const Meta& m, int r, int Kd, int M, int rw) {
  return resident_f<ACT_FORM<Act>>(m, r, Kd, M, rw);
}

// dst[r*ld + n] = src[r*E + e0 + n] for n < ne, 0 for ne <= n < TW: issued
// as 16-byte cp.async.cg (L2 only, so memory the same kernel wrote is read
// fresh) when vec (E, e0, src 16-byte aligned), else loaded synchronously
// through the read-only cache (RO) or L2.  Visible after tiles_ready().
template <bool RO, int TW = ET>
__device__ void load_tile_async(const float* __restrict__ src, int rows, int E, int e0, int ne,
                                float* dst, int ld, bool vec) {
  if (vec) {
    for (int q = threadIdx.x; q < rows * (TW / 4); q += NT) {
      const int r = q / (TW / 4), n4 = (q % (TW / 4)) * 4;
      const int nb = 4 * max(0, min(4, ne - n4));
      cp_async16(dst + r * ld + n4, nb ? src + (size_t)r * E + e0 + n4 : src, nb);
    }
    cp_async_commit();
  } else {
    for (int q = threadIdx.x; q < rows * TW; q += NT) {
      const int r = q / TW, n = q % TW;
      const float* s = src + (size_t)r * E + e0 + n;
      dst[r * ld + n] = n < ne ? (RO ? __ldg(s) : __ldcg(s)) : 0.f;
    }
  }
}

// The same tile from bf16 rows, converted to f32 as it loads (synchronous,
// two edges a load where the pairs are 4-byte aligned).  Visible after
// tiles_ready().
template <bool RO, int TW = ET>
__device__ void load_tile_async(const __nv_bfloat16* __restrict__ src, int rows, int E, int e0,
                                int ne, float* dst, int ld, bool vec) {
  if (vec) {  // E, e0 even and src 4-byte aligned
    for (int q = threadIdx.x; q < rows * (TW / 2); q += NT) {
      const int r = q / (TW / 2), n2 = (q % (TW / 2)) * 2;
      float2 v = make_float2(0.f, 0.f);
      if (n2 < ne) {
        const __nv_bfloat162* s2 =
            reinterpret_cast<const __nv_bfloat162*>(src + (size_t)r * E + e0 + n2);
        v = __bfloat1622float2(RO ? __ldg(s2) : __ldcg(s2));
        if (n2 + 1 >= ne) v.y = 0.f;
      }
      dst[r * ld + n2] = v.x;
      dst[r * ld + n2 + 1] = v.y;
    }
  } else {
    for (int q = threadIdx.x; q < rows * TW; q += NT) {
      const int r = q / TW, n = q % TW;
      dst[r * ld + n] = n < ne ? __bfloat162float(src[(size_t)r * E + e0 + n]) : 0.f;
    }
  }
}

__device__ __forceinline__ void tiles_ready() {
  cp_async_wait<0>();
  __syncthreads();
}

// T[(pp*C + c)*ldt + n] = sum over the 3j entries of output row r of
// w * V[i][c][n] * env[j][c].  Thread (warp w, lane n) owns the cells (c, n)
// for c = w + 8 jj; each path's sum stays in registers (the wrapper's table
// lists a row's entries grouped by path, in ascending order), one shared
// load of V per entry and cell, one store of T per path and cell.
__device__ void tp_row_reg(int C, const Meta& m, int r, const float* Vs, const float* env,
                           float* T, int ldt) {
  const int n = threadIdx.x & 31, w8 = threadIdx.x >> 5;
  const int P = m.rowP[r], end = m.rowstart[r + 1];
  for (int cb = 0; cb < C; cb += 32) {
    int e = m.rowstart[r];
    for (int pp = 0; pp < P; ++pp) {
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      for (; e < end && (m.ent[e] & 255) == pp; ++e) {
        const int code = m.ent[e];
        const int i = (code >> 8) & 255, j = code >> 16;
        const float w = m.w[e];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int c = cb + w8 + 8 * jj;
          if (c < C) a[jj] = fmaf(w * env[j * C + c], Vs[(i * C + c) * LDV + n], a[jj]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = cb + w8 + 8 * jj;
        if (c < C) T[(pp * C + c) * ldt + n] = a[jj];
      }
    }
  }
}

// perm[rowstart[r] ..] = the entries of each row r ordered by (j, index), so
// that the TP backward meets each j of a row in one run.
__device__ void build_jperm(const Meta& m, int nrows, int* perm) {
  for (int e = threadIdx.x; e < m.rowstart[nrows]; e += NT) {
    int r = 0;
    while (m.rowstart[r + 1] <= e) ++r;
    const int j = m.ent[e] >> 16;
    int rank = m.rowstart[r];
    for (int f = m.rowstart[r]; f < m.rowstart[r + 1]; ++f) {
      const int jf = m.ent[f] >> 16;
      rank += jf < j || (jf == j && f < e);
    }
    perm[rank] = e;
  }
}

// TP backward of output row r from its cotangent dT (P*C rows, stride ldt):
// dV[i][c][n] += w dT[p][c][n] env[j][c] and denv[j][c] += sum_n w dT[p][c][n]
// V[i][c][n].  The cells (c, n) are thread-owned as in tp_row_reg; each run
// of equal j sums its denv share in registers, reduces it across the warp's
// lanes (the edges) and adds it to denv once per channel; the warps own
// distinct channels, so no atomics.
__device__ void tp_row_bwd(int C, const Meta& m, const int* perm, int r, const float* dT, int ldt,
                           const float* Vs, const float* env, float* dVs, float* denv) {
  const int n = threadIdx.x & 31, w8 = threadIdx.x >> 5;
  const int end = m.rowstart[r + 1];
  for (int cb = 0; cb < C; cb += 32) {
    int e = m.rowstart[r];
    while (e < end) {
      const int j = m.ent[perm[e]] >> 16;
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      for (; e < end && (m.ent[perm[e]] >> 16) == j; ++e) {
        const int q = perm[e], code = m.ent[q];
        const int pp = code & 255, i = (code >> 8) & 255;
        const float w = m.w[q];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int c = cb + w8 + 8 * jj;
          if (c < C) {
            const float gg = w * dT[(pp * C + c) * ldt + n];
            float* dv = dVs + (i * C + c) * LDV + n;
            *dv = fmaf(gg, env[j * C + c], *dv);
            s[jj] = fmaf(gg, Vs[(i * C + c) * LDV + n], s[jj]);
          }
        }
      }
      // the four channels' sums over the warp's 32 edges: halves exchange
      // two channels, then quarters one, then three butterfly steps; lane
      // 8 q ends with channel q's total
      const bool h16 = n & 16, h8 = n & 8;
      const float x0 = h16 ? s[0] : s[2], x1 = h16 ? s[1] : s[3];
      const float t0 = (h16 ? s[2] : s[0]) + __shfl_xor_sync(~0u, x0, 16);
      const float t1 = (h16 ? s[3] : s[1]) + __shfl_xor_sync(~0u, x1, 16);
      float v = (h8 ? t1 : t0) + __shfl_xor_sync(~0u, h8 ? t0 : t1, 8);
      for (int o = 4; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
      const int c = cb + w8 + 8 * (n >> 3);
      if ((n & 7) == 0 && c < C) denv[j * C + c] += v;
    }
  }
}

// K4's TP row, with env on the edges: T[(c*P + pp)*ldt + n] = sum over the
// 3j entries of output row r of w * V[i][c][n] * env[j][c][n], the V and
// env tiles at row stride TW.  T's rows are c-major (the order of the
// tree's mix leaves and of the invariants), where tp_row_reg's are p-major.
// Thread t owns the cells (c, n) = (t / TW + (NT / TW) jj, t % TW), a
// warp's lanes on consecutive words of the tiles; each path's sum stays in
// registers, one store of T per path and cell.
template <int TW>
__device__ void tp_row_reg_edges(int C, const Meta& m, int r, const float* Vs, const float* envs,
                                 float* T, int ldt) {
  constexpr int CG = NT / TW;  // channels a sweep of jj covers, per jj
  const int n = threadIdx.x % TW, c0 = threadIdx.x / TW;
  const int P = m.rowP[r], end = m.rowstart[r + 1];
  for (int cb = 0; cb < C; cb += 4 * CG) {
    int e = m.rowstart[r];
    for (int pp = 0; pp < P; ++pp) {
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      for (; e < end && (m.ent[e] & 255) == pp; ++e) {
        const int code = m.ent[e];
        const int i = (code >> 8) & 255, j = code >> 16;
        const float w = m.w[e];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int c = cb + c0 + CG * jj;
          if (c < C)
            a[jj] = fmaf(w * envs[(j * C + c) * TW + n], Vs[(i * C + c) * TW + n], a[jj]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = cb + c0 + CG * jj;
        if (c < C) T[(c * P + pp) * ldt + n] = a[jj];
      }
    }
  }
}

// K4's TP backward of output row r from its cotangent dT (C*P rows,
// c-major, stride ldt), env on the edges: dV[i][c][n] += w dT[p][c][n] env[j][c][n] and
// denv[j][c][n] += w dT[p][c][n] V[i][c][n], every tile at row stride TW.
// The cells are thread-owned as in tp_row_reg_edges, in every row, so no
// atomics and no barrier between rows; each run of equal j (perm, from
// build_jperm) sums its denv share in registers and adds it once per cell.
template <int TW>
__device__ void tp_row_bwd_edges(int C, const Meta& m, const int* perm, int r, const float* dT,
                                 int ldt, const float* Vs, const float* envs, float* dVs,
                                 float* denvs) {
  constexpr int CG = NT / TW;
  const int n = threadIdx.x % TW, c0 = threadIdx.x / TW;
  const int P = m.rowP[r], end = m.rowstart[r + 1];
  for (int cb = 0; cb < C; cb += 4 * CG) {
    int e = m.rowstart[r];
    while (e < end) {
      const int j = m.ent[perm[e]] >> 16;
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      for (; e < end && (m.ent[perm[e]] >> 16) == j; ++e) {
        const int q = perm[e], code = m.ent[q];
        const int pp = code & 255, i = (code >> 8) & 255;
        const float w = m.w[q];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int c = cb + c0 + CG * jj;
          if (c < C) {
            const float gg = w * dT[(c * P + pp) * ldt + n];
            float* dv = dVs + (i * C + c) * TW + n;
            *dv = fmaf(gg, envs[(j * C + c) * TW + n], *dv);
            s[jj] = fmaf(gg, Vs[(i * C + c) * TW + n], s[jj]);
          }
        }
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = cb + c0 + CG * jj;
        if (c < C) denvs[(j * C + c) * TW + n] += s[jj];
      }
    }
  }
}

}  // namespace
