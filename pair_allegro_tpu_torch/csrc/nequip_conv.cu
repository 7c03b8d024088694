// K3: the fused NequIP convolution as a hand-written Hopper kernel pair (f32;
// nequip_conv_bf16.cu builds this file with a bf16 hj, K3_HJ below, and
// nequip_conv{,_bf16}_{bf16x3,onepass}.cu with the radial products in the
// matmul precision policy's other forms, K3_MMA below).
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
// What bounds it on an H100: bytes.  At the NequIP bench (l_max=1, two
// tracks, C=64, 2x32 radial MLP) an edge's gathered hj row is 2 KB, read
// once forward and read once and written once (dhj) backward, against
// ~45k flops forward (41k of them the 32 x 640 last radial product) and
// ~95k backward.  With that product on the tensor cores in 3xTF32 (165
// TFLOP/s) the bytes take about twice as long as the flops; on the CUDA
// cores alone (67 TFLOP/s) the two were even.
//
// Design:
//  * the last radial product runs on the tensor cores: mma.sync.m16n8k8 in
//    3xTF32 (split_tf32 and mma_tf32 of mma_ptx.cuh: hi*hi' + hi*lo' +
//    lo*hi', f32 accuracy), edges as the m16 rows, the hidden activations
//    X (feature-major in shared memory) as A, the last weight as B.  An
//    n8 tile is 8 channels of one radial weight (tau, p), so each lane's
//    accumulators hold every weight of its (edge, channel) cells: edges
//    g and g + 8, channels 2t and 2t + 1 of the octet.  The TP reads them
//    there, on the CUDA cores, unrolled from the X-macro tables of
//    nequip_tp_table.cuh (generated from ops/tp.py:tp_entry_table); no
//    product tile is ever written to shared memory;
//  * the backward's product back into the radial MLP, dX = gs Wlast^T,
//    runs on the tensor cores the same way, its A fragments the
//    accumulators of the forward product holding gs = dw * u (an m16n8
//    accumulator is an m16k8 A fragment with k permuted: lane t's columns
//    2t, 2t+1 as k = t, t+4), its B fragments Wlast read as pairs of
//    neighbouring columns;
//  * the last weight is staged once per block by cp.async and kept in
//    shared memory (row stride = 8 mod 32: conflict-free B fragments for
//    both products) over every tile and center the persistent block
//    walks; where it does not fit beside the tiles, its fragments are read
//    from device memory through the read-only cache instead;
//  * forward: a block walks centers, each in edge tiles of ET (64 where it
//    fits); warps own channel octets (and split the edges where there are
//    fewer octets than warps), so a channel's sum over the center's edges
//    is a register sum, three shuffles and one shared-memory add per warp;
//  * backward: a block walks flat tiles of 128 edges (one m16 tile per
//    warp); each warp runs every channel octet of its 16 edges, so the
//    cross-channel sums stay its own: dY and du in its registers, dX in its
//    16 columns of a shared-memory tile, no atomics; the center's cotangent
//    is read per edge;
//  * the tensor cores' f32 accumulation does not round to nearest, so
//    long sums leave them in pieces added in f32 on the CUDA cores: the
//    backward's T P C-term sum into dX one pass (a channel octet's 8 PG
//    terms) at a time, the hidden layers' in chunks of 64 terms, and the
//    last product's hin terms in chunks of 64 where hin > 64 (the kernels
//    instantiated with LONG; at the bench hin is 32, one chain, and a
//    second set of accumulators would cost registers for nothing).  One
//    768-term chain put the backward's error at up to 0.85 of the tight
//    gate against the f64 plain version, where the plain f32 version
//    stays at 0.05 (chip_smoke.py --k3-spread);
//  * the radial hidden layers (8 -> 32 -> 32 at the bench) run on the
//    tensor cores too (small_product: warps take the (m16, n8) output
//    tiles in turn, weights through the read-only cache), the
//    pre-activations kept for the backward in shared memory; on the CUDA
//    cores, one thread an output, they took ~40% of either kernel's time;
//  * the block's layout (edge tile, weight resident or not) is picked by
//    the launcher, the widest tile first with the weight resident, and
//    mirrored by ops/nequip_conv.py:block_layout, so a caller decides
//    before any launch;
//  * the radial products (the hidden layers, the last product and its
//    backward) take the build's form (K3_MMA, mma_ptx.cuh Mma), the
//    products pallas_nequip.py _dot / _dot_t compute under the precision
//    policy: 3xTF32 here (highest, mixed), bf16x3 (kernel_high, high: JAX's
//    split hi = bf16(x), lo = bf16(x - hi) of both operands, hi*hi' +
//    hi*lo' + lo*hi') or one pass on bf16-rounded operands (default).  All
//    three keep the m16n8k8 TF32 fragments: a bf16 value is exact in TF32,
//    so a TF32 mma of bf16 values is the bf16 product, summed in f32.  The
//    backward's last product splits the cotangent as it stands (gs = dw *
//    u, then the hidden layers' dz after silu'), the scale applied after,
//    as JAX's _dot_t(g, w) * scale.  The per-center sum stays an f32 sum
//    under every policy.
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see ops/nequip_conv.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_ptx.cuh"
#include "nequip_tp_table.cuh"

// the storage type of the gathered rows hj and of their cotangent dhj: f32
// here; nequip_conv_bf16.cu builds this file at __nv_bfloat16, the
// PAT_NEQUIP_HJ=bf16 boundary (pallas_nequip.py upcasts hj in the kernel)
#ifndef K3_HJ
#define K3_HJ float
#endif

// the radial products' form (mma_ptx.cuh Mma): TF32X3 here; the *_bf16x3.cu
// builds BF16X3, the *_onepass.cu builds BF16P (the radial activations are
// f32 in every build, so the bf16-hj builds take the policy's form too, as
// pallas_nequip.py _kprec of their dtype does)
#ifndef K3_MMA
#define K3_MMA TF32X3
#endif

namespace {

// hj values: two neighbouring channels (4- or 8-byte aligned) or one,
// upcast to f32 once in registers; dhj stored at hj's type (rounded to
// nearest at bf16)
__device__ __forceinline__ float2 ld_hj2(const float* q) {
  return __ldg(reinterpret_cast<const float2*>(q));
}
__device__ __forceinline__ float2 ld_hj2(const __nv_bfloat16* q) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(q)));
}
__device__ __forceinline__ float ld_hj(const float* q) { return __ldg(q); }
__device__ __forceinline__ float ld_hj(const __nv_bfloat16* q) {
  return __bfloat162float(__ldg(q));
}
__device__ __forceinline__ void st_hj(float* q, float v) { *q = v; }
__device__ __forceinline__ void st_hj(__nv_bfloat16* q, float v) { *q = __float2bfloat16_rn(v); }

constexpr int NT = 256;  // threads per block: 8 warps
constexpr int NWARP = NT / 32;
constexpr int MAX_W = 8;
constexpr int SMEM_MAX = 232448;
// dX columns of one backward pass (registers of its product): 32, or 16
// where the last weight is read from device memory, whose guards take the
// registers
__host__ __device__ constexpr int xc_of(bool resident) { return resident ? 32 : 16; }
constexpr float SILU_C = 1.6790564307512243f;
// the edge tiles the launcher tries, widest first (the weight resident,
// then read from device memory); a tile of 8 fills half an m16 tile
constexpr int N_ET_FWD = 4, N_ET_BWD = 5;
constexpr int ET_FWD[N_ET_FWD] = {64, 32, 16, 8};
constexpr int ET_BWD[N_ET_BWD] = {128, 64, 32, 16, 8};

struct K3P {
  const K3_HJ* hj;
  const float *bes, *u, *Y, *w, *wl, *dagg;
  K3_HJ* dhj;
  float *agg, *dbes, *du, *dY;
  int C, K, E, nw;
  int wdim[MAX_W + 1];
  int woff[MAX_W];
  float inv_avg;
  // layout (k3_layout): edge tile, tile row stride, the weight resident,
  // warps over channel octets (wo) and over edges (we), the weight's row
  // stride, rows of the activation tiles; shared-memory offsets (floats)
  int et, ldx, resident, wo, we, sa, hmax8;
  int o_w, o_bes, o_xa, o_xb, o_z, o_y, o_u, o_agg;
};

__host__ __device__ constexpr int r8(int x) { return (x + 7) & ~7; }

template <int LMAX, int T>
struct Cfg {
  static constexpr int D = (LMAX + 1) * (LMAX + 1);
  static constexpr int P = LMAX == 1 ? K3_P_L1 : K3_P_L2;
  static constexpr int DT = D * T;
  static constexpr int TP = T * P;
  // the radial weights of one product pass: both tracks' at TP <= 16, else
  // one track's (the accumulators of a pass are 4 * PG registers)
  static constexpr int NG = TP <= 16 ? 1 : T;
  static constexpr int PG = TP / NG;
};

__device__ __forceinline__ float silu(float z) { return z / (1.0f + expf(-z)); }

__device__ __forceinline__ float dsilu(float z) {
  const float s = 1.0f / (1.0f + expf(-z));
  return s * (1.0f + z * (1.0f - s));
}

// An operand's parts in the build's form, each a TF32 fragment register:
// TF32X3 hi = rna_tf32(x), lo = rna_tf32(x - hi); BF16X3 hi = bf16(x), lo =
// bf16(x - hi), rounded to nearest even (pallas_nequip.py _split_bf16);
// BF16P hi = bf16(x), lo unused.
__device__ __forceinline__ void split_op(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (K3_MMA == TF32X3) {
    split_tf32(x, hi, lo);
  } else {
    // cvt.rn.bf16.f32, then the bf16 bits to the top of an f32 word (on the
    // H100 faster than rounding by four integer operations: PERF.md)
    const float h = __bfloat162float(__float2bfloat16_rn(x));
    hi = __float_as_uint(h);
    lo = K3_MMA == BF16X3 ? __float_as_uint(__bfloat162float(__float2bfloat16_rn(x - h))) : 0u;
  }
}

// One k-step of a product from split_op's parts: the correction terms
// lo*hi' and hi*lo' into cor (none in one pass), then hi*hi' into acc (cor
// may be acc: one accumulation chain).
__device__ __forceinline__ void mma_op(float* acc, float* cor, const uint32_t (&ah)[4],
                                       const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                       const uint32_t (&bl)[2]) {
  if constexpr (K3_MMA != BF16P) {
    mma_tf32(cor, al, bh);
    mma_tf32(cor, ah, bl);
  }
  mma_tf32(acc, ah, bh);
}

// ---------------------------------------------------------------------------
// Tiles and the radial hidden layers
// ---------------------------------------------------------------------------

// The tile's bessel rows (feature-major, rows past B and edges past ne
// zero), Y (et x D) and u of edges e0 .. e0 + ne.
template <int D>
__device__ void load_tile(const K3P& p, float* sm, int e0, int ne) {
  const int B = p.wdim[0], b8 = r8(B);
  float* bs = sm + p.o_bes;
  for (int q = threadIdx.x; q < b8 * p.et; q += NT) {
    const int n = q / b8, k = q - n * b8;
    bs[k * p.ldx + n] = n < ne && k < B ? __ldg(p.bes + (size_t)(e0 + n) * B + k) : 0.f;
  }
  float* ys = sm + p.o_y;
  for (int q = threadIdx.x; q < p.et * D; q += NT)
    ys[q] = q < ne * D ? __ldg(p.Y + (size_t)e0 * D + q) : 0.f;
  for (int n = threadIdx.x; n < p.et; n += NT) sm[p.o_u + n] = n < ne ? __ldg(p.u + e0 + n) : 0.f;
}

// A small product of the tile on the tensor cores (the build's form): out = s *
// in^T Wk for the tile's edges, feature-major at row stride ldx, rows nd ..
// r8(nd) zero; in (r8(kd) rows, zero past kd) feature-major; Wk(k, n) =
// W[k * nd + n], or with wt W[n * kd + k] (the transpose, for the
// backward), read through the read-only cache.  With act: silu(z) *
// SILU_C into out, and z into zs unless it is null.  Warps take the (m16,
// n8) output tiles in turn; the sum runs in chunks of 64 terms added in
// f32.
__device__ void small_product(const float* __restrict__ W, bool wt, int kd, int nd, const float* in,
                              float* out, bool act, float* zs, int ldx, int et, float s) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int mtiles = (et + 15) >> 4, ntiles = r8(nd) >> 3;
  for (int tile = warp; tile < mtiles * ntiles; tile += NWARP) {
    const int mt = tile % mtiles, n0 = (tile / mtiles) * 8;
    const int e = mt * 16 + g, n = n0 + g;
    const bool r0 = e < et, r1 = e + 8 < et, nv = n < nd;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int kc = 0; kc < r8(kd); kc += 64) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k0 = kc; k0 < min(kc + 64, r8(kd)); k0 += 8) {
        const float* x = in + (k0 + t) * ldx + e;
        uint32_t ah[4], al[4], bh[2], bl[2];
        split_op(r0 ? x[0] : 0.f, ah[0], al[0]);
        split_op(r1 ? x[8] : 0.f, ah[1], al[1]);
        split_op(r0 ? x[4 * ldx] : 0.f, ah[2], al[2]);
        split_op(r1 ? x[4 * ldx + 8] : 0.f, ah[3], al[3]);
        const int k = k0 + t;
        split_op(nv && k < kd ? __ldg(W + (wt ? n * kd + k : k * nd + n)) : 0.f, bh[0], bl[0]);
        split_op(nv && k + 4 < kd ? __ldg(W + (wt ? n * kd + k + 4 : (k + 4) * nd + n)) : 0.f,
                 bh[1], bl[1]);
        mma_op(part, part, ah, al, bh, bl);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] += part[i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ee = e + 8 * (i >> 1), nn = n0 + 2 * t + (i & 1);
      if (ee >= et) continue;
      const float z = acc[i] * s;
      if (act) {
        if (zs) zs[nn * ldx + ee] = z;
        out[nn * ldx + ee] = nn < nd ? silu(z) * SILU_C : 0.f;
      } else {
        out[nn * ldx + ee] = z;
      }
    }
  }
}

// The radial hidden layers of the tile (bessel tile in, ping-pong through
// xa / xb); returns the last layer's input X (r8(hin) rows, zero past hin).
// keep_z: each layer's pre-activations into its slot of the z region.
__device__ const float* radial_hidden(const K3P& p, float* sm, bool keep_z) {
  const float* in = sm + p.o_bes;
  for (int i = 0; i + 1 < p.nw; ++i) {
    float* out = sm + ((i & 1) ? p.o_xb : p.o_xa);
    small_product(p.w + p.woff[i], false, p.wdim[i], p.wdim[i + 1], in, out, true,
                  keep_z ? sm + p.o_z + i * p.hmax8 * p.ldx : nullptr, p.ldx, p.et,
                  rsqrtf((float)p.wdim[i]));
    __syncthreads();
    in = out;
  }
  return in;
}

// The last weight (hin x tpc) into shared memory at row stride sa, rows
// hin .. r8(hin) zeroed, as 16-byte cp.async in one group; the row
// padding (columns tpc .. sa) zeroed too, so that every fragment a product
// reads there is finite and the products need no guard.
__device__ void stage_w(const K3P& p, float* Ws, int hin, int tpc) {
  const int q4 = p.sa / 4;
  for (int q = threadIdx.x; q < r8(hin) * q4; q += NT) {
    const int k = q / q4, m4 = (q - k * q4) * 4;
    const bool in = k < hin && m4 < tpc;
    cp_async16(Ws + k * p.sa + m4, p.wl + (in ? (size_t)k * tpc + m4 : 0), in ? 16 : 0);
  }
  cp_async_commit();
}

// ---------------------------------------------------------------------------
// The tensor-core products
// ---------------------------------------------------------------------------

// acc[j] += X^T Wlast over the rows kb .. ke (multiples of 8) for the
// warp's m16 edge tile mt (rows: edges mt*16 + g and + 8 of the tile) and
// n8 tile j = columns (lo + j) * C + cb .. + 8 of the last weight
// (channels cb .. cb + 8 of radial weight lo + j), unscaled, in the build's
// form on one accumulation chain.  X: feature-major (r8(hin) rows, zero past hin)
// at row stride ldx; with RES the resident weight Ws (row stride sa, zero
// past hin and tpc: no guard), else p.wl (row stride tpc) through the
// read-only cache.
template <int PG, bool RES>
__device__ __forceinline__ void product_terms(const K3P& p, const float* X, const float* Ws,
                                              int hin, int tpc, int mt, int cb, int lo, int kb,
                                              int ke, float (&acc)[PG][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int e = mt * 16 + g;
  const bool r0 = e < p.et, r1 = e + 8 < p.et;
  const bool cv = cb + g < p.C;  // C = 4 fills half an octet
  const int col = lo * p.C + cb + g;
  for (int k0 = kb; k0 < ke; k0 += 8) {
    const float* x = X + (k0 + t) * p.ldx + e;
    uint32_t ah[4], al[4];
    split_op(r0 ? x[0] : 0.f, ah[0], al[0]);
    split_op(r1 ? x[8] : 0.f, ah[1], al[1]);
    split_op(r0 ? x[4 * p.ldx] : 0.f, ah[2], al[2]);
    split_op(r1 ? x[4 * p.ldx + 8] : 0.f, ah[3], al[3]);
    const bool k_lo = cv && k0 + t < hin, k_hi = cv && k0 + t + 4 < hin;
#pragma unroll
    for (int j = 0; j < PG; ++j) {
      float b0, b1;
      if constexpr (RES) {
        const float* w = Ws + (k0 + t) * p.sa + col + j * p.C;
        b0 = w[0];
        b1 = w[4 * p.sa];
      } else {
        const float* w = p.wl + (size_t)(k0 + t) * tpc + col + j * p.C;
        b0 = k_lo ? __ldg(w) : 0.f;
        b1 = k_hi ? __ldg(w + 4 * (size_t)tpc) : 0.f;
      }
      uint32_t bh[2], bl[2];
      split_op(b0, bh[0], bl[0]);
      split_op(b1, bh[1], bl[1]);
      mma_op(acc[j], acc[j], ah, al, bh, bl);
    }
  }
}

// acc[j] = X^T Wlast (product_terms over all hin rows): one chain, or with
// LONG chunks of 64 terms, each from zero, added in f32.
template <int PG, bool RES, bool LONG>
__device__ __forceinline__ void product_fwd(const K3P& p, const float* X, const float* Ws, int hin,
                                            int tpc, int mt, int cb, int lo, float (&acc)[PG][4]) {
#pragma unroll
  for (int j = 0; j < PG; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  if constexpr (LONG) {
    for (int kc = 0; kc < r8(hin); kc += 64) {
      float part[PG][4];
#pragma unroll
      for (int j = 0; j < PG; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[j][i] = 0.f;
      product_terms<PG, RES>(p, X, Ws, hin, tpc, mt, cb, lo, kc, min(kc + 64, r8(hin)), part);
#pragma unroll
      for (int j = 0; j < PG; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] += part[j][i];
    }
  } else {
    product_terms<PG, RES>(p, X, Ws, hin, tpc, mt, cb, lo, 0, r8(hin), acc);
  }
}

// dX += s_last gs Wlast^T over the pass's dX columns x0 .. x0 + XC for the
// warp's edges (dX feature-major in shared memory, the warp's 16 columns
// its own; stored, not added, on the tile's first pass); gs in acc (the
// layout product_fwd left, columns (lo + j) * C + cb ..), each accumulator
// used as an m16k8 A fragment with k = t <- column 2t and k = t + 4 <-
// column 2t + 1, the B fragment the matching pair of Wlast columns of row
// x0 + 8 jj + g.  The pass's 8 PG terms are summed on the tensor cores in
// the build's form, gs split as it stands (with RES the hi*hi' term and the
// corrections in two chains; one chain where the weight is read from device
// memory, whose guards take the registers), the passes in f32.
template <int PG, bool RES>
__device__ __forceinline__ void product_bwd(const K3P& p, const float (&acc)[PG][4],
                                            const float* Ws, int hin, int tpc, int mt, int cb,
                                            int lo, int x0, bool first, float s_last, float* dX) {
  constexpr int XC = xc_of(RES);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool cv = cb + 2 * t < p.C;
  float ph[XC / 8][4], pc[XC / 8][4];
#pragma unroll
  for (int jj = 0; jj < XC / 8; ++jj)
#pragma unroll
    for (int i = 0; i < 4; ++i) ph[jj][i] = pc[jj][i] = 0.f;
#pragma unroll
  for (int j = 0; j < PG; ++j) {
    uint32_t ah[4], al[4];
    split_op(acc[j][0], ah[0], al[0]);
    split_op(acc[j][2], ah[1], al[1]);
    split_op(acc[j][1], ah[2], al[2]);
    split_op(acc[j][3], ah[3], al[3]);
    const int m = (lo + j) * p.C + cb + 2 * t;
#pragma unroll
    for (int jj = 0; jj < XC / 8; ++jj) {
      const int kr = x0 + 8 * jj + g;
      if (x0 + 8 * jj < r8(hin)) {
        float2 b;
        if constexpr (RES)
          b = *reinterpret_cast<const float2*>(Ws + kr * p.sa + m);
        else
          b = cv && kr < hin ? __ldg(reinterpret_cast<const float2*>(p.wl + (size_t)kr * tpc + m))
                             : make_float2(0.f, 0.f);
        uint32_t bh[2], bl[2];
        split_op(b.x, bh[0], bl[0]);
        split_op(b.y, bh[1], bl[1]);
        mma_op(ph[jj], RES ? pc[jj] : ph[jj], ah, al, bh, bl);
      }
    }
  }
  // columns x0 + 8 jj + 2t (+1) of edges g, g + 8
#pragma unroll
  for (int jj = 0; jj < XC / 8; ++jj) {
    const int col = x0 + 8 * jj + 2 * t;
    if (col >= r8(hin)) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = mt * 16 + g + 8 * (i >> 1);
      if (n >= p.et) continue;
      float* d = dX + (col + (i & 1)) * p.ldx + n;
      const float v = (ph[jj][i] + pc[jj][i]) * s_last;
      *d = first ? v : *d + v;
    }
  }
}

// ---------------------------------------------------------------------------
// The TP (CUDA cores), one product pass's radial weights LO .. LO + PG
// ---------------------------------------------------------------------------

// forward: an entry of track pi, for the lane's two channels (a0 / a1 the
// channel's message sums, h0 / h1 its hj values, w0 / w1 its weights)
#define K3_FWD_TRACK(d1, d2, d3, pp, odd, cf, pi)                                 \
  if constexpr ((pi) * P + (pp) >= LO && (pi) * P + (pp) < LO + PG) {            \
    constexpr int wi = (pi) * P + (pp) - LO, i1 = (d1) * T + (pi);                \
    constexpr int i3 = (d3) * T + (T == 2 ? ((pi) ^ (odd)) : 0);                  \
    const float cy = (cf) * y[d2];                                               \
    a0[i3] = fmaf(cy * w0[wi], h0[i1], a0[i3]);                                  \
    a1[i3] = fmaf(cy * w1[wi], h1[i1], a1[i3]);                                  \
  }
#define K3_FWD(d1, d2, d3, pp, odd, cf)     \
  K3_FWD_TRACK(d1, d2, d3, pp, odd, cf, 0)  \
  if constexpr (T == 2) {                   \
    K3_FWD_TRACK(d1, d2, d3, pp, odd, cf, 1) \
  }

template <int LMAX, int T, int GI>
__device__ __forceinline__ void tp_fwd(const float* y, const float (&w0)[Cfg<LMAX, T>::PG],
                                       const float (&w1)[Cfg<LMAX, T>::PG],
                                       const float (&h0)[Cfg<LMAX, T>::DT],
                                       const float (&h1)[Cfg<LMAX, T>::DT],
                                       float (&a0)[Cfg<LMAX, T>::DT],
                                       float (&a1)[Cfg<LMAX, T>::DT]) {
  constexpr int P = Cfg<LMAX, T>::P, PG = Cfg<LMAX, T>::PG, LO = GI * PG;
  if constexpr (LMAX == 1) {
    K3_TP_ENTRIES_L1(K3_FWD)
  } else {
    K3_TP_ENTRIES_L2(K3_FWD)
  }
}

// backward: an entry of track pi for one (edge, channel) cell: its
// contributions to dh, dw and dY (gl the center's cotangent * inv_avg)
#define K3_BWD_TRACK(d1, d2, d3, pp, odd, cf, pi)                                \
  if constexpr ((pi) * P + (pp) >= LO && (pi) * P + (pp) < LO + PG) {           \
    constexpr int wi = (pi) * P + (pp) - LO, i1 = (d1) * T + (pi);               \
    constexpr int i3 = (d3) * T + (T == 2 ? ((pi) ^ (odd)) : 0);                 \
    const float gm = (cf) * gl[i3];                                              \
    const float gw = gm * w[wi];                                                 \
    dh[i1] = fmaf(gw, y[d2], dh[i1]);                                            \
    dw[wi] = fmaf(gm, h[i1] * y[d2], dw[wi]);                                    \
    dy[d2] = fmaf(gw, h[i1], dy[d2]);                                            \
  }
#define K3_BWD(d1, d2, d3, pp, odd, cf)     \
  K3_BWD_TRACK(d1, d2, d3, pp, odd, cf, 0)  \
  if constexpr (T == 2) {                   \
    K3_BWD_TRACK(d1, d2, d3, pp, odd, cf, 1) \
  }

template <int LMAX, int T, int GI>
__device__ __forceinline__ void tp_bwd(const float* y, const float (&w)[Cfg<LMAX, T>::PG],
                                       const float (&gl)[Cfg<LMAX, T>::DT],
                                       const float (&h)[Cfg<LMAX, T>::DT],
                                       float (&dh)[Cfg<LMAX, T>::DT],
                                       float (&dw)[Cfg<LMAX, T>::PG],
                                       float (&dy)[Cfg<LMAX, T>::D]) {
  constexpr int P = Cfg<LMAX, T>::P, PG = Cfg<LMAX, T>::PG, LO = GI * PG;
  if constexpr (LMAX == 1) {
    K3_TP_ENTRIES_L1(K3_BWD)
  } else {
    K3_TP_ENTRIES_L2(K3_BWD)
  }
}

// Whether hj lane i = d * T + tau belongs to product pass GI's tracks.
template <int T, int NG, int GI>
__device__ __forceinline__ constexpr bool in_pass(int i) {
  return NG == 1 || i % T == GI;
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

// Pass GI of the warp's m16 tile mt and channel octet cb: the product, then
// the TP of the lane's cells (edges mt*16 + g, + 8; channels c, c + 1) into
// the channel sums a0 / a1, their hj values read as pairs of channels (on
// the card, loading them ahead of the product was slower and spilled).
template <int LMAX, int T, int GI, bool RES, bool LONG>
__device__ __forceinline__ void fwd_pass(const K3P& p, const float* sm, const float* X,
                                         const float* Ws, int hin, int mt, int cb, int e0, int ne,
                                         float s_last, float (&a0)[Cfg<LMAX, T>::DT],
                                         float (&a1)[Cfg<LMAX, T>::DT]) {
  using G = Cfg<LMAX, T>;
  constexpr int D = G::D, DT = G::DT, PG = G::PG, NG = G::NG;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int C = p.C, c = cb + 2 * t, df = DT * C;
  float acc[PG][4];
  product_fwd<PG, RES, LONG>(p, X, Ws, hin, G::TP * C, mt, cb, GI * PG, acc);
  const float* ys = sm + p.o_y;
  const float* us = sm + p.o_u;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int n = mt * 16 + g + 8 * h2;
    if (c >= C || n >= ne) continue;
    const K3_HJ* row = p.hj + (size_t)(e0 + n) * df + c;
    float y[D], w0[PG], w1[PG], h0[DT], h1[DT];
#pragma unroll
    for (int d = 0; d < D; ++d) y[d] = ys[n * D + d];
    const float uu = us[n] * s_last;
#pragma unroll
    for (int j = 0; j < PG; ++j) {
      w0[j] = acc[j][2 * h2] * uu;
      w1[j] = acc[j][2 * h2 + 1] * uu;
    }
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      const float2 v = in_pass<T, NG, GI>(i) ? ld_hj2(row + i * C) : make_float2(0.f, 0.f);
      h0[i] = v.x;
      h1[i] = v.y;
    }
    tp_fwd<LMAX, T, GI>(y, w0, w1, h0, h1, a0, a1);
  }
}

template <int LMAX, int T, bool RES, bool LONG>
__global__ void __launch_bounds__(NT, LMAX == 1 ? 2 : 1) k3_fwd_kernel(const K3P p) {
  using G = Cfg<LMAX, T>;
  constexpr int D = G::D, DT = G::DT, NG = G::NG;
  extern __shared__ __align__(16) float sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int C = p.C, hin = p.wdim[p.nw - 1], df = DT * C;
  const int noct = (C + 7) >> 3, wo = warp % p.wo, we = warp / p.wo;
  const float s_last = rsqrtf((float)hin);
  const float* Ws = RES ? sm + p.o_w : nullptr;
  if (RES) stage_w(p, sm + p.o_w, hin, G::TP * C);
  bool staged = !RES;
  float* aggp = sm + p.o_agg;  // [we][DT][C]: each edge group's channel sums
  for (int center = blockIdx.x; center < p.E / p.K; center += gridDim.x) {
    for (int q = threadIdx.x; q < p.we * df; q += NT) aggp[q] = 0.f;
    for (int t0 = 0; t0 < p.K; t0 += p.et) {
      const int e0 = center * p.K + t0, ne = min(p.et, p.K - t0);
      load_tile<D>(p, sm, e0, ne);
      __syncthreads();
      const float* X = radial_hidden(p, sm, false);
      if (!staged) {
        cp_async_wait<0>();
        __syncthreads();
        staged = true;
      }
      for (int oc = wo; oc < noct; oc += p.wo) {
        const int cb = 8 * oc, c = cb + 2 * t;
        float a0[DT], a1[DT];
#pragma unroll
        for (int i = 0; i < DT; ++i) a0[i] = a1[i] = 0.f;
        for (int mt = we; mt * 16 < ne; mt += p.we) {
          fwd_pass<LMAX, T, 0, RES, LONG>(p, sm, X, Ws, hin, mt, cb, e0, ne, s_last, a0, a1);
          if constexpr (NG == 2)
            fwd_pass<LMAX, T, 1, RES, LONG>(p, sm, X, Ws, hin, mt, cb, e0, ne, s_last, a0, a1);
        }
        // the channels' sums over the warp's edges: the 8 lanes of equal t
#pragma unroll
        for (int i = 0; i < DT; ++i)
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            a0[i] += __shfl_xor_sync(0xffffffffu, a0[i], off);
            a1[i] += __shfl_xor_sync(0xffffffffu, a1[i], off);
          }
        if (g == 0 && c < C) {
          float* dst = aggp + we * df + c;
#pragma unroll
          for (int i = 0; i < DT; ++i) {
            dst[i * C] += a0[i];
            dst[i * C + 1] += a1[i];
          }
        }
      }
      __syncthreads();  // the tile's buffers are rewritten next
    }
    for (int q = threadIdx.x; q < df; q += NT) {
      float s = 0.f;
      for (int w2 = 0; w2 < p.we; ++w2) s += aggp[w2 * df + q];
      p.agg[(size_t)center * df + q] = s * p.inv_avg;
    }
    __syncthreads();
  }
  if (!staged) cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// Pass GI of the warp's m16 tile and channel octet cb: the product again
// (w_raw), the TP backward of the lane's four cells one at a time (dhj, dY
// and du on the first dX pass only), gs = dw * u into the accumulators,
// and the pass's dX columns from them.
template <int LMAX, int T, int GI, bool RES, bool LONG>
__device__ __forceinline__ void bwd_pass(const K3P& p, const float* sm, const float* X,
                                         const float* Ws, int hin, int mt, int cb, int e0, int ne,
                                         float s_last, int x0, float* dX,
                                         float (&dy)[2][Cfg<LMAX, T>::D], float (&du)[2]) {
  using G = Cfg<LMAX, T>;
  constexpr int D = G::D, DT = G::DT, PG = G::PG, NG = G::NG;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int C = p.C, df = DT * C, tpc = G::TP * C;
  // at l_max 1, where the registers allow, this pass's hj values of the
  // lane's cells and their centers' cotangents, loaded ahead of the product
  constexpr bool PRE = LMAX == 1;
  float2 hv[2][PRE ? DT : 1], gv[2][PRE ? DT : 1];
  if constexpr (PRE) {
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int n = mt * 16 + g + 8 * h2, c = cb + 2 * t;
      const bool ok = c < C && n < ne;
      const K3_HJ* row = p.hj + (size_t)(e0 + (ok ? n : 0)) * df + c;
      const float* grow = p.dagg + (size_t)((e0 + (ok ? n : 0)) / p.K) * df + c;
#pragma unroll
      for (int i = 0; i < DT; ++i) {
        hv[h2][i] = ok && in_pass<T, NG, GI>(i) ? ld_hj2(row + i * C) : make_float2(0.f, 0.f);
        gv[h2][i] = ok ? __ldg(reinterpret_cast<const float2*>(grow + i * C))
                       : make_float2(0.f, 0.f);
      }
    }
  }
  float acc[PG][4];
  product_fwd<PG, RES, LONG>(p, X, Ws, hin, tpc, mt, cb, GI * PG, acc);
  const float* ys = sm + p.o_y;
  const float* us = sm + p.o_u;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
#pragma unroll
    for (int hc = 0; hc < 2; ++hc) {
      const int n = mt * 16 + g + 8 * h2, c = cb + 2 * t + hc, slot = 2 * h2 + hc;
      float dw[PG];
#pragma unroll
      for (int j = 0; j < PG; ++j) dw[j] = 0.f;
      if (n < ne && c < C) {
        const int e = e0 + n;
        const float* gp = p.dagg + (size_t)(e / p.K) * df + c;
        const K3_HJ* hp = p.hj + (size_t)e * df + c;
        float gl[DT], h[DT], dh[DT], y[D], w[PG], dyl[D];
#pragma unroll
        for (int i = 0; i < DT; ++i) {
          if constexpr (PRE) {
            gl[i] = (hc ? gv[h2][i].y : gv[h2][i].x) * p.inv_avg;
            h[i] = hc ? hv[h2][i].y : hv[h2][i].x;
          } else {
            gl[i] = __ldg(gp + i * C) * p.inv_avg;
            h[i] = in_pass<T, NG, GI>(i) ? ld_hj(hp + i * C) : 0.f;
          }
          dh[i] = 0.f;
        }
#pragma unroll
        for (int d = 0; d < D; ++d) {
          y[d] = ys[n * D + d];
          dyl[d] = 0.f;
        }
        const float uu = us[n];
#pragma unroll
        for (int j = 0; j < PG; ++j) w[j] = acc[j][slot] * s_last * uu;
        tp_bwd<LMAX, T, GI>(y, w, gl, h, dh, dw, dyl);
        if (x0 == 0) {
          K3_HJ* dp = p.dhj + (size_t)e * df + c;
#pragma unroll
          for (int i = 0; i < DT; ++i)
            if (in_pass<T, NG, GI>(i)) st_hj(dp + i * C, dh[i]);
          float s = 0.f;
#pragma unroll
          for (int j = 0; j < PG; ++j) s = fmaf(dw[j], acc[j][slot], s);
          du[h2] = fmaf(s, s_last, du[h2]);
#pragma unroll
          for (int d = 0; d < D; ++d) dy[h2][d] += dyl[d];
        }
#pragma unroll
        for (int j = 0; j < PG; ++j) dw[j] *= uu;
      }
#pragma unroll
      for (int j = 0; j < PG; ++j) acc[j][slot] = dw[j];
    }
  }
  product_bwd<PG, RES>(p, acc, Ws, hin, tpc, mt, cb, GI * PG, x0, cb == 0 && GI == 0, s_last, dX);
}

template <int LMAX, int T, bool RES, bool LONG>
__global__ void __launch_bounds__(NT, 1) k3_bwd_kernel(const K3P p) {
  using G = Cfg<LMAX, T>;
  constexpr int D = G::D, NG = G::NG;
  extern __shared__ __align__(16) float sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int C = p.C, hin = p.wdim[p.nw - 1], B = p.wdim[0];
  const int noct = (C + 7) >> 3, mt = warp;  // the warp's m16 edge tile
  const float s_last = rsqrtf((float)hin);
  const float* Ws = RES ? sm + p.o_w : nullptr;
  if (RES) stage_w(p, sm + p.o_w, hin, G::TP * C);
  bool staged = !RES;
  // X is the last hidden layer's output (xa for an even layer, xb for an
  // odd one) or, without hidden layers, the bessel tile; dX goes to the
  // other buffer
  const int last = p.nw - 2;
  float* dX = sm + (last >= 0 && (last & 1) == 0 ? p.o_xb : p.o_xa);
  float* other = sm + (dX == sm + p.o_xa ? p.o_xb : p.o_xa);
  const int n_tiles = (p.E + p.et - 1) / p.et;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int e0 = tile * p.et, ne = min(p.et, p.E - e0);
    load_tile<D>(p, sm, e0, ne);
    __syncthreads();
    const float* X = radial_hidden(p, sm, true);
    if (!staged) {
      cp_async_wait<0>();
      __syncthreads();
      staged = true;
    }
    const bool active = mt * 16 < ne;
    float dy[2][D], du[2] = {0.f, 0.f};
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
      for (int d = 0; d < D; ++d) dy[h2][d] = 0.f;
    for (int x0 = 0; x0 < r8(hin) && active; x0 += xc_of(RES))
      for (int oc = 0; oc < noct; ++oc) {
        bwd_pass<LMAX, T, 0, RES, LONG>(p, sm, X, Ws, hin, mt, 8 * oc, e0, ne, s_last, x0, dX,
                                        dy, du);
        if constexpr (NG == 2)
          bwd_pass<LMAX, T, 1, RES, LONG>(p, sm, X, Ws, hin, mt, 8 * oc, e0, ne, s_last, x0, dX,
                                          dy, du);
      }
    // dY and du: each lane holds its channels' share of edges g and g + 8;
    // the four lanes of equal g hold all of them
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        du[h2] += __shfl_xor_sync(0xffffffffu, du[h2], off);
#pragma unroll
        for (int d = 0; d < D; ++d) dy[h2][d] += __shfl_xor_sync(0xffffffffu, dy[h2][d], off);
      }
      const int n = mt * 16 + g + 8 * h2;
      if (t == 0 && n < ne) {
        p.du[e0 + n] = du[h2];
#pragma unroll
        for (int d = 0; d < D; ++d) p.dY[(size_t)(e0 + n) * D + d] = dy[h2][d];
      }
    }
    __syncthreads();
    // back through the hidden layers: dz = dx * silu'(z) * c, dx_i = dz W_i^T / sqrt(din)
    float* dx = dX;
    float* dx2 = other;
    for (int i = p.nw - 2; i >= 0; --i) {
      const int din = p.wdim[i], dout = p.wdim[i + 1];
      const float* zs = sm + p.o_z + i * p.hmax8 * p.ldx;
      for (int q = threadIdx.x; q < dout * p.et; q += NT) {
        const int j = q / p.et, n = q - j * p.et;
        dx[j * p.ldx + n] *= dsilu(zs[j * p.ldx + n]) * SILU_C;
      }
      __syncthreads();
      small_product(p.w + p.woff[i], true, dout, din, dx, dx2, false, nullptr, p.ldx, p.et,
                    rsqrtf((float)din));
      __syncthreads();
      float* tmp = dx;
      dx = dx2;
      dx2 = tmp;
    }
    for (int q = threadIdx.x; q < ne * B; q += NT) {
      const int n = q / B, k = q - n * B;
      p.dbes[(size_t)e0 * B + q] = dx[k * p.ldx + n];
    }
    __syncthreads();  // the tile's buffers are rewritten next
  }
  if (!staged) cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// Layout and launch
// ---------------------------------------------------------------------------

// The block's shared-memory carving at edge tile et, with the last weight
// resident or not (16-byte aligned regions, in floats); returns its bytes.
size_t k3_layout(K3P& p, bool bwd, int D, int DT, int et, bool resident) {
  const int hin = p.wdim[p.nw - 1];
  p.et = et;
  p.ldx = et > 8 ? et + 8 : 8;  // = 8 mod 32 (or 24): conflict-free A fragments
  p.resident = resident;
  int off = 0;
  auto take = [&](int words) {
    const int o = off;
    off += (words + 3) & ~3;
    return o;
  };
  p.o_w = take(resident ? r8(hin) * p.sa : 0);
  p.o_bes = take(r8(p.wdim[0]) * p.ldx);
  p.o_xa = take(bwd || p.nw > 1 ? p.hmax8 * p.ldx : 0);
  p.o_xb = take(p.nw > 2 || (bwd && p.nw > 1) ? p.hmax8 * p.ldx : 0);
  p.o_z = take(bwd ? (p.nw - 1) * p.hmax8 * p.ldx : 0);
  p.o_y = take(et * D);
  p.o_u = take(et);
  p.o_agg = take(bwd ? 0 : p.we * DT * p.C);
  return (size_t)off * 4;
}

// Reads the widths, checks what the kernels take and picks the layout:
// the widest edge tile with the last weight resident, else the widest
// without; returns the block's shared-memory bytes or a negative code.
int k3_plan(K3P& p, bool bwd, int lmax, int n_tracks, const int* dims) {
  if (lmax < 1 || lmax > 2 || n_tracks < 1 || n_tracks > 2) return -6;
  p.C = dims[0];
  p.K = dims[1];
  p.E = dims[2];
  p.nw = dims[3];
  if (p.nw < 1 || p.nw > MAX_W) return -1;
  if (p.K < 1 || p.E % p.K) return -2;
  // C in 4, 8, 16 or a multiple of 32 up to 128 (channel octets; 4 fills half of one)
  if (p.C < 4 || p.C > 128 || (p.C % 32 && 32 % p.C)) return -3;
  int off = 0, hmax = 0;
  for (int i = 0; i <= p.nw; ++i) {
    p.wdim[i] = dims[4 + i];
    if (p.wdim[i] < 1) return -4;
    if (i < p.nw) {
      p.woff[i] = off;
      off += p.wdim[i] * dims[5 + i];
      if (p.wdim[i] > hmax) hmax = p.wdim[i];
    }
  }
  const int D = (lmax + 1) * (lmax + 1), DT = D * n_tracks;
  const int tpc = n_tracks * (lmax == 1 ? K3_P_L1 : K3_P_L2) * p.C;
  if (p.wdim[p.nw] != tpc) return -4;
  if (p.wdim[p.nw - 1] % 4) return -7;
  p.hmax8 = r8(hmax);
  p.sa = (tpc + 23) / 32 * 32 + 8;
  p.wo = (p.C + 7) / 8 < NWARP ? (p.C + 7) / 8 : NWARP;
  p.we = NWARP / p.wo;
  const int* ets = bwd ? ET_BWD : ET_FWD;
  const int n_et = bwd ? N_ET_BWD : N_ET_FWD;
  for (int resident = 1; resident >= 0; --resident)
    for (int i = 0; i < n_et; ++i) {
      const size_t smem = k3_layout(p, bwd, D, DT, ets[i], resident);
      if (smem <= SMEM_MAX) return (int)smem;
    }
  return -5;
}

template <typename Kern>
int launch(Kern kern, const K3P& p, int smem, int work, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT, smem)) != cudaSuccess)
    return (int)err;
  const int blocks = work < sms * (per_sm > 0 ? per_sm : 1) ? work : sms * (per_sm > 0 ? per_sm : 1);
  if (blocks == 0) return 0;
  kern<<<blocks, NT, smem, st>>>(p);
  return (int)cudaGetLastError();
}

template <int LMAX, int T, bool LONG>
int launch_kernel(bool bwd, const K3P& p, int smem, cudaStream_t st) {
  const int tiles = (p.E + p.et - 1) / p.et, centers = p.E / p.K;
  if (bwd)
    return p.resident ? launch(k3_bwd_kernel<LMAX, T, true, LONG>, p, smem, tiles, st)
                      : launch(k3_bwd_kernel<LMAX, T, false, LONG>, p, smem, tiles, st);
  return p.resident ? launch(k3_fwd_kernel<LMAX, T, true, LONG>, p, smem, centers, st)
                    : launch(k3_fwd_kernel<LMAX, T, false, LONG>, p, smem, centers, st);
}

// the last product's depth picks the chained (hin <= 64) or chunked kernels
template <int LMAX, int T>
int launch_kernel(bool bwd, const K3P& p, int smem, cudaStream_t st) {
  return p.wdim[p.nw - 1] > 64 ? launch_kernel<LMAX, T, true>(bwd, p, smem, st)
                               : launch_kernel<LMAX, T, false>(bwd, p, smem, st);
}

}  // namespace

extern "C" {

// radial MLP weight matrices the kernel takes (checked by the wrapper)
int k3_max_weights() { return MAX_W; }

// dims: C, K, E, nw, wdim[0..nw] (as k3_launch).  The shared-memory bytes
// of the launch the kernel would make, or its negative code; with what =
// 1 its edge tile, 2 whether the last weight is resident (1 / 0).
int k3_layout_of(int bwd, int lmax, int n_tracks, const int* dims, int what) {
  K3P p{};
  const int smem = k3_plan(p, bwd != 0, lmax, n_tracks, dims);
  if (smem < 0 || what == 0) return smem;
  return what == 1 ? p.et : p.resident;
}

// ptrs: hj, bes, u, Y, w (every radial weight, flat), wl (the last weight,
//       16-byte aligned), dagg, agg, dhj, dbes, du, dY (unused ones 0)
// dims: C, K, E, nw, wdim[0..nw]
// Returns 0, a negative code for a shape the kernel does not take (-8: wl
// not 16-byte aligned), or the cudaError_t of the launch.
int k3_launch(int bwd, int lmax, int n_tracks, const unsigned long long* ptrs, const int* dims,
              float inv_avg, void* stream) {
  K3P p{};
  const int smem = k3_plan(p, bwd != 0, lmax, n_tracks, dims);
  if (smem < 0) return smem;
  p.hj = (const K3_HJ*)ptrs[0];
  p.bes = (const float*)ptrs[1];
  p.u = (const float*)ptrs[2];
  p.Y = (const float*)ptrs[3];
  p.w = (const float*)ptrs[4];
  p.wl = (const float*)ptrs[5];
  p.dagg = (const float*)ptrs[6];
  p.agg = (float*)ptrs[7];
  p.dhj = (K3_HJ*)ptrs[8];
  p.dbes = (float*)ptrs[9];
  p.du = (float*)ptrs[10];
  p.dY = (float*)ptrs[11];
  p.inv_avg = inv_avg;
  if (ptrs[5] % 16) return -8;
  cudaStream_t st = (cudaStream_t)stream;
  if (lmax == 1 && n_tracks == 1) return launch_kernel<1, 1>(bwd != 0, p, smem, st);
  if (lmax == 1 && n_tracks == 2) return launch_kernel<1, 2>(bwd != 0, p, smem, st);
  if (lmax == 2 && n_tracks == 1) return launch_kernel<2, 1>(bwd != 0, p, smem, st);
  return launch_kernel<2, 2>(bwd != 0, p, smem, st);
}

}  // extern "C"
