// The body of the one-layer fused Allegro kernels, shared by K1
// (fused_layer.cu), its embed- and readout-fused forms K6 and K7
// (embed_readout_layer.cu) and the whole-stack kernel K8 (fused_stack.cu),
// which runs it once per layer.  The form is a template parameter, so each
// library compiles only its own code paths:
//   PLAIN    K1: x (and V, or pT when first_v) read from device memory;
//   EMBED    K6: the first_v form, x = MLP2b(in) * u and pT = W_te^T x /
//            sqrt(ns) made per tile from the two-body input rows (the
//            prologue); the backward returns d(in), dY and du;
//   READOUT  K7: the last form, the readout (and charge) heads run per tile
//            on x' (the epilogue) and only their rows e = head(x') * u
//            leave the kernel; the backward takes those rows' cotangents;
//   STACK    K8: PLAIN, but x, V and the cotangents dx', dV' live in device
//            memory the same kernel writes (the previous layer's output), so
//            they are read around the read-only cache, and the backward adds
//            its dY and du to the layers' already there when ``acc`` is set;
//            each layer's parameters are copied into shared memory first.
// One thread block owns one center and walks its K edges in tiles of ET
// (allegro_tiles.cuh).  Every small product (wz, the mix, the latent MLP,
// the prologue's and epilogue's MLPs, and their backward) runs on the
// tensor cores in 3xTF32 with its weights staged through a cp.async ring,
// and the TP keeps its sums in registers (allegro_mma.cuh); the tiles come
// in by cp.async.  What K1 computes and why it is laid out so is at the top
// of fused_layer.cu, what the prologue and the epilogue add at the top of
// embed_readout_layer.cu.
//
// The body is templated on the activations' storage type (K1T<Act>): f32,
// and bf16 for the interior="bf16" tier in every form (fused_layer_bf16.cu:
// K1; embed_readout_layer_bf16.cu: K6 and K7; fused_stack_bf16.cu: K8).  At
// bf16 the activations are read from and written to device memory as bf16
// and converted to and from f32 in the shared tiles, so the TP, the env
// sums and the elementwise work run in f32 registers, and every product,
// the prologue's and the epilogue's MLP layers and the tensor embed
// included, runs one bf16 tensor-core pass on pair-packed weights
// (allegro_mma.cuh prod_f); a head's width-1 last layer is a row sum on its
// bf16-rounded weights, unpacked from their pairs (wcol).  The prologue's and
// the epilogue's MLPs and the tensor embed apply their constants (the fan-in
// scales, the SiLU norm, 1/sqrt(ns)) rounded to bf16 and round a width-1
// layer's operands and products, as the TPU kernels do at bf16 (rnd); so
// does the K1 body: its constants (the fan-in scales, the SiLU norm,
// 1/sqrt(ns), 1/sqrt(2); the wrappers round 1/sqrt(avg), the 3j weights and
// the mix norms of the table they pass) apply rounded to bf16, where JAX's
// weakly typed Python floats take the values' dtype.
//
// On f32 activations the body's products take the build's form (K1_MMA,
// allegro_mma.cuh): 3xTF32 (fused_layer.cu and the other f32 sources),
// bf16x3 (the *_bf16x3.cu builds: the precision policy's kernel_high and
// high) or one bf16 pass on pair-packed weights (the *_onepass.cu builds:
// its default), so the body computes what the TPU kernels' _mm computes
// under each policy.  The readout heads stay 3xTF32 in every build (JAX's
// _mm_exact); the prologue (the two-body MLP and the tensor embed) takes
// the body's form, or 3xTF32 where the launch sets pro_exact
// (PAT_EMBED_PREC=highest, JAX's _mm_embed).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "allegro_mma.cuh"

namespace {

#ifndef K1_MMA
#define K1_MMA TF32X3
#endif

constexpr float SILU_C = 1.6790564307512243f;
constexpr float R2 = 0.70710678118654752f;

enum Form { PLAIN = 0, EMBED = 1, READOUT = 2, STACK = 3 };

// The body's product form (Mma): the build's on f32 activations, one bf16
// pass on bf16 ones; and the f32-accurate form of the heads and of an
// exact prologue (one bf16 pass at bf16, as JAX's _mm_exact falls back).
template <typename Act>
constexpr int BODY = IS_BF16<Act> ? (int)BF16P : (int)K1_MMA;
template <typename Act>
constexpr int EXACT = IS_BF16<Act> ? (int)BF16P : (int)TF32X3;

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// Shape of a prologue or epilogue MLP (bias-free, normalized SiLU), built
// by the wrapper and copied into shared memory at block start: layer li
// maps dim[li] rows to dim[li + 1] rows with the row-major (dim[li],
// dim[li + 1]) block at ew + off[li] (its transpose at ewT + off[li]),
// times scale[li] = 1/sqrt(fan-in).  dim[0] may be padded with zero weight
// rows to a multiple of 4; a last layer of width 1 is a weighted row sum.
struct MlpTab {
  int n;     // layers
  int maxw;  // widest hidden layer (rows of one pre-activation slot), >= 4
  int dim[MAX_LAT + 1];
  int off[MAX_LAT];
  float scale[MAX_LAT];
};
constexpr int MT_WORDS = sizeof(MlpTab) / 4;

// The launch's parameters; Act is the storage type of the activations and
// their cotangents (x, V, Y, u, the input rows and the heads' cotangents
// in; xo, vo, dx, dV, dY, du, d(in) and the heads' rows out), whose
// weights (envw .. mixT, te, teT, ew, ewT) are f32 at f32 and pair-packed
// bf16 words at bf16.
template <typename Act>
struct K1T {
  const Act *x, *V, *Y, *u;
  const float *envw, *envwT, *lat, *latT, *mix, *mixT;
  const Act *dxo, *dvo;
  const int* meta;
  Act *xo, *vo, *dx, *dV, *dY, *du;
  int ns, C, Cout, D, K, E, nlat, first_v, last, maxw, maxpc, in0;
  float inv_avg, cns;
  int o_env, o_denv, o_cat, o_V, o_pT, o_Y, o_u, o_du, o_R;
  // EMBED and READOUT: two MlpTab (the two-body MLP; or the readout and the
  // charge head) and the flat weights they index, with their transposes
  const int* mt;
  const float *ew, *ewT;
  int o_mt;
  // the widest hidden layer, and the rows of the pre-activation store: of
  // the two-body MLP (EMBED) or of either head (READOUT)
  int xmaxw, hzrows;
  // EMBED: the (n_in, E) two-body input rows, W_te (ns, C) and its
  // transpose, d(in) (n_in, E), and the backward's f32 scratch part
  // (ns + 1, E) for the pass-1 partials of dx (which EMBED does not
  // return) and du, so that du rounds to Act once, at its last store
  const Act* in;
  const float *te, *teT;
  Act* din;
  float* part;
  int n_in;
  // READOUT: heads (1 or 2), their cotangent rows and output rows (1, E)
  int nhead;
  const Act *dh0, *dh1;
  Act *ho0, *ho1;
  // STACK backward: add dY and du to what the later layers left there
  int acc;
  // EMBED: the prologue's products in EXACT form (its weights f32, or at
  // bf16 pair-packed) rather than the body's
  int pro_exact;
  // the product tiles' row stride (LDS_WIDE, or LDS_MIN where the layout
  // needs it; the kernels are built for each), the weight ring (words, 0 for none; offset), the backward's
  // j-ordered entries, the STACK copy of this K1P, and whether tiles load
  // by 16-byte cp.async
  int lds, ring, o_ring, o_perm, o_p, vec;
};
using K1P = K1T<float>;
constexpr int P_WORDS = 128;  // shared words that hold STACK's copy of its layer's K1P
static_assert(sizeof(K1P) <= 4 * P_WORDS, "K1P exceeds its shared-memory slot");

template <typename Act>
__device__ __forceinline__ float* ring_of(const K1T<Act>& p) {
  extern __shared__ float sm[];
  return sm + p.o_ring;
}

// x, V and the cotangents dx', dV' of a tile: STACK reads memory its own
// kernel wrote, the other forms read-only inputs
template <int F, typename Act>
__device__ __forceinline__ void load_act(const K1T<Act>& p, const Act* src, int rows, int e0,
                                         int ne, float* dst, int ld) {
  load_tile_async<F != STACK>(src, rows, p.E, e0, ne, dst, ld, p.vec);
}

template <int F, int L, typename Act>
__device__ __forceinline__ void load_act(const K1T<Act>& p, const Act* src, int rows, int e0,
                                         int ne, float* dst) {
  load_act<F>(p, src, rows, e0, ne, dst, L);
}

// Y, u, the input rows and the heads' cotangents: read-only inputs
template <int L, typename Act, typename T>
__device__ __forceinline__ void load_in(const K1T<Act>& p, const T* src, int rows, int e0, int ne,
                                        float* dst) {
  load_tile_async<true>(src, rows, p.E, e0, ne, dst, L, p.vec);
}

__device__ __forceinline__ float silu(float z) { return z / (1.0f + expf(-z)); }

__device__ __forceinline__ float dsilu(float z) {
  const float s = 1.0f / (1.0f + expf(-z));
  return s * (1.0f + z * (1.0f - s));
}

// Element k of a width-1 weight column at w in form FM: f32, or half of the
// pair-packed word k / 2 (low half for even k); BF16X3 (which no head
// takes) the sum of the hi and lo words' halves.
__device__ __forceinline__ float half_of(uint32_t word, int k) {
  return __uint_as_float((k & 1 ? word >> 16 : word & 0xffffu) << 16);
}

template <int FM>
__device__ __forceinline__ float wcol(const float* w, int k) {
  if constexpr (FM == BF16P) {
    return half_of(__float_as_uint(w[k >> 1]), k);
  } else if constexpr (FM == BF16X3) {
    return half_of(__float_as_uint(w[k & ~1]), k) + half_of(__float_as_uint(w[(k & ~1) + 1]), k);
  } else {
    return w[k];
  }
}

// v as the TPU kernel holds it at the storage type: at bf16 rounded to
// bf16 (JAX keeps the prologue's and the epilogue's values in bf16 and
// rounds a Python constant to bf16 where it multiplies one), else v.
template <typename Act>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (IS_BF16<Act>) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

// The pass-1 partials of dx (ns rows) and du (one row): in the outputs dx
// and du, or for EMBED in the f32 scratch part.
template <int F, typename Act>
__device__ __forceinline__ auto* dx_part(const K1T<Act>& p) {
  if constexpr (F == EMBED) {
    return p.part;
  } else {
    return p.dx;
  }
}

template <int F, typename Act>
__device__ __forceinline__ auto* du_part(const K1T<Act>& p) {
  if constexpr (F == EMBED) {
    return p.part + (size_t)p.ns * p.E;
  } else {
    return p.du;
  }
}

// Forward of a prologue / epilogue MLP on one tile: hin (t.dim[0] rows) ->
// out (t.dim[t.n] rows); hidden activations ping-pong through hA / hB, and
// the pre-activations are kept in zs (slots of t.maxw rows) when given.
template <int L, int FM, typename Act>
__device__ void mlp_fwd(const K1T<Act>& p, const MlpTab& t, const float* w, const float* hin,
                        float* hA, float* hB, float* zs, float* out) {
  for (int li = 0; li < t.n; ++li) {
    const int din = t.dim[li], dout = t.dim[li + 1];
    const bool hidden = li < t.n - 1;
    float* h = (li & 1) ? hB : hA;
    float* z = !hidden ? out : (zs ? zs + (size_t)li * t.maxw * L : h);
    const float scale = rnd<Act>(t.scale[li]);
    if (dout == 1) {  // a head's last layer: one weighted row sum per edge
      const float* wl = w + wofs_f<FM>(t.off[li]);
      for (int n = threadIdx.x; n < ET; n += NT) {
        float s = 0.f;
        for (int k = 0; k < din; ++k) s += rnd<Act>(wcol<FM>(wl, k) * rnd<Act>(hin[k * L + n]));
        z[n] = s * scale;
      }
    } else {
      prod_f<FM>(w + wofs_f<FM>(t.off[li]), din, dout, hin, L, z, L, scale, ET, ring_of(p), p.ring);
    }
    __syncthreads();
    if (hidden) {
      const float c = rnd<Act>(SILU_C);
      for (int q = threadIdx.x; q < dout * ET; q += NT) {
        const int row = q / ET, n = q % ET;
        h[row * L + n] = silu(z[row * L + n]) * c;
      }
      __syncthreads();
      hin = h;
    }
  }
}

// Backward of mlp_fwd from g (t.dim[t.n] rows) with the kept pre-activations
// zs; g and g2 (each as wide as the widest layer) ping-pong and g is
// overwritten.  Returns the buffer that holds d(hin) (t.dim[0] rows).
template <int L, int FM, typename Act>
__device__ float* mlp_bwd(const K1T<Act>& p, const MlpTab& t, const float* w, const float* wT,
                          const float* zs, float* g, float* g2) {
  const float c = rnd<Act>(SILU_C);
  for (int li = t.n - 1; li >= 0; --li) {
    const int din = t.dim[li], dout = t.dim[li + 1];
    const float scale = rnd<Act>(t.scale[li]);
    if (li < t.n - 1) {
      const float* z = zs + (size_t)li * t.maxw * L;
      for (int q = threadIdx.x; q < dout * ET; q += NT) {
        const int row = q / ET, n = q % ET;
        g[row * L + n] *= dsilu(z[row * L + n]) * c;
      }
      __syncthreads();
    }
    if (dout == 1) {  // outer product with the width-1 layer's weights
      const float* wl = w + wofs_f<FM>(t.off[li]);
      for (int q = threadIdx.x; q < din * ET; q += NT) {
        const int k = q / ET, n = q % ET;
        g2[k * L + n] = wcol<FM>(wl, k) * g[n] * scale;
      }
    } else {
      prod_f<FM>(wT + wofs_f<FM>(t.off[li]), dout, din, g, L, g2, L, scale, ET, ring_of(p),
                 p.ring);
    }
    __syncthreads();
    float* tmp = g;
    g = g2;
    g2 = tmp;
  }
  return g;
}

// EMBED prologue on one tile: x = MLP2b(in) * u into xs (ns rows).  The
// caller has issued the load of us (visible after the first barrier here).
// The input rows go to ins (t.dim[0] rows, the padding rows zeroed), hidden
// activations ping-pong through hA / hB; with zs the pre-activations are
// kept there and x0 (before * u) in x0s.
template <int L, typename Act>
__device__ void embed_x(const K1T<Act>& p, const MlpTab& t, int e0, int ne, const float* us,
                        float* xs, float* ins, float* hA, float* hB, float* zs, float* x0s) {
  load_in<L>(p, p.in, p.n_in, e0, ne, ins);
  for (int q = threadIdx.x; q < (t.dim[0] - p.n_in) * ET; q += NT)
    ins[(p.n_in + q / ET) * L + q % ET] = 0.f;
  tiles_ready();
  float* x0 = x0s ? x0s : xs;
  if (p.pro_exact)
    mlp_fwd<L, EXACT<Act>>(p, t, p.ew, ins, hA, hB, zs, x0);
  else
    mlp_fwd<L, BODY<Act>>(p, t, p.ew, ins, hA, hB, zs, x0);
  for (int q = threadIdx.x; q < p.ns * ET; q += NT) {
    const int s = q / ET, n = q % ET;
    xs[s * L + n] = x0[s * L + n] * us[n];
  }
  __syncthreads();
}

// env[d*C + c] = inv_avg * sum over the center's edges of wz[c] * Y[d];
// xs (ns rows), Ys, us and wz (C rows) are scratch tiles (EMBED: the
// prologue's scratch starts at wz).
template <int F, int L, typename Act>
__device__ void center_env(const K1T<Act>& p, const MlpTab* mt, int center, float* env, float* xs,
                           float* Ys, float* us, float* wz) {
  const int C = p.C, D = p.D;
  for (int q = threadIdx.x; q < D * C; q += NT) env[q] = 0.f;
  for (int t0 = 0; t0 < p.K; t0 += ET) {
    const int e0 = center * p.K + t0, ne = min(ET, p.K - t0);
    load_in<L>(p, p.Y, D, e0, ne, Ys);
    load_in<L>(p, p.u, 1, e0, ne, us);
    if constexpr (F == EMBED) {
      float* ins = wz;
      float* hA = ins + mt[0].dim[0] * L;
      embed_x<L>(p, mt[0], e0, ne, us, xs, ins, hA, hA + mt[0].maxw * L, nullptr, nullptr);
    } else {
      load_act<F, L>(p, p.x, p.ns, e0, ne, xs);
      tiles_ready();
    }
    prod_f<BODY<Act>>(p.envw, p.ns, C, xs, L, wz, L, rnd<Act>(p.cns), ET, ring_of(p), p.ring);
    __syncthreads();
    // (d, c) = (q % D, q / D): a warp reads few distinct wz rows
    for (int q = threadIdx.x; q < D * C; q += NT) {
      const int d = q % D, c = q / D;
      float s = 0.f;
      for (int n = 0; n < ne; ++n) s = fmaf(wz[c * L + n] * us[n], Ys[d * L + n], s);
      env[d * C + c] += s;
    }
    __syncthreads();
  }
  for (int q = threadIdx.x; q < D * C; q += NT) env[q] *= p.inv_avg;
  __syncthreads();
}

// V0 = pT * Y on one tile
template <int L, typename Act>
__device__ void build_v0(const K1T<Act>& p, const float* pTs, const float* Ys, float* Vs) {
  for (int q = threadIdx.x; q < p.D * p.C * ET; q += NT) {
    const int row = q / ET, n = q % ET;
    Vs[row * LDV + n] = pTs[(row % p.C) * L + n] * Ys[(row / p.C) * L + n];
  }
}

// x (into cat rows [0, ns)), Y, u and V (built from pT when first_v); EMBED
// makes x and pT in the prologue, with its scratch at scr.
template <int F, int L, typename Act>
__device__ void load_edges(const K1T<Act>& p, const MlpTab* mt, int e0, int ne, float* cat,
                           float* Ys, float* us, float* Vs, float* pTs, float* scr) {
  const int C = p.C, D = p.D;
  load_in<L>(p, p.Y, D, e0, ne, Ys);
  load_in<L>(p, p.u, 1, e0, ne, us);
  if constexpr (F == EMBED) {
    float* hA = scr + mt[0].dim[0] * L;
    embed_x<L>(p, mt[0], e0, ne, us, cat, scr, hA, hA + mt[0].maxw * L, nullptr, nullptr);
    if (p.pro_exact)
      prod_f<EXACT<Act>>(p.te, p.ns, C, cat, L, pTs, L, rnd<Act>(p.cns), ET, ring_of(p), p.ring);
    else
      prod_f<BODY<Act>>(p.te, p.ns, C, cat, L, pTs, L, rnd<Act>(p.cns), ET, ring_of(p), p.ring);
    __syncthreads();
    build_v0<L>(p, pTs, Ys, Vs);
  } else {
    load_act<F, L>(p, p.x, p.ns, e0, ne, cat);
    if (p.first_v) {
      load_act<F, L>(p, p.V, C, e0, ne, pTs);
      tiles_ready();
      build_v0<L>(p, pTs, Ys, Vs);
    } else {
      load_act<F>(p, p.V, D * C, e0, ne, Vs, LDV);
    }
  }
  tiles_ready();
}

// latent MLP forward on one tile: input cat (in0 rows), hidden activations
// ping-pong through hA/hB; pre-activations saved into zs when given; the
// output (ns rows) goes to out.
template <int L, typename Act>
__device__ void latent_fwd(const K1T<Act>& p, const Meta& m, const float* cat, float* hA, float* hB,
                           float* zs, float* out) {
  const float* hin = cat;
  for (int li = 0; li < p.nlat; ++li) {
    const int din = m.latdim[li], dout = m.latdim[li + 1];
    const bool hidden = li < p.nlat - 1;
    float* h = (li & 1) ? hB : hA;
    float* z = !hidden ? out : (zs ? zs + (size_t)li * p.maxw * L : h);
    prod_f<BODY<Act>>(p.lat + wofs_f<BODY<Act>>(m.latoff[li]), din, dout, hin, L, z, L,
                      rnd<Act>(1.0f / sqrtf((float)din)), ET, ring_of(p), p.ring);
    __syncthreads();
    if (hidden) {
      const float c = rnd<Act>(SILU_C);
      for (int q = threadIdx.x; q < dout * ET; q += NT) {
        const int row = q / ET, n = q % ET;
        h[row * L + n] = silu(z[row * L + n]) * c;
      }
      __syncthreads();
      hin = h;
    }
  }
}

// x' = (x + xn * u) / sqrt(2) in place of x (cat rows [0, ns))
template <int L, typename Act>
__device__ void residual_in_place(const K1T<Act>& p, float* cat, const float* xn, const float* us) {
  for (int q = threadIdx.x; q < p.ns * ET; q += NT) {
    const int s = q / ET, n = q % ET;
    cat[s * L + n] = (cat[s * L + n] + xn[s * L + n] * us[n]) * rnd<Act>(R2);
  }
  __syncthreads();
}

// READOUT forward epilogue on one tile: x' in place of x, then each head's
// row head(x') * u to device memory.  Scratch: two ping-pong buffers of
// xmaxw rows and one output row per head (xn may lie there: the residual
// consumes it first).
template <int L, typename Act>
__device__ void heads_fwd(const K1T<Act>& p, const MlpTab* mt, float* cat, const float* xn,
                          const float* us, int e0, int ne, float* scr) {
  residual_in_place<L>(p, cat, xn, us);
  float* hA = scr;
  float* hB = hA + p.xmaxw * L;
  for (int h = 0; h < p.nhead; ++h) {
    float* raw = hB + (p.xmaxw + h) * L;
    mlp_fwd<L, EXACT<Act>>(p, mt[h], p.ew, cat, hA, hB, nullptr, raw);
    Act* out = h ? p.ho1 : p.ho0;
    for (int n = threadIdx.x; n < ne; n += NT) st_act(out + e0 + n, raw[n] * us[n]);
  }
}

// READOUT backward epilogue on one tile, after the latent forward: x' in
// place of x; for each head its forward (pre-activations kept), then its
// backward from the cotangent row c: dxo = sum over heads of
// d(c * head(x') * u)/dx', and dus = sum over heads of c * head(x').
// Scratch: two ping-pong buffers of max(xmaxw, ns) rows, the heads'
// pre-activations (hzrows) and two rows.
template <int L, typename Act>
__device__ void heads_bwd(const K1T<Act>& p, const MlpTab* mt, float* cat, const float* xn,
                          const float* us, int e0, int ne, float* dxo, float* dus, float* scr) {
  const int hg = imax(p.xmaxw, p.ns);
  float* P0 = scr;
  float* P1 = P0 + hg * L;
  float* hz = P1 + hg * L;
  float* raw = hz + p.hzrows * L;
  float* cot = raw + L;
  residual_in_place<L>(p, cat, xn, us);
  for (int n = threadIdx.x; n < ET; n += NT) dus[n] = 0.f;
  for (int h = 0; h < p.nhead; ++h) {
    mlp_fwd<L, EXACT<Act>>(p, mt[h], p.ew, cat, P0, P1, hz, raw);
    load_in<L>(p, h ? p.dh1 : p.dh0, 1, e0, ne, cot);
    tiles_ready();
    for (int n = threadIdx.x; n < ET; n += NT) {
      dus[n] = fmaf(cot[n], raw[n], dus[n]);
      P0[n] = cot[n] * us[n];
    }
    __syncthreads();
    const float* g = mlp_bwd<L, EXACT<Act>>(p, mt[h], p.ew, p.ewT, hz, P0, P1);
    for (int q = threadIdx.x; q < p.ns * ET; q += NT) {
      const int s = q / ET, n = q % ET;
      dxo[s * L + n] = (h ? dxo[s * L + n] : 0.f) + g[s * L + n];
    }
    __syncthreads();
  }
}

// EMBED backward prologue on one tile, after the env backward: the whole
// dx = the pass-1 partial (f32 scratch) + dxa; du = its partial + sum_s dx
// * x0, stored once; and d(in) = the two-body MLP's backward of dx * u,
// its real n_in rows.
template <int L, typename Act>
__device__ void embed_bwd(const K1T<Act>& p, const MlpTab& t, int e0, int ne, const float* us,
                          float* dxa, const float* x0s, const float* tbz, float* gA, float* gB) {
  const float* dxp = dx_part<EMBED>(p);
  const float* dup = du_part<EMBED>(p);
  for (int q = threadIdx.x; q < p.ns * ET; q += NT) {
    const int s = q / ET, n = q % ET;
    const float v = n < ne ? dxp[(size_t)s * p.E + e0 + n] + dxa[s * L + n] : 0.f;
    dxa[s * L + n] = v;
    gA[s * L + n] = v * us[n];
  }
  __syncthreads();
  for (int n = threadIdx.x; n < ne; n += NT) {
    float s = 0.f;
    for (int q = 0; q < p.ns; ++q) s = fmaf(dxa[q * L + n], x0s[q * L + n], s);
    st_act(p.du + e0 + n, dup[e0 + n] + s);
  }
  const float* g = p.pro_exact ? mlp_bwd<L, EXACT<Act>>(p, t, p.ew, p.ewT, tbz, gA, gB)
                               : mlp_bwd<L, BODY<Act>>(p, t, p.ew, p.ewT, tbz, gA, gB);
  for (int q = threadIdx.x; q < p.n_in * ET; q += NT) {
    const int row = q / ET, n = q % ET;
    if (n < ne) st_act(p.din + (size_t)row * p.E + e0 + n, g[row * L + n]);
  }
}

template <typename Act>
__device__ void load_tables(const K1T<Act>& p) {
  extern __shared__ float sm[];
  for (int q = threadIdx.x; q < 2 * MT_WORDS; q += NT)
    reinterpret_cast<int*>(sm + p.o_mt)[q] = __ldg(p.mt + q);
}

// One layer's forward for the block's center (blockIdx.x), the tables
// already in shared memory (m, and mt for EMBED / READOUT).
template <int F, int L, typename Act>
__device__ __forceinline__ void layer_fwd(const K1T<Act>& p, const Meta& m, const MlpTab* mt) {
  extern __shared__ float sm[];
  const int center = blockIdx.x;
  float* env = sm + p.o_env;
  float* cat = sm + p.o_cat;
  float* Vs = sm + p.o_V;
  float* pTs = sm + p.o_pT;
  float* Ys = sm + p.o_Y;
  float* us = sm + p.o_u;
  float* R = sm + p.o_R;
  float* ring = ring_of(p);

  center_env<F, L>(p, mt, center, env, cat, Ys, us, R);
  const int nrows = p.last ? 1 : p.D;
  // latent ping-pong; the output lands in the buffer the last layer does not read
  float* hA = R;
  float* hB = R + imax(p.maxw, p.ns) * L;
  float* xn = ((p.nlat - 1) & 1) ? hB : hA;
  for (int t0 = 0; t0 < p.K; t0 += ET) {
    const int e0 = center * p.K + t0, ne = min(ET, p.K - t0);
    load_edges<F, L>(p, mt, e0, ne, cat, Ys, us, Vs, pTs, R);
    for (int r = 0; r < nrows; ++r) {
      const int kd = m.rowP[r] * p.C;
      // the mix block loads while the TP runs
      if (!p.last && !resident_f<BODY<Act>>(m, r, kd, p.Cout, p.ring))
        stage_f<BODY<Act>>(p.mix + wofs_f<BODY<Act>>(m.rowmix[r]), kd, p.Cout, ring, p.ring);
      float* T = r == 0 ? cat + p.ns * L : R;  // row 0 is inv (p-major)
      tp_row_reg(p.C, m, r, Vs, env, T, L);
      __syncthreads();
      if (!p.last) {
        prod_f<BODY<Act>>(p.mix + wofs_f<BODY<Act>>(m.rowmix[r]), kd, p.Cout, T, L,
                          p.vo + (size_t)r * p.Cout * p.E + e0, p.E, m.rownorm[r], ne, ring,
                          p.ring, true);
        __syncthreads();
      }
    }
    latent_fwd<L>(p, m, cat, hA, hB, nullptr, xn);
    if constexpr (F == READOUT) {
      heads_fwd<L>(p, mt, cat, xn, us, e0, ne, R);
    } else {
      for (int q = threadIdx.x; q < p.ns * ET; q += NT) {
        const int s = q / ET, n = q % ET;
        if (n < ne)
          st_act(p.xo + (size_t)s * p.E + e0 + n,
                 (cat[s * L + n] + xn[s * L + n] * us[n]) * rnd<Act>(R2));
      }
    }
    __syncthreads();
  }
}

// One layer's backward for the block's center, the tables already in
// shared memory.
template <int F, int L, typename Act>
__device__ __forceinline__ void layer_bwd(const K1T<Act>& p, const Meta& m, const MlpTab* mt) {
  extern __shared__ float sm[];
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
  float* ring = ring_of(p);
  int* perm = reinterpret_cast<int*>(sm + p.o_perm);
  // phase-1 scratch: latent forward + backward
  const int gw = max(p.in0, p.maxw);
  float* dxo = R;
  float* xn = dxo + ns * L;
  float* zs = xn + ns * L;
  float* gA = zs + (p.nlat - 1) * p.maxw * L;
  float* gB = gA + gw * L;
  // phase-2 scratch (aliases phase 1): TP / mix backward
  float* dVs = R;
  float* dT = dVs + D * C * LDV;
  float* dVo = dT + p.maxpc * L;
  const float r2 = rnd<Act>(R2), silu_c = rnd<Act>(SILU_C);

  build_jperm(m, D, perm);
  center_env<F, L>(p, mt, center, env, cat, Ys, us, R);
  for (int q = threadIdx.x; q < D * C; q += NT) denv[q] = 0.f;
  const int nrows = p.last ? 1 : D;
  // row r's dV' tile and mixT block, loaded ahead of its product
  auto issue_row = [&](int r, int e0, int ne) {
    load_act<F, L>(p, p.dvo + (size_t)r * p.Cout * E, p.Cout, e0, ne, dVo);
    const int kd = m.rowP[r] * C;
    if (!resident_f<BODY<Act>>(m, r, p.Cout, kd, p.ring))
      stage_f<BODY<Act>>(p.mixT + wofs_f<BODY<Act>>(m.rowmix[r]), p.Cout, kd, ring, p.ring);
  };

  // pass 1: latent forward + backward, TP/mix backward, denv accumulation
  for (int t0 = 0; t0 < p.K; t0 += ET) {
    const int e0 = center * p.K + t0, ne = min(ET, p.K - t0);
    load_edges<F, L>(p, mt, e0, ne, cat, Ys, us, Vs, pTs, R);
    if constexpr (F != READOUT) load_act<F, L>(p, p.dxo, ns, e0, ne, dxo);
    tp_row_reg(C, m, 0, Vs, env, cat + ns * L, L);
    tiles_ready();
    latent_fwd<L>(p, m, cat, gA, gB, zs, xn);
    // READOUT: dxo (and the heads' share of du) from the heads' backward
    if constexpr (F == READOUT) heads_bwd<L>(p, mt, cat, xn, us, e0, ne, dxo, dus, gA);
    for (int n = threadIdx.x; n < ET; n += NT) {
      float s = 0.f;
      for (int q = 0; q < ns; ++q) s = fmaf(dxo[q * L + n], xn[q * L + n], s);
      dus[n] = F == READOUT ? fmaf(s, r2, dus[n]) : s * r2;
    }
    for (int q = threadIdx.x; q < ns * ET; q += NT) {
      const int s = q / ET, n = q % ET;
      gA[s * L + n] = dxo[s * L + n] * us[n] * r2;
    }
    __syncthreads();
    float* g = gA;
    float* g2 = gB;
    for (int li = p.nlat - 1; li >= 0; --li) {
      const int din = m.latdim[li], dout = m.latdim[li + 1];
      if (li < p.nlat - 1) {
        const float* z = zs + (size_t)li * p.maxw * L;
        for (int q = threadIdx.x; q < dout * ET; q += NT) {
          const int row = q / ET, n = q % ET;
          g[row * L + n] *= dsilu(z[row * L + n]) * silu_c;
        }
        __syncthreads();
      }
      prod_f<BODY<Act>>(p.latT + wofs_f<BODY<Act>>(m.latoff[li]), dout, din, g, L, g2, L,
                        rnd<Act>(1.0f / sqrtf((float)din)), ET, ring, p.ring);
      __syncthreads();
      float* tmp = g;
      g = g2;
      g2 = tmp;
    }
    // g = dcat (in0 rows).  The dx and du partials go to device memory (for
    // EMBED its f32 scratch) and are completed in pass 2 by this same
    // block; dinv moves into the dead inv rows of cat so that phase 2 may
    // reuse the scratch.
    auto* dxp = dx_part<F>(p);
    auto* dup = du_part<F>(p);
    for (int q = threadIdx.x; q < ns * ET; q += NT) {
      const int s = q / ET, n = q % ET;
      if (n < ne) st_act(dxp + (size_t)s * E + e0 + n, dxo[s * L + n] * r2 + g[s * L + n]);
    }
    for (int n = threadIdx.x; n < ne; n += NT)
      st_act(dup + e0 + n, F == STACK && p.acc ? ld_act(dup + e0 + n) + dus[n] : dus[n]);
    for (int q = threadIdx.x; q < (p.in0 - ns) * ET; q += NT) {
      const int row = ns + q / ET, n = q % ET;
      cat[row * L + n] = g[row * L + n];
    }
    __syncthreads();
    const float* dinv = cat + ns * L;
    for (int q = threadIdx.x; q < D * C * ET; q += NT) dVs[(q / ET) * LDV + q % ET] = 0.f;
    if (!p.last) issue_row(0, e0, ne);
    __syncthreads();
    for (int r = 0; r < nrows; ++r) {
      const float* dTr = dinv;
      if (!p.last) {
        tiles_ready();
        prod_f<BODY<Act>>(p.mixT + wofs_f<BODY<Act>>(m.rowmix[r]), p.Cout, m.rowP[r] * C, dVo, L,
                          dT, L, m.rownorm[r], ET, ring, p.ring, true);
        __syncthreads();
        if (r + 1 < nrows) issue_row(r + 1, e0, ne);  // loads while this row's TP runs
        if (r == 0) {
          for (int q = threadIdx.x; q < m.rowP[0] * C * ET; q += NT)
            dT[(q / ET) * L + q % ET] += dinv[(q / ET) * L + q % ET];
          __syncthreads();
        }
        dTr = dT;
      }
      tp_row_bwd(C, m, perm, r, dTr, L, Vs, env, dVs, denv);
      __syncthreads();
    }
    if constexpr (F == EMBED) {
      // dpT = sum_d dV0[d] * Y (into the dead dT rows), dY = sum_c dV0[d] *
      // pT, then the tensor embed's share of dx, W_te dpT / sqrt(ns) (in the
      // dT rows after dpT), joins the partial
      float* dp = dT;
      float* dxe = dT + C * L;
      for (int q = threadIdx.x; q < C * ET; q += NT) {
        const int cc = q / ET, n = q % ET;
        float s = 0.f;
        for (int d = 0; d < D; ++d) s = fmaf(dVs[(d * C + cc) * LDV + n], Ys[d * L + n], s);
        dp[cc * L + n] = s;
      }
      for (int q = threadIdx.x; q < D * ET; q += NT) {
        const int d = q / ET, n = q % ET;
        float s = 0.f;
        for (int cc = 0; cc < C; ++cc) s = fmaf(dVs[(d * C + cc) * LDV + n], pTs[cc * L + n], s);
        if (n < ne) st_act(p.dY + (size_t)d * E + e0 + n, s);
      }
      __syncthreads();
      if (p.pro_exact)
        prod_f<EXACT<Act>>(p.teT, C, ns, dp, L, dxe, L, rnd<Act>(p.cns), ET, ring, p.ring);
      else
        prod_f<BODY<Act>>(p.teT, C, ns, dp, L, dxe, L, rnd<Act>(p.cns), ET, ring, p.ring);
      __syncthreads();
      for (int q = threadIdx.x; q < ns * ET; q += NT) {
        const int s = q / ET, n = q % ET;
        if (n < ne) dxp[(size_t)s * E + e0 + n] += dxe[s * L + n];
      }
    } else if (p.first_v) {
      for (int q = threadIdx.x; q < C * ET; q += NT) {  // dpT = sum_d dV0[d] * Y[d]
        const int cc = q / ET, n = q % ET;
        float s = 0.f;
        for (int d = 0; d < D; ++d) s = fmaf(dVs[(d * C + cc) * LDV + n], Ys[d * L + n], s);
        if (n < ne) st_act(p.dV + (size_t)cc * E + e0 + n, s);
      }
      for (int q = threadIdx.x; q < D * ET; q += NT) {  // dY = sum_c dV0[d] * pT
        const int d = q / ET, n = q % ET;
        float s = 0.f;
        for (int cc = 0; cc < C; ++cc) s = fmaf(dVs[(d * C + cc) * LDV + n], pTs[cc * L + n], s);
        if (F == STACK && p.acc && n < ne) s += ld_act(p.dY + (size_t)d * E + e0 + n);
        if (n < ne) st_act(p.dY + (size_t)d * E + e0 + n, s);
      }
    } else {
      for (int q = threadIdx.x; q < D * C * ET; q += NT) {
        const int row = q / ET, n = q % ET;
        if (n < ne) st_act(p.dV + (size_t)row * E + e0 + n, dVs[row * LDV + n]);
      }
      for (int q = threadIdx.x; !(F == STACK && p.acc) && q < D * ET; q += NT) {
        const int d = q / ET, n = q % ET;
        if (n < ne) st_act(p.dY + (size_t)d * E + e0 + n, 0.f);
      }
    }
    __syncthreads();
  }

  // pass 2: env backward with the complete per-center denv
  for (int q = threadIdx.x; q < D * C; q += NT) denv[q] *= p.inv_avg;  // = dA
  __syncthreads();
  float* wz0 = R;
  float* dwz = R + C * L;
  float* dxa = dwz + C * L;
  // EMBED: x0, the two-body pre-activations, the input tile and two
  // ping-pong buffers for the prologue's recompute and backward
  const int nin = (p.n_in + 3) / 4 * 4;
  float* x0s = dxa + ns * L;
  float* tbz = x0s + ns * L;
  float* ins = tbz + p.hzrows * L;
  float* tA = ins + nin * L;
  float* tB = tA + imax(imax(p.xmaxw, ns), nin) * L;
  for (int t0 = 0; t0 < p.K; t0 += ET) {
    const int e0 = center * p.K + t0, ne = min(ET, p.K - t0);
    load_in<L>(p, p.Y, D, e0, ne, Ys);
    load_in<L>(p, p.u, 1, e0, ne, us);
    if constexpr (F == EMBED) {
      embed_x<L>(p, mt[0], e0, ne, us, cat, ins, tA, tB, tbz, x0s);
    } else {
      load_act<F, L>(p, p.x, ns, e0, ne, cat);
      tiles_ready();
    }
    prod_f<BODY<Act>>(p.envw, ns, C, cat, L, wz0, L, rnd<Act>(p.cns), ET, ring, p.ring);
    for (int q = threadIdx.x; q < C * ET; q += NT) {
      const int cc = q / ET, n = q % ET;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(denv[d * C + cc], Ys[d * L + n], s);
      dwz[cc * L + n] = s;
    }
    __syncthreads();
    for (int q = threadIdx.x; q < D * ET; q += NT) {
      const int d = q / ET, n = q % ET;
      float s = 0.f;
      for (int cc = 0; cc < C; ++cc) s = fmaf(denv[d * C + cc], wz0[cc * L + n], s);
      if (n < ne) {
        Act* q = p.dY + (size_t)d * E + e0 + n;
        st_act(q, ld_act(q) + s * us[n]);
      }
    }
    for (int n = threadIdx.x; n < ne; n += NT) {
      float s = 0.f;
      for (int cc = 0; cc < C; ++cc) s = fmaf(dwz[cc * L + n], wz0[cc * L + n], s);
      auto* dq = du_part<F>(p) + e0 + n;
      st_act(dq, ld_act(dq) + s);
    }
    __syncthreads();
    for (int q = threadIdx.x; q < C * ET; q += NT) {
      const int cc = q / ET, n = q % ET;
      dwz[cc * L + n] *= us[n];
    }
    __syncthreads();
    prod_f<BODY<Act>>(p.envwT, C, ns, dwz, L, dxa, L, rnd<Act>(p.cns), ET, ring, p.ring);
    __syncthreads();
    if constexpr (F == EMBED) {
      embed_bwd<L>(p, mt[0], e0, ne, us, dxa, x0s, tbz, tA, tB);
    } else {
      for (int q = threadIdx.x; q < ns * ET; q += NT) {
        const int s = q / ET, n = q % ET;
        if (n < ne) {
          Act* q = p.dx + (size_t)s * E + e0 + n;
          st_act(q, ld_act(q) + dxa[s * L + n]);
        }
      }
    }
    __syncthreads();
  }
}

template <int F, int L, typename Act>
__global__ void __launch_bounds__(NT, 2) k1_fwd_kernel(const __grid_constant__ K1T<Act> p) {
  extern __shared__ float sm[];
  if constexpr (F != PLAIN) load_tables(p);
  load_meta(p.meta, reinterpret_cast<int*>(sm));
  layer_fwd<F, L>(p, *reinterpret_cast<const Meta*>(sm),
                  reinterpret_cast<const MlpTab*>(sm + p.o_mt));
}

template <int F, int L, typename Act>
__global__ void __launch_bounds__(NT, 1) k1_bwd_kernel(const __grid_constant__ K1T<Act> p) {
  extern __shared__ float sm[];
  if constexpr (F != PLAIN) load_tables(p);
  load_meta(p.meta, reinterpret_cast<int*>(sm));
  layer_bwd<F, L>(p, *reinterpret_cast<const Meta*>(sm),
                  reinterpret_cast<const MlpTab*>(sm + p.o_mt));
}

// The K1 fields of K1P from the launchers' arrays.
// ptrs: x, V, Y, u, envw, envwT, lat, latT, mix, mixT, dxo, dvo, meta,
//       xo, vo, dx, dV, dY, du  (unused ones may be 0)
// dims: ns, C, Cout, D, K, E, nlat, first_v, last, maxw, maxpc, in0
template <typename Act>
void k1_params(K1T<Act>& p, const unsigned long long* ptrs, const int* dims, float inv_avg) {
  p.x = (const Act*)ptrs[0];
  p.V = (const Act*)ptrs[1];
  p.Y = (const Act*)ptrs[2];
  p.u = (const Act*)ptrs[3];
  p.envw = (const float*)ptrs[4];
  p.envwT = (const float*)ptrs[5];
  p.lat = (const float*)ptrs[6];
  p.latT = (const float*)ptrs[7];
  p.mix = (const float*)ptrs[8];
  p.mixT = (const float*)ptrs[9];
  p.dxo = (const Act*)ptrs[10];
  p.dvo = (const Act*)ptrs[11];
  p.meta = (const int*)ptrs[12];
  p.xo = (Act*)ptrs[13];
  p.vo = (Act*)ptrs[14];
  p.dx = (Act*)ptrs[15];
  p.dV = (Act*)ptrs[16];
  p.dY = (Act*)ptrs[17];
  p.du = (Act*)ptrs[18];
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
}

bool aligned16(const void* q) { return ((uintptr_t)q & 15) == 0; }

// Whether the tiles of p load as 16-byte cp.async (every row start and
// tile start 16-byte aligned), and whether the weights the products stage
// are 16-byte aligned (the wrappers' layouts always are).
template <typename Act>
bool tiles_vec(const K1T<Act>& p) {
  const void* act[] = {p.x, p.V, p.Y, p.u, p.dxo, p.dvo, p.in, p.dh0, p.dh1};
  bool ok = p.E % 4 == 0 && p.K % 4 == 0;
  for (const void* q : act) ok = ok && aligned16(q);
  return ok;
}

template <typename Act>
bool weights_aligned(const K1T<Act>& p) {
  const void* w[] = {p.envw, p.envwT, p.lat, p.latT, p.mix, p.mixT, p.te, p.teT, p.ew, p.ewT};
  bool ok = true;
  for (const void* q : w) ok = ok && aligned16(q);
  return ok;
}

// Shared memory of a form: checks the widths and lays out the block's
// shared memory (the sums ops/fused_layer.py, ops/embed_layer.py,
// ops/readout_layer.py and ops/fused_stack.py mirror in kernel_takes) into
// p's offsets: the product tiles at stride LDS_WIDE with the ring, or where
// that does not fit at LDS_MIN with the ring, or at LDS_MIN without one
// (allegro_mma.cuh).  Every region starts on 16 bytes (cp.async).  Returns
// the block's bytes, or a negative code for a shape the kernel does not
// take.
template <int F, typename Act>
int layer_layout(int bwd, K1T<Act>& p) {
  p.cns = 1.0f / sqrtf((float)p.ns);
  if (p.D > MAX_D || p.nlat < 1 || p.nlat > MAX_LAT) return -1;
  if (NT % p.C || NT / p.C > ET) return -2;  // C a multiple of 8: the TP's cells
  if (p.K < 1 || p.E % p.K) return -3;
  if (p.ns % 4 || p.C % 4 || p.Cout % 4 || p.in0 % 4 || p.maxw % 4) return -4;
  if (!p.last && p.Cout != p.C) return -5;
  if (F == EMBED && (!p.first_v || p.last)) return -7;
  if (F == READOUT && (p.first_v || !p.last || p.nhead < 1 || p.nhead > 2)) return -7;
  constexpr bool MLPS = F == EMBED || F == READOUT;  // forms with MlpTab tables
  if (MLPS && p.xmaxw % 4) return -4;

  int rows = p.C;  // center_env scratch (rows of R at the tile stride)
  if (bwd) {
    const int gw = imax(p.in0, p.maxw);
    rows = imax(rows, 2 * p.ns + (p.nlat - 1) * p.maxw + 2 * gw);  // latent fwd + bwd
    rows = imax(rows, 2 * p.C + p.ns);                               // env backward
  } else {
    rows = imax(rows, imax(p.maxpc, 2 * imax(p.maxw, p.ns)));  // T; latent ping-pong
  }
  if constexpr (F == EMBED) {
    const int nin = (p.n_in + 3) / 4 * 4;
    rows = imax(rows, nin + 2 * p.xmaxw);  // the prologue in center_env / load_edges
    if (bwd) {
      const int gwt = imax(imax(p.xmaxw, p.ns), nin);
      rows = imax(rows, 2 * p.C + 2 * p.ns + p.hzrows + nin + 2 * gwt);
    }
  }
  if constexpr (F == READOUT) {
    if (bwd)
      rows = imax(rows, 2 * p.ns + (p.nlat - 1) * p.maxw + 2 * imax(p.xmaxw, p.ns) + p.hzrows + 2);
    else
      rows = imax(rows, 2 * p.xmaxw + 2);
  }
  const int strides[2] = {LDS_WIDE, LDS_MIN};
  for (const int L : strides) {
    int off = 0;
    auto take = [&](int words) {
      const int o = off;
      off += (words + 3) & ~3;
      return o;
    };
    take(META_WORDS);
    p.o_p = take(F == STACK ? P_WORDS : 0);
    p.o_perm = take(bwd ? MAX_ENT : 0);
    p.o_mt = take(MLPS ? 2 * MT_WORDS : 0);
    p.o_env = take(p.D * p.C);
    p.o_denv = take(bwd ? p.D * p.C : 0);
    p.o_cat = take(p.in0 * L);
    p.o_V = take(p.D * p.C * LDV);
    p.o_pT = take(p.first_v ? p.C * L : 0);
    p.o_Y = take(p.D * L);
    p.o_u = take(L);
    p.o_du = take(bwd ? L : 0);
    int r_words = rows * L;
    // TP / mix backward: dV (D*C rows at LDV), dT, dV' (EMBED then dpT and
    // its share of dx in dT's rows)
    if (bwd)
      r_words = imax(r_words, p.D * p.C * LDV +
                                  ((F == EMBED ? imax(p.maxpc, p.C + p.ns) : p.maxpc) + p.Cout) * L);
    // the ring: its cap, or what is left when less (not below RING_MIN);
    // at LDS_MIN none if even that does not fit
    const int left = ((int)(SMEM_MAX / 4) - off - r_words) & ~7;
    p.lds = L;
    p.ring = left >= RING_MIN ? min(bwd ? RING_BWD : RING_FWD, left) : 0;
    if (p.ring == 0 && (L == LDS_WIDE || left < 0)) continue;
    p.o_ring = take(p.ring);
    p.o_R = take(0);
    return (off + r_words) * 4;
  }
  return -6;
}

// Lays out and launches a form, one block per center, built for the tile
// stride the layout chose.  Returns 0, a negative code for a shape the
// kernel does not take (-9: a weight not 16-byte aligned), or the
// cudaError_t of the launch.
template <int F, typename Act>
int layer_launch(int bwd, K1T<Act>& p, void* stream) {
  const int bytes = layer_layout<F>(bwd, p);
  if (bytes < 0) return bytes;
  if (!weights_aligned(p)) return -9;
  p.vec = tiles_vec(p);
  const bool wide = p.lds == LDS_WIDE;
  void (*kernel)(const K1T<Act>) =
      bwd ? (wide ? k1_bwd_kernel<F, LDS_WIDE, Act> : k1_bwd_kernel<F, LDS_MIN, Act>)
          : (wide ? k1_fwd_kernel<F, LDS_WIDE, Act> : k1_fwd_kernel<F, LDS_MIN, Act>);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<p.E / p.K, NT, (size_t)bytes, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace
