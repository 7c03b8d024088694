// K4: the per-edge TP + mix of an Allegro layer as a hand-written Hopper
// kernel pair (f32; tp_mix_fused_bf16x3.cu and tp_mix_fused_onepass.cu build
// this file with the mix in the matmul precision policy's other forms).
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
// What bounds it on an H100: bytes.  At l_max=2 with parity and C = Cout =
// 32 the forward does ~7.7e4 flops per edge (the mix, 2*C*Cout*35, is 93%
// of them) against ~3.8 KB moved, the backward ~8.2e4 against ~6.1 KB.
// With the mix on the tensor cores in 3xTF32 (495/3 TFLOP/s) and the TP on
// the CUDA cores (67 TFLOP/s), the operations' least time falls under the
// bytes'.
//
// Design (K2's, csrc/env_layer.cu, without the per-center aggregation, on
// the same pieces, allegro_mma.cuh):
//  * one thread block owns one tile of TW consecutive edges; edges are
//    independent, so blocks share nothing and nothing is atomic.  The tail
//    tile is masked, so E need not be a multiple of the tile;
//  * the tiles come in by 16-byte cp.async; one output row's TP and its mix
//    are done before the next row's;
//  * the TP keeps each path's sum in registers (tp_row_reg_edges), on
//    thread-owned (channel, edge) cells, and writes T's rows c-major, so the
//    mix reads the tree's c-major leaves as they are (the backward their
//    transposes) and T's first row is the invariants in scalar_part's
//    order; its backward (tp_row_bwd_edges)
//    keeps those cells in every row, so dV and denv accumulate in shared
//    memory without atomics or a barrier between rows, denv summed per run
//    of equal j in registers;
//  * the mix and its transpose run mma.sync m16n8k8 in 3xTF32 (f32
//    accuracy; the build's form, MIX_MMA in allegro_mma.cuh: bf16x3 or
//    one bf16 pass m16n8k16 in the policy's other builds, on the weights
//    the wrapper lays out for them) with the weights staged through a
//    two-stage cp.async ring while the row's TP runs, an l3 block kept in
//    the ring over its 2 l3 + 1 rows; the forward writes V' from the accumulators to device memory,
//    the backward loads row r+1's dV' tile and mixT block while row r's TP
//    runs;
//  * TW is 32, 16 or 8 (the product's 8 warps arranged to the tile's
//    columns, ps_of its row stride): the launcher takes the widest tile
//    whose block, with the ring, lets two blocks share an SM, else the
//    widest that fits with the ring, else 8 edges without the ring (at the
//    flagship widths the forward at 32 edges, the backward at 16), so every
//    width the FFMA K4 took (down to its 8-edge tile, l_max 3 at C = 64) is
//    still taken;
//  * the dead last layer's dV' arrives as zeros (autograd materialises the
//    unused output's cotangent) and is read as such.
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see ops/tp_mix_fused.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "allegro_mma.cuh"

namespace {

struct K4P {
  const float *V, *env, *mix, *mixT, *dout, *dinv;
  const int* meta;
  float *out, *inv, *dV, *denv;
  int C, Cout, D, E, maxpc, P0;
  // the edge tile, the weight ring (words, 0 for none), the region offsets,
  // and whether tiles load by 16-byte cp.async
  int tw, ring, o_ring, o_perm, o_V, o_env, o_dV, o_denv, o_T, o_dvo, vec;
};

template <int TW>
__global__ void __launch_bounds__(NT, 2) k4_fwd_kernel(const __grid_constant__ K4P p) {
  constexpr int PS = ps_of(TW);
  extern __shared__ float sm[];
  load_meta(p.meta, reinterpret_cast<int*>(sm));
  const Meta& m = *reinterpret_cast<const Meta*>(sm);
  const int C = p.C, D = p.D, E = p.E;
  const int e0 = blockIdx.x * TW, ne = min(TW, E - e0);
  float* Vs = sm + p.o_V;
  float* envs = sm + p.o_env;
  float* T = sm + p.o_T;
  float* ring = sm + p.o_ring;

  load_tile_async<true, TW>(p.V, D * C, E, e0, ne, Vs, TW, p.vec);
  load_tile_async<true, TW>(p.env, D * C, E, e0, ne, envs, TW, p.vec);
  tiles_ready();
  for (int r = 0; r < D; ++r) {
    const int kd = m.rowP[r] * C;
    // the mix block loads while the TP runs
    if (!resident<float>(m, r, kd, p.Cout, p.ring))
      stage<float>(p.mix + wofs<float>(m.rowmix[r]), kd, p.Cout, ring, p.ring);
    tp_row_reg_edges<TW>(C, m, r, Vs, envs, T, PS);
    __syncthreads();
    if (r == 0) {  // inv (E, C*P0): column c*P0 + pp is T's row
      const int cp0 = C * p.P0;
      for (int q = threadIdx.x; q < ne * cp0; q += NT) {
        const int n = q / cp0, col = q % cp0;
        p.inv[(size_t)(e0 + n) * cp0 + col] = T[col * PS + n];
      }
    }
    prod<float, TW>(p.mix + wofs<float>(m.rowmix[r]), kd, p.Cout, T, PS,
                    p.out + (size_t)r * p.Cout * E + e0, E, m.rownorm[r], ne, ring, p.ring, true);
    __syncthreads();
  }
}

template <int TW>
__global__ void __launch_bounds__(NT, 2) k4_bwd_kernel(const __grid_constant__ K4P p) {
  constexpr int PS = ps_of(TW);
  extern __shared__ float sm[];
  load_meta(p.meta, reinterpret_cast<int*>(sm));
  const Meta& m = *reinterpret_cast<const Meta*>(sm);
  const int C = p.C, D = p.D, E = p.E;
  const int e0 = blockIdx.x * TW, ne = min(TW, E - e0);
  float* Vs = sm + p.o_V;
  float* envs = sm + p.o_env;
  float* dVs = sm + p.o_dV;
  float* denvs = sm + p.o_denv;
  float* dT = sm + p.o_T;
  float* dVo = sm + p.o_dvo;
  float* ring = sm + p.o_ring;
  int* perm = reinterpret_cast<int*>(sm + p.o_perm);
  // row r's dV' tile and mixT block, loaded ahead of its product
  auto issue_row = [&](int r) {
    load_tile_async<true, TW>(p.dout + (size_t)r * p.Cout * E, p.Cout, E, e0, ne, dVo, PS, p.vec);
    const int kd = m.rowP[r] * C;
    if (!resident<float>(m, r, p.Cout, kd, p.ring))
      stage<float>(p.mixT + wofs<float>(m.rowmix[r]), p.Cout, kd, ring, p.ring);
  };

  build_jperm(m, D, perm);
  load_tile_async<true, TW>(p.V, D * C, E, e0, ne, Vs, TW, p.vec);
  load_tile_async<true, TW>(p.env, D * C, E, e0, ne, envs, TW, p.vec);
  for (int q = threadIdx.x; q < D * C * TW; q += NT) {
    dVs[q] = 0.f;
    denvs[q] = 0.f;
  }
  issue_row(0);
  for (int r = 0; r < D; ++r) {
    tiles_ready();
    prod<float, TW>(p.mixT + wofs<float>(m.rowmix[r]), p.Cout, m.rowP[r] * C, dVo, PS, dT, PS,
                    m.rownorm[r], TW, ring, p.ring, true);
    __syncthreads();
    if (r + 1 < D) issue_row(r + 1);  // loads while this row's TP runs
    if (r == 0) {  // + dinv, which arrives (E, C*P0): column c*P0 + pp is dT's row
      const int cp0 = C * p.P0;
      for (int q = threadIdx.x; q < ne * cp0; q += NT) {
        const int n = q / cp0, col = q % cp0;
        dT[col * PS + n] += __ldg(p.dinv + (size_t)(e0 + n) * cp0 + col);
      }
      __syncthreads();
    }
    tp_row_bwd_edges<TW>(C, m, perm, r, dT, PS, Vs, envs, dVs, denvs);
    __syncthreads();
  }
  for (int q = threadIdx.x; q < D * C * TW; q += NT) {
    const int row = q / TW, n = q % TW;
    if (n < ne) {
      p.dV[(size_t)row * E + e0 + n] = dVs[q];
      p.denv[(size_t)row * E + e0 + n] = denvs[q];
    }
  }
}

// Lays out one block at edge tile tw into p's offsets (the sum
// ops/tp_mix_fused.py's block_layout mirrors): the tables, the V and env
// tiles (and dV, denv) at row stride tw, T (and dV') at ps_of(tw), each
// region on 16 bytes, then the ring: its cap, or what is left under
// budget bytes when less, not below RING_MIN, or none when ring is false.
// Returns the block's bytes, or -6 if it does not fit the budget.
int layout(K4P& p, int tw, bool bwd, int budget, bool ring) {
  const int ps = ps_of(tw);
  int off = 0;
  auto take = [&](int words) {
    const int o = off;
    off += (words + 3) & ~3;
    return o;
  };
  take(META_WORDS);
  p.o_perm = take(bwd ? MAX_ENT : 0);
  p.o_V = take(p.D * p.C * tw);
  p.o_env = take(p.D * p.C * tw);
  p.o_dV = take(bwd ? p.D * p.C * tw : 0);
  p.o_denv = take(bwd ? p.D * p.C * tw : 0);
  p.o_T = take(p.maxpc * ps);
  p.o_dvo = take(bwd ? p.Cout * ps : 0);
  const int left = (budget / 4 - off) & ~7;
  p.tw = tw;
  p.ring = 0;
  if (ring) {
    if (left < RING_MIN) return -6;
    p.ring = min(bwd ? RING_BWD : RING_FWD, left);
  } else if (left < 0) {
    return -6;
  }
  p.o_ring = take(p.ring);
  return off * 4;
}

// The block of a launch: the widest tile (32, 16, 8) whose block with the
// ring lets two blocks share an SM, else the widest that fits with the
// ring, else 8 edges without it.  Returns its bytes, or -6.
int pick_tile(K4P& p, bool bwd) {
  const int budgets[2] = {SHARE2, SMEM_MAX};
  for (const int budget : budgets)
    for (int tw = 32; tw >= 8; tw /= 2) {
      const int b = layout(p, tw, bwd, budget, true);
      if (b > 0) return b;
    }
  return layout(p, 8, bwd, SMEM_MAX, false);
}

template <int TW>
int run(bool bwd, const K4P& p, int smem, cudaStream_t st) {
  const int blocks = (p.E + TW - 1) / TW;
  void (*kernel)(const K4P) = bwd ? k4_bwd_kernel<TW> : k4_fwd_kernel<TW>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, NT, (size_t)smem, st>>>(p);
  return (int)cudaGetLastError();
}

// dims: C, Cout, D, E, maxpc, P0.  Returns the block's bytes (pick_tile)
// or the negative code of a shape the kernel does not take.
int parse(K4P& p, const int* dims, bool bwd) {
  p.C = dims[0];
  p.Cout = dims[1];
  p.D = dims[2];
  p.E = dims[3];
  p.maxpc = dims[4];
  p.P0 = dims[5];
  if (p.D < 1 || p.D > MAX_D) return -1;
  if (p.E < 1) return -3;
  if (p.C < 4 || p.C % 4 || p.Cout < 4 || p.Cout % 4) return -4;  // 16-byte weight rows
  return pick_tile(p, bwd);
}

bool aligned16(const void* q) { return ((uintptr_t)q & 15) == 0; }

}  // namespace

extern "C" {

// words of the Meta table the wrapper builds (checked by the wrapper)
int k4_meta_words() { return META_WORDS; }

// The edge tile a launch with these dims takes (32, 16 or 8), or a
// negative code: -1 D, -3 E, -4 C or Cout, -6 shared memory.
int k4_tile(int bwd, const int* dims) {
  K4P p{};
  const int rc = parse(p, dims, bwd != 0);
  return rc < 0 ? rc : p.tw;
}

// The shared-memory bytes of that launch, or the negative code.
int k4_layout_bytes(int bwd, const int* dims) {
  K4P p{};
  return parse(p, dims, bwd != 0);
}

// The weight ring's words in that launch, or the negative code.
int k4_ring_words(int bwd, const int* dims) {
  K4P p{};
  const int rc = parse(p, dims, bwd != 0);
  return rc < 0 ? rc : p.ring;
}

// ptrs: V, env, mix, mixT, meta, dout, dinv, out, inv, dV, denv (unused
//       ones may be 0)
// dims: C, Cout, D, E, maxpc, P0
// Returns 0, a negative code for a shape the kernel does not take (see
// k4_tile; -9: a weight not 16-byte aligned), or the cudaError_t of the
// launch.
int k4_launch(int bwd, const unsigned long long* ptrs, const int* dims, void* stream) {
  K4P p{};
  const int smem = parse(p, dims, bwd != 0);
  if (smem < 0) return smem;
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
  if (!aligned16(p.mix) || !aligned16(p.mixT)) return -9;
  p.vec = p.E % 4 == 0 && aligned16(p.V) && aligned16(p.env) && (!bwd || aligned16(p.dout));
  cudaStream_t st = (cudaStream_t)stream;
  if (p.tw == 32) return run<32>(bwd != 0, p, smem, st);
  if (p.tw == 16) return run<16>(bwd != 0, p, smem, st);
  return run<8>(bwd != 0, p, smem, st);
}

}  // extern "C"
