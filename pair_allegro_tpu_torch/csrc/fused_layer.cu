// K1: one whole Allegro layer as a hand-written Hopper kernel pair (f32;
// fused_layer_bf16.cu builds this file on bf16 activations).
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
// forward does ~1.2e5 flops against ~2.9 KB moved, and 95% of the flops are
// small matrix products (the per-l3 mix, 2*C*C*35, then the latent MLP and
// the env weights).  On the CUDA cores at f32 that is ~40 flops per byte,
// above the f32 ridge (67 TFLOP/s / 3.35 TB/s = 20); the products go to the
// tensor cores instead, at f32 accuracy (3xTF32: 495/3 TFLOP/s).
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
//  * every small product runs mma.sync m16n8k8 in 3xTF32 (each operand
//    split into two TF32 halves, three products summed in f32: f32
//    accuracy), rows = output features, columns = the tile's edges; its
//    weights come into a two-stage shared ring by cp.async, chunk c+1 in
//    flight while chunk c is consumed, and a mix l3 block stays there over
//    the rows of its l3 (a tile reads 45 KB of mix weights, not 143 KB);
//    a layer whose tiles leave no room for the ring takes a narrower tile
//    stride, and past that reads its weights without the ring, so every
//    width the FFMA body before it took is still taken;
//  * the TP runs on thread-owned (channel, edge) cells with each path's sum
//    in registers (one shared load of V per 3j entry); its backward sums
//    denv per run of equal j in registers and reduces it across the warp;
//    the 3j table (83 entries at l_max=2 with parity) and the row tables
//    sit in shared memory;
//  * the tiles come in by 16-byte cp.async; the forward's layout fits two
//    blocks on an SM at the flagship widths.
// The Meta table is in allegro_tiles.cuh; the products, the staging and the
// TP are in allegro_mma.cuh, both shared with K2 (env_layer.cu) and K4
// (tp_mix_fused.cu); the kernel body is in allegro_layer.cuh, shared with
// K6, K7 (embed_readout_layer.cu) and K8 (fused_stack.cu).
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see ops/fused_layer.py).

#include "allegro_layer.cuh"

// the activations' storage type: f32 here; fused_layer_bf16.cu builds this
// file at __nv_bfloat16
#ifndef K1_ACT
#define K1_ACT float
#endif

extern "C" {

// words of the Meta table the wrapper builds (checked by the wrapper)
int k1_meta_words() { return META_WORDS; }

// The shared-memory bytes of a launch at these dims (k1_launch's), or the
// negative refusal code: the sum ops/fused_layer.py's block_bytes mirrors.
int k1_layout_bytes(int bwd, const int* dims) {
  K1T<K1_ACT> p{};
  const unsigned long long none[19] = {};
  k1_params(p, none, dims, 1.0f);
  return layer_layout<PLAIN>(bwd, p);
}

// ptrs: x, V, Y, u, envw, envwT, lat, latT, mix, mixT, dxo, dvo, meta,
//       xo, vo, dx, dV, dY, du  (unused ones may be 0)
// dims: ns, C, Cout, D, K, E, nlat, first_v, last, maxw, maxpc, in0
// Returns 0, a negative code for a shape the kernel does not take, or the
// cudaError_t of the launch (layer_launch in allegro_layer.cuh).
int k1_launch(int bwd, const unsigned long long* ptrs, const int* dims, float inv_avg,
              void* stream) {
  K1T<K1_ACT> p{};
  k1_params(p, ptrs, dims, inv_avg);
  return layer_launch<PLAIN>(bwd, p, stream);
}

}  // extern "C"
