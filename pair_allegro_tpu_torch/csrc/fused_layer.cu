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
// shared with K2 (env_layer.cu) and K4; the kernel body is in
// allegro_layer.cuh, shared with K6 and K7 (embed_readout_layer.cu).
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see ops/fused_layer.py).

#include "allegro_layer.cuh"

extern "C" {

// words of the Meta table the wrapper builds (checked by the wrapper)
int k1_meta_words() { return META_WORDS; }

// ptrs: x, V, Y, u, envw, envwT, lat, latT, mix, mixT, dxo, dvo, meta,
//       xo, vo, dx, dV, dY, du  (unused ones may be 0)
// dims: ns, C, Cout, D, K, E, nlat, first_v, last, maxw, maxpc, in0
// Returns 0, a negative code for a shape the kernel does not take, or the
// cudaError_t of the launch (layer_launch in allegro_layer.cuh).
int k1_launch(int bwd, const unsigned long long* ptrs, const int* dims, float inv_avg,
              void* stream) {
  K1P p{};
  k1_params(p, ptrs, dims, inv_avg);
  return layer_launch<PLAIN>(bwd, p, stream);
}

}  // extern "C"
