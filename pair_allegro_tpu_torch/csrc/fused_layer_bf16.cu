// K1 on bf16 operands: the one-layer fused Allegro kernel pair of
// fused_layer.cu, built with bf16 activations for the interior="bf16" tier
// (the TPU kernels pallas_stack.py _layer1_fwd_kernel / _layer1_bwd_kernel
// run on bf16 operands there: each dot one MXU pass with f32 accumulation,
// pallas_stack.py _mm).
//
// x, V (or pT), Y, u and the cotangents dx', dV' come in as bf16 and the
// outputs x', V', dx, dV (dpT), dY, du leave as bf16 (rounded to nearest);
// in shared memory the tiles are f32, so the TP, the per-center env and
// denv sums, the SiLU and the residual run in f32 registers, as before.
// Every product (wz, the mix, the latent MLP and their backward) runs one
// mma.sync.m16n8k16 bf16 pass with f32 accumulation, its B tile rounded to
// bf16 pairs as the fragments load and its weights pair-packed bf16 words
// (the wrapper's layout, ops/fused_layer.pack_pairs) staged through the
// same cp.async ring in half the bytes.  The backward's dx and du partials
// of pass 1 are bf16 in device memory, as the TPU kernel's bf16 sums are.
// The tiles load synchronously (a bf16 pair a load), not by cp.async: the
// conversion happens on the way.
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see ops/fused_layer.py).

#define K1_ACT __nv_bfloat16
#include "fused_layer.cu"
