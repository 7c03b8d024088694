// K2 on bf16 operands: the per-layer env-fused TP + mix kernel pair of
// env_layer.cu, built with bf16 activations for the interior="bf16" tier
// (the TPU kernels pallas_stack.py _env_layer_fwd_kernel /
// _env_layer_bwd_kernel run on bf16 operands there: each dot one MXU pass
// with f32 accumulation, pallas_stack.py _mm).
//
// V, wz, Y, dV' and dinv come in as bf16 and V', inv, dV, dwz, dY leave as
// bf16 (rounded to nearest); the tiles are f32 in shared memory, so the TP,
// the env and denv sums and the invariants run in f32 registers.  The mix
// and its transpose run one mma.sync.m16n8k16 bf16 pass with f32
// accumulation on pair-packed weights (ops/fused_layer.pack_pairs) staged
// through the cp.async ring in half the bytes (allegro_mma.cuh prod).
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see ops/env_layer.py).

#define K2_ACT __nv_bfloat16
#include "env_layer.cu"
