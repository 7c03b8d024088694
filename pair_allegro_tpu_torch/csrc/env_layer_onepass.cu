// K2 in one bf16 pass on f32 operands: the per-layer env-fused TP + mix
// kernel pair of env_layer.cu, built with the mix and its transpose in the
// one-pass form (allegro_mma.cuh BF16P) for the matmul precision policy
// default (ops/prec.py).  There the TPU kernels pallas_stack.py
// _env_layer_fwd_kernel / _env_layer_bwd_kernel run each f32 dot at
// Precision.DEFAULT: one bf16 MXU pass with f32 accumulation.
//
// Activations, tiles, the TP and the env sums are f32 as in the 3xTF32
// build; each mix product runs one mma.sync.m16n8k16 bf16 pass a k-step of
// 16 on weights the wrapper pair-packs (ops/fused_layer.pack_pairs, as the
// bf16 build's), B rounded to bf16 pairs as its fragments load.
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see ops/env_layer.py).

#define MIX_MMA BF16P
#include "env_layer.cu"
