// K2 in bf16x3 on f32 operands: the per-layer env-fused TP + mix kernel pair
// of env_layer.cu, built with the mix and its transpose in the bf16x3 form
// (allegro_mma.cuh BF16X3) for the matmul precision policies kernel_high
// (the default) and high (ops/prec.py).  There the TPU kernels
// pallas_stack.py _env_layer_fwd_kernel / _env_layer_bwd_kernel run each f32
// dot as pallas_stack.py _mm writes Precision.HIGH: both operands split
// hi + lo in bf16, hi*hi + hi*lo + lo*hi in f32.
//
// Activations, tiles, the TP and the env sums are f32 as in the 3xTF32
// build (the env sums f32 under every policy); each mix product runs three
// mma.sync.m16n8k16 bf16 passes a k-step of 16 on weights the wrapper lays
// out as interleaved hi / lo pair-packed rows (ops/fused_layer.pack_x3, the
// f32 layout's bytes), B split as its fragments load.
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see ops/env_layer.py).

#define MIX_MMA BF16X3
#include "env_layer.cu"
