// K4 in bf16x3 on f32 operands: the per-edge TP + mix kernel pair of
// tp_mix_fused.cu, built with the mix and its transpose in the bf16x3 form
// (allegro_mma.cuh BF16X3) for the matmul precision policies kernel_high
// (the default) and high (ops/prec.py).  There the TPU kernels
// pallas_tp.py _fwd_kernel / _bwd_kernel run each f32 dot as pallas_tp.py
// _kdot writes Precision.HIGH: both operands split hi + lo in bf16,
// hi*hi + hi*lo + lo*hi in f32.
//
// V, env, the tiles and the TP are f32 as in the 3xTF32 build; each mix
// product runs three mma.sync.m16n8k16 bf16 passes a k-step of 16 on
// weights the wrapper lays out as interleaved hi / lo pair-packed rows
// (ops/fused_layer.pack_x3 of the tree's c-major leaves and of their
// transposes, the f32 layout's bytes), B split as its fragments load, at
// every edge tile (32, 16, 8).
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see ops/tp_mix_fused.py).

#define MIX_MMA BF16X3
#include "tp_mix_fused.cu"
