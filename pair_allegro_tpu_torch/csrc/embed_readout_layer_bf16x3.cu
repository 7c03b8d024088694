// K6 and K7 in bf16x3 on f32 operands: the embed- and readout-fused Allegro kernel pairs of
// embed_readout_layer.cu,
// built with the layer body's products in the bf16x3 form (allegro_mma.cuh
// BF16X3) for the matmul precision policies kernel_high (the default) and
// high (ops/prec.py).  There the TPU kernels pallas_stack.py _layer1e_* and _layer1r_* kernels
// run each f32 dot as pallas_stack.py _mm writes Precision.HIGH: both
// operands split hi + lo in bf16, hi*hi + hi*lo + lo*hi in f32.
//
// Activations, tiles and every elementwise step are f32 as in the 3xTF32
// build; each product runs three mma.sync.m16n8k16 bf16 passes a k-step of
// 16 on weights the wrapper lays out as interleaved hi / lo pair-packed rows
// (ops/fused_layer.pack_x3, the f32 layout's bytes), B split as its
// fragments load.  The readout heads stay 3xTF32 (JAX's _mm_exact); K6's
// prologue follows PAT_EMBED_PREC (pro_exact).
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see ops/embed_layer.py).

#define K1_MMA BF16X3
#include "embed_readout_layer.cu"
