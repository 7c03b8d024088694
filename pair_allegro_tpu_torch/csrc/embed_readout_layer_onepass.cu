// K6 and K7 in one bf16 pass on f32 operands: the embed- and readout-fused Allegro kernel pairs of
// embed_readout_layer.cu,
// built with the layer body's products in the one-pass form (allegro_mma.cuh
// BF16P) for the matmul precision policy default (ops/prec.py).  There the
// TPU kernels pallas_stack.py _layer1e_* and _layer1r_* kernels run each
// f32 dot at Precision.DEFAULT: one bf16 MXU pass with f32 accumulation.
//
// Activations, tiles and every elementwise step are f32 as in the 3xTF32
// build; each product runs one mma.sync.m16n8k16 bf16 pass a k-step of 16 on
// weights the wrapper pair-packs (ops/fused_layer.pack_pairs, as the bf16
// build's), B rounded to bf16 pairs as its fragments load.  The readout
// heads stay 3xTF32 (JAX's _mm_exact); K6's prologue follows
// PAT_EMBED_PREC (pro_exact).
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see ops/embed_layer.py).

#define K1_MMA BF16P
#include "embed_readout_layer.cu"
