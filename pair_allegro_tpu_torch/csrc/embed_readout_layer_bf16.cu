// K6 and K7 on bf16 operands: the embed- and readout-fused Allegro kernel
// pairs of embed_readout_layer.cu, built with bf16 activations for the
// interior="bf16" tier's embed/readout form (PAT_L1_EMBED=1).  The TPU
// kernels pallas_stack.py _layer1e_fwd_kernel / _layer1e_bwd_kernel and
// _layer1r_fwd_kernel / _layer1r_bwd_kernel run on bf16 operands there
// (models/allegro.py casts in_T, Y and u): each dot one MXU pass with f32
// accumulation (pallas_stack.py _mm, _mm_embed), the weights cast to bf16
// (_latent_fwd), the heads' width-1 layer a row sum on those weights.
//
// in_T, Y, u, x, V and the heads' cotangents come in as bf16, and x', V',
// the head rows, d(in), dx, dV, dY and du leave as bf16 (rounded to
// nearest), as K1's bf16 build (fused_layer_bf16.cu) does: the tiles are
// f32 in shared memory, so the prologue's and epilogue's SiLU, the TP, the
// env sums and the residual run in f32 registers, and every product (the
// two-body MLP, the tensor embed, the layer's, the heads' hidden layers and
// their backward) runs one mma.sync.m16n8k16 bf16 pass with f32
// accumulation on weights the wrappers pair-pack (ops/fused_layer.pack_pairs;
// the MLP blocks at offsets of 8 floats, so each packed block starts on 16
// bytes).  K6's backward keeps its pass-1 partial of dx and du in device
// memory at bf16.
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see ops/embed_layer.py).

#define K1_ACT __nv_bfloat16
#include "embed_readout_layer.cu"
