// K8 on bf16 operands: the fused-stack kernel pair of fused_stack.cu, built
// with bf16 activations for the interior="bf16" tier with fused_stack=True.
// The TPU kernels pallas_stack.py _stack_fwd_kernel / _stack_bwd_kernel run
// on bf16 operands there (models/allegro.py casts x, pT, Y and u): each dot
// one MXU pass with f32 accumulation (pallas_stack.py _mm), every layer's x
// and V bf16 arrays.
//
// x0, pT, Y, u and dx_final come in as bf16 and x_final, dx0, dpT, dY and
// du leave as bf16.  Each layer's body is K1's bf16 build (fused_layer_bf16.cu):
// f32 tiles in shared memory, the TP, env sums and elementwise work in f32
// registers, every product one mma.sync.m16n8k16 bf16 pass with f32
// accumulation on pair-packed weights.  The device-memory stores between
// the layers are bf16, so x and V round to bf16 at every layer boundary,
// as the reference's per-layer arrays do: the forward's x / V store, the
// backward's stash of each layer's input x and V (half the f32 build's
// bytes; the backward reads exactly the values its recompute rounded) and
// the carried dx and dV.  dY and du add up across the layers at bf16.
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see ops/fused_stack.py).

#define K1_ACT __nv_bfloat16
#include "fused_stack.cu"
