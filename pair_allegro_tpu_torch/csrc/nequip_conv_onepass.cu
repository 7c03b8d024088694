// K3 in one bf16 pass: the fused NequIP convolution pair of nequip_conv.cu,
// built with the radial MLP's products in the one-pass form (K3_MMA BF16P)
// for the matmul precision policy default (ops/prec.py).  There the TPU
// kernels pallas_nequip.py _conv_fwd_kernel / _conv_bwd_kernel run each
// radial dot at Precision.DEFAULT: one bf16 MXU pass with f32 accumulation.
//
// hj, the tiles, the TP and the per-center sums are f32 as in the 3xTF32
// build; each radial product runs one m16n8k8 TF32 pass on operands rounded
// to bf16 (exact in TF32) as they load.
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see ops/nequip_conv.py).

#define K3_MMA BF16P
#include "nequip_conv.cu"
