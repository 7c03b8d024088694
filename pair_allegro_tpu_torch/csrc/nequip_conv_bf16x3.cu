// K3 in bf16x3: the fused NequIP convolution pair of nequip_conv.cu, built
// with the radial MLP's products in the bf16x3 form (K3_MMA BF16X3) for the
// matmul precision policies kernel_high (the default) and high
// (ops/prec.py).  There the TPU kernels pallas_nequip.py _conv_fwd_kernel /
// _conv_bwd_kernel run each radial dot as pallas_nequip.py _dot / _dot_t
// write Precision.HIGH: both operands split hi + lo in bf16, hi*hi + hi*lo
// + lo*hi in f32.
//
// hj, the tiles, the TP and the per-center sums are f32 as in the 3xTF32
// build; each radial product keeps the m16n8k8 TF32 fragments and its
// three passes, its operands split into bf16 hi and lo parts (exact in
// TF32) as they load.
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see ops/nequip_conv.py).

#define K3_MMA BF16X3
#include "nequip_conv.cu"
