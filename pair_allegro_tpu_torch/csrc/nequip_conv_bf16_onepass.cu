// K3 with a bf16 hj in one bf16 pass: nequip_conv.cu built at K3_HJ bf16
// (the PAT_NEQUIP_HJ=bf16 boundary, as nequip_conv_bf16.cu) with the radial
// MLP's products in the one-pass form (K3_MMA BF16P, as
// nequip_conv_onepass.cu), for the matmul precision policy default
// (ops/prec.py): the radial activations are f32 on that tier, so the TPU
// kernels' pallas_nequip.py _kprec gives them Precision.DEFAULT there.
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see ops/nequip_conv.py).

#define K3_HJ __nv_bfloat16
#define K3_MMA BF16P
#include "nequip_conv.cu"
