// K3 with a bf16 hj in bf16x3: nequip_conv.cu built at K3_HJ bf16 (the
// PAT_NEQUIP_HJ=bf16 boundary, as nequip_conv_bf16.cu) with the radial MLP's
// products in the bf16x3 form (K3_MMA BF16X3, as nequip_conv_bf16x3.cu).
// The radial activations are f32 on that tier too, so the TPU kernels'
// pallas_nequip.py _kprec of their dtype gives them the policy's
// Precision.HIGH under kernel_high and high (ops/prec.py).
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see ops/nequip_conv.py).

#define K3_HJ __nv_bfloat16
#define K3_MMA BF16X3
#include "nequip_conv.cu"
