// K3 with a bf16 hj: the fused NequIP convolution pair of nequip_conv.cu,
// built for the PAT_NEQUIP_HJ=bf16 tier, where the model gathers its node
// rows through a bf16 boundary (pair_allegro_tpu/models/nequip.py _hj_bf16;
// the TPU kernel pallas_nequip.py _conv_fwd_kernel upcasts hj in VMEM).
//
// The forward reads hj as bf16 pairs and upcasts them once in registers;
// the radial MLP, its 3xTF32 products, the TP and the per-center sums stay
// f32, as does agg.  The backward reads hj the same way and writes dhj at
// hj's type, bf16 (rounded to nearest), as JAX's custom VJP returns it;
// dbessel, du and dY stay f32.
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see ops/nequip_conv.py).

#define K3_HJ __nv_bfloat16
#include "nequip_conv.cu"
