// K6 and K7: the embed-fused first and the readout-fused last Allegro layer
// as hand-written Hopper kernel pairs (f32; embed_readout_layer_bf16.cu
// builds this file on bf16 activations).
//
// Replace the TPU kernels pair_allegro_tpu/ops/pallas_stack.py
// _layer1e_fwd_kernel / _layer1e_bwd_kernel (entry
// allegro_layer_embed_fused_t) and _layer1r_fwd_kernel /
// _layer1r_bwd_kernel (entry allegro_layer_readout_fused_t):
//   K6 = K1's first_v form whose x and pT come from a prologue: per tile
//        x = MLP2b(in) * u from the (2T + B, E) two-body input rows and
//        pT = W_te^T x / sqrt(ns), so neither exists in device memory;
//        returns x' (ns, E) and V' (D, C, E), and the backward d(in), dY
//        and du;
//   K7 = K1's last form with the readout (and charge) head as epilogue:
//        only the rows e = MLP_ro(x') * u (and q = MLP_q(x') * u), (1, E)
//        each, leave it; the backward takes de (and dq) and returns dx,
//        dV, dY and du.
// Weight cotangents are not computed: the wrappers hand them back NaN.
//
// What bounds them on an H100: operations, as K1 (fused_layer.cu), with
// the products on the tensor cores.  The
// prologue adds 2*(n_in*w + w*w + w*ns) + 2*ns*C flops per edge slot and
// pass (~21k at the flagship, w = 64, against K1's ~1.2e5 forward), the
// epilogue ~2*ns*32 per head.
//
// Design (the body is K1's, allegro_layer.cuh, templated on the form):
//  * x in every pass.  K1 reads x once for the per-center env sum, again in
//    the main pass, and the backward a third time for the env backward.
//    K6 recomputes x from the input rows in each pass instead of keeping
//    the center's x0 in shared memory (ns*K*4 B: 16 KB at K = 64, 24 KB
//    after a regrow to K = 96, growing with K): the recompute costs the
//    prologue's flops once more per pass, and the block's shared memory
//    stays independent of K, as K1's is.
//  * the backward knows the whole dx only in pass 2, after the env
//    backward (it needs the complete per-center denv).  Pass 1 writes its
//    partial, the tensor embed's W_te dpT / sqrt(ns) included, and du's to
//    an f32 device scratch (ns + 1, E) (where K1 writes its dx and du
//    outputs), so that at bf16 du rounds once, at its last store; pass 2
//    completes them, adds sum_s dx * x0 to du and runs the two-body MLP's
//    backward on dx * u to d(in).
//  * the two-body input width 2T + B (10 at the flagship) need not be a
//    multiple of 4, which the products' 16-byte weight staging needs: the
//    wrapper pads the first weight with zero rows (its transpose with zero
//    columns) to a multiple of 4, the input tile's padding rows are zeroed,
//    and d(in) writes only the real rows.
//  * the heads' last layer (32 -> 1) is a weighted row sum forward and an
//    outer product backward, as the TPU kernel runs it
//    (pallas_stack.py:446-488), on the CUDA cores; every other layer of the
//    MLPs runs on the tensor cores as K1's products do.
//  * the MLPs' shapes (MlpTab) are copied into shared memory beside the 3j
//    table; the epilogue's and the prologue's scratch alias rows of the
//    layer's scratch that are dead at that point, so at the flagship K6
//    and K7 take at most 2.2 KB more shared memory than K1 and their
//    forwards still fit two blocks on an SM (kernel_takes beside the
//    wrappers mirrors the sums).
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see ops/embed_layer.py).

#include "allegro_layer.cuh"

// the activations' storage type: f32 here; embed_readout_layer_bf16.cu
// builds this file at __nv_bfloat16
#ifndef K1_ACT
#define K1_ACT float
#endif

extern "C" {

// words of the Meta table and of one MlpTab (checked by the wrappers)
int er_meta_words() { return META_WORDS; }
int er_mt_words() { return MT_WORDS; }

// The shared-memory bytes of a launch of form at these dims (er_launch's),
// or the negative refusal code: the sum ops/fused_layer.py's block_bytes
// mirrors.
int er_layout_bytes(int form, int bwd, const int* dims) {
  K1T<K1_ACT> p{};
  const unsigned long long none[19] = {};
  k1_params(p, none, dims, 1.0f);
  p.n_in = dims[12];
  p.xmaxw = dims[13];
  p.hzrows = dims[14];
  p.nhead = dims[15];
  if (form == EMBED) return layer_layout<EMBED>(bwd, p);
  if (form == READOUT) return layer_layout<READOUT>(bwd, p);
  return -8;
}

// form 1 (K6) or 2 (K7).
// ptrs: K1's 19 (k1_params), then in, te, teT, din, mt, ew, ewT, dh0, dh1,
//       ho0, ho1, part  (unused ones may be 0; the activations' at K1_ACT,
//       the weights f32 or, at bf16, pair-packed; part f32)
// dims: K1's 12, then n_in, xmaxw, hzrows, nhead, pro_exact (K6: the
//       prologue's products 3xTF32 on f32 weights, PAT_EMBED_PREC=highest)
// Returns 0, a negative code for a shape the kernel does not take, or the
// cudaError_t of the launch.
int er_launch(int form, int bwd, const unsigned long long* ptrs, const int* dims, float inv_avg,
              void* stream) {
  using Act = K1_ACT;
  K1T<Act> p{};
  k1_params(p, ptrs, dims, inv_avg);
  p.in = (const Act*)ptrs[19];
  p.te = (const float*)ptrs[20];
  p.teT = (const float*)ptrs[21];
  p.din = (Act*)ptrs[22];
  p.mt = (const int*)ptrs[23];
  p.ew = (const float*)ptrs[24];
  p.ewT = (const float*)ptrs[25];
  p.dh0 = (const Act*)ptrs[26];
  p.dh1 = (const Act*)ptrs[27];
  p.ho0 = (Act*)ptrs[28];
  p.ho1 = (Act*)ptrs[29];
  p.part = (float*)ptrs[30];
  p.n_in = dims[12];
  p.xmaxw = dims[13];
  p.hzrows = dims[14];
  p.nhead = dims[15];
  p.pro_exact = dims[16];
  if (form == EMBED) return layer_launch<EMBED>(bwd, p, stream);
  if (form == READOUT) return layer_launch<READOUT>(bwd, p, stream);
  return -8;
}

}  // extern "C"
