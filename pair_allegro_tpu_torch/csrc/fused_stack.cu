// K8: the whole Allegro layer stack as one hand-written Hopper kernel pair
// (f32; fused_stack_bf16.cu builds this file on bf16 activations).
//
// Replaces the TPU kernels pair_allegro_tpu/ops/pallas_stack.py
// _stack_fwd_kernel / _stack_bwd_kernel (through _stack_call and the
// custom VJP _stack; entry allegro_stack_apply).  On the feature-major
// (rows, E) layout of the TABLE edge list (each center's K edges
// contiguous) the forward takes x0 (ns, E), pT (C, E), Y (D, E) and u
// (1, E), builds V0 = pT * Y and runs every layer
//   wz  = (Wenv^T x) / sqrt(ns) * u;  env = per-center sum wz (x) Y / sqrt(avg_n)
//   T   = channelwise TP of V with env;  V' = per-l3 mix of T;  inv = T[l3=0]
//   x'  = (x + MLP([x; inv]) * u) / sqrt(2)
// in one launch, writing only x_final (ns, E).  The backward takes
// dx_final and returns dx0, dpT, dY and du in one launch.  Weight
// cotangents are not computed: the wrapper hands them back NaN-filled, as
// the TPU kernel's VJP does.
//
// What bounds it on an H100: operations, as K1 (fused_layer.cu): per edge
// slot and layer ~1.2e5 flops forward, 95% of them in small products that
// run on the tensor cores, against ~0.7 KB of the stack's own inputs and
// output per edge slot (x0, pT, Y, u in, x_final out).
//
// Design:
//  * one thread block per center, as K1, looping over the layers; each
//    layer is K1's body (allegro_layer.cuh, form STACK) with that layer's
//    parameters: the env sum over the center's tiles of ET = 32 edges, then
//    per tile the TP, the mix (not in the last layer, whose V' is dead),
//    inv, the latent MLP and the residual.  The TPU kernel's center-aligned
//    512-lane blocks, its S indicator matmul and its K padding to 32 are
//    not carried over;
//  * a layer's per-tile phase reads and writes only its own tile of x and
//    V, so the center's x and V live in one device-memory store that each
//    layer overwrites in place: x in the output rows, V in a (D*C, E)
//    scratch the wrapper allocates.  A K = 64 center's V is 73.7 KB, which
//    does not fit in shared memory beside K1's tiles; only the resident
//    blocks' slices are live at a time (~90 KB a center, ~12 MB for one
//    block on each of the 132 SMs), so the store can stay in the 50 MB L2.
//    Tiles written by the same kernel come in by cp.async.cg, which reads
//    L2 only, never through the read-only cache (which could hold them
//    stale);
//  * the backward follows the TPU kernel's schedule
//    (pallas_stack.py:572-651): per center it recomputes layers 0 .. L-2,
//    stashing each layer's input x and V in device memory ((L-1)*(ns +
//    D*C) floats per edge slot; wz is recomputed from x by K1's backward,
//    so it is not stashed), then runs K1's backward for each layer in
//    reverse with dx and dV carried in place (dV' = 0 for the last layer),
//    dY and du adding up across the layers, and V0's backward (dpT =
//    sum_d dV[d] * Y[d], dY[d] += sum_c dV[d, c] * pT[c]) inside the first
//    layer's, as K1's first form has it;
//  * the per-layer parameters sit in one __grid_constant__ kernel argument;
//    each layer's are copied once into a shared slot at its start, so the
//    body reads them there, not by a dynamic index into the argument;
//  * the products run on the tensor cores in 3xTF32 with their weights
//    staged by cp.async, as K1 (allegro_mma.cuh).
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see ops/fused_stack.py).

#include "allegro_layer.cuh"

// the activations' storage type: f32 here; fused_stack_bf16.cu builds this
// file at __nv_bfloat16
#ifndef K1_ACT
#define K1_ACT float
#endif

namespace {

constexpr int MAX_LAYERS = 8;
using Act = K1_ACT;
using KP = K1T<Act>;

struct K8P {
  KP layer[MAX_LAYERS];
  int L;
};
static_assert(sizeof(K8P) <= 4096, "K8's kernel argument exceeds 4 KB");
static_assert(sizeof(KP) <= 4 * P_WORDS, "a layer's parameters exceed their shared slot");

// Copies layer l's parameters into their shared slot, where the body reads
// them for the whole layer (after the barrier).
__device__ const KP& layer_params(const K8P& p, int l) {
  extern __shared__ float sm[];
  KP* lp = reinterpret_cast<KP*>(sm + p.layer[0].o_p);
  const int* src = reinterpret_cast<const int*>(&p.layer[l]);
  for (int q = threadIdx.x; q < (int)(sizeof(KP) / 4); q += NT) reinterpret_cast<int*>(lp)[q] = src[q];
  __syncthreads();
  return *lp;
}

template <int S>  // the tile stride
__global__ void __launch_bounds__(NT, 2) k8_fwd_kernel(const __grid_constant__ K8P p) {
  extern __shared__ float sm[];
  load_meta(p.layer[0].meta, reinterpret_cast<int*>(sm));
  const Meta& m = *reinterpret_cast<const Meta*>(sm);
  for (int l = 0; l < p.L; ++l) {
    layer_fwd<STACK, S>(layer_params(p, l), m, nullptr);
    __syncthreads();
  }
}

template <int S>
__global__ void __launch_bounds__(NT, 1) k8_bwd_kernel(const __grid_constant__ K8P p) {
  extern __shared__ float sm[];
  load_meta(p.layer[0].meta, reinterpret_cast<int*>(sm));
  const Meta& m = *reinterpret_cast<const Meta*>(sm);
  for (int l = 0; l < p.L - 1; ++l) {  // recompute, stashing each layer's input
    layer_fwd<STACK, S>(layer_params(p, l), m, nullptr);
    __syncthreads();
  }
  for (int l = p.L - 1; l >= 0; --l) {
    layer_bwd<STACK, S>(layer_params(p, l), m, nullptr);
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// words of the Meta table and the most layers (checked by the wrapper)
int k8_meta_words() { return META_WORDS; }
int k8_max_layers() { return MAX_LAYERS; }

// The shared-memory bytes of a launch at these dims (k8_launch's: every
// layer shares K1's first-form layout), or the negative refusal code: the
// sum ops/fused_layer.py's block_bytes mirrors.
int k8_layout_bytes(int bwd, const int* dims) {
  KP p{};
  const unsigned long long none[19] = {};
  k1_params(p, none, dims, 1.0f);
  p.first_v = 1;
  p.last = 0;
  return layer_layout<STACK>(bwd, p);
}

// ptrs: Y, u, meta, x0, pT, xo, xs, vs, dxo, dx, dvc, dpT, dY, du, then per
//       layer envw, envwT, lat, latT, mix, mixT  (unused ones may be 0; the
//       activations, the stores and the stash at K1_ACT, the weights f32
//       or, at bf16, pair-packed)
//   forward:  x0, pT -> xo (also the x store); vs the (D*C, E) V store
//   backward: x0, pT, dxo -> dx, dpT, dY, du; xs ((L-1)*ns, E) and vs
//             ((L-1)*D*C, E) the stash, dvc the (D*C, E) carried dV
// dims: K1's 12 (k1_params; first_v and last are set per layer), then L
// Returns 0, a negative code for a shape the kernel does not take (-8: L
// outside 1 .. MAX_LAYERS; -9 a weight not 16-byte aligned; the others as
// layer_layout), or the cudaError_t of the launch.
int k8_launch(int bwd, const unsigned long long* ptrs, const int* dims, float inv_avg,
              void* stream) {
  const int L = dims[12];
  if (L < 1 || L > MAX_LAYERS) return -8;
  KP base{};
  const unsigned long long k1[19] = {0, 0, ptrs[0], ptrs[1], 0, 0, 0, 0, 0, 0,
                                     0, 0, ptrs[2], 0, 0, 0, 0, 0, 0};
  k1_params(base, k1, dims, inv_avg);
  base.first_v = 1;  // the layout with the pT tile serves every layer
  base.last = 0;
  const int bytes = layer_layout<STACK>(bwd, base);
  if (bytes < 0) return bytes;

  auto f = [&](int i) { return reinterpret_cast<Act*>(ptrs[i]); };
  const Act *x0 = f(3), *pT = f(4), *dxo = f(8);
  Act *xo = f(5), *xs = f(6), *vs = f(7), *dx = f(9), *dvc = f(10);
  const size_t xrows = (size_t)base.ns * base.E, vrows = (size_t)base.D * base.C * base.E;
  K8P kp{};
  kp.L = L;
  for (int l = 0; l < L; ++l) {
    KP& q = kp.layer[l];
    q = base;
    const unsigned long long* w = ptrs + 14 + 6 * l;
    q.envw = (const float*)w[0];
    q.envwT = (const float*)w[1];
    q.lat = (const float*)w[2];
    q.latT = (const float*)w[3];
    q.mix = (const float*)w[4];
    q.mixT = (const float*)w[5];
    q.first_v = l == 0;
    q.last = l == L - 1;
    if (!bwd) {
      q.x = l == 0 ? x0 : xo;
      q.V = l == 0 ? pT : vs;
      q.xo = xo;
      q.vo = q.last ? nullptr : vs;
    } else {
      q.x = l == 0 ? x0 : xs + (l - 1) * xrows;
      q.V = l == 0 ? pT : vs + (l - 1) * vrows;
      q.xo = q.last ? nullptr : xs + l * xrows;  // the recompute's stash
      q.vo = q.last ? nullptr : vs + l * vrows;
      q.dxo = q.last ? dxo : dx;
      q.dvo = q.last ? nullptr : dvc;
      q.dx = dx;
      q.dV = l == 0 ? f(11) : dvc;
      q.dY = f(12);
      q.du = f(13);
      q.acc = !q.last;
    }
    if (!weights_aligned(q)) return -9;
    q.vec = tiles_vec(q);
  }

  cudaStream_t st = (cudaStream_t)stream;
  const bool wide = base.lds == LDS_WIDE;  // the tile stride the layout chose
  void (*kernel)(const K8P) = bwd ? (wide ? k8_bwd_kernel<LDS_WIDE> : k8_bwd_kernel<LDS_MIN>)
                                  : (wide ? k8_fwd_kernel<LDS_WIDE> : k8_fwd_kernel<LDS_MIN>);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<base.E / base.K, NT, (size_t)bytes, st>>>(kp);
  return (int)cudaGetLastError();
}

}  // extern "C"
