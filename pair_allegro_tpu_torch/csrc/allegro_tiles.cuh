// Pieces shared by the Allegro layer kernels K1 (fused_layer.cu), K2
// (env_layer.cu) and K4 (tp_mix_fused.cu), and through K1's body
// (allegro_layer.cuh) by K6, K7 and K8: the launch constants and the 3j
// row table the wrappers build, copied into shared memory at block start.
// The tiles, products and TP rows they run on are in allegro_mma.cuh.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int ET = 32;   // edges per tile (K4 also takes 16 and 8)
constexpr int NT = 256;  // threads per block
constexpr int MAX_ENT = 512;
constexpr int MAX_D = 16;
constexpr int MAX_LAT = 8;
constexpr int SMEM_MAX = 232448;
// shared memory a block may use where two share an H100 SM (233,472 bytes
// an SM, 1 KB reserved per block)
constexpr int SHARE2 = 233472 / 2 - 1024;

// Tables built by the wrapper (the numpy structured dtype of
// ops/fused_layer.py) and copied into shared memory at block start; K2
// and K4 leave the latent fields unused.
struct Meta {
  int n_ent;
  int ent[MAX_ENT];  // p | i << 8 | j << 16, sorted by output row
  float w[MAX_ENT];
  int rowstart[MAX_D + 1];
  int rowP[MAX_D];     // paths feeding the row's l3
  int rowmix[MAX_D];   // float offset of the row's l3 block in mix / mixT
  float rownorm[MAX_D];
  int latdim[MAX_LAT + 1];
  int latoff[MAX_LAT];
};
constexpr int META_WORDS = sizeof(Meta) / 4;

__device__ void load_meta(const int* __restrict__ meta, int* s_meta) {
  for (int q = threadIdx.x; q < META_WORDS; q += NT) s_meta[q] = __ldg(meta + q);
  __syncthreads();
}

}  // namespace
