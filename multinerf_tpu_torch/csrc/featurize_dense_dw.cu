// Weight gradient of the fused featurize -> Dense layer for Hopper (sm_90a):
//   dW[F, W] = bf16(IPE(contract(means, covs)))^T [F, N] @ bf16(g) [N, W]
// with f32 accumulation over all N samples.
//
// Replaces the TPU kernel multinerf_tpu/ops/pallas/featurize_dense.py
// (_dw_kernel, reached through pallas_call in _grad_w): it recomputes the
// features per sample tile, as the forward does, so they never reach device
// memory, and rounds the cotangent to bf16 first (featurize_dense.py:217).
//
// What bounds it: at the 360 config (N = 131,072 samples of one 4,096-ray
// batch, F = 504, W = 1,024) the product is 2 * N * 512 * 1024 = 137 GFLOP
// against reading g once (0.5 GB f32), so the tensor cores bound it; the
// features cost a few hundred f32 operations per sample and are recomputed
// once per 64-column slab (16 times at W = 1,024).  Design: the split-K
// partials + ordered reduce of dw_accumulate.cuh, with A = the features
// (bm = 512 rows, bn = 64 columns per block, P sample splits chosen by the
// caller to fill one wave).  Deterministic: no atomics.  No TMA/wgmma
// pipeline yet.

#include <cuda_runtime.h>

#include "dw_accumulate.cuh"

extern "C" int featurize_dense_dw(const void* means, const void* covs,
                                  const void* basis_t, const void* bb_t,
                                  const void* g, void* part, void* out, int n,
                                  int width, int num_dims, int num_degs,
                                  int use_contract, int bm, int bn,
                                  int num_splits, void* stream) {
  using namespace mnt;
  return (int)weight_gradient<true, float>(
      static_cast<const float*>(means), static_cast<const float*>(covs),
      static_cast<const float*>(basis_t), static_cast<const float*>(bb_t),
      num_dims, num_degs, use_contract, nullptr, 0,
      static_cast<const float*>(g), n, width, 2 * num_degs * num_dims, bm, bn,
      num_splits, static_cast<float*>(part), static_cast<float*>(out),
      static_cast<cudaStream_t>(stream));
}
