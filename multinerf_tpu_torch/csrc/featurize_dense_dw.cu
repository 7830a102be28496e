// Weight gradient of the fused featurize -> Dense layer for Hopper (sm_90a):
//   dW[F, W] = bf16(IPE(contract(means, covs)))^T [F, N] @ bf16(g) [N, W]
// with f32 accumulation over all N samples.
//
// Replaces the TPU kernel multinerf_tpu/ops/pallas/featurize_dense.py
// (_dw_kernel, reached through pallas_call in _grad_w), with its numerics:
// the features as the forward computes them, the cotangent rounded to bf16
// first (featurize_dense.py:217).
//
// What bounds it: at the 360 config (N = 131,072 samples of one 4,096-ray
// batch, F = 504, W = 1,024) the product is 2 * N * 512 * 1024 = 137 GFLOP
// against reading g once (0.54 GB f32), so the bound is 0.16 ms of memory
// traffic against 0.14 ms of bf16 tensor-core time.  Design, in two stages:
//   1. featurize_cast_kernel (featurize_cast.cuh) computes each sample's
//      504 features once per call (not once per column block of dW) and
//      writes them as bf16 rows of 512 (134 MB), and rounds g to bf16 once
//      on its way to the GEMM (268 MB);
//   2. the split-K TMA + wgmma GEMM of wgmma_dw.cuh: 128 x 256 blocks of
//      dW, 8 sample splits (16 blocks x 8 = 128 CTAs, one wave), then the
//      ordered reduce.  Deterministic: no atomics.

#include <cuda_runtime.h>

#include "featurize_cast.cuh"

namespace mnt {

struct FeaturizeDenseDw;  // Names this kernel's dW GEMM in a profile.

}  // namespace mnt

// Scratch (allocated by the caller): feats bf16 [n][kpad64], g16 bf16
// [n][width], part f32 [splits][kpad64][width], kpad64 the feature count
// rounded up to 64.  Output: out f32 [F][width].  (bn, splits, per) is the
// GEMM's plan (plans.dw_gemm_plan).
extern "C" int featurize_dense_dw(const void* means, const void* covs,
                                  const void* basis_t, const void* bb_t,
                                  const void* g, void* feats, void* g16,
                                  void* part, void* out, int n, int width,
                                  int num_dims, int num_degs,
                                  int use_contract, int bn, int splits,
                                  int per, void* stream) {
  using namespace mnt;
  const int num_feats = 2 * num_degs * num_dims;
  const int kpad64 = round_up(num_feats, 64);
  if (n < 1 || width % 64 != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* feats_b = static_cast<__nv_bfloat16*>(feats);
  __nv_bfloat16* g16_b = static_cast<__nv_bfloat16*>(g16);
  const cudaError_t err = featurize_cast(
      static_cast<const float*>(means), static_cast<const float*>(covs),
      static_cast<const float*>(basis_t), static_cast<const float*>(bb_t),
      static_cast<const float*>(g), n, width, num_dims, num_degs,
      use_contract, kpad64, feats_b, g16_b, st);
  if (err != cudaSuccess) return (int)err;
  return (int)dw_gemm<FeaturizeDenseDw>(
      feats_b, g16_b, n, kpad64, width, num_feats, bn, splits, per,
      static_cast<float*>(part), static_cast<float*>(out), st);
}

// Dynamic shared memory of the two stages, for the launch plans' checks.
extern "C" int featurize_dense_dw_smem(int num_feats, int num_dims, int bn) {
  using namespace mnt;
  const int a = featurize_cast_smem(round_up(num_feats, 64), num_dims);
  const int b = dw_gemm_smem(bn);
  return a > b ? a : b;
}
