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
//   1. featurize_cast_kernel computes each sample's 504 features once per
//      call (not once per column block of dW) and writes them as bf16 rows
//      of 512 (134 MB), and rounds g to bf16 once on its way to the GEMM
//      (268 MB);
//   2. the split-K TMA + wgmma GEMM of wgmma_dw.cuh: 128 x 256 blocks of
//      dW, 8 sample splits (16 blocks x 8 = 128 CTAs, one wave), then the
//      ordered reduce.  Deterministic: no atomics.

#include <cuda_runtime.h>

#include "wgmma_dw.cuh"

namespace mnt {

struct FeaturizeDenseDw;  // Names this kernel's dW GEMM in a profile.

__host__ __device__ inline int featurize_cast_smem(int kpad64, int num_dims) {
  return round_up(kTile * tile_stride(kpad64) * 2, 16) +
         featurizer_smem_floats(num_dims) * (int)sizeof(float);
}

// Rows row0 .. row0 + 63 of feats [n][kpad64] (bf16 features, zero from
// column F on) and of g16 [n][width] = bf16(g).
__global__ void __launch_bounds__(kThreads)
featurize_cast_kernel(const float* __restrict__ means,
                      const float* __restrict__ covs,
                      const float* __restrict__ basis_t,
                      const float* __restrict__ bb_t,
                      const float* __restrict__ g, int n, int width,
                      int num_dims, int num_degs, int use_contract,
                      int kpad64, __nv_bfloat16* __restrict__ feats,
                      __nv_bfloat16* __restrict__ g16) {
  extern __shared__ __align__(16) unsigned char fc_smem[];
  const int ld = tile_stride(kpad64);
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(fc_smem);
  float* scratch =
      reinterpret_cast<float*>(fc_smem + round_up(kTile * ld * 2, 16));
  const long long row0 = (long long)blockIdx.x * kTile;
  const int tid = threadIdx.x;
  featurize_rows<kTile>(
      means, covs, basis_t, bb_t, row0, n, num_dims, num_degs,
      use_contract != 0, scratch, tid, blockDim.x, kpad64,
      [=](int s, int f, __nv_bfloat16 v) { tile[s * ld + f] = v; },
      [] { __syncthreads(); });
  const int words = kpad64 / 8;
  for (int i = tid; i < kTile * words; i += blockDim.x) {
    const int s = i / words;
    const int c = (i - s * words) * 8;
    if (row0 + s < n)
      *reinterpret_cast<uint4*>(feats + (row0 + s) * kpad64 + c) =
          *reinterpret_cast<const uint4*>(tile + s * ld + c);
  }
  const int words_g = width / 8;
  for (int i = tid; i < kTile * words_g; i += blockDim.x) {
    const int s = i / words_g;
    const int c = (i - s * words_g) * 8;
    if (row0 + s < n)
      *reinterpret_cast<uint4*>(g16 + (row0 + s) * width + c) =
          load8_bf16(g + (row0 + s) * width + c);
  }
}

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
  const int smem = featurize_cast_smem(kpad64, num_dims);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      featurize_cast_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  __nv_bfloat16* feats_b = static_cast<__nv_bfloat16*>(feats);
  __nv_bfloat16* g16_b = static_cast<__nv_bfloat16*>(g16);
  featurize_cast_kernel<<<(n + kTile - 1) / kTile, kThreads, smem, st>>>(
      f32(means), f32(covs), f32(basis_t), f32(bb_t), f32(g), n, width,
      num_dims, num_degs, use_contract, kpad64, feats_b, g16_b);
  err = cudaGetLastError();
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
