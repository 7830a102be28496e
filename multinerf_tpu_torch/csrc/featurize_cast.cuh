// The featurize stage of the feature-row weight gradients, dW[F, W] =
// bf16(features)^T @ bf16(g), of K4 (featurize_dense_dw.cu) and K6
// (int8_trunk_bwd.cu, dW_0 and each skip layer's feature rows): each
// sample's features computed once per call and written as bf16 rows for
// wgmma_dw.cuh's GEMM, and (K4) the cotangent rounded to bf16 once on its
// way there.
#pragma once

#include "wgmma_dw.cuh"

namespace mnt {

__host__ __device__ inline int featurize_cast_smem(int kpad64, int num_dims) {
  return round_up(kTile * tile_stride(kpad64) * 2, 16) +
         featurizer_smem_floats(num_dims) * (int)sizeof(float);
}

// Rows row0 .. row0 + 63 of feats [n][kpad64] (bf16 features, zero from
// column F on) and, when g is given, of g16 [n][width] = bf16(g).
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
  if (g == nullptr) return;
  const int words_g = width / 8;
  for (int i = tid; i < kTile * words_g; i += blockDim.x) {
    const int s = i / words_g;
    const int c = (i - s * words_g) * 8;
    if (row0 + s < n)
      *reinterpret_cast<uint4*>(g16 + (row0 + s) * width + c) =
          load8_bf16(g + (row0 + s) * width + c);
  }
}

// The stage over n samples: feats [n][kpad64], and g16 [n][width] when g
// is not null.
inline cudaError_t featurize_cast(const float* means, const float* covs,
                                  const float* basis_t, const float* bb_t,
                                  const float* g, int n, int width,
                                  int num_dims, int num_degs,
                                  int use_contract, int kpad64,
                                  __nv_bfloat16* feats, __nv_bfloat16* g16,
                                  cudaStream_t stream) {
  const int smem = featurize_cast_smem(kpad64, num_dims);
  if (n < 1 || kpad64 % 64 != 0 || smem > kSmemLimit)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      featurize_cast_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  featurize_cast_kernel<<<(n + kTile - 1) / kTile, kThreads, smem, stream>>>(
      means, covs, basis_t, bb_t, g, n, width, num_dims, num_degs,
      use_contract, kpad64, feats, g16);
  return cudaGetLastError();
}

}  // namespace mnt
