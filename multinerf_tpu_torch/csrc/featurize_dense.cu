// Fused featurize -> Dense forward for Hopper (sm_90a).
//
// Replaces the TPU kernel multinerf_tpu/ops/pallas/featurize_dense.py
// (_fwd_kernel, reached through pallas_call in _forward):
//   out[N, W] = bf16(IPE(contract(means, covs))) [N, F] @ bf16(W) [F, W] + bias
// with F = 2 * D * L IPE features (504 at the 360 config), f32 accumulation
// and an f32 bias.  The features never touch device memory.
//
// What bounds it: at the 360 config (N = 131,072 samples of one 4,096-ray
// chunk, W = 1,024) the product is 2 * N * 512 * 1024 = 137 GFLOP against
// 0.5 GB of f32 output, so the tensor cores bound it, not memory.  Design:
// one block of 8 warps per 64 samples computes the tile's bf16 features
// into shared memory once ([64][520], K padded from 504 to 512 with zeros),
// then walks the W output columns in 256-wide slabs; each warp runs bf16
// wmma products (16x16x16, f32 accumulators) for a 64 x 32 block, reading
// the bf16 weights straight from global memory, where the 1 MB matrix stays
// L2-resident across blocks.  The epilogue stages each 16x16 accumulator
// through shared memory, adds the bias and stores rows < N only: the ragged
// edge is masked in the kernel, not padded.  No TMA/wgmma pipeline yet.

#include <cuda_runtime.h>

#include "features.cuh"

namespace mnt {

__global__ void __launch_bounds__(kThreads)
featurize_dense_fwd_kernel(const float* __restrict__ means,
                           const float* __restrict__ covs,
                           const float* __restrict__ basis_t,
                           const float* __restrict__ bb_t,
                           const __nv_bfloat16* __restrict__ w,
                           const float* __restrict__ bias,
                           float* __restrict__ out, int n, int width,
                           int num_dims, int num_degs, int use_contract) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int kpad = padded_feats(2 * num_degs * num_dims);
  const int ldf = tile_stride(kpad);
  __nv_bfloat16* feats = reinterpret_cast<__nv_bfloat16*>(smem);
  float* stage = reinterpret_cast<float*>(
      smem + round_up(kTile * ldf * 2, 128));          // [kWarps][16*16]
  float* scratch = stage + kWarps * 256;
  const long long row0 = (long long)blockIdx.x * kTile;

  tile_features(means, covs, basis_t, bb_t, row0, n, num_dims, num_degs,
                use_contract != 0, scratch, feats, ldf);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* my_stage = stage + warp * 256;
  FragC acc[kTile / 16][2];
  for (int col0 = warp * 32; col0 < width; col0 += kWarps * 32) {
    warp_tile_product(feats, ldf, w, width, kpad, col0, acc);
    for (int r = 0; r < kTile / 16; ++r) {
      for (int c = 0; c < 2; ++c) {
        wmma::store_matrix_sync(my_stage, acc[r][c], 16, wmma::mem_row_major);
        __syncwarp();
        const int rr = lane / 2;
        const int cc = (lane % 2) * 8;
        const long long row = row0 + r * 16 + rr;
        const int col = col0 + c * 16 + cc;
        if (row < n) {
          float4* dst = reinterpret_cast<float4*>(out + row * width + col);
          const float* src = my_stage + rr * 16 + cc;
          dst[0] = make_float4(src[0] + bias[col], src[1] + bias[col + 1],
                               src[2] + bias[col + 2], src[3] + bias[col + 3]);
          dst[1] = make_float4(src[4] + bias[col + 4], src[5] + bias[col + 5],
                               src[6] + bias[col + 6], src[7] + bias[col + 7]);
        }
        __syncwarp();
      }
    }
  }
}

}  // namespace mnt

extern "C" int featurize_dense_forward(const void* means, const void* covs,
                                       const void* basis_t, const void* bb_t,
                                       const void* w, const void* bias,
                                       void* out, int n, int width,
                                       int num_dims, int num_degs,
                                       int use_contract, void* stream) {
  using namespace mnt;
  const int kpad = padded_feats(2 * num_degs * num_dims);
  const size_t smem = round_up(kTile * tile_stride(kpad) * 2, 128) +
                      (kWarps * 256 + featurizer_smem_floats(num_dims)) *
                          sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      featurize_dense_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  const int blocks = (n + kTile - 1) / kTile;
  featurize_dense_fwd_kernel<<<blocks, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(means), static_cast<const float*>(covs),
      static_cast<const float*>(basis_t), static_cast<const float*>(bb_t),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(bias),
      static_cast<float*>(out), n, width, num_dims, num_degs, use_contract);
  return (int)cudaGetLastError();
}
