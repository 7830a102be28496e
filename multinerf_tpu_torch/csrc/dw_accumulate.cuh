// Device code of the int8 trunk's backward (K6 int8_trunk_bwd.cu; K3 and
// K4 use only reduce_splits, under wgmma_dw.cuh's GEMM): a weight gradient
// dW[rows, width] = A^T @ B summed over every sample, where per 64-sample
// tile A is [64, rows] bf16 (the IPE features, recomputed with
// tile_features, or rows of a bf16 or f32 matrix in device memory, rounded
// to bf16) and B is [64, width] rounded to bf16 (the cotangent).
//
// The TPU kernels run their grid in order and accumulate `+=` into one
// output that stays resident in VMEM.  Hopper's blocks run in parallel and
// in no order, and a 2 MB dW does not fit a block, so the sum is split over
// samples instead: block (x, p) owns the dW columns [x*bn, x*bn + bn) of
// sample split p, keeps that [bm, bn] slab in registers (8 warps, each a
// 64 x 64 wmma accumulator block) while it walks the tiles p, p + P, ...,
// then stores it to its own partial slab (columns past the width masked).
// A second pass sums the P slabs in a fixed order.  No atomics: the result is bitwise-deterministic.
// P is chosen by the caller so that the grid is one wave of the card.
#pragma once

#include <mma.h>

#include "features.cuh"

namespace mnt {

constexpr int kDwWarpDim = 64;  // Each warp owns a 64 x 64 block of dW.

using namespace nvcuda;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
using FragACol = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                                wmma::col_major>;

// 8 consecutive values, rounded to bf16, as one 16-byte word (p is
// 16-byte aligned for bf16 and 32-byte aligned for f32).
__device__ __forceinline__ uint4 load8_bf16(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ uint4 load8_bf16(const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  uint4 out;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&out);
  h[0] = __floats2bfloat162_rn(a.x, a.y);
  h[1] = __floats2bfloat162_rn(a.z, a.w);
  h[2] = __floats2bfloat162_rn(b.x, b.y);
  h[3] = __floats2bfloat162_rn(b.z, b.w);
  return out;
}

// A plan is valid when bm is 64 * (1, 2, 4 or 8), the 8 warps tile
// [bm, bn] with 64 x 64 blocks, and the width is a multiple of 16 (the
// columns past it in the last block are masked).
__host__ inline bool dw_plan_ok(int rows, int width, int bm, int bn) {
  if (bm % kDwWarpDim != 0 || bm > kWarps * kDwWarpDim || rows > bm ||
      rows % 8 != 0)
    return false;
  const int warps_m = bm / kDwWarpDim;
  if (kWarps % warps_m != 0) return false;
  return bn == kDwWarpDim * (kWarps / warps_m) && width % 16 == 0;
}

__host__ inline size_t dw_smem_bytes(int bm, int bn, int num_dims) {
  return round_up(kTile * tile_stride(bm) * 2, 128) +
         round_up(kTile * tile_stride(bn) * 2, 128) +
         featurizer_smem_floats(num_dims) * sizeof(float);
}

// part[p][bm][width]: split p's share of A^T @ B.  kFeatures: A is the IPE
// features of (means, covs) (columns [kpad, bm) zero); otherwise A is the
// first a_cols columns of a_rows[n][a_ld], rounded to bf16 (columns
// [a_cols, bm) zero).  B is b_rows[n][width].  Rows past n of B are zero,
// so padded samples add exactly nothing.
template <bool kFeatures, typename TB, typename TA>
__global__ void __launch_bounds__(kThreads, 1)
dw_partial_kernel(const float* __restrict__ means,
                  const float* __restrict__ covs,
                  const float* __restrict__ basis_t,
                  const float* __restrict__ bb_t, int num_dims, int num_degs,
                  int use_contract, const TA* __restrict__ a_rows,
                  int a_cols, int a_ld, const TB* __restrict__ b_rows, int n,
                  int width, int bm, int bn, int num_splits,
                  float* __restrict__ part) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = tile_stride(bm);
  const int ldb = tile_stride(bn);
  const int bytes_a = round_up(kTile * lda * 2, 128);
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* b_s = reinterpret_cast<__nv_bfloat16*>(smem + bytes_a);
  float* scratch = reinterpret_cast<float*>(
      smem + bytes_a + round_up(kTile * ldb * 2, 128));
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int warps_m = bm / kDwWarpDim;
  const int m0 = (warp % warps_m) * kDwWarpDim;
  const int nb0 = blockIdx.x * bn;                       // Block's column.
  const int nw0 = (warp / warps_m) * kDwWarpDim;         // Warp's, in block.
  const int num_tiles = (n + kTile - 1) / kTile;

  FragC acc[4][4];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int t = blockIdx.y; t < num_tiles; t += num_splits) {
    const long long row0 = (long long)t * kTile;
    // Tiles move in 16-byte words: 8 bf16 values per thread and load.
    const uint4 zero = make_uint4(0, 0, 0, 0);
    int a_filled;
    if constexpr (kFeatures) {
      tile_features(means, covs, basis_t, bb_t, row0, n, num_dims, num_degs,
                    use_contract != 0, scratch, a_s, lda);
      a_filled = padded_feats(2 * num_degs * num_dims);
    } else {
      const int words = a_cols / 8;
      for (int i = tid; i < kTile * words; i += blockDim.x) {
        const int s = i / words;
        const int c = (i - s * words) * 8;
        *reinterpret_cast<uint4*>(a_s + s * lda + c) =
            row0 + s < n ? load8_bf16(a_rows + (row0 + s) * a_ld + c)
                         : zero;
      }
      a_filled = a_cols;
    }
    const int extra = (bm - a_filled) / 8;
    for (int i = tid; i < kTile * extra; i += blockDim.x) {
      const int s = i / extra;
      *reinterpret_cast<uint4*>(a_s + s * lda + a_filled +
                                (i - s * extra) * 8) = zero;
    }
    const int words_b = bn / 8;
    for (int i = tid; i < kTile * words_b; i += blockDim.x) {
      const int s = i / words_b;
      const int c = (i - s * words_b) * 8;
      *reinterpret_cast<uint4*>(b_s + s * ldb + c) =
          row0 + s < n && nb0 + c < width
              ? load8_bf16(b_rows + (row0 + s) * width + nb0 + c)
              : zero;
    }
    __syncthreads();
    FragACol a[4];
    FragB b[4];
    for (int k = 0; k < kTile; k += 16) {
      // A^T's [m, k] block is A's [k, m] block read column-major.
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], a_s + k * lda + m0 + 16 * i, lda);
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(b[j], b_s + k * ldb + nw0 + 16 * j, ldb);
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = part + (size_t)blockIdx.y * bm * width;
  for (int j = 0; j < 4; ++j) {
    const int col = nb0 + nw0 + 16 * j;
    if (col >= width) break;
    for (int i = 0; i < 4; ++i)
      wmma::store_matrix_sync(out + (size_t)(m0 + 16 * i) * width + col,
                              acc[i][j], width, wmma::mem_row_major);
  }
}

// out[i] = sum_p part[p * stride + i] for i < count, p = 0, 1, ... in order.
__global__ void reduce_splits_kernel(const float* __restrict__ part,
                                     int num_splits, long long stride,
                                     long long count,
                                     float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float sum = 0.0f;
  for (int p = 0; p < num_splits; ++p) sum += part[p * stride + i];
  out[i] = sum;
}

inline cudaError_t reduce_splits(const float* part, int num_splits,
                                 long long stride, long long count,
                                 float* out, cudaStream_t stream) {
  if (count == 0) return cudaSuccess;
  const int threads = 256;
  const long long blocks = (count + threads - 1) / threads;
  reduce_splits_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      part, num_splits, stride, count, out);
  return cudaGetLastError();
}

// Keeps a template parameter out of argument deduction (C++20's
// std::type_identity_t): a nullptr A then takes the default type.
template <typename T>
struct NoDeduce {
  using type = T;
};

// dW[rows_out, width] = A^T @ bf16(B) over all n samples: the partial pass
// into `part` ([num_splits, bm, width] floats), then the ordered reduce.
// A's rows are a_ld elements apart (a_cols when a_ld is 0).
template <bool kFeatures, typename TB, typename TA = __nv_bfloat16>
cudaError_t weight_gradient(const float* means, const float* covs,
                            const float* basis_t, const float* bb_t,
                            int num_dims, int num_degs, int use_contract,
                            const typename NoDeduce<TA>::type* a_rows,
                            int a_cols,
                            const TB* b_rows, int n, int width, int rows_out,
                            int bm, int bn, int num_splits, float* part,
                            float* out, cudaStream_t stream, int a_ld = 0) {
  if (a_ld == 0) a_ld = a_cols;
  const int rows = kFeatures ? padded_feats(2 * num_degs * num_dims) : a_cols;
  if (!dw_plan_ok(rows, width, bm, bn) || num_splits < 1 || rows_out > bm)
    return cudaErrorInvalidValue;
  const size_t smem = dw_smem_bytes(bm, bn, num_dims);
  cudaError_t err = cudaFuncSetAttribute(
      dw_partial_kernel<kFeatures, TB, TA>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((width + bn - 1) / bn, num_splits);
  dw_partial_kernel<kFeatures, TB, TA><<<grid, kThreads, smem, stream>>>(
      means, covs, basis_t, bb_t, num_dims, num_degs, use_contract, a_rows,
      a_cols, a_ld, b_rows, n, width, bm, bn, num_splits, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_splits(part, num_splits, (long long)bm * width,
                       (long long)rows_out * width, out, stream);
}

}  // namespace mnt
