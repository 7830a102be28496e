// Fused int8 NerfMLP trunk forward for Hopper (sm_90a), K5:
//   out[N, W] = bf16(trunk(bf16(IPE(contract(means, covs)))))
// with layer 0 in bf16, layers 1.. as int8 products with per-sample
// activation scales and per-output-channel weight scales, and the skip
// layers' bf16 feature projection (numerics in int8_trunk.cuh).
//
// Replaces the TPU kernel multinerf_tpu/ops/pallas/int8_trunk.py
// (_fwd_kernel with _tile_forward and _qcols, reached through pallas_call
// in _forward).
//
// What bounds it: at the 360 config (8 x 1,024 trunk, skip at layer 5,
// N = 131,072 samples of one 4,096-ray chunk) layer 0 and the skip tail are
// 2 * N * 512 * 1024 * 2 = 275 GFLOP of bf16 products (0.28 ms at 989
// TFLOP/s) and the seven hidden layers 2 * N * 1024^2 * 7 = 1,924 GOP of
// int8 products (0.97 ms at 1,979 TOPS), against 48 bytes in and 2 KB out
// per sample (0.27 GB, 0.08 ms at 3.35 TB/s): the tensor cores bound it,
// at 1.25 ms.  Design: one block of 16 warps per 32 samples keeps the
// features, the f32 layer output and its int8 copy in shared memory (see
// int8_trunk.cuh); each warp owns 32 output columns per pass, with the
// weights read from L2 (all blocks share them).  The output is written
// once, as bf16 rows, rows >= N masked.  No TMA/wgmma pipeline yet.

#include <cuda_runtime.h>

#include "int8_trunk.cuh"

namespace mnt {

__global__ void __launch_bounds__(kI8Threads, 1)
int8_trunk_fwd_kernel(const float* __restrict__ means,
                      const float* __restrict__ covs,
                      const float* __restrict__ basis_t,
                      const float* __restrict__ bb_t, I8Trunk tr,
                      __nv_bfloat16* __restrict__ out, int n, int num_dims,
                      int num_degs, int use_contract) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int width = tr.width;
  const I8Layout lay = i8_layout(width, tr.kpad, num_dims);
  float* y = reinterpret_cast<float*>(smem);
  __nv_bfloat16* feats = reinterpret_cast<__nv_bfloat16*>(smem + lay.y_bytes);
  int8_t* xq = reinterpret_cast<int8_t*>(smem + lay.y_bytes + lay.feat_bytes);
  float* sx = reinterpret_cast<float*>(smem + lay.y_bytes + lay.region_bytes);
  float* scratch = sx + kI8Rows;
  const long long row0 = (long long)blockIdx.x * kI8Rows;

  i8_tile_features(means, covs, basis_t, bb_t, row0, n, num_dims, num_degs,
                   use_contract != 0, tr.kpad, scratch, feats, lay.ldf);
  tile_trunk_forward(tr, feats, lay.ldf, y, lay.ldy, xq, lay.ldq, sx,
                     [](int) {});

  // bf16 rows, 8 columns (16 bytes) per thread and store.
  const int words = width / 8;
  for (int i = threadIdx.x; i < kI8Rows * words; i += kI8Threads) {
    const int r = i / words, c = (i - r * words) * 8;
    if (row0 + r >= n) continue;
    const float* src = y + r * lay.ldy + c;
    uint4 word;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&word);
    for (int j = 0; j < 4; ++j)
      h[j] = __floats2bfloat162_rn(src[2 * j], src[2 * j + 1]);
    *reinterpret_cast<uint4*>(out + (row0 + r) * width + c) = word;
  }
}

}  // namespace mnt

extern "C" int int8_trunk_forward(const void* means, const void* covs,
                                  const void* basis_t, const void* bb_t,
                                  const void* w0t, const void* wqt,
                                  const void* sw, const void* tailt,
                                  const void* biases, void* out, int n,
                                  int width, int depth, int num_dims,
                                  int num_degs, int use_contract,
                                  int skip_mask, void* stream) {
  using namespace mnt;
  if (width % kKBlock != 0 || depth < 1) return (int)cudaErrorInvalidValue;
  const int kpad = i8_kpad(2 * num_degs * num_dims);
  const size_t smem = i8_layout(width, kpad, num_dims).total;
  cudaError_t err = cudaFuncSetAttribute(
      int8_trunk_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  const I8Trunk tr{static_cast<const __nv_bfloat16*>(w0t),
                   static_cast<const int8_t*>(wqt),
                   static_cast<const float*>(sw),
                   static_cast<const __nv_bfloat16*>(tailt),
                   static_cast<const float*>(biases), width, depth, kpad,
                   (unsigned)skip_mask};
  const int blocks = (n + kI8Rows - 1) / kI8Rows;
  int8_trunk_fwd_kernel<<<blocks, kI8Threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(means), static_cast<const float*>(covs),
      static_cast<const float*>(basis_t), static_cast<const float*>(bb_t), tr,
      static_cast<__nv_bfloat16*>(out), n, num_dims, num_degs, use_contract);
  return (int)cudaGetLastError();
}
