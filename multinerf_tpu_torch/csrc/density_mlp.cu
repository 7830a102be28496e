// Fully fused density MLP forward for Hopper (sm_90a):
//   raw_density[N] = head(relu-trunk(bf16(IPE(contract(means, covs)))))
//
// Replaces the TPU kernel multinerf_tpu/ops/pallas/density_mlp.py
// (_fwd_kernel with _trunk_forward and _density_row, reached through
// pallas_call in _forward).  Per sample: the 504 IPE features, a trunk of
// `depth` ReLU layers of width H (bf16 inputs, f32 accumulation, f32 bias,
// ReLU, activations rounded to bf16), then the density head as an f32 sum
// of bf16-rounded activation * bf16-rounded weight, plus the bias.
//
// What bounds it: at the 360 config (4 x 256 trunk, N = 262,144 samples per
// proposal level of a 4,096-ray chunk) the trunk is 2 * N * (512 * 256 +
// 3 * 256 * 256) = 172 GFLOP, while device memory sees only 48 bytes in and
// 4 bytes out per sample: the unfused trunk would move ~2 KB of activations
// per sample instead.  So the tensor cores bound it.  Design: one block of
// 8 warps per 64 samples; the features and the [64, 256] activations
// ping-pong between two bf16 tiles in shared memory and never reach device
// memory.  The TPU kept the whole 0.65 MB bf16 trunk resident in VMEM; a
// Hopper block has at most 227 KB of shared memory, so each layer's bf16
// weights stream from global memory (L2-resident: every block reads the
// same matrices) straight into wmma fragments.  Each warp owns 32 output
// columns of a 256-wide layer; the bias + ReLU + bf16 epilogue goes through
// a per-warp 16x16 f32 staging tile.  The head is a warp reduction per
// sample, and rows >= N are masked at the store.  No TMA/wgmma pipeline yet.

#include <cuda_runtime.h>

#include "features.cuh"

namespace mnt {

// act_out[kTile][ldo] = bf16(relu(act_in @ w + bias)) for all kTile rows.
__device__ void dense_relu_layer(const __nv_bfloat16* act_in, int ldi,
                                 const __nv_bfloat16* __restrict__ w,
                                 const float* __restrict__ bias, int k_dim,
                                 int width, __nv_bfloat16* act_out, int ldo,
                                 float* my_stage) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  FragC acc[kTile / 16][2];
  for (int col0 = warp * 32; col0 < width; col0 += kWarps * 32) {
    warp_tile_product(act_in, ldi, w, width, k_dim, col0, acc);
    for (int r = 0; r < kTile / 16; ++r) {
      for (int c = 0; c < 2; ++c) {
        wmma::store_matrix_sync(my_stage, acc[r][c], 16, wmma::mem_row_major);
        __syncwarp();
        const int rr = lane / 2;
        const int cc = (lane % 2) * 8;
        const int col = col0 + c * 16 + cc;
        __nv_bfloat16* dst = act_out + (size_t)(r * 16 + rr) * ldo + col;
        const float* src = my_stage + rr * 16 + cc;
        for (int j = 0; j < 8; ++j)
          dst[j] = __float2bfloat16_rn(fmaxf(src[j] + bias[col + j], 0.0f));
        __syncwarp();
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
density_mlp_fwd_kernel(const float* __restrict__ means,
                       const float* __restrict__ covs,
                       const float* __restrict__ basis_t,
                       const float* __restrict__ bb_t,
                       const __nv_bfloat16* __restrict__ w0,
                       const __nv_bfloat16* __restrict__ w_hidden,
                       const float* __restrict__ biases,
                       const __nv_bfloat16* __restrict__ wd,
                       const float* __restrict__ bd, float* __restrict__ out,
                       int n, int width, int depth, int num_dims,
                       int num_degs, int use_contract) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int kpad = padded_feats(2 * num_degs * num_dims);
  const int lda = tile_stride(kpad > width ? kpad : width);
  const int ldb = tile_stride(width);
  __nv_bfloat16* buf_a = reinterpret_cast<__nv_bfloat16*>(smem);
  const int bytes_a = round_up(kTile * lda * 2, 128);
  __nv_bfloat16* buf_b = reinterpret_cast<__nv_bfloat16*>(smem + bytes_a);
  const int bytes_b = round_up(kTile * ldb * 2, 128);
  float* stage = reinterpret_cast<float*>(smem + bytes_a + bytes_b);
  float* scratch = stage + kWarps * 256;
  const long long row0 = (long long)blockIdx.x * kTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  tile_features(means, covs, basis_t, bb_t, row0, n, num_dims, num_degs,
                use_contract != 0, scratch, buf_a, lda);

  // Layer l reads `in` and writes `out`; the two tiles swap every layer.
  __nv_bfloat16* in = buf_a;
  __nv_bfloat16* act = buf_b;
  int ldi = lda, ldo = ldb;
  for (int l = 0; l < depth; ++l) {
    const __nv_bfloat16* w =
        l == 0 ? w0 : w_hidden + (size_t)(l - 1) * width * width;
    dense_relu_layer(in, ldi, w, biases + (size_t)l * width,
                     l == 0 ? kpad : width, width, act, ldo,
                     stage + warp * 256);
    __syncthreads();
    __nv_bfloat16* t = in;
    in = act;
    act = t;
    const int lt = ldi;
    ldi = ldo;
    ldo = lt;
  }

  // Density head: a reduction, not a product.  Each warp takes 8 samples.
  const float bias_d = bd[0];
  for (int s = warp; s < kTile; s += kWarps) {
    const __nv_bfloat16* x = in + (size_t)s * ldi;
    float sum = 0.0f;
    for (int c = lane; c < width; c += 32)
      sum += __bfloat162float(x[c]) * __bfloat162float(wd[c]);
    for (int off = 16; off > 0; off /= 2)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const long long row = row0 + s;
    if (lane == 0 && row < n) out[row] = sum + bias_d;
  }
}

}  // namespace mnt

extern "C" int density_mlp_forward(const void* means, const void* covs,
                                   const void* basis_t, const void* bb_t,
                                   const void* w0, const void* w_hidden,
                                   const void* biases, const void* wd,
                                   const void* bd, void* out, int n,
                                   int width, int depth, int num_dims,
                                   int num_degs, int use_contract,
                                   void* stream) {
  using namespace mnt;
  const int kpad = padded_feats(2 * num_degs * num_dims);
  const int lda = tile_stride(kpad > width ? kpad : width);
  const size_t smem = round_up(kTile * lda * 2, 128) +
                      round_up(kTile * tile_stride(width) * 2, 128) +
                      (kWarps * 256 + featurizer_smem_floats(num_dims)) *
                          sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      density_mlp_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  const int blocks = (n + kTile - 1) / kTile;
  density_mlp_fwd_kernel<<<blocks, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(means), static_cast<const float*>(covs),
      static_cast<const float*>(basis_t), static_cast<const float*>(bb_t),
      static_cast<const __nv_bfloat16*>(w0),
      static_cast<const __nv_bfloat16*>(w_hidden),
      static_cast<const float*>(biases),
      static_cast<const __nv_bfloat16*>(wd), static_cast<const float*>(bd),
      static_cast<float*>(out), n, width, depth, num_dims, num_degs,
      use_contract);
  return (int)cudaGetLastError();
}
