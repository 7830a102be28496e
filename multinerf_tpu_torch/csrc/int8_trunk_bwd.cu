// Backward of the fused int8 NerfMLP trunk for Hopper (sm_90a), K6: every
// dW_l and db_l from the bf16 cotangent g[N, W] of the trunk's output.  The
// sample positions get no gradient (stop-gradient inputs, as in the TPU
// kernel).
//
// Replaces the TPU kernel multinerf_tpu/ops/pallas/int8_trunk.py
// (_bwd_kernel with _qrows and _qcols, reached through pallas_call in _grad)
// and follows its numerics:
//   * the forward is recomputed (int8_trunk.cuh) and da = g * (act > 0) at
//     each layer, from the f32 activations;
//   * db_l = sum da_l; dW_0 and the skip layers' feature rows are
//     bf16(features)^T @ bf16(da_l);
//   * bwd_bf16 = 0 ('int8'): the hidden dW_l is an int8 product with x_in
//     (the f32 activation of layer l-1) and da_l each quantized per channel
//     over a group of samples, the JAX kernel's tile (the caller passes it;
//     N is padded to n_pad as the JAX kernel pads it, and the padded
//     samples, whose activations are not zero, enter the last group's
//     scales); dx = float(int32 sum of q(da) * wq2) * (sw2[in] * s[sample])
//     with da quantized per sample;
//   * bwd_bf16 = 1 ('int8_hybrid'): dW_l = bf16(x_in)^T @ bf16(da_l) and
//     dx = bf16(da) @ bf16(w_q * sw)^T, f32 accumulation.
//
// What bounds it: at the 360 config (8 x 1,024 trunk, N = 131,072) the
// recomputed forward is 1.25 ms of tensor-core work (int8_trunk.cu), the
// seven int8 dW and seven int8 dx products 2 x 1,924 GOP (1.94 ms at 1,979
// TOPS) and the bf16 dW of layer 0 and the skip tail 271 GFLOP (0.27 ms):
// about 3.5 ms.  In hybrid mode dW and dx run in bf16 (2 x 1,924 GFLOP,
// 3.9 ms): about 5.4 ms.  Design, in two passes, as K3:
//   1. one block of 16 warps per 32 samples recomputes the features and
//      the trunk, writing each hidden layer's f32 activation to device
//      memory, then walks back through the layers with da in shared memory,
//      writing every f32 da_l and the tile's column sums of da_l; in int8
//      mode it also folds the tile's per-channel absmax of every activation
//      and da_l into its group's scale slot with atomicMax on the f32 bit
//      pattern (non-negative floats order as their bits, and a maximum does
//      not depend on the order, so this stays deterministic);
//   2. the dW products as split-K partials and ordered reduces: the bf16
//      ones through dw_accumulate.cuh (dW_0 and the skip tails recompute
//      the features); for the int8 ones, group_quantize_kernel quantizes
//      x_in and da_l with their groups' scales into int8, channel-major per
//      group, and int8_dw_partial_kernel sums each group in int32,
//      dequantizes it and adds it into f32 registers.
// The TPU kept every dW (34 MB) resident in VMEM and accumulated over an
// ordered grid; here every sum has a fixed order, so two launches agree bit
// for bit.  The f32 scratch (acts and da) is 8 KB per sample per layer
// pair, 8.1 GB at N = 131,072.  No TMA/wgmma pipeline yet.

#include <cuda_runtime.h>

#include "dw_accumulate.cuh"
#include "int8_trunk.cuh"

namespace mnt {

// Column c of the 32 f32 rows: max |x| folded into slot[c] (atomicMax on
// the bit pattern), or the sum in row order stored to slot[c].
__device__ void column_max(const float* y, int ldy, int width,
                           unsigned* slot) {
  for (int c = threadIdx.x; c < width; c += kI8Threads) {
    float m = 0.0f;
    for (int r = 0; r < kI8Rows; ++r) m = fmaxf(m, fabsf(y[r * ldy + c]));
    atomicMax(slot + c, __float_as_uint(m));
  }
}

__device__ void column_sum(const float* y, int ldy, int width, float* slot) {
  for (int c = threadIdx.x; c < width; c += kI8Threads) {
    float s = 0.0f;
    for (int r = 0; r < kI8Rows; ++r) s += y[r * ldy + c];
    slot[c] = s;
  }
}

// 32 f32 rows of shared memory to device memory, 4 floats per store.
__device__ void store_rows(const float* y, int ldy, int width, float* dst) {
  const int words = width / 4;
  for (int i = threadIdx.x; i < kI8Rows * words; i += kI8Threads) {
    const int r = i / words, c = (i - r * words) * 4;
    *reinterpret_cast<float4*>(dst + (size_t)r * width + c) =
        *reinterpret_cast<const float4*>(y + r * ldy + c);
  }
}

__global__ void __launch_bounds__(kI8Threads, 1)
int8_trunk_bwd_tile_kernel(const float* __restrict__ means,
                           const float* __restrict__ covs,
                           const float* __restrict__ basis_t,
                           const float* __restrict__ bb_t, I8Trunk tr,
                           const void* __restrict__ wdx,
                           const float* __restrict__ swdx,
                           const __nv_bfloat16* __restrict__ g,
                           float* __restrict__ acts, float* __restrict__ das,
                           unsigned* __restrict__ x_max,
                           unsigned* __restrict__ d_max,
                           float* __restrict__ vec_part, int n, int n_pad,
                           int group, int num_dims, int num_degs,
                           int use_contract, int bwd_bf16) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int width = tr.width;
  const int depth = tr.depth;
  const I8Layout lay = i8_layout(width, tr.kpad, num_dims);
  float* y = reinterpret_cast<float*>(smem);
  __nv_bfloat16* feats = reinterpret_cast<__nv_bfloat16*>(smem + lay.y_bytes);
  int8_t* xq = reinterpret_cast<int8_t*>(smem + lay.y_bytes + lay.feat_bytes);
  __nv_bfloat16* da16 = feats;  // The hybrid backward's bf16 copy of da.
  float* sx = reinterpret_cast<float*>(smem + lay.y_bytes + lay.region_bytes);
  float* scratch = sx + kI8Rows;
  const long long row0 = (long long)blockIdx.x * kI8Rows;
  const int groups = n_pad / group;
  const int gi = (int)(row0 / group);
  const int ldy = lay.ldy;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  float* vec = vec_part + (size_t)blockIdx.x * depth * width;

  i8_tile_features(means, covs, basis_t, bb_t, row0, n, num_dims, num_degs,
                   use_contract != 0, tr.kpad, scratch, feats, lay.ldf);
  tile_trunk_forward(tr, feats, lay.ldf, y, ldy, xq, lay.ldq, sx, [&](int l) {
    if (l + 1 == depth) return;
    store_rows(y, ldy, width, acts + ((size_t)l * n_pad + row0) * width);
    if (!bwd_bf16)
      column_max(y, ldy, width, x_max + ((size_t)l * groups + gi) * width);
  });

  // da of the last layer: g through its ReLU mask; samples past n get 0.
  for (int i = tid; i < kI8Rows * width; i += kI8Threads) {
    const int r = i / width, c = i - r * width;
    const float gv =
        row0 + r < n ? __bfloat162float(g[(row0 + r) * width + c]) : 0.0f;
    y[r * ldy + c] = y[r * ldy + c] > 0.0f ? gv : 0.0f;
  }
  __syncthreads();

  for (int l = depth - 1; l >= 0; --l) {
    if (l + 1 < depth) {
      const float* act = acts + ((size_t)l * n_pad + row0) * width;
      for (int i = tid; i < kI8Rows * width; i += kI8Threads) {
        const int r = i / width, c = i - r * width;
        if (!(act[(size_t)r * width + c] > 0.0f)) y[r * ldy + c] = 0.0f;
      }
      __syncthreads();
    }
    store_rows(y, ldy, width, das + ((size_t)l * n_pad + row0) * width);
    column_sum(y, ldy, width, vec + (size_t)l * width);
    if (!bwd_bf16 && l > 0)
      column_max(y, ldy, width, d_max + ((size_t)l * groups + gi) * width);
    if (l == 0) break;
    // dx: da of layer l-1's output, before its ReLU mask.
    if (!bwd_bf16) {
      const int8_t* wq2 =
          static_cast<const int8_t*>(wdx) + (size_t)(l - 1) * width * width;
      const float* sw2 = swdx + (size_t)(l - 1) * width;
      quantize_rows(y, ldy, width, xq, lay.ldq, sx);
      for (int col0 = warp * kI8Cols; col0 < width;
           col0 += kI8Warps * kI8Cols) {
        int acc[2][4][4];
        warp_product(xq, lay.ldq, wq2, width, width, col0, acc);
        #pragma unroll
        for (int m = 0; m < 2; ++m)
          #pragma unroll
          for (int j = 0; j < 4; ++j)
            #pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = acc_row(m, e), c = col0 + acc_col(j, e);
              y[r * ldy + c] = (float)acc[m][j][e] * (sw2[c] * sx[r]);
            }
      }
    } else {
      const __nv_bfloat16* wdeq = static_cast<const __nv_bfloat16*>(wdx) +
                                  (size_t)(l - 1) * width * width;
      __syncthreads();
      for (int i = tid; i < kI8Rows * width; i += kI8Threads) {
        const int r = i / width, c = i - r * width;
        da16[r * lay.ldh + c] = __float2bfloat16_rn(y[r * ldy + c]);
      }
      __syncthreads();
      for (int col0 = warp * kI8Cols; col0 < width;
           col0 += kI8Warps * kI8Cols) {
        float acc[2][4][4];
        warp_product(da16, 2 * lay.ldh, wdeq, 2 * width, 2 * width, col0,
                     acc);
        #pragma unroll
        for (int m = 0; m < 2; ++m)
          #pragma unroll
          for (int j = 0; j < 4; ++j)
            #pragma unroll
            for (int e = 0; e < 4; ++e)
              y[acc_row(m, e) * ldy + col0 + acc_col(j, e)] = acc[m][j][e];
      }
    }
    __syncthreads();
  }
}

constexpr int kDw8 = 128;          // dW rows and columns per block.
constexpr int kDw8Threads = 256;
constexpr int kQuantRows = 64;     // Samples per quantize block (| group).
constexpr int kQuantCols = 32;     // Channels per quantize block.

__device__ __forceinline__ float group_scale(unsigned max_bits) {
  return fmaxf(__uint_as_float(max_bits), kScaleFloor) / 127.0f;
}

// q[g][c][s] = rint(x[g * group + s][c] / scale_g[c]): one hidden layer's f32
// input or cotangent quantized per channel over each group of samples, in
// a channel-major layout per group (the dW product's k axis contiguous).
__global__ void __launch_bounds__(kDw8Threads)
group_quantize_kernel(const float* __restrict__ x,
                      const unsigned* __restrict__ maxes, int group,
                      int width, int8_t* __restrict__ q) {
  __shared__ __align__(16) int8_t tile[kQuantCols][kQuantRows + 16];
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kQuantCols;
  const long long s0 = (long long)blockIdx.y * kQuantRows;
  const int gi = (int)(s0 / group);
  for (int i = tid; i < kQuantRows * kQuantCols; i += kDw8Threads) {
    const int s = i / kQuantCols, c = i - s * kQuantCols;
    const float scale = group_scale(maxes[(size_t)gi * width + c0 + c]);
    tile[c][s] = (int8_t)__float2int_rn(x[(s0 + s) * width + c0 + c] / scale);
  }
  __syncthreads();
  const int words = kQuantRows / 4;
  int8_t* dst =
      q + ((size_t)gi * width + c0) * group + (s0 - (long long)gi * group);
  for (int i = tid; i < kQuantCols * words; i += kDw8Threads) {
    const int c = i / words, w = i - c * words;
    *reinterpret_cast<unsigned*>(dst + (size_t)c * group + 4 * w) =
        ld_u32(&tile[c][4 * w]);
  }
}

__device__ __forceinline__ uint4 ldg_u128_or_0(const int8_t* p, bool ok) {
  return ok ? __ldg(reinterpret_cast<const uint4*>(p))
            : make_uint4(0, 0, 0, 0);
}

// part[p][W][W]: split p's share of the int8 dW of one hidden layer, over
// the groups p, p + P, ...: per group, the int32 sum over its samples of
// qx[g][i][s] * qd[g][o][s] (group_quantize_kernel's layout), times
// (sx_g[i] * sd_g[o]), added to the f32 sum in group order.  8 warps of
// 32 x 64 cover a 128 x 128 block of dW; the operands are read from L2,
// 16 bytes per thread and load (mma_block).
__global__ void __launch_bounds__(kDw8Threads, 1)
int8_dw_partial_kernel(const int8_t* __restrict__ qx,
                       const int8_t* __restrict__ qd,
                       const unsigned* __restrict__ x_max,
                       const unsigned* __restrict__ d_max, int n_pad,
                       int group, int width, int num_splits,
                       float* __restrict__ part) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int i0 = blockIdx.y * kDw8 + (warp % 4) * 32;  // The warp's rows,
  const int o0 = blockIdx.x * kDw8 + (warp / 4) * 64;  // and columns.
  const int groups = n_pad / group;
  float accf[2][8][4];
  #pragma unroll
  for (int m = 0; m < 2; ++m)
    #pragma unroll
    for (int j = 0; j < 8; ++j)
      #pragma unroll
      for (int e = 0; e < 4; ++e) accf[m][j][e] = 0.0f;

  for (int gi = blockIdx.z; gi < groups; gi += num_splits) {
    const int8_t* xa = qx + (size_t)gi * width * group + t * 16;
    const int8_t* xb = qd + (size_t)gi * width * group + t * 16;
    int acc[2][8][4];
    #pragma unroll
    for (int m = 0; m < 2; ++m)
      #pragma unroll
      for (int j = 0; j < 8; ++j)
        #pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][j][e] = 0;
    for (int k = 0; k < group; k += kKBlock) {
      uint4 av[2][2], bv[8];
      #pragma unroll
      for (int m = 0; m < 2; ++m)
        #pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = i0 + m * 16 + h * 8 + g;
          av[m][h] = ldg_u128_or_0(xa + (size_t)r * group + k, r < width);
        }
      #pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = o0 + j * 8 + g;
        bv[j] = ldg_u128_or_0(xb + (size_t)c * group + k, c < width);
      }
      mma_block(acc, av, bv);
    }
    float sa[2][2], sd[8][2];
    #pragma unroll
    for (int m = 0; m < 2; ++m)
      #pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = i0 + acc_row(m, 2 * h);
        sa[m][h] =
            r < width ? group_scale(x_max[(size_t)gi * width + r]) : 0.0f;
      }
    #pragma unroll
    for (int j = 0; j < 8; ++j)
      #pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = o0 + acc_col(j, h);
        sd[j][h] =
            c < width ? group_scale(d_max[(size_t)gi * width + c]) : 0.0f;
      }
    #pragma unroll
    for (int m = 0; m < 2; ++m)
      #pragma unroll
      for (int j = 0; j < 8; ++j)
        #pragma unroll
        for (int e = 0; e < 4; ++e)
          accf[m][j][e] +=
              (float)acc[m][j][e] * (sa[m][e / 2] * sd[j][e % 2]);
  }

  float* out = part + (size_t)blockIdx.z * width * width;
  #pragma unroll
  for (int m = 0; m < 2; ++m)
    #pragma unroll
    for (int j = 0; j < 8; ++j)
      #pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + acc_row(m, e), o = o0 + acc_col(j, e);
        if (i < width && o < width)
          out[(size_t)i * width + o] = accf[m][j][e];
      }
}

}  // namespace mnt

// Scratch (allocated by the caller): acts [depth-1][n_pad][W] f32, das
// [depth][n_pad][W] f32, x_max [depth-1][groups][W] and d_max
// [depth][groups][W] (zeroed), vec_part [n_pad/32][depth*W] f32, part, the
// dW partials, and qbuf, 2 * n_pad * W bytes for the int8 mode's quantized
// operands.  Weights: tr's operands (int8_trunk.cuh) plus wdx
// [depth-1][W][W] (int8 wq2 per input channel, or bf16 w_q * sw in hybrid
// mode, both [in][out]) and swdx [depth-1][W] (sw2).  Outputs: dw_out,
// every layer's dW back to back (dW_0 [F][W], then [W (+ F)][W]); db_out
// [depth][W].
extern "C" int int8_trunk_backward(
    const void* means, const void* covs, const void* basis_t,
    const void* bb_t, const void* w0t, const void* wqt, const void* sw,
    const void* tailt, const void* biases, const void* wdx, const void* swdx,
    const void* g, void* acts, void* das, void* x_max, void* d_max,
    void* vec_part, void* part, void* qbuf, void* dw_out, void* db_out,
    int n, int n_pad,
    int group, int width, int depth, int num_dims, int num_degs,
    int use_contract, int skip_mask, int bwd_bf16, int bm0, int bn0,
    int splits0, int bm1, int bn1, int splits1, int splits8, void* stream) {
  using namespace mnt;
  if (width % kKBlock != 0 || depth < 1 || n_pad % kI8Rows != 0 ||
      group % kQuantRows != 0 || n_pad % group != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int kpad = i8_kpad(2 * num_degs * num_dims);
  const size_t smem = i8_layout(width, kpad, num_dims).total;
  cudaError_t err = cudaFuncSetAttribute(
      int8_trunk_bwd_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return (int)cudaErrorInvalidValue;
  const I8Trunk tr{static_cast<const __nv_bfloat16*>(w0t),
                   static_cast<const int8_t*>(wqt),
                   static_cast<const float*>(sw),
                   static_cast<const __nv_bfloat16*>(tailt),
                   static_cast<const float*>(biases), width, depth, kpad,
                   (unsigned)skip_mask};
  auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  float* acts_f = static_cast<float*>(acts);
  float* das_f = static_cast<float*>(das);
  unsigned* x_max_u = static_cast<unsigned*>(x_max);
  unsigned* d_max_u = static_cast<unsigned*>(d_max);
  const int tiles = n_pad / kI8Rows;
  const int groups = n_pad / group;
  int8_trunk_bwd_tile_kernel<<<tiles, kI8Threads, smem, st>>>(
      f32(means), f32(covs), f32(basis_t), f32(bb_t), tr, wdx, f32(swdx),
      static_cast<const __nv_bfloat16*>(g), acts_f, das_f, x_max_u, d_max_u,
      static_cast<float*>(vec_part), n, n_pad, group, num_dims, num_degs,
      use_contract, bwd_bf16);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int num_feats = 2 * num_degs * num_dims;
  float* dw = static_cast<float*>(dw_out);
  float* part_f = static_cast<float*>(part);
  const size_t plane = (size_t)n_pad * width;
  // Layer 0 and each skip layer's feature rows: bf16(features)^T @ bf16(da).
  auto feature_rows = [&](int l) {
    err = weight_gradient<true, float>(
        f32(means), f32(covs), f32(basis_t), f32(bb_t), num_dims, num_degs,
        use_contract, nullptr, 0, das_f + l * plane, n, width, num_feats, bm0,
        bn0, splits0, part_f, dw, st);
    dw += (size_t)num_feats * width;
    return err;
  };
  if (feature_rows(0) != cudaSuccess) return (int)err;
  const int row_block = width < 512 ? width : 512;
  if (bwd_bf16 && width % row_block != 0) return (int)cudaErrorInvalidValue;
  for (int l = 1; l < depth; ++l) {
    const float* x_in = acts_f + (l - 1) * plane;
    const float* d = das_f + l * plane;
    if (bwd_bf16) {
      for (int r0 = 0; r0 < width; r0 += row_block) {
        err = weight_gradient<false, float, float>(
            nullptr, nullptr, nullptr, nullptr, num_dims, num_degs,
            use_contract, x_in + r0, row_block, d, n, width, row_block, bm1,
            bn1, splits1, part_f, dw + (size_t)r0 * width, st, width);
        if (err != cudaSuccess) return (int)err;
      }
    } else {
      const unsigned* xm = x_max_u + (size_t)(l - 1) * groups * width;
      const unsigned* dm = d_max_u + (size_t)l * groups * width;
      int8_t* qx = static_cast<int8_t*>(qbuf);
      int8_t* qd = qx + plane;
      const dim3 qgrid(width / kQuantCols, n_pad / kQuantRows);
      group_quantize_kernel<<<qgrid, kDw8Threads, 0, st>>>(x_in, xm, group,
                                                           width, qx);
      group_quantize_kernel<<<qgrid, kDw8Threads, 0, st>>>(d, dm, group,
                                                           width, qd);
      const int blocks = (width + kDw8 - 1) / kDw8;
      int8_dw_partial_kernel<<<dim3(blocks, blocks, splits8), kDw8Threads, 0,
                               st>>>(qx, qd, xm, dm, n_pad, group, width,
                                     splits8, part_f);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      err = reduce_splits(part_f, splits8, (long long)width * width,
                          (long long)width * width, dw, st);
      if (err != cudaSuccess) return (int)err;
    }
    dw += (size_t)width * width;
    if (((unsigned)skip_mask >> l) & 1u) {
      if (feature_rows(l) != cudaSuccess) return (int)err;
    }
  }
  return (int)reduce_splits(static_cast<const float*>(vec_part), tiles,
                            (long long)depth * width,
                            (long long)depth * width,
                            static_cast<float*>(db_out), st);
}
