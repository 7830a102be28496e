// Device code of the fused int8 trunk forward (K5, int8_trunk.cu): warp-level
// tensor-core products through mma.sync, the per-sample int8 quantizer and
// the trunk forward of one 32-sample tile.  K6 (int8_trunk_bwd.cu) takes
// the quantizer's scale floor and the features' k extent from here.
//
// The numerics follow multinerf_tpu/ops/pallas/int8_trunk.py:69-147:
//   * layer 0: bf16 features @ bf16 W_0, f32 accumulation, + b_0, ReLU;
//   * layer l >= 1: the f32 input x is quantized per sample,
//     s = max(max_c |x_c|, 1e-30) / 127, q = rint(x / s) (IEEE division,
//     ties to even); y = float(int32 sum of q * w_q) * (sw[col] * s[row]),
//     the product of the scales formed first; a skip layer then adds the
//     f32-accumulated bf16(features) @ bf16(W_tail); then + b_l, then ReLU.
// The weights are quantized outside the kernel (ops/kernels/int8_trunk.py:
// quantize_weights, per output channel), as in the JAX package.
//
// Why a 32-sample tile: each sample's scale needs its whole f32 row of the
// layer output before anything is quantized for the next layer.  The TPU
// held a 512-sample tile's f32 activations (2 MB) in VMEM; a Hopper block
// has 227 KB of shared memory, so the block holds 32 samples: the f32 rows
// [32][W + 8] (132 KB at W = 1,024), the int8 input and the bf16 features
// (34 KB each).  The scales are per sample, so the tile size does not
// change any value.
//
// Products: mma.sync m16n8k32 (s8 x s8 -> s32) and m16n8k16 (bf16 x bf16 ->
// f32).  Both give a thread the same accumulator positions (rows g and
// g + 8 of a 16-row tile, columns 2t and 2t + 1 of an 8-column tile, for
// lane = 4g + t), so the int8 sum and the skip projection of one output
// meet in registers.  The A operand (activations, k contiguous) comes from
// shared memory, the B operand from the transposed weights [out][in] in
// global memory (k contiguous; L2-resident, every block reads the same
// ~9 MB trunk), 16 bytes per thread and load (mma_block).  wmma's int8
// fragments would need 32-byte aligned k offsets, which a 16-byte int8 k
// step does not give.
#pragma once

#include <cstdint>

#include "features.cuh"

namespace mnt {

constexpr int kI8Rows = 32;                // Samples per block.
constexpr int kI8Threads = 512;            // 16 warps.
constexpr int kI8Warps = kI8Threads / 32;
constexpr int kI8Cols = 32;                // Output columns per warp pass.
constexpr int kKBlock = 64;                // Bytes of k per load block.
constexpr float kScaleFloor = 1e-30f;

// The features' k extent in the int8 kernels: a whole number of 32-deep
// bf16 load blocks (the columns past the features are zero).
__host__ __device__ inline int i8_kpad(int num_feats) {
  return round_up(num_feats, 32);
}

// Row strides of the shared-memory tiles, in elements of `bytes` each: a
// multiple of 16 bytes that is 64 bytes past a multiple of 128, so that the
// 16-byte loads of 8 consecutive lanes (two rows, four 16-byte words each)
// hit 8 different bank groups.
__host__ __device__ inline int i8_stride(int cols, int bytes) {
  return (round_up(cols * bytes, 128) + 64) / bytes;
}

// Shared memory of one tile, in bytes: the f32 rows, then the bf16
// features and the int8 input, then the scales and the featurizer.
struct I8Layout {
  int ldy, ldf, ldq;  // Row strides: f32, features, int8 rows.
  size_t y_bytes, feat_bytes, region_bytes, total;
};

__host__ __device__ inline I8Layout i8_layout(int width, int kpad,
                                              int num_dims) {
  I8Layout s;
  s.ldy = width + 8;
  s.ldf = i8_stride(kpad, 2);
  s.ldq = i8_stride(width, 1);
  s.y_bytes = round_up(kI8Rows * s.ldy * 4, 128);
  s.feat_bytes = round_up(kI8Rows * s.ldf * 2, 128);
  s.region_bytes = s.feat_bytes + round_up(kI8Rows * s.ldq, 128);
  s.total = s.y_bytes + s.region_bytes +
            (kI8Rows + featurizer_smem_floats(num_dims, kI8Rows)) *
                sizeof(float);
  return s;
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T>
__device__ __forceinline__ void mma(T (&d)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1);
template <>
__device__ __forceinline__ void mma<int>(int (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  mma_s8(d, a, b0, b1);
}
template <>
__device__ __forceinline__ void mma<float>(float (&d)[4],
                                           const unsigned (&a)[4],
                                           unsigned b0, unsigned b1) {
  mma_bf16(d, a, b0, b1);
}

__device__ __forceinline__ unsigned word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Accumulates one 64-byte k block into acc: a[m][h] holds this thread's 16
// bytes of row m * 16 + g + 8h of A, b[j] its 16 bytes of column j * 8 + g
// of B, both from byte 16t of the block (lane = 4g + t).  The block is two
// mma steps (32 int8 or 16 bf16 deep), and the k order inside it is
// permuted: step s takes bytes 8s .. 8s + 7 of every thread's 16, as the
// words the mma reads at k 4t (int8) or 2t (bf16) and 16 (8) past that.  A
// and B take the same permutation, so the sum is the same set of products;
// in int8 it is exact, in bf16 only the f32 summation order inside an mma
// step changes.
template <typename T, int kN>
__device__ __forceinline__ void mma_block(T (&acc)[2][kN][4],
                                          const uint4 (&a)[2][2],
                                          const uint4 (&b)[kN]) {
  #pragma unroll
  for (int s = 0; s < 2; ++s) {
    #pragma unroll
    for (int m = 0; m < 2; ++m) {
      const unsigned af[4] = {word(a[m][0], 2 * s), word(a[m][1], 2 * s),
                              word(a[m][0], 2 * s + 1),
                              word(a[m][1], 2 * s + 1)};
      #pragma unroll
      for (int j = 0; j < kN; ++j)
        mma<T>(acc[m][j], af, word(b[j], 2 * s), word(b[j], 2 * s + 1));
    }
  }
}

// One warp's [32 rows][32 columns at col0] of A @ B: A is a[32][lda]
// (shared memory), B is given transposed, bt[col][ldb] (global memory; L2),
// int8 with an int32 sum (T = int) or bf16 with f32 accumulation (T =
// float).  Both hold k contiguous; lda and ldb in bytes are multiples of
// 16, and k_bytes, the bytes of k, a multiple of 64.
template <typename T>
__device__ __forceinline__ void warp_product(const void* a, int lda,
                                             const void* __restrict__ bt,
                                             int ldb, int k_bytes, int col0,
                                             T (&acc)[2][4][4]) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const char* pa = static_cast<const char*>(a) + g * lda + t * 16;
  const char* pb =
      static_cast<const char*>(bt) + (size_t)(col0 + g) * ldb + t * 16;
  #pragma unroll
  for (int m = 0; m < 2; ++m)
    #pragma unroll
    for (int j = 0; j < 4; ++j)
      #pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0;
  #pragma unroll 2
  for (int k = 0; k < k_bytes; k += kKBlock) {
    uint4 av[2][2], bv[4];
    #pragma unroll
    for (int m = 0; m < 2; ++m)
      #pragma unroll
      for (int h = 0; h < 2; ++h)
        av[m][h] = *reinterpret_cast<const uint4*>(
            pa + (m * 16 + h * 8) * lda + k);
    #pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = __ldg(reinterpret_cast<const uint4*>(
          pb + (size_t)j * 8 * ldb + k));
    mma_block(acc, av, bv);
  }
}

// Accumulator element e of tile (m, j): its row in the 32-row tile and its
// column offset from col0.
__device__ __forceinline__ int acc_row(int m, int e) {
  return m * 16 + (threadIdx.x % 32) / 4 + (e / 2) * 8;
}
__device__ __forceinline__ int acc_col(int j, int e) {
  return j * 8 + (threadIdx.x % 4) * 2 + (e % 2);
}

// Per-sample quantizer (_qcols of int8_trunk.py on the transposed layout):
// scale[r] = max(max_c |x[r][c]|, 1e-30) / 127 and q = rint(x / scale) for
// the 32 f32 rows x[r][ldx] into q[r][ldq].  16 threads per row reduce the
// absmax.  Starts and ends with __syncthreads.
__device__ void quantize_rows(const float* x, int ldx, int width, int8_t* q,
                              int ldq, float* scale) {
  __syncthreads();
  const int tid = threadIdx.x;
  const int r = tid / 16, sub = tid % 16;
  float m = 0.0f;
  for (int c = sub; c < width; c += 16) m = fmaxf(m, fabsf(x[r * ldx + c]));
  for (int off = 8; off > 0; off /= 2)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (sub == 0) scale[r] = fmaxf(m, kScaleFloor) / 127.0f;
  __syncthreads();
  for (int i = tid; i < kI8Rows * width; i += kI8Threads) {
    const int row = i / width, c = i - row * width;
    q[row * ldq + c] = (int8_t)__float2int_rn(x[row * ldx + c] / scale[row]);
  }
  __syncthreads();
}

// The trunk's weights as the kernels take them (ops/kernels/int8_trunk.py:
// _operands): w0t [W][kpad] bf16 (layer 0, transposed, K zero-padded to
// kpad = i8_kpad(F));
// wqt [depth-1][W][W] int8 (w_q of layers 1.., transposed: [out][in]); sw
// [depth-1][W] f32 (per output channel); tailt [skips][W][kpad] bf16 (the
// feature rows of each skip layer, transposed); biases [depth][W] f32.
struct I8Trunk {
  const __nv_bfloat16* w0t;
  const int8_t* wqt;
  const float* sw;
  const __nv_bfloat16* tailt;
  const float* biases;
  int width, depth, kpad;
  unsigned skip_mask;  // Bit l: layer l takes [x, features].
};

// The IPE features of the tile's samples into feats[32][ldf], zero in the
// columns [F, kpad).  Ends with __syncthreads.
__device__ void i8_tile_features(const float* __restrict__ means,
                                 const float* __restrict__ covs,
                                 const float* __restrict__ basis_t,
                                 const float* __restrict__ bb_t,
                                 long long row0, int n, int num_dims,
                                 int num_degs, bool use_contract, int kpad,
                                 float* scratch, __nv_bfloat16* feats,
                                 int ldf) {
  tile_features<kI8Rows>(means, covs, basis_t, bb_t, row0, n, num_dims,
                         num_degs, use_contract, scratch, feats, ldf);
  const int k16 = padded_feats(2 * num_degs * num_dims);
  const int extra = kpad - k16;
  for (int i = threadIdx.x; i < kI8Rows * extra; i += blockDim.x) {
    const int r = i / extra;
    feats[r * ldf + k16 + (i - r * extra)] = __float2bfloat16_rn(0.0f);
  }
  __syncthreads();
}

// The forward of one tile whose features are in `feats`: every layer's f32
// output lands in y[32][ldy]; after the last layer y holds the trunk's
// output.  on_layer(l) runs after layer l's output is complete (between two
// __syncthreads), before it is quantized for layer l + 1.
template <typename OnLayer>
__device__ void tile_trunk_forward(const I8Trunk& tr,
                                   const __nv_bfloat16* feats, int ldf,
                                   float* y, int ldy, int8_t* xq, int ldq,
                                   float* sx, OnLayer on_layer) {
  const int warp = threadIdx.x / 32;
  const int width = tr.width;
  for (int l = 0; l < tr.depth; ++l) {
    const float* bias = tr.biases + (size_t)l * width;
    const bool skip = l > 0 && ((tr.skip_mask >> l) & 1u);
    for (int col0 = warp * kI8Cols; col0 < width; col0 += kI8Warps * kI8Cols) {
      if (l == 0) {
        float acc[2][4][4];
        warp_product(feats, 2 * ldf, tr.w0t, 2 * tr.kpad, 2 * tr.kpad, col0,
                     acc);
        #pragma unroll
        for (int m = 0; m < 2; ++m)
          #pragma unroll
          for (int j = 0; j < 4; ++j)
            #pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int c = col0 + acc_col(j, e);
              y[acc_row(m, e) * ldy + c] = fmaxf(acc[m][j][e] + bias[c], 0.0f);
            }
        continue;
      }
      float proj[2][4][4];
      if (skip) {
        const int tail = __popc(tr.skip_mask & ((1u << l) - 1u));
        warp_product(feats, 2 * ldf,
                     tr.tailt + (size_t)tail * width * tr.kpad, 2 * tr.kpad,
                     2 * tr.kpad, col0, proj);
      }
      int acc[2][4][4];
      warp_product(xq, ldq, tr.wqt + (size_t)(l - 1) * width * width, width,
                   width, col0, acc);
      const float* sw = tr.sw + (size_t)(l - 1) * width;
      #pragma unroll
      for (int m = 0; m < 2; ++m)
        #pragma unroll
        for (int j = 0; j < 4; ++j)
          #pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = acc_row(m, e), c = col0 + acc_col(j, e);
            float v = (float)acc[m][j][e] * (sw[c] * sx[r]);
            if (skip) v = v + proj[m][j][e];
            y[r * ldy + c] = fmaxf(v + bias[c], 0.0f);
          }
    }
    __syncthreads();
    on_layer(l);
    if (l + 1 < tr.depth) quantize_rows(y, ldy, width, xq, ldq, sx);
  }
}

}  // namespace mnt
