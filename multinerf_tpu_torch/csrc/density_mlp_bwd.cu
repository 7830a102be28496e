// Backward of the fully fused density MLP for Hopper (sm_90a): every trunk
// weight and bias gradient and the density head's, from the cotangent g[N]
// of the raw density.  The sample positions get no gradient (stop-gradient
// inputs, as in the TPU kernel).
//
// Replaces the TPU kernel multinerf_tpu/ops/pallas/density_mlp.py
// (_bwd_kernel, reached through pallas_call in _grad) and follows its
// numerics, which are not autograd's of the forward:
//   * the trunk's forward is recomputed per tile (f32 accumulation, ReLU);
//   * dwd = sum act_L * g with the f32 last activation, dbd = sum g;
//   * da_L = wd * g * (act_L > 0) with the f32 head weight wd;
//   * dW_l += bf16(x_in)^T @ bf16(da_l), x_in the bf16 features at l = 0
//     and the bf16 activation of layer l-1 otherwise; db_l += sum da_l (f32);
//   * da_{l-1} = (bf16(da_l) @ bf16(W_l)^T) * (act_{l-1} > 0).
// The ReLU masks of the hidden layers are read from the bf16 activations
// kept in shared memory: a positive f32 activation rounds to a positive
// bf16 unless it is below ~1e-40, where the two masks could differ.
//
// What bounds it: at the 360 config (4 x 256 trunk, N = 262,144 samples per
// proposal level) the recomputed forward is 172 GFLOP, the three dX
// products 103 GFLOP and the four dW products 172 GFLOP, so the tensor
// cores bound it.  Design, in two passes:
//   1. one block per 64-sample tile recomputes the features and the trunk
//      with the activations ping-ponged in shared memory (as K1 does), then
//      walks the trunk backwards, writing every bf16 da_l and every bf16
//      hidden activation to device memory (3.5 KB per sample), and its
//      tile's f32 column sums (db_l, dwd, dbd) to a per-tile slot;
//   2. the four dW products run as the split-K partials + ordered reduce
//      of dw_accumulate.cuh (dW_0 recomputes the features), and the
//      per-tile slots are summed in tile order.
// The Pallas grid instead accumulated into one resident output in order; a
// parallel grid doing that would race, and atomics would make the sums
// depend on the schedule.  Here every sum has a fixed order, so the result
// is bitwise-deterministic.  No TMA/wgmma pipeline yet.

#include <cuda_runtime.h>

#include "dw_accumulate.cuh"

namespace mnt {

// One warp's 64 x 32 block at column col0 of act[kTile][k_dim] @ w^T, where
// w is row-major with row stride ldw: output column j reads w's row j.
__device__ __forceinline__ void warp_tile_product_wt(
    const __nv_bfloat16* act, int lda, const __nv_bfloat16* __restrict__ w,
    int ldw, int k_dim, int col0, FragC (&acc)[kTile / 16][2]) {
  for (int r = 0; r < kTile / 16; ++r)
    for (int c = 0; c < 2; ++c) wmma::fill_fragment(acc[r][c], 0.0f);
  FragA a;
  FragBCol b0, b1;
  for (int k = 0; k < k_dim; k += 16) {
    wmma::load_matrix_sync(b0, w + (size_t)col0 * ldw + k, ldw);
    wmma::load_matrix_sync(b1, w + (size_t)(col0 + 16) * ldw + k, ldw);
    for (int r = 0; r < kTile / 16; ++r) {
      wmma::load_matrix_sync(a, act + (size_t)(r * 16) * lda + k, lda);
      wmma::mma_sync(acc[r][0], a, b0, acc[r][0]);
      wmma::mma_sync(acc[r][1], a, b1, acc[r][1]);
    }
  }
}

// Lanes 0..15 return the sum of column `lane` of a 16 x 16 stage tile,
// rows in order.
__device__ __forceinline__ float stage_column_sum(const float* stage,
                                                  int lane) {
  float sum = 0.0f;
  if (lane < 16)
    for (int r = 0; r < 16; ++r) sum += stage[r * 16 + lane];
  return sum;
}

// Stores 8 bf16 values as one 16-byte word (dst 16-byte aligned).
__device__ __forceinline__ void store8_bf16(__nv_bfloat16* dst,
                                            const float (&v)[8]) {
  uint4 word;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&word);
  for (int j = 0; j < 4; ++j)
    h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  *reinterpret_cast<uint4*>(dst) = word;
}

struct BwdSmem {
  int act_bytes;  // One [kTile][width + 8] bf16 tile.
  int x_bytes;    // The features, later the two da tiles.
  size_t total;
};

__host__ __device__ inline BwdSmem bwd_smem(int width, int depth, int kpad,
                                            int num_dims) {
  BwdSmem s;
  s.act_bytes = round_up(kTile * tile_stride(width) * 2, 128);
  const int feat_bytes = round_up(kTile * tile_stride(kpad) * 2, 128);
  s.x_bytes = feat_bytes > 2 * s.act_bytes ? feat_bytes : 2 * s.act_bytes;
  s.total = (size_t)s.x_bytes + (size_t)(depth - 1) * s.act_bytes +
            (kWarps * 256 + kTile + width + featurizer_smem_floats(num_dims)) *
                sizeof(float);
  return s;
}

__global__ void __launch_bounds__(kThreads, 1)
density_mlp_bwd_tile_kernel(const float* __restrict__ means,
                            const float* __restrict__ covs,
                            const float* __restrict__ basis_t,
                            const float* __restrict__ bb_t,
                            const __nv_bfloat16* __restrict__ w0,
                            const __nv_bfloat16* __restrict__ w_hidden,
                            const float* __restrict__ biases,
                            const float* __restrict__ wd,
                            const float* __restrict__ g,
                            __nv_bfloat16* __restrict__ acts_out,
                            __nv_bfloat16* __restrict__ das_out,
                            float* __restrict__ vec_part, int n, int n_pad,
                            int width, int depth, int num_dims, int num_degs,
                            int use_contract) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int kpad = padded_feats(2 * num_degs * num_dims);
  const int ldf = tile_stride(kpad);
  const int ldw = tile_stride(width);
  const BwdSmem lay = bwd_smem(width, depth, kpad, num_dims);
  const int act_elems = lay.act_bytes / 2;
  __nv_bfloat16* feats = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* da_buf[2] = {
      reinterpret_cast<__nv_bfloat16*>(smem),
      reinterpret_cast<__nv_bfloat16*>(smem + lay.act_bytes)};
  __nv_bfloat16* acts =
      reinterpret_cast<__nv_bfloat16*>(smem + lay.x_bytes);  // depth - 1
  float* stage = reinterpret_cast<float*>(
      smem + lay.x_bytes + (size_t)(depth - 1) * lay.act_bytes);
  float* g_s = stage + kWarps * 256;
  float* wd_s = g_s + kTile;
  float* scratch = wd_s + width;

  const long long row0 = (long long)blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  float* my_stage = stage + warp * 256;
  float* vec = vec_part + (size_t)blockIdx.x * ((depth + 1) * width + 1);
  const int rr = lane / 2;        // Epilogue: this lane's row in a 16 x 16
  const int cc = (lane % 2) * 8;  // tile, and its first of 8 columns.

  // Samples past n get g = 0, so every cotangent they produce is 0.
  for (int s = tid; s < kTile; s += blockDim.x)
    g_s[s] = row0 + s < n ? g[row0 + s] : 0.0f;
  for (int c = tid; c < width; c += blockDim.x) wd_s[c] = wd[c];
  tile_features(means, covs, basis_t, bb_t, row0, n, num_dims, num_degs,
                use_contract != 0, scratch, feats, ldf);

  // Forward: layer l reads `in` and writes act_l, except the last layer,
  // whose epilogue starts the backward pass (da_L, dwd, db_L).
  FragC acc[kTile / 16][2];
  const __nv_bfloat16* in = feats;
  int ldi = ldf;
  int k_dim = kpad;
  for (int l = 0; l < depth; ++l) {
    const __nv_bfloat16* w =
        l == 0 ? w0 : w_hidden + (size_t)(l - 1) * width * width;
    const float* bias = biases + (size_t)l * width;
    const bool last = l == depth - 1;
    __nv_bfloat16* act = acts + (size_t)l * act_elems;
    __nv_bfloat16* act_g = acts_out + ((size_t)l * n_pad + row0) * width;
    __nv_bfloat16* da = da_buf[0];
    __nv_bfloat16* da_g =
        das_out + ((size_t)(depth - 1) * n_pad + row0) * width;
    for (int col0 = warp * 32; col0 < width; col0 += kWarps * 32) {
      warp_tile_product(in, ldi, w, width, k_dim, col0, acc);
      float cs_db[2] = {0.0f, 0.0f};
      float cs_dwd[2] = {0.0f, 0.0f};
      for (int r = 0; r < kTile / 16; ++r) {
        for (int c = 0; c < 2; ++c) {
          wmma::store_matrix_sync(my_stage, acc[r][c], 16,
                                  wmma::mem_row_major);
          __syncwarp();
          const int s = r * 16 + rr;
          const int col = col0 + c * 16 + cc;
          float* src = my_stage + rr * 16 + cc;
          if (!last) {
            float v[8];
            for (int j = 0; j < 8; ++j)
              v[j] = fmaxf(src[j] + bias[col + j], 0.0f);
            store8_bf16(act + s * ldw + col, v);
            store8_bf16(act_g + (size_t)s * width + col, v);
            __syncwarp();
            continue;
          }
          const float gs = g_s[s];
          float dav[8];
          for (int j = 0; j < 8; ++j) {
            const float a = fmaxf(src[j] + bias[col + j], 0.0f);
            dav[j] = a > 0.0f ? wd_s[col + j] * gs : 0.0f;
            src[j] = a * gs;
          }
          __syncwarp();
          cs_dwd[c] += stage_column_sum(my_stage, lane);
          __syncwarp();
          for (int j = 0; j < 8; ++j) src[j] = dav[j];
          store8_bf16(da + s * ldw + col, dav);
          store8_bf16(da_g + (size_t)s * width + col, dav);
          __syncwarp();
          cs_db[c] += stage_column_sum(my_stage, lane);
          __syncwarp();
        }
      }
      if (last && lane < 16) {
        for (int c = 0; c < 2; ++c) {
          const int col = col0 + c * 16 + lane;
          vec[(size_t)(depth - 1) * width + col] = cs_db[c];
          vec[(size_t)depth * width + col] = cs_dwd[c];
        }
      }
    }
    __syncthreads();
    in = act;
    ldi = ldw;
    k_dim = width;
  }

  // Backward through the hidden layers: da_{l-1} from da_l.
  int cur = 0;
  for (int l = depth - 1; l >= 1; --l) {
    const __nv_bfloat16* w = w_hidden + (size_t)(l - 1) * width * width;
    const __nv_bfloat16* mask = acts + (size_t)(l - 1) * act_elems;
    const __nv_bfloat16* da_in = da_buf[cur];
    __nv_bfloat16* da = da_buf[1 - cur];
    __nv_bfloat16* da_g = das_out + ((size_t)(l - 1) * n_pad + row0) * width;
    for (int col0 = warp * 32; col0 < width; col0 += kWarps * 32) {
      warp_tile_product_wt(da_in, ldw, w, width, width, col0, acc);
      float cs_db[2] = {0.0f, 0.0f};
      for (int r = 0; r < kTile / 16; ++r) {
        for (int c = 0; c < 2; ++c) {
          wmma::store_matrix_sync(my_stage, acc[r][c], 16,
                                  wmma::mem_row_major);
          __syncwarp();
          const int s = r * 16 + rr;
          const int col = col0 + c * 16 + cc;
          float* src = my_stage + rr * 16 + cc;
          const uint4 mword =
              *reinterpret_cast<const uint4*>(mask + s * ldw + col);
          const __nv_bfloat16* m8 =
              reinterpret_cast<const __nv_bfloat16*>(&mword);
          float v[8];
          for (int j = 0; j < 8; ++j) {
            v[j] = __bfloat162float(m8[j]) > 0.0f ? src[j] : 0.0f;
            src[j] = v[j];
          }
          store8_bf16(da + s * ldw + col, v);
          store8_bf16(da_g + (size_t)s * width + col, v);
          __syncwarp();
          cs_db[c] += stage_column_sum(my_stage, lane);
          __syncwarp();
        }
      }
      if (lane < 16) {
        for (int c = 0; c < 2; ++c)
          vec[(size_t)(l - 1) * width + col0 + c * 16 + lane] = cs_db[c];
      }
    }
    __syncthreads();
    cur = 1 - cur;
  }

  if (tid == 0) {
    float sum = 0.0f;
    for (int s = 0; s < kTile; ++s) sum += g_s[s];
    vec[(size_t)(depth + 1) * width] = sum;
  }
}

}  // namespace mnt

// Scratch (allocated by the caller): acts [depth-1][n_pad][width] bf16,
// das [depth][n_pad][width] bf16, vec_part [tiles][(depth+1)*width + 1] f32
// and part, the dW partials (the larger of splits0 * bm0 and splits1 * bm1
// rows of width floats).  Outputs: dw_out, dW_0 [F][width] then dW_1..
// [width][width] back to back; vec_out, db_0.., dwd [width] and dbd.
extern "C" int density_mlp_backward(
    const void* means, const void* covs, const void* basis_t,
    const void* bb_t, const void* w0, const void* w_hidden,
    const void* biases, const void* wd, const void* g, void* acts,
    void* das, void* vec_part, void* part, void* dw_out, void* vec_out,
    int n, int width, int depth, int num_dims, int num_degs,
    int use_contract, int bm0, int bn0, int splits0, int bm1, int bn1,
    int splits1, void* stream) {
  using namespace mnt;
  if (depth < 2 || width % 32 != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int kpad = padded_feats(2 * num_degs * num_dims);
  const size_t smem = bwd_smem(width, depth, kpad, num_dims).total;
  cudaError_t err = cudaFuncSetAttribute(
      density_mlp_bwd_tile_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (n + kTile - 1) / kTile;
  const int n_pad = tiles * kTile;
  auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  __nv_bfloat16* acts_b = static_cast<__nv_bfloat16*>(acts);
  __nv_bfloat16* das_b = static_cast<__nv_bfloat16*>(das);
  if (tiles > 0) {
    density_mlp_bwd_tile_kernel<<<tiles, kThreads, smem, st>>>(
        f32(means), f32(covs), f32(basis_t), f32(bb_t),
        static_cast<const __nv_bfloat16*>(w0),
        static_cast<const __nv_bfloat16*>(w_hidden), f32(biases), f32(wd),
        f32(g), acts_b, das_b, static_cast<float*>(vec_part), n, n_pad,
        width, depth, num_dims, num_degs, use_contract);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int num_feats = 2 * num_degs * num_dims;
  float* dw = static_cast<float*>(dw_out);
  float* part_f = static_cast<float*>(part);
  err = weight_gradient<true, __nv_bfloat16>(
      f32(means), f32(covs), f32(basis_t), f32(bb_t), num_dims, num_degs,
      use_contract, nullptr, 0, das_b, n, width, num_feats, bm0, bn0, splits0,
      part_f, dw, st);
  if (err != cudaSuccess) return (int)err;
  dw += (size_t)num_feats * width;
  for (int l = 1; l < depth; ++l) {
    err = weight_gradient<false, __nv_bfloat16>(
        nullptr, nullptr, nullptr, nullptr, num_dims, num_degs, use_contract,
        acts_b + (size_t)(l - 1) * n_pad * width, width,
        das_b + (size_t)l * n_pad * width, n, width, width, bm1, bn1, splits1,
        part_f, dw, st);
    if (err != cudaSuccess) return (int)err;
    dw += (size_t)width * width;
  }
  const long long vstride = (long long)(depth + 1) * width + 1;
  return (int)reduce_splits(static_cast<const float*>(vec_part), tiles,
                            vstride, vstride, static_cast<float*>(vec_out),
                            st);
}
