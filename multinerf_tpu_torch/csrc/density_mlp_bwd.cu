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
//   * da_{l-1} = (bf16(da_l) @ bf16(W_l)^T) * (act_{l-1} > 0), the masks
//     taken from the f32 recomputed activations.
//
// What bounds it: at the 360 config (4 x 256 trunk, N = 262,144 samples per
// proposal level) the recomputed forward is 172 GFLOP, the three dX
// products 103 GFLOP and the four dW products 172 GFLOP, so the tensor
// cores bound it (0.45 ms at the bf16 peak).  Design, in two passes:
//   1. the tile pass: a persistent CTA per SM walks 128-sample tiles.  Two
//      consumer warpgroups own 64 samples each; one producer warp streams
//      the trunk with TMA, in 32-deep k slabs of 16 KB, through a 4-stage
//      mbarrier ring that both warpgroups read (W_l's rows for the forward,
//      its columns, i.e. W_l^T as a K-major operand, for the backward), so
//      each slab serves 128 samples and three slabs are in flight while one
//      is multiplied.  Products are wgmma m64n256k16 with the
//      activations (K-major, 128-byte swizzled) in shared memory.  The
//      epilogues work on the accumulators in registers: bias, ReLU, the
//      bf16 rounding, the ReLU masks (kept as bits, 32 bytes per sample and
//      hidden layer), and the column sums (db_l, dwd) by shuffles and a
//      fixed-order warp sum into a per-tile, per-warpgroup slot.  Every bf16
//      tile a dW product needs (features, activations, cotangents: 4.6 KB
//      a sample) goes to device memory by TMA stores from the swizzled
//      tiles, overlapping the next product;
//   2. the four dW products run on the TMA + wgmma GEMM of wgmma_dw.cuh,
//      reading those bf16 rows; the per-slot column sums are reduced in
//      slot order.
// The ring, the producer's forward slabs, the tile product, the featurizer
// into the swizzled tile and the bias + ReLU + bf16 epilogue are K1's too
// (tile_pass.cuh).
// Wide features (blender_512.gin and llff_512.gin: 16 degrees, 672
// features) would need a [64][704] feature tile per warpgroup, 276,032
// bytes in all, over the card's 232,448.  There layer 0 runs in two
// K-parts (parts = 2): the sin half of the features, then the cos half,
// each featurized into the tile (the featurizer computes both and keeps
// one: twice its ALU work) padded to kx = 384 columns, which fits the
// [64][2W] activation buffers.  Layer 0's product accumulates over the
// parts in the features' own order (the padding columns add exact zeros),
// and w0's rows and the feats scratch of the dW_0 GEMM are laid out part
// by part, [parts * kx] rows; the reduction of dW_0's split partials drops
// the padding rows.  360.gin (504 features, kx = 512 = 2W) keeps one part.
// Every sum has a fixed order (no atomics), so the result is bitwise
// deterministic.

#include <cuda_runtime.h>

#include "tile_pass.cuh"

namespace mnt {

struct DensityMlpBwd;  // Names this kernel's dW GEMMs in a profile.

// Shared memory of the tile pass (byte offsets from a 1,024-aligned base).
struct BwdLayout {
  int x_bytes;     // One warpgroup's operand tile: a feature part, later 2
                   // activation buffers.
  int slab_bytes;  // One ring stage: a 32-deep k slab of a trunk layer.
  int ring, masks, aux, aux_bytes, g, bars;
  int total;  // Bytes to request, with the alignment slack.
};

// kx: the columns of one feature part (features rounded up to 64 with one
// part, half of them rounded up to 64 with two).
__host__ __device__ inline BwdLayout bwd_layout(int width, int depth, int kx,
                                                int num_dims) {
  BwdLayout l;
  l.x_bytes = (kx > 2 * width ? kx : 2 * width) * 128;
  l.slab_bytes = width * kSlabK * 2;
  l.ring = 2 * l.x_bytes;
  l.masks = l.ring + kRing * l.slab_bytes;
  // Two column-sum buffers of [4 warps][width] floats per warpgroup, which
  // also hold the featurizer's scratch at the start of a tile.
  const int colsum = 2 * 4 * width * 4;
  const int feat = featurizer_smem_floats(num_dims, 64) * 4;
  l.aux_bytes = round_up(colsum > feat ? colsum : feat, 16);
  l.aux = l.masks + (depth - 1) * kConsumerThreads * (width / 64) * 4;
  l.g = l.aux + 2 * l.aux_bytes;
  l.bars = l.g + kTileRows * 4;
  l.total = l.bars + 2 * kRing * 8 + 1024;
  return l;
}

// Sum over the 8 lanes that share lane % 4 (the warp's 16 rows, given the
// thread's two rows already added): lanes 0..3 hold the column sums.
__device__ __forceinline__ float rows_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// Features lo .. lo + cols - 1 of samples row0 .. row0 + 63 into columns
// 0 .. cols - 1 of the operand tile x, columns cols .. kx - 1 zero: the sin
// half (lo = 0) or the cos half (lo = F/2) of the features, the featurizer
// computing both.  As featurize_tile otherwise; the caller fences for the
// async proxy and syncs the warpgroup.
__device__ __forceinline__ void featurize_part(
    const float* __restrict__ means, const float* __restrict__ covs,
    const float* __restrict__ basis_t, const float* __restrict__ bb_t,
    int row0, int n, int num_dims, int num_degs, bool use_contract, int lo,
    int cols, int kx, unsigned char* x, float* scratch, int wtid,
    int bar_id) {
  featurize_rows<64>(
      means, covs, basis_t, bb_t, row0, n, num_dims, num_degs, use_contract,
      scratch, wtid, 128, 2 * num_degs * num_dims,
      [=](int s, int f, __nv_bfloat16 v) {
        const unsigned c = (unsigned)(f - lo);
        if (c < (unsigned)cols)
          *reinterpret_cast<__nv_bfloat16*>(x + swizzled_offset(s, c)) = v;
      },
      [=] { named_sync(bar_id, 128); });
  const int extra = kx - cols;
  for (int i = wtid; i < 64 * extra; i += 128) {
    const int s = i / extra;
    *reinterpret_cast<__nv_bfloat16*>(
        x + swizzled_offset(s, cols + i - s * extra)) =
        __float2bfloat16_rn(0.0f);
  }
}

template <int W, int kParts>
__global__ void __launch_bounds__(kHopperThreads, 1)
density_mlp_bwd_tile_kernel(
    const __grid_constant__ CUtensorMap w0_map,    // w0 [kParts * kx][W]
    const __grid_constant__ CUtensorMap wh_map,    // w_hidden [(L-1)W][W]
    const __grid_constant__ CUtensorMap wh_t_map,  // the same, [W][32] boxes
    const __grid_constant__ CUtensorMap feats_map,  // [n_pad][kParts * kx]
    const __grid_constant__ CUtensorMap acts_map,   // acts [(L-1)n_pad][W]
    const __grid_constant__ CUtensorMap das_map,    // das [L n_pad][W]
    const float* __restrict__ means, const float* __restrict__ covs,
    const float* __restrict__ basis_t, const float* __restrict__ bb_t,
    const float* __restrict__ biases, const float* __restrict__ wd,
    const float* __restrict__ g, float* __restrict__ vec_part, int n,
    int n_pad, int depth, int num_dims, int num_degs, int use_contract,
    int kx) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const BwdLayout lay = bwd_layout(W, depth, kx, num_dims);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  const SlabRing ring{smem + lay.ring, full, full + kRing, lay.slab_bytes,
                      kRing};
  const int tiles = n_pad / kTileRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) ring_init(ring);
  __syncthreads();

  if (warp == kProducerWarp) {
    // The slab sequence of one tile, repeated per tile: W_0's rows, then
    // each hidden layer's rows, then their columns from the last layer down.
    if (lane == 0) {
      RingPos it;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        produce_trunk_forward<W>(ring, it, &w0_map, &wh_map, kParts * kx,
                                 depth);
        for (int l = depth - 1; l >= 1; --l)
          for (int kb = 0; kb < W / kSlabK; ++kb) {
            uint64_t* bar;
            unsigned char* dst = ring_acquire(ring, it, bar);
            tma_load(dst, &wh_t_map, bar, kb * kSlabK, (l - 1) * W);
          }
      }
    }
    return;
  }

  const int wg = warp / 4;            // Consumer warpgroup: 0 or 1.
  const int wq = warp % 4;            // Warp in the warpgroup.
  const int wtid = threadIdx.x % 128;  // Thread in the warpgroup.
  const int bar_id = 1 + wg;
  unsigned char* x = smem + wg * lay.x_bytes;
  unsigned char* buf[2] = {x, x + W * 128};
  uint32_t* masks =
      reinterpret_cast<uint32_t*>(smem + lay.masks) + threadIdx.x;
  float* aux = reinterpret_cast<float*>(smem + lay.aux + wg * lay.aux_bytes);
  float* g_s = reinterpret_cast<float*>(smem + lay.g) + wg * 64;
  const int vstride = (depth + 1) * W + 1;
  const AccPos pos(wtid);
  const int r_lo = pos.r_lo;  // This thread's rows: r_lo, r_lo + 8.
  const int c_lo = pos.c_lo;  // Its first column in each 8.
  RingPos it;
  float acc[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) acc[i] = 0.0f;

  // bf16 (v0, v1) to row r_lo + 8h, columns 8q + c_lo + {0, 1} of dst.
  auto put = [&](unsigned char* dst, int q, int h, float v0, float v1) {
    put_bf16x2(dst, r_lo + 8 * h, q * 8 + c_lo, v0, v1);
  };
  // Lanes 0..3 of each warp leave its 16 rows' sum of columns 8q + c_lo
  // + {0, 1} in column-sum buffer b.
  auto col_sums = [&](int b, int q, float s0, float s1) {
    s0 = rows_sum(s0);
    s1 = rows_sum(s1);
    if (lane < 4) {
      float* dst = aux + (b * 4 + wq) * W + q * 8 + c_lo;
      dst[0] = s0;
      dst[1] = s1;
    }
  };
  // Before writing an operand buffer: the TMA stores have read it.
  auto begin_write = [&] {
    if (wtid == 0) bulk_wait_read();
    named_sync(bar_id, 128);
  };
  // After writing one: publish it to the async proxy, store it by TMA to
  // columns col0 .. col0 + cols - 1 of `map`'s rows row ..
  auto end_write = [&](const unsigned char* src, const CUtensorMap* map,
                       int row, int col0, int cols) {
    fence_proxy_async();
    named_sync(bar_id, 128);
    if (wtid == 0) {
      for (int kb = 0; kb < cols / 64; ++kb)
        tma_store(map, src + kb * kBoxBytes, col0 + kb * 64, row);
      bulk_commit();
    }
  };
  // Column-sum buffer b, warps in order, to vec[off ..].
  auto flush = [&](float* vec, int b, int off) {
    for (int col = wtid; col < W; col += 128) {
      const float* s = aux + b * 4 * W + col;
      vec[off + col] = ((s[0] + s[W]) + s[2 * W]) + s[3 * W];
    }
  };

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * kTileRows + wg * 64;
    float* vec = vec_part + (size_t)(2 * tile + wg) * vstride;
    begin_write();  // The last tile's stores, and its column sums, are done.
    // Samples past n get g = 0, so every cotangent they produce is 0.
    if (wtid < 64) g_s[wtid] = row0 + wtid < n ? g[row0 + wtid] : 0.0f;

    if constexpr (kParts == 1) {
      featurize_tile(means, covs, basis_t, bb_t, row0, n, num_dims,
                     num_degs, use_contract != 0, kx, x, aux, wtid, bar_id);
      end_write(x, &feats_map, row0, 0, kx);
    }

    // Forward.  Layer l reads `in` and writes buf[cur]; the last layer's
    // epilogue starts the backward pass (da_L, dwd, db_L).  With two parts,
    // layer 0 multiplies the features part by part, each part featurized
    // into x and stored to its columns of feats.
    const unsigned char* in = x;
    int k_slabs = kx / kSlabK;
    int cur = 0;
    for (int l = 0; l < depth; ++l) {
      if constexpr (kParts == 1) {
        tile_product<W, true>(acc, in, k_slabs, ring, it, lane);
      } else {
        const int cols = num_degs * num_dims;  // Features of one part.
        for (int p = 0; p < (l == 0 ? kParts : 1); ++p) {
          if (l == 0) {
            if (p > 0) begin_write();  // Part p - 1's stores and products.
            featurize_part(means, covs, basis_t, bb_t, row0, n, num_dims,
                           num_degs, use_contract != 0, p * cols, cols, kx,
                           x, aux, wtid, bar_id);
            end_write(x, &feats_map, row0, p * kx, kx);
          }
          tile_product<W, true>(acc, in, k_slabs, ring, it, lane, p > 0);
        }
      }
      const float* bias = biases + (size_t)l * W;
      unsigned char* dst = buf[cur];
      begin_write();
      if (l < depth - 1) {
        uint32_t bits[W / 64];
#pragma unroll
        for (int w = 0; w < W / 64; ++w) bits[w] = 0u;
        bias_relu_bf16<W>(acc, bias, dst, pos, [&](int i, float v0,
                                                   float v1) {
          bits[i >> 5] |= (v0 > 0.0f ? 1u : 0u) << (i & 31);
          bits[i >> 5] |= (v1 > 0.0f ? 1u : 0u) << ((i + 1) & 31);
        });
#pragma unroll
        for (int w = 0; w < W / 64; ++w)
          masks[(l * (W / 64) + w) * kConsumerThreads] = bits[w];
        end_write(dst, &acts_map, l * n_pad + row0, 0, W);
      } else {
        const float g0 = g_s[r_lo], g1 = g_s[r_lo + 8];
#pragma unroll
        for (int q = 0; q < W / 8; ++q) {
          const int col = q * 8 + c_lo;
          const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
          const float wd0 = __ldg(wd + col), wd1 = __ldg(wd + col + 1);
          float a[4], da[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            a[e] = fmaxf(acc[4 * q + e] + (e & 1 ? b1 : b0), 0.0f);
            const float gs = e < 2 ? g0 : g1;
            da[e] = a[e] > 0.0f ? (e & 1 ? wd1 : wd0) * gs : 0.0f;
          }
          put(dst, q, 0, da[0], da[1]);
          put(dst, q, 1, da[2], da[3]);
          col_sums(0, q, da[0] + da[2], da[1] + da[3]);
          col_sums(1, q, a[0] * g0 + a[2] * g1, a[1] * g0 + a[3] * g1);
        }
        end_write(dst, &das_map, l * n_pad + row0, 0, W);
        flush(vec, 0, l * W);      // db_L
        flush(vec, 1, depth * W);  // dwd
        if (wtid == 0) {
          float sum = 0.0f;
          for (int s = 0; s < 64; ++s) sum += g_s[s];
          vec[(size_t)(depth + 1) * W] = sum;  // dbd
        }
      }
      in = dst;
      k_slabs = W / kSlabK;
      cur ^= 1;
    }

    // Backward through the hidden layers: da_{l-1} from da_l (in `in`).
    for (int l = depth - 1; l >= 1; --l) {
      tile_product<W, false>(acc, in, W / kSlabK, ring, it, lane);
      unsigned char* dst = buf[cur];
      begin_write();
      uint32_t bits[W / 64];
#pragma unroll
      for (int w = 0; w < W / 64; ++w)
        bits[w] = masks[((l - 1) * (W / 64) + w) * kConsumerThreads];
#pragma unroll
      for (int q = 0; q < W / 8; ++q) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * q + e;
          v[e] = (bits[i >> 5] >> (i & 31)) & 1u ? acc[i] : 0.0f;
        }
        put(dst, q, 0, v[0], v[1]);
        put(dst, q, 1, v[2], v[3]);
        col_sums(0, q, v[0] + v[2], v[1] + v[3]);
      }
      end_write(dst, &das_map, (l - 1) * n_pad + row0, 0, W);
      flush(vec, 0, (l - 1) * W);  // db_{l-1}
      in = dst;
      cur ^= 1;
    }
  }
  if (wtid == 0) bulk_wait();
}

template <int W, int kParts>
cudaError_t tile_pass_parts(const CUtensorMap* maps, const void* means,
                            const void* covs, const void* basis_t,
                            const void* bb_t, const void* biases,
                            const void* wd, const void* g, void* vec_part,
                            int n, int n_pad, int depth, int num_dims,
                            int num_degs, int use_contract, int kx, int grid,
                            int smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      density_mlp_bwd_tile_kernel<W, kParts>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  density_mlp_bwd_tile_kernel<W, kParts><<<grid, kHopperThreads, smem, st>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], f32(means),
      f32(covs), f32(basis_t), f32(bb_t), f32(biases), f32(wd), f32(g),
      static_cast<float*>(vec_part), n, n_pad, depth, num_dims, num_degs,
      use_contract, kx);
  return cudaGetLastError();
}

template <int W>
cudaError_t tile_pass(const CUtensorMap* maps, const void* means,
                      const void* covs, const void* basis_t,
                      const void* bb_t, const void* biases, const void* wd,
                      const void* g, void* vec_part, int n, int n_pad,
                      int depth, int num_dims, int num_degs,
                      int use_contract, int kx, int parts, int grid,
                      int smem, cudaStream_t st) {
  return (parts == 1 ? tile_pass_parts<W, 1> : tile_pass_parts<W, 2>)(
      maps, means, covs, basis_t, bb_t, biases, wd, g, vec_part, n, n_pad,
      depth, num_dims, num_degs, use_contract, kx, grid, smem, st);
}

}  // namespace mnt

// The columns of one feature part of layer 0: F rounded up to 64 with one
// part, F/2 rounded up to 64 with two.
__host__ __device__ inline int bwd_part_cols(int num_feats, int parts) {
  return mnt::round_up(parts == 1 ? num_feats : num_feats / 2, 64);
}

// Inputs: w0 bf16 [parts * kx][width] (kx = bwd_part_cols; part p holds
// features p * F / parts .. in rows p * kx .., the other rows zero),
// w_hidden bf16 [depth-1][width][width], biases f32 [depth][width], wd f32
// [width], g f32 [n]; width is 64, 128 or 256 (the caller pads narrower
// trunks with zeros) and parts is 1 or 2 (plans.density_mlp_bwd_plan).
// Scratch (allocated by the caller): feats bf16 [n_pad][parts * kx], acts
// bf16 [depth-1][n_pad][width], das bf16 [depth][n_pad][width], vec_part
// f32 [2 * tiles][(depth+1)*width + 1], part f32 for the dW partials (the
// larger of splits0 * parts * kx and splits1 * width rows of width
// floats); n_pad = tiles * 128.  Outputs: dw_out, dW_0
// [F][width] then dW_1.. [width][width] back to back; vec_out, db_0.., dwd
// [width] and dbd.  grid: CTAs of the tile pass; (bn, splits, per) the plans
// of the dW_0 and dW_1.. GEMMs (plans.py).
extern "C" int density_mlp_backward(
    const void* means, const void* covs, const void* basis_t,
    const void* bb_t, const void* w0, const void* w_hidden,
    const void* biases, const void* wd, const void* g, void* feats,
    void* acts, void* das, void* vec_part, void* part, void* dw_out,
    void* vec_out, int n, int width, int depth, int num_dims, int num_degs,
    int use_contract, int parts, int grid, int bn0, int splits0, int per0,
    int bn1, int splits1, int per1, void* stream) {
  using namespace mnt;
  const int num_feats = 2 * num_degs * num_dims;
  const int kx = bwd_part_cols(num_feats, parts);
  const int k0 = parts * kx;  // Rows of w0, columns of feats.
  const int tiles = (n + kTileRows - 1) / kTileRows;
  const long long n_pad = (long long)tiles * kTileRows;
  if (depth < 2 || n < 1 || grid < 1 || depth * n_pad >= (1ll << 31) ||
      (parts != 1 && parts != 2))
    return (int)cudaErrorInvalidValue;
  const int smem = bwd_layout(width, depth, kx, num_dims).total;
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap maps[6];
  const long long hidden_rows = (long long)(depth - 1) * width;
  cudaError_t err = bf16_tile_map(&maps[0], w0, k0, width, kSlabK);
  if (err == cudaSuccess)
    err = bf16_tile_map(&maps[1], w_hidden, hidden_rows, width, kSlabK);
  if (err == cudaSuccess)
    err = bf16_tile_map(&maps[2], w_hidden, hidden_rows, width, width,
                        kSlabK);
  if (err == cudaSuccess)
    err = bf16_tile_map(&maps[3], feats, n_pad, k0, 64);
  if (err == cudaSuccess)
    err = bf16_tile_map(&maps[4], acts, (depth - 1) * n_pad, width, 64);
  if (err == cudaSuccess)
    err = bf16_tile_map(&maps[5], das, depth * n_pad, width, 64);
  if (err != cudaSuccess) return (int)err;
  const int np = (int)n_pad;
  if (width == 256)
    err = tile_pass<256>(maps, means, covs, basis_t, bb_t, biases, wd, g,
                         vec_part, n, np, depth, num_dims, num_degs,
                         use_contract, kx, parts, grid, smem, st);
  else if (width == 128)
    err = tile_pass<128>(maps, means, covs, basis_t, bb_t, biases, wd, g,
                         vec_part, n, np, depth, num_dims, num_degs,
                         use_contract, kx, parts, grid, smem, st);
  else if (width == 64)
    err = tile_pass<64>(maps, means, covs, basis_t, bb_t, biases, wd, g,
                        vec_part, n, np, depth, num_dims, num_degs,
                        use_contract, kx, parts, grid, smem, st);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;

  float* dw = static_cast<float*>(dw_out);
  float* part_f = static_cast<float*>(part);
  const __nv_bfloat16* acts_b = static_cast<const __nv_bfloat16*>(acts);
  const __nv_bfloat16* das_b = static_cast<const __nv_bfloat16*>(das);
  // dW_0: with two parts, the GEMM's [k0][width] partials reduced part by
  // part into the F rows (the padding rows of each part dropped).
  const int half = num_feats / parts;
  err = dw_gemm<DensityMlpBwd>(feats, das_b, n_pad, k0, width,
                               parts == 1 ? num_feats : 0, bn0, splits0,
                               per0, part_f, dw, st);
  for (int p = 0; parts > 1 && p < parts && err == cudaSuccess; ++p)
    err = reduce_splits(part_f + (size_t)p * kx * width, splits0,
                        (long long)k0 * width, (long long)half * width,
                        dw + (size_t)p * half * width, st);
  if (err != cudaSuccess) return (int)err;
  dw += (size_t)num_feats * width;
  for (int l = 1; l < depth; ++l) {
    err = dw_gemm<DensityMlpBwd>(acts_b + (size_t)(l - 1) * n_pad * width,
                                 das_b + (size_t)l * n_pad * width, n_pad,
                                 width, width, width, bn1, splits1, per1,
                                 part_f, dw, st);
    if (err != cudaSuccess) return (int)err;
    dw += (size_t)width * width;
  }
  const long long vstride = (long long)(depth + 1) * width + 1;
  return (int)reduce_splits(static_cast<const float*>(vec_part), 2 * tiles,
                            vstride, vstride, static_cast<float*>(vec_out),
                            st);
}

// Dynamic shared memory of the tile pass, for the launch plans' checks.
extern "C" int density_mlp_bwd_smem(int width, int depth, int num_feats,
                                    int num_dims, int parts) {
  using namespace mnt;
  return bwd_layout(width, depth, bwd_part_cols(num_feats, parts), num_dims)
      .total;
}
