// The tile pass of the fused int8 NerfMLP trunk for Hopper (sm_90a): the
// trunk's forward over 64-sample tiles on wgmma, fed by TMA weight rings.
// The forward kernel K5 (int8_trunk.cu) runs it and writes the trunk's
// output; the backward K6 (int8_trunk_bwd.cu) runs it to recompute the
// activations, then walks back through the layers on the same machine.
//
// The numerics follow multinerf_tpu/ops/pallas/int8_trunk.py:69-147:
//   * layer 0: bf16 features @ bf16 W_0, f32 accumulation, + b_0, ReLU;
//   * layer l >= 1: the f32 input x is quantized per sample,
//     s = max(max_c |x_c|, 1e-30) / 127, q = rint(x / s) (the IEEE
//     quotient, ties to even); y = float(int32 sum of q * w_q) * (sw[col] *
//     s[row]), the product of the scales formed first; a skip layer then
//     adds the f32-accumulated bf16(features) @ bf16(W_tail); then + b_l,
//     then ReLU.
// The weights are quantized outside the kernels (ops/kernels/int8_trunk.py:
// quantize_weights, per output channel), as in the JAX package.
//
// One persistent CTA per SM walks the 64-sample tiles blockIdx.x,
// blockIdx.x + gridDim.x, ...  Both consumer warpgroups multiply the whole
// tile (wgmma's 64 rows); they split each layer's output columns, warpgroup
// w taking the BN-column blocks cb = w, w + 2, ...  Each warpgroup has its
// own ring of [BN][64-byte] weight slabs (K-major, 64-byte swizzle), fed by
// its own producer warp in the order it multiplies them: per tile, layer
// 0's W_0 (bf16), each hidden layer's w_q (int8) and, at a skip layer, its
// feature rows (bf16) (K6 then streams its dx weights).  (Two lanes of one
// warp spinning on two rings' barriers would take turns; the producers make
// up a third warpgroup, so that setmaxnreg can hand their registers to the
// consumers.)  The operands of the tile stay in shared memory as K-major
// 128-byte-swizzled tiles: the bf16 features F [64][kpad64], computed once
// per tile, and the int8 input A [64][W] of the layer being multiplied.
//
// A per-sample scale needs the sample's whole output row, [64][W] f32 =
// 256 KB at W = 1,024, more than shared memory holds.  So a layer runs in
// two passes: pass 1 multiplies column block by column block, and its
// epilogue hands each block to the caller, which stores it to device memory
// (K5: a per-CTA staging block of [64][W] f32 rows, 34.6 MB at 132 CTAs and
// W = 1,024, which stays in the 50 MB L2; K6: the scratch planes its dW
// products read anyway), and folds the rows' running absmax; pass 2, once
// both warpgroups are done with A, reads the tile's rows back (from L2,
// just written) and quantizes them per sample into A in place.  The rows
// of a last tile past n are featurized from zero means and covariances;
// their scales are their own, so they move no other row's value.
#pragma once

#include <type_traits>

#include "tile_pass.cuh"

namespace mnt {

constexpr int kI8Tile = 64;  // Samples per tile: wgmma's M.
constexpr int kI8Consumers = 256;
// Two consumer warpgroups, then a producer warpgroup whose first two warps
// feed one warpgroup's ring each.  setmaxnreg moves registers from the
// producers (40 each) to the consumers (232 each: 64 accumulators, the
// converted block and the epilogue's addresses).
constexpr int kI8TileThreads = kI8Consumers + 128;
constexpr int kI8ProducerRegs = 40, kI8ConsumerRegs = 232;
constexpr int kI8Bar = 1;        // Named barrier of both consumer warpgroups.
constexpr int kBatch = 8;        // Pass 2's loads in flight per thread.
constexpr int kI8WgBar = 2;      // + wg: a warpgroup's own barrier.
constexpr float kScaleFloor = 1e-30f;

// The features' k extent in the weight maps: a whole number of 32-deep bf16
// slabs (the columns past the features are zero).
__host__ __device__ inline int i8_kpad(int num_feats) {
  return round_up(num_feats, 32);
}

// rint(x / s) as an int8 bit pattern, with the IEEE quotient formed from
// r = RN(1 / s) by one product and one FMA correction (Markstein's: the
// correctly rounded quotient for normal operands).  div.rn's checks made
// pass 2 about 8 ms slower per K6 call at the 360 config on an H100
// (kernel_probe's pass2_divide, which also holds the two to the same
// outputs).
__device__ __forceinline__ unsigned quantize_byte(float x, float s, float r) {
  const float q = __fmul_rn(x, r);
  return (unsigned)(__float2int_rn(__fmaf_rn(__fmaf_rn(-q, s, x), r, q)) &
                    0xff);
}

// Byte b of row `row` of a K-major [64][bytes] tile of 128-byte-swizzled
// [64][128-byte] blocks (int8 A; for bf16, byte 2 * col: swizzled_offset).
__device__ __forceinline__ int swizzled_byte(int row, int b) {
  return (b >> 7) * kBoxBytes + row * 128 +
         ((((b & 127) >> 4) ^ (row & 7)) << 4) + (b & 15);
}

// Shared memory of the tile pass (byte offsets from a 1,024-aligned base).
struct I8TileLayout {
  int f, region, ring, slab, colred, rowmax, scale, recip, bars, total;
};

// `backward`: K6's layout, which adds the hybrid dx's bf16 [64][W] operand
// over A and F and the column-reduction buffers.
__host__ __device__ inline I8TileLayout i8_tile_layout(int width, int kpad64,
                                                       int num_dims, int bn,
                                                       int stages,
                                                       bool backward) {
  I8TileLayout l;
  // A [64][W] int8 at 0, in whole [64][128-byte] blocks (also the
  // featurizer's scratch while F is computed), F [64][kpad64] bf16 after
  // it; K6's hybrid dx: [64][W] bf16 at 0.
  const int scratch = featurizer_smem_floats(num_dims, kI8Tile) * 4;
  const int a_bytes = kI8Tile * round_up(width, 128);
  l.f = round_up(a_bytes > scratch ? a_bytes : scratch, 1024);
  const int fwd = l.f + kI8Tile * kpad64 * 2;
  const int hyb = backward ? kI8Tile * width * 2 : 0;
  l.region = round_up(fwd > hyb ? fwd : hyb, 1024);
  l.slab = bn * 64;
  l.ring = l.region;  // Ring w at ring + w * stages * slab.
  l.colred = l.ring + 2 * stages * l.slab;  // [2 wg][2][4 warps][BN] f32.
  l.rowmax = l.colred + (backward ? 2 * 2 * 4 * bn * 4 : 0);  // [2 wg][64].
  l.scale = l.rowmax + 2 * kI8Tile * 4;      // [64] f32.
  l.recip = l.scale + kI8Tile * 4;           // [64] f32: 1 / scale.
  l.bars = l.recip + kI8Tile * 4;            // Full, empty of both rings.
  l.total = l.bars + 2 * 2 * stages * 8 + 1024;
  return l;
}

// What the forward takes.  The trunk's weights (ops/kernels/int8_trunk.py:
// _operands) come through the tensor maps: w0t [W][kpad32] bf16 (layer 0,
// transposed, K zero-padded), wqt [depth-1][W][W] int8 (w_q of layers 1..,
// [out][in]) and tailt [skips][W][kpad32] bf16 (the skip layers' feature
// rows, transposed).
struct I8TrunkArgs {
  const float* means;
  const float* covs;
  const float* basis_t;
  const float* bb_t;
  const float* sw;      // [depth-1][W]: w_q's per-output-channel scales.
  const float* biases;  // [depth][W].
  int n, width, depth, kpad32, kpad64, num_dims, num_degs, use_contract;
  int stages, tiles;
  unsigned skip_mask;  // Bit l: layer l takes [x, features].
};

// The slot of skip layer l's bf16 rows among the trunk's feature blocks:
// 0 for W_0, 1 + its index among the skip layers for a skip layer (K6's d16
// planes use the same slots).
__host__ __device__ inline int feature_slot(unsigned skip_mask, int l) {
  int slot = 0;
  for (int k = 1; k <= l; ++k) slot += (skip_mask >> k) & 1u;
  return slot;
}

// The TMA map of a tile pass's weight operand, [rows][cols] K-major, in
// [bn][64-byte] slabs (64-byte swizzle): bf16 or int8.
inline cudaError_t i8_slab_map(CUtensorMap* m, const void* base, bool bf16,
                               long long rows, int cols, int bn) {
  return tile_map(m,
                  bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                       : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                  bf16 ? 2 : 1, base, rows, cols, bn, bf16 ? 32 : 64,
                  CU_TENSOR_MAP_SWIZZLE_64B);
}

// The forward's maps: maps[0] W_0, maps[1] w_q, maps[2] the tails; a map
// the trunk has no weights for repeats W_0 and is never read.
inline cudaError_t i8_forward_maps(CUtensorMap* maps, const void* w0t,
                                   const void* wqt, const void* tailt,
                                   int width, int depth, int kpad32,
                                   int skips, int bn) {
  cudaError_t err = i8_slab_map(&maps[0], w0t, true, width, kpad32, bn);
  if (err != cudaSuccess) return err;
  maps[1] = maps[2] = maps[0];
  if (depth > 1)
    err = i8_slab_map(&maps[1], wqt, false, (long long)(depth - 1) * width,
                      width, bn);
  if (err == cudaSuccess && skips > 0)
    err = i8_slab_map(&maps[2], tailt, true, (long long)skips * width,
                      kpad32, bn);
  return err;
}

// acc (+)= A @ B over k_slabs slabs of ring r: A a K-major tile at `a`
// (each slab 64 bytes of its k: 32 bf16 or 64 int8 values), B the ring's
// next slabs, [BN][64 bytes] K-major (64-byte swizzle).  T = float: bf16
// products (wgmma k16), T = int: s8 products (wgmma k32).  Each warp
// releases a slab once its products have read it.
template <int BN, typename T>
__device__ __forceinline__ void slab_product(T (&acc)[BN / 2],
                                             const unsigned char* a,
                                             int k_slabs, const SlabRing& r,
                                             RingPos& it, int lane,
                                             bool accumulate) {
  constexpr int kSteps = 2;  // wgmma k steps of 32 bytes per slab.
  // Zeroed here rather than by scale_d = 0: ptxas serializes wgmma when it
  // cannot tell which products read their accumulators.
  if (!accumulate) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = T(0);
  }
  int prev = 0;
  for (int kb = 0; kb < k_slabs; ++kb) {
    const int s = it.stage;
    mbar_wait(&r.full[s], it.phase);
    const unsigned char* b = r.base + s * r.slab_bytes;
    const unsigned char* a_kb = a + (kb >> 1) * kBoxBytes + (kb & 1) * 64;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const uint64_t da = smem_desc(a_kb + k * 32, 16, 1024);
      const uint64_t db = smem_desc(b + k * 32, 16, 512, kSwizzle64);
      if constexpr (std::is_same_v<T, int>)
        wgmma_s8<BN>(acc, da, db, 1);
      else
        wgmma<BN, 0, 0>(acc, da, db, 1);
    }
    wgmma_commit();
    fence_acc(acc);
    wgmma_wait<1>();
    fence_acc(acc);
    if (kb > 0 && lane == 0) mbar_arrive(&r.empty[prev]);
    prev = s;
    it.advance(r.stages);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (lane == 0) mbar_arrive(&r.empty[prev]);
}

// Producer: k_slabs slabs of rows row .. row + BN - 1 of `map`, `cols`
// elements (64 bytes) each, from column 0.
__device__ __forceinline__ void produce_slabs(const SlabRing& r, RingPos& it,
                                              const CUtensorMap* map, int row,
                                              int k_slabs, int cols) {
  for (int kb = 0; kb < k_slabs; ++kb) {
    uint64_t* bar;
    unsigned char* dst = ring_acquire(r, it, bar);
    tma_load(dst, map, bar, kb * cols, row);
  }
}

// Producer warp w: the forward's slabs of one tile for warpgroup w's
// column blocks, in the order tile_forward multiplies them.
template <int BN>
__device__ __forceinline__ void produce_forward(const SlabRing& r, RingPos& it,
                                                const CUtensorMap* w0_map,
                                                const CUtensorMap* wq_map,
                                                const CUtensorMap* tail_map,
                                                const I8TrunkArgs& p, int w) {
  const int width = p.width, blocks = width / BN;
  const int kq = width / 64, kb16 = p.kpad32 / 32;
  for (int cb = w; cb < blocks; cb += 2)
    produce_slabs(r, it, w0_map, cb * BN, kb16, 32);
  for (int l = 1; l < p.depth; ++l)
    for (int cb = w; cb < blocks; cb += 2) {
      produce_slabs(r, it, wq_map, (l - 1) * width + cb * BN, kq, 64);
      if ((p.skip_mask >> l) & 1u)
        produce_slabs(r, it, tail_map,
                      (feature_slot(p.skip_mask, l) - 1) * width + cb * BN,
                      kb16, 32);
    }
}

// Stores the thread's accumulator block, v[4q + 2h + e] at row r_lo + 8h,
// column col0 + 8q + c_lo + e, of the [64][W] rows at dst (f32 or bf16).
template <int BN>
__device__ __forceinline__ void store_block(const float (&v)[BN / 2],
                                            float* dst, int width, AccPos p,
                                            int col0) {
#pragma unroll
  for (int q = 0; q < BN / 8; ++q)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(dst + (size_t)(p.r_lo + 8 * h) * width +
                                 col0 + 8 * q + p.c_lo) =
          make_float2(v[4 * q + 2 * h], v[4 * q + 2 * h + 1]);
}

template <int BN>
__device__ __forceinline__ void store_block(const float (&v)[BN / 2],
                                            __nv_bfloat16* dst, int width,
                                            AccPos p, int col0) {
#pragma unroll
  for (int q = 0; q < BN / 8; ++q)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<__nv_bfloat162*>(
          dst + (size_t)(p.r_lo + 8 * h) * width + col0 + 8 * q + p.c_lo) =
          __floats2bfloat162_rn(v[4 * q + 2 * h], v[4 * q + 2 * h + 1]);
}

// A consumer thread of the tile pass: its warpgroup's ring, the CTA's
// operand tiles and row buffers, and its place in them.
struct I8Consumer {
  SlabRing r;
  unsigned char* a_tile;
  unsigned char* f_tile;
  float* rowmax;  // [2 wg][64]: each warpgroup's row maxima.
  float* scale;   // [64]: the rows' scales, for the next epilogue.
  float* recip;   // [64]: their reciprocals.
  AccPos pos;
  int tid, wg, lane;
};

// Both warpgroups' row maxima rmax into rowmax[wg][64]; then all threads.
__device__ __forceinline__ void publish_rowmax(const I8Consumer& c,
                                               const float (&rmax)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float x = rmax[h];
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    if (c.lane % 4 == 0) c.rowmax[c.wg * kI8Tile + c.pos.r_lo + 8 * h] = x;
  }
  named_sync(kI8Bar, kI8Consumers);
}

// Pass 2: the tile's f32 rows [64][W] at src quantized per sample into A
// (scale[r] kept for the next epilogue), visible to wgmma after.
__device__ __forceinline__ void quantize_into_a(const I8Consumer& c,
                                                const float* src, int width) {
  const int tid = c.tid;
  if (tid < kI8Tile) {
    const float s =
        fmaxf(fmaxf(c.rowmax[tid], c.rowmax[kI8Tile + tid]), kScaleFloor) /
        127.0f;
    c.scale[tid] = s;
    c.recip[tid] = __frcp_rn(s);
  }
  named_sync(kI8Bar, kI8Consumers);
  const int words = width / 4;  // float4 words of a row.
  const int total = kI8Tile * words;
  // kBatch loads in flight per thread before any is used.
  for (int i0 = tid; i0 < total; i0 += kBatch * kI8Consumers) {
    float4 x[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + j * kI8Consumers;
      if (i < total)
        x[j] = *reinterpret_cast<const float4*>(src + (size_t)i * 4);
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + j * kI8Consumers;
      if (i >= total) break;
      const int row = i / words, col = (i - row * words) * 4;
      const float s = c.scale[row], r = c.recip[row];
      const unsigned b0 = quantize_byte(x[j].x, s, r);
      const unsigned b1 = quantize_byte(x[j].y, s, r);
      const unsigned b2 = quantize_byte(x[j].z, s, r);
      const unsigned b3 = quantize_byte(x[j].w, s, r);
      *reinterpret_cast<unsigned*>(c.a_tile + swizzled_byte(row, col)) =
          b0 | (b1 << 8) | (b2 << 16) | (b3 << 24);
    }
  }
  fence_proxy_async();
  named_sync(kI8Bar, kI8Consumers);
}

// The forward of the tile at row0 by the consumers: its bf16 features into
// F (the featurizer's scratch in A, once the previous tile is done with A
// and F), then layer by layer.  Pass 1 of a hidden layer l hands each of
// the thread's [64][BN] blocks (after the scales, the skip projection, the
// bias and the ReLU) to store(l, y, col0); pass 2 quantizes the rows that
// rows(l) points at.  The last layer's blocks go to last(y, col0), which
// may fold them into rmax; the caller publishes rmax if it needs it.
template <int BN, typename Store, typename Rows, typename Last>
__device__ __forceinline__ void tile_forward(const I8TrunkArgs& p,
                                             const I8Consumer& c, RingPos& it,
                                             long long row0,
                                             float (&rmax)[2], Store store,
                                             Rows rows, Last last) {
  const int width = p.width, depth = p.depth, blocks = width / BN;
  const int kq = width / 64;       // Slabs of an int8 product over W.
  const int kb16 = p.kpad32 / 32;  // Slabs of a bf16 product over F.
  named_sync(kI8Bar, kI8Consumers);
  unsigned char* f_tile = c.f_tile;
  featurize_rows<kI8Tile>(
      p.means, p.covs, p.basis_t, p.bb_t, row0, p.n, p.num_dims,
      p.num_degs, p.use_contract != 0, reinterpret_cast<float*>(c.a_tile),
      c.tid, kI8Consumers, p.kpad64,
      [=](int s, int f, __nv_bfloat16 v) {
        *reinterpret_cast<__nv_bfloat16*>(f_tile + swizzled_offset(s, f)) = v;
      },
      [] { named_sync(kI8Bar, kI8Consumers); });
  fence_proxy_async();
  named_sync(kI8Bar, kI8Consumers);

  const AccPos pos = c.pos;
  for (int l = 0; l < depth; ++l) {
    rmax[0] = rmax[1] = 0.0f;
    const bool skip = l > 0 && ((p.skip_mask >> l) & 1u);
    const float* bias = p.biases + (size_t)l * width;
    for (int cb = c.wg; cb < blocks; cb += 2) {
      const int col0 = cb * BN;
      float y[BN / 2];
      if (l == 0) {
        slab_product<BN>(y, c.f_tile, kb16, c.r, it, c.lane, false);
      } else {
        int acc[BN / 2];
        slab_product<BN>(acc, c.a_tile, kq, c.r, it, c.lane, false);
        const float* swl = p.sw + (size_t)(l - 1) * width + col0;
        const float sx[2] = {c.scale[pos.r_lo], c.scale[pos.r_lo + 8]};
#pragma unroll
        for (int q = 0; q < BN / 8; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            y[4 * q + e] = (float)acc[4 * q + e] *
                           (__ldg(swl + 8 * q + pos.c_lo + e % 2) *
                            sx[e / 2]);
        // The skip layer's feature rows, accumulated onto y.
        if (skip) slab_product<BN>(y, c.f_tile, kb16, c.r, it, c.lane, true);
      }
#pragma unroll
      for (int q = 0; q < BN / 8; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          y[4 * q + e] = fmaxf(
              y[4 * q + e] + __ldg(bias + col0 + 8 * q + pos.c_lo + e % 2),
              0.0f);
      if (l + 1 < depth) {
        store(l, y, col0);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i)
          rmax[(i / 2) % 2] = fmaxf(rmax[(i / 2) % 2], y[i]);
      } else {
        last(y, col0);
      }
    }
    if (l + 1 < depth) {
      publish_rowmax(c, rmax);
      quantize_into_a(c, rows(l), width);
    }
  }
}

}  // namespace mnt
