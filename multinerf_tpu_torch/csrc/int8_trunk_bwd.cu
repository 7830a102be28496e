// Backward of the fused int8 NerfMLP trunk for Hopper (sm_90a), K6: every
// dW_l and db_l from the bf16 cotangent g[N, W] of the trunk's output.  The
// sample positions get no gradient (stop-gradient inputs, as in the TPU
// kernel).
//
// Replaces the TPU kernel multinerf_tpu/ops/pallas/int8_trunk.py
// (_bwd_kernel with _qrows and _qcols, reached through pallas_call in _grad)
// and follows its numerics:
//   * the forward is recomputed (per-sample int8 activation scales, as in
//     K5: int8_tile_pass.cuh) and da = g * (act > 0) at each layer, from
//     the f32 activations;
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
//   1. the tile pass (below, on int8_tile_pass.cuh, shared with K5):
//      persistent CTAs walk 64-sample tiles on wgmma, fed by TMA weight
//      rings, recompute the features and the trunk, writing each hidden
//      layer's activation to device memory, then walk back through the
//      layers, writing every da_l and the tile's column sums of da_l.
//      'int8' keeps the activations and da_1..
//      in f32 (the group quantizer needs them) and writes bf16 copies of
//      da_0 and of each skip layer's da for the feature dW; 'int8_hybrid'
//      writes activations and every da_l in bf16 only, rounded once where
//      the dW products round them.  In int8 mode it also folds the tile's
//      per-channel absmax of every activation and da_l into its group's
//      scale slot with atomicMax on the f32 bit pattern (non-negative
//      floats order as their bits, and a maximum does not depend on the
//      order, so this stays deterministic);
//   2. the dW products, split over samples and summed in order
//      (reduce_splits): the bf16 ones (dW_0 and each skip tail from the
//      features, computed once per call by K4's featurize_cast.cuh; the
//      hybrid hidden dW from the bf16 scratch) on wgmma_dw.cuh's TMA +
//      wgmma GEMM; the int8 hidden dW from group_quantize_kernel's int8
//      operands (x_in and da_l quantized with their groups' scales,
//      channel-major per group, samples contiguous: the K-major layout
//      8-bit wgmma needs, having no transpose) on int8_dw_gemm_kernel.
// The TPU kept every dW (34 MB) resident in VMEM and accumulated over an
// ordered grid; here every sum has a fixed order, so two launches agree bit
// for bit.  The scratch (acts and da) is 8 KB per sample per layer pair in
// f32 ('int8', 7.5 GB at N = 131,072) and half that in bf16 (hybrid).

#include <cuda_runtime.h>

#include "featurize_cast.cuh"
#include "int8_tile_pass.cuh"

namespace mnt {

// ------------------------------------------------------------ tile pass ---
//
// int8_tile_pass.cuh's machine: the forward of each tile (tile_forward),
// then, on the same rings, the backward through the layers.  Pass 1's
// epilogues store each block to the layer's scratch plane in device memory
// (the activations or da that the dW products read anyway), from which
// pass 2 reads the rows back; in hybrid mode the activations are stored in
// bf16, so pass 2 reads the f32 rows from a per-CTA staging block.  The
// producers stream, after each tile's forward slabs, the dx weights of
// layers depth-1 .. 1 (int8 wq2, or bf16 w_q * sw in hybrid mode).  The
// hybrid dx's A operand is a bf16 [64][W] that spans A and F, the features
// being dead by then.

struct I8TileArgs : I8TrunkArgs {
  const float* swdx;    // [depth-1][W]: sw2 ('int8').
  const __nv_bfloat16* g;
  void* acts;  // [depth-1] planes: f32 ('int8') or bf16 (hybrid).
  void* das;   // 'int8': f32 da_1.. at plane l - 1; hybrid: bf16, plane l.
  __nv_bfloat16* d16;  // 'int8': bf16 da_0 and the skip layers' da.
  float* stage;        // Hybrid: [gridDim.x][64][W] f32 rows for pass 2.
  unsigned* x_max;     // [depth-1][groups][W], 'int8'.
  unsigned* d_max;     // [depth][groups][W], 'int8'.
  float* vec_part;     // [tiles][depth * W]: the tiles' column sums of da.
  int n_pad, group, hybrid;
};

// Per column of the thread's accumulator block, the warpgroup's 64 rows
// reduced (kMax: max |v|, else the sum in a fixed order: the thread's two
// rows, a shuffle tree over the warp's 8 row groups, then the four warps in
// order), handed to out(col, value) by threads wtid < BN.
template <int BN, bool kMax, typename Out>
__device__ __forceinline__ void column_reduce(const float (&v)[BN / 2],
                                              float* red, int wtid, int bar,
                                              Out out) {
  const int lane = wtid % 32, warp = wtid / 32;
#pragma unroll
  for (int q = 0; q < BN / 8; ++q)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float lo = v[4 * q + e], hi = v[4 * q + 2 + e];
      float x = kMax ? fmaxf(fabsf(lo), fabsf(hi)) : lo + hi;
#pragma unroll
      for (int off = 4; off < 32; off *= 2) {
        const float y = __shfl_xor_sync(0xffffffffu, x, off);
        x = kMax ? fmaxf(x, y) : x + y;
      }
      if (lane < 4) red[warp * BN + q * 8 + 2 * lane + e] = x;
    }
  named_sync(bar, 128);
  if (wtid < BN) {
    float x = red[wtid];
    for (int w = 1; w < 4; ++w)
      x = kMax ? fmaxf(x, red[w * BN + wtid]) : x + red[w * BN + wtid];
    out(wtid, x);
  }
  named_sync(bar, 128);
}

// What a consumer thread of the tile pass needs for its epilogues.
struct I8TileCtx {
  AccPos pos;
  int wtid, wg_bar;
  float* red;    // The warpgroup's column-reduction buffers.
  size_t rows;   // Offset of the tile's rows in a scratch plane.
  size_t plane;  // n_pad * W.
  int gi, groups;
  float* vec;    // The tile's column sums of da, [depth][W].
};

// da_m's epilogue (m: its layer), v its [64][BN] block at column col0:
// stores (f32 da_m, m >= 1, and bf16 copies for the feature dW, 'int8'; bf16
// da_m, hybrid), the group absmax ('int8'), the column sums (db) and the
// rows' running absmax.
template <int BN>
__device__ __forceinline__ void da_epilogue(const I8TileArgs& p,
                                            const I8TileCtx& c, int m,
                                            const float (&v)[BN / 2],
                                            int col0, float (&rmax)[2]) {
  if (p.hybrid) {
    store_block<BN>(v, static_cast<__nv_bfloat16*>(p.das) + m * c.plane +
                           c.rows,
                    p.width, c.pos, col0);
  } else {
    if (m > 0) {
      store_block<BN>(v, static_cast<float*>(p.das) + (m - 1) * c.plane +
                             c.rows,
                      p.width, c.pos, col0);
      unsigned* slot =
          p.d_max + ((size_t)m * c.groups + c.gi) * p.width + col0;
      column_reduce<BN, true>(v, c.red + 4 * BN, c.wtid, c.wg_bar,
                              [=](int col, float x) {
                                atomicMax(slot + col, __float_as_uint(x));
                              });
    }
    if (m == 0 || ((p.skip_mask >> m) & 1u))
      store_block<BN>(
          v, p.d16 + feature_slot(p.skip_mask, m) * c.plane + c.rows,
          p.width, c.pos, col0);
  }
  float* sums = c.vec + (size_t)m * p.width + col0;
  column_reduce<BN, false>(v, c.red, c.wtid, c.wg_bar,
                           [=](int col, float x) { sums[col] = x; });
#pragma unroll
  for (int i = 0; i < BN / 2; ++i)
    rmax[(i / 2) % 2] = fmaxf(rmax[(i / 2) % 2], fabsf(v[i]));
}

template <int BN>
__global__ void __launch_bounds__(kI8TileThreads, 1)
int8_bwd_tile_kernel(const __grid_constant__ CUtensorMap w0_map,
                     const __grid_constant__ CUtensorMap wq_map,
                     const __grid_constant__ CUtensorMap tail_map,
                     const __grid_constant__ CUtensorMap wdx_map,
                     const __grid_constant__ I8TileArgs p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const int width = p.width, depth = p.depth, stages = p.stages;
  const I8TileLayout lay =
      i8_tile_layout(width, p.kpad64, p.num_dims, BN, stages, true);
  unsigned char* a_tile = smem;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bars);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int blocks = width / BN;  // Column blocks of a layer.
  const size_t plane = (size_t)p.n_pad * width;
  const int kdx = p.hybrid ? width / 32 : width / 64;
  auto ring = [&](int w) {
    return SlabRing{smem + lay.ring + w * stages * lay.slab,
                    bars + 2 * w * stages, bars + 2 * w * stages + stages,
                    lay.slab, stages};
  };
  if (tid < 2) {
    const SlabRing r = ring(tid);
    for (int s = 0; s < stages; ++s) {
      mbar_init(&r.full[s], 1);
      mbar_init(&r.empty[s], 4);  // The four warps of one warpgroup.
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kI8Consumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kI8ProducerRegs));
    // Producer warp w feeds warpgroup w's ring, in the order it multiplies.
    const int w = warp - kI8Consumers / 32;
    if (lane == 0 && w < 2 && w < blocks) {
      const SlabRing r = ring(w);
      RingPos it;
      for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
        produce_forward<BN>(r, it, &w0_map, &wq_map, &tail_map, p, w);
        for (int l = depth - 1; l >= 1; --l)
          for (int cb = w; cb < blocks; cb += 2)
            produce_slabs(r, it, &wdx_map, (l - 1) * width + cb * BN, kdx,
                          p.hybrid ? 32 : 64);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kI8ConsumerRegs));
  const int wg = warp / 4, wtid = tid % 128;
  const AccPos pos(wtid);
  const I8Consumer cons{ring(wg),
                     a_tile,
                     smem + lay.f,
                     reinterpret_cast<float*>(smem + lay.rowmax),
                     reinterpret_cast<float*>(smem + lay.scale),
                     reinterpret_cast<float*>(smem + lay.recip),
                     pos,
                     tid,
                     wg,
                     lane};
  const SlabRing& r = cons.r;
  RingPos it;
  float* red = reinterpret_cast<float*>(smem + lay.colred) + wg * 2 * 4 * BN;
  float* acts_f = static_cast<float*>(p.acts);
  __nv_bfloat16* acts_h = static_cast<__nv_bfloat16*>(p.acts);
  float* das_f = static_cast<float*>(p.das);
  __nv_bfloat16* das_h = static_cast<__nv_bfloat16*>(p.das);
  float* stage = p.stage + (size_t)blockIdx.x * kI8Tile * width;
  const int groups = p.n_pad / p.group;
  const int wg_bar = kI8WgBar + wg;

  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const long long row0 = (long long)t * kI8Tile;
    const int gi = (int)(row0 / p.group);
    const size_t rows = (size_t)row0 * width;  // Offset of the tile's rows.
    float* vec = p.vec_part + (size_t)t * depth * width;
    float rmax[2];
    const I8TileCtx cx{pos, wtid, wg_bar, red, rows, plane, gi, groups, vec};

    // The forward: each hidden layer's activation to its scratch plane
    // (and, hybrid, to the staging block), its group absmax ('int8'); the
    // last layer's da from g through its ReLU mask, 0 past n.
    tile_forward<BN>(
        p, cons, it, row0, rmax,
        [&](int l, const float (&y)[BN / 2], int col0) {
          if (p.hybrid) {
            store_block<BN>(y, acts_h + l * plane + rows, width, pos, col0);
            store_block<BN>(y, stage, width, pos, col0);
          } else {
            store_block<BN>(y, acts_f + l * plane + rows, width, pos, col0);
            unsigned* slot =
                p.x_max + ((size_t)l * groups + gi) * width + col0;
            column_reduce<BN, true>(y, red + 4 * BN, wtid, wg_bar,
                                    [=](int col, float x) {
                                      atomicMax(slot + col, __float_as_uint(x));
                                    });
          }
        },
        [&](int l) { return p.hybrid ? stage : acts_f + l * plane + rows; },
        [&](float (&y)[BN / 2], int col0) {
#pragma unroll
          for (int q = 0; q < BN / 8; ++q)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const long long row = row0 + pos.r_lo + 8 * h;
              const int c = col0 + 8 * q + pos.c_lo;
              float2 gv = make_float2(0.0f, 0.0f);
              if (row < p.n)
                gv = __bfloat1622float2(*reinterpret_cast<
                                        const __nv_bfloat162*>(
                    p.g + row * width + c));
              const int i = 4 * q + 2 * h;
              y[i] = y[i] > 0.0f ? gv.x : 0.0f;
              y[i + 1] = y[i + 1] > 0.0f ? gv.y : 0.0f;
            }
          da_epilogue<BN>(p, cx, depth - 1, y, col0, rmax);
        });
    publish_rowmax(cons, rmax);

    // The backward: da_l -> dx -> da_{l-1} through layer l-1's ReLU mask.
    for (int l = depth - 1; l >= 1; --l) {
      if (p.hybrid) {
        // bf16(da_l), as stored, into A [64][W] bf16 (over F).
        const __nv_bfloat16* src = das_h + l * plane + rows;
        const int words = width / 8;  // uint4 words of a row.
        const int total = kI8Tile * words;
        for (int i0 = tid; i0 < total; i0 += kBatch * kI8Consumers) {
          uint4 x[kBatch];
#pragma unroll
          for (int j = 0; j < kBatch; ++j) {
            const int i = i0 + j * kI8Consumers;
            if (i < total)
              x[j] = *reinterpret_cast<const uint4*>(src + (size_t)i * 8);
          }
#pragma unroll
          for (int j = 0; j < kBatch; ++j) {
            const int i = i0 + j * kI8Consumers;
            if (i >= total) break;
            const int row = i / words, c = (i - row * words) * 8;
            *reinterpret_cast<uint4*>(a_tile + swizzled_offset(row, c)) = x[j];
          }
        }
        fence_proxy_async();
        named_sync(kI8Bar, kI8Consumers);
      } else {
        quantize_into_a(cons, das_f + (l - 1) * plane + rows, width);
      }
      rmax[0] = rmax[1] = 0.0f;
      const int m = l - 1;
      for (int cb = wg; cb < blocks; cb += 2) {
        const int col0 = cb * BN;
        float v[BN / 2];
        if (p.hybrid) {
          slab_product<BN>(v, a_tile, kdx, r, it, lane, false);
        } else {
          int acc[BN / 2];
          slab_product<BN>(acc, a_tile, kdx, r, it, lane, false);
          const float* sw2 = p.swdx + (size_t)m * width + col0;
          const float sd[2] = {cons.scale[pos.r_lo],
                                cons.scale[pos.r_lo + 8]};
#pragma unroll
          for (int q = 0; q < BN / 8; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              v[4 * q + e] = (float)acc[4 * q + e] *
                             (__ldg(sw2 + 8 * q + pos.c_lo + e % 2) *
                              sd[e / 2]);
        }
        // Layer m's ReLU mask, from its stored activation (hybrid: bf16,
        // which keeps the sign of every f32 activation above 1e-40).
#pragma unroll
        for (int q = 0; q < BN / 8; ++q)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const size_t k = rows + (size_t)(pos.r_lo + 8 * h) * width +
                             col0 + 8 * q + pos.c_lo;
            float2 act;
            if (p.hybrid)
              act = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(
                      acts_h + m * plane + k));
            else
              act = *reinterpret_cast<const float2*>(acts_f + m * plane + k);
            const int i = 4 * q + 2 * h;
            if (!(act.x > 0.0f)) v[i] = 0.0f;
            if (!(act.y > 0.0f)) v[i + 1] = 0.0f;
          }
        da_epilogue<BN>(p, cx, m, v, col0, rmax);
      }
      publish_rowmax(cons, rmax);
    }
  }
}

constexpr int kQuantThreads = 256;
constexpr int kQuantRows = 64;     // Samples per quantize block (| group).
constexpr int kQuantCols = 64;     // Channels per quantize block.

__device__ __forceinline__ float group_scale(unsigned max_bits) {
  return fmaxf(__uint_as_float(max_bits), kScaleFloor) / 127.0f;
}

// q[g][c][s] = rint(x[g * group + s][c] / scale_g[c]): one hidden layer's f32
// input or cotangent quantized per channel over each group of samples, in
// a channel-major layout per group (the dW product's k axis contiguous).
// A block transposes [64 samples][64 channels] through shared memory: each
// thread reads 4 channels of 4 samples as float4 and writes 16 bytes of
// one channel.
__global__ void __launch_bounds__(kQuantThreads)
group_quantize_kernel(const float* __restrict__ x,
                      const unsigned* __restrict__ maxes, int group,
                      int width, int8_t* __restrict__ q) {
  __shared__ __align__(16) int8_t tile[kQuantCols][kQuantRows + 16];
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kQuantCols;
  const long long s0 = (long long)blockIdx.y * kQuantRows;
  const int gi = (int)(s0 / group);
  const int c = (tid % 16) * 4;  // This thread's four channels.
  float scale[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    scale[j] = group_scale(maxes[(size_t)gi * width + c0 + c + j]);
  for (int s = tid / 16; s < kQuantRows; s += kQuantThreads / 16) {
    const float4 v =
        *reinterpret_cast<const float4*>(x + (s0 + s) * width + c0 + c);
    tile[c][s] = (int8_t)__float2int_rn(v.x / scale[0]);
    tile[c + 1][s] = (int8_t)__float2int_rn(v.y / scale[1]);
    tile[c + 2][s] = (int8_t)__float2int_rn(v.z / scale[2]);
    tile[c + 3][s] = (int8_t)__float2int_rn(v.w / scale[3]);
  }
  __syncthreads();
  const int cc = tid / 4, w = tid % 4;  // A channel, a 16-byte word of it.
  *reinterpret_cast<uint4*>(q + ((size_t)gi * width + c0 + cc) * group +
                            (s0 - (long long)gi * group) + 16 * w) =
      *reinterpret_cast<const uint4*>(&tile[cc][16 * w]);
}

// The int8 hidden dW on wgmma.  int8_dw_gemm_kernel<BN>: a CTA owns a
// 128 x BN block of dW_l (two consumer warpgroups of 64 rows) and the
// groups [z * per, z * per + per) of split z.  The producer warp streams
// each 128-sample slab of a group, qx's [128 rows][128] and qd's [BN][128]
// int8 boxes of group_quantize_kernel's layout (K-major, 128-byte swizzle),
// by TMA through a 6-stage ring, and with a group's last slab the group's
// absmaxes of those rows and columns (a bulk copy); the consumers run four
// wgmma m64nBNk32 s8 products per slab into int32 accumulators, and at the
// end of each group fold them into f32: acc_f += float(acc) * (sx_g[i] *
// sd_g[o]), group after group, as the plain version sums its exact int32
// group products.  BN = 128 keeps both accumulator sets (64 + 64
// registers) in registers.  Each split stores its [W][W] partial;
// reduce_splits sums the splits in order.
constexpr int kS8Stages = 6;
constexpr int kS8Slab = 128;          // Samples per stage: 128-byte rows.
constexpr int kS8Box = 64 * kS8Slab;  // One [64][128] int8 box: 8 KB.

__host__ __device__ constexpr int s8_stage_bytes(int bn) {
  return kS8Slab * (kDwTileRows + bn);
}

// The ring, each stage's group absmaxes ([128 + BN] u32), the barriers, the
// alignment slack.
__host__ __device__ constexpr int s8_dw_smem(int bn) {
  return kS8Stages * (s8_stage_bytes(bn) + (kDwTileRows + bn) * 4) +
         2 * kS8Stages * 8 + 1024;
}

// A bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from device memory to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

template <int BN>
__global__ void __launch_bounds__(kHopperThreads, 1)
int8_dw_gemm_kernel(const __grid_constant__ CUtensorMap x_map,
                    const __grid_constant__ CUtensorMap d_map,
                    const unsigned* __restrict__ x_max,
                    const unsigned* __restrict__ d_max, int width, int group,
                    int groups, int per, float* __restrict__ part) {
  constexpr int kStage = s8_stage_bytes(BN);
  constexpr int kScales = kDwTileRows + BN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned* scales = reinterpret_cast<unsigned*>(smem + kS8Stages * kStage);
  uint64_t* full = reinterpret_cast<uint64_t*>(scales + kS8Stages * kScales);
  uint64_t* empty = full + kS8Stages;
  const int m0 = blockIdx.x * kDwTileRows;
  const int n0 = blockIdx.y * BN;
  const int g0 = blockIdx.z * per;
  const int slabs = group / kS8Slab;  // Slabs per group.
  const int count = min(per, groups - g0) * slabs;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kS8Stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerThreads / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kProducerWarp) {
    // A block of fewer than 128 rows loads only the first warpgroup's A
    // box; the second warpgroup then multiplies stale shared memory into
    // rows that are never stored.
    const bool two = m0 + 64 < width;
    const int x_rows = two ? kDwTileRows : 64;
    if (lane == 0) {
      for (int it = 0; it < count; ++it) {
        const int s = it % kS8Stages;
        mbar_wait(&empty[s], ((it / kS8Stages) & 1) ^ 1);
        unsigned char* a = smem + s * kStage;
        unsigned char* b = a + 2 * kS8Box;
        const int gi = g0 + it / slabs;
        const int row = gi * width;
        const int col = (it % slabs) * kS8Slab;
        const bool last = it % slabs == slabs - 1;
        mbar_expect_tx(&full[s], kStage - (two ? 0 : kS8Box) +
                                     (last ? (x_rows + BN) * 4 : 0));
        tma_load(a, &x_map, &full[s], col, row + m0);
        if (two) tma_load(a + kS8Box, &x_map, &full[s], col, row + m0 + 64);
        for (int j = 0; j < BN / 64; ++j)
          tma_load(b + j * kS8Box, &d_map, &full[s], col, row + n0 + j * 64);
        if (last) {
          unsigned* sc = scales + s * kScales;
          bulk_load(sc, x_max + (size_t)row + m0, x_rows * 4, &full[s]);
          bulk_load(sc + kDwTileRows, d_max + (size_t)row + n0, BN * 4,
                    &full[s]);
        }
      }
    }
    return;
  }

  const int wg = warp / 4;
  const int r0 = wg * 64 + (warp % 4) * 16 + lane / 4;  // Rows in the block.
  int acc[BN / 2];
  float accf[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    acc[i] = 0;
    accf[i] = 0.0f;
  }
  int it = 0;  // Slabs consumed.
  for (int gi = 0; gi < count / slabs; ++gi) {
    for (int k_slab = 0; k_slab < slabs; ++k_slab, ++it) {
      const int s = it % kS8Stages;
      mbar_wait(&full[s], (it / kS8Stages) & 1);
      const unsigned char* a = smem + s * kStage + wg * kS8Box;
      const unsigned char* b = smem + s * kStage + 2 * kS8Box;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kS8Slab / 32; ++k)
        wgmma_s8<BN>(acc, smem_desc(a + k * 32, 16, 1024),
                     smem_desc(b + k * 32, 16, 1024), (k_slab | k) != 0);
      wgmma_commit();
      fence_acc(acc);
      // The products of the previous slab are done: release its stage.
      wgmma_wait<1>();
      fence_acc(acc);
      if (it > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % kS8Stages]);
    }
    // The group's int32 sums are complete: fold them with its scales,
    // which came with its last slab, whose stage is still held.
    wgmma_wait<0>();
    fence_acc(acc);
    const unsigned* sc = scales + ((it - 1) % kS8Stages) * kScales;
    float sx[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      sx[h] = m0 + r < width ? group_scale(sc[r]) : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < BN / 8; ++q) {
      const int col = q * 8 + 2 * (lane % 4);
      const float sd[2] = {group_scale(sc[kDwTileRows + col]),
                           group_scale(sc[kDwTileRows + col + 1])};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        accf[4 * q + e] += (float)acc[4 * q + e] * (sx[e / 2] * sd[e % 2]);
    }
  }

  float* out = part + (size_t)blockIdx.z * width * width;
#pragma unroll
  for (int q = 0; q < BN / 8; ++q) {
    const int col = n0 + q * 8 + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + r0 + 8 * h;
      if (row < width)
        *reinterpret_cast<float2*>(out + (size_t)row * width + col) =
            make_float2(accf[4 * q + 2 * h], accf[4 * q + 2 * h + 1]);
    }
  }
}

// dw[W][W] = the int8 dW of one hidden layer from its quantized operands
// qx, qd [groups][W][group] and their group absmaxes [groups][W]: the
// split partials into part ([splits][W][W]), then the ordered reduce.
inline cudaError_t int8_dw(const int8_t* qx, const int8_t* qd,
                           const unsigned* x_max, const unsigned* d_max,
                           int width, int group, int groups, int bn,
                           int splits, int per, float* part, float* dw,
                           cudaStream_t st) {
  if (width % bn != 0 || group % kS8Slab != 0 || splits < 1 || per < 1 ||
      (splits - 1) * per >= groups || splits * per < groups)
    return cudaErrorInvalidValue;
  CUtensorMap x_map, d_map;
  const long long rows = (long long)groups * width;
  cudaError_t err =
      tile_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, qx, rows, group, 64,
               kS8Slab, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  err = tile_map(&d_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, qd, rows, group,
                 64, kS8Slab, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  const dim3 grid((width + kDwTileRows - 1) / kDwTileRows, width / bn,
                  splits);
  if (bn == 128) {
    err = cudaFuncSetAttribute(int8_dw_gemm_kernel<128>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               s8_dw_smem(128));
    if (err != cudaSuccess) return err;
    int8_dw_gemm_kernel<128><<<grid, kHopperThreads, s8_dw_smem(128), st>>>(
        x_map, d_map, x_max, d_max, width, group, groups, per, part);
  } else if (bn == 64) {
    err = cudaFuncSetAttribute(int8_dw_gemm_kernel<64>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               s8_dw_smem(64));
    if (err != cudaSuccess) return err;
    int8_dw_gemm_kernel<64><<<grid, kHopperThreads, s8_dw_smem(64), st>>>(
        x_map, d_map, x_max, d_max, width, group, groups, per, part);
  } else {
    return cudaErrorInvalidValue;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_splits(part, splits, (long long)width * width,
                       (long long)width * width, dw, st);
}

struct Int8TrunkBwd;  // Names this kernel's bf16 dW GEMMs in a profile.

template <int BN>
cudaError_t launch_tile_pass(const CUtensorMap (&maps)[4],
                             const I8TileArgs& args, int grid, int smem,
                             cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      int8_bwd_tile_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  int8_bwd_tile_kernel<BN><<<grid, kI8TileThreads, smem, st>>>(
      maps[0], maps[1], maps[2], maps[3], args);
  return cudaGetLastError();
}

}  // namespace mnt

// Scratch (allocated by the caller, planes of [n_pad][W]): acts [depth-1]
// planes and das [depth-1] (int8, f32) or [depth] (hybrid, bf16) planes;
// d16 (int8 only) [1 + skips] bf16 planes; stage (hybrid only) [grid][64]
// [W] f32; x_max [depth-1][groups][W] and d_max [depth][groups][W]
// (zeroed; int8 only); vec_part [n_pad/64][depth*W] f32; feats bf16
// [n][kpad64] (kpad64: the features rounded up to 64); part, the dW
// partials; qbuf, 2 * n_pad * W bytes for the int8 mode's quantized
// operands.  Weights (ops/kernels/int8_trunk.py: _operands): w0t [W][kpad]
// bf16, wqt [depth-1][W][W] int8 ([out][in]), sw [depth-1][W], tailt
// [skips][W][kpad] bf16, biases [depth][W], wdx [depth-1][W][W] (int8 wq2
// per input channel, or bf16 w_q * sw in hybrid mode, both [in][out]) and
// swdx [depth-1][W] (sw2); kpad the features rounded up to 32.  Outputs:
// dw_out, every layer's dW back to back (dW_0 [F][W], then [W (+ F)][W]);
// db_out [depth][W].  Plans (plans.int8_bwd_plan): the tile pass's (bn,
// stages, grid), (f_bn, f_splits, f_per) the feature dW GEMMs over n
// samples, (h_bn, h_splits, h_per) the hybrid hidden dW GEMMs, (s8_bn,
// s8_splits, s8_per) the int8 hidden dW over groups.
extern "C" int int8_trunk_backward(
    const void* means, const void* covs, const void* basis_t,
    const void* bb_t, const void* w0t, const void* wqt, const void* sw,
    const void* tailt, const void* biases, const void* wdx, const void* swdx,
    const void* g, void* acts, void* das, void* d16, void* stage,
    void* x_max, void* d_max, void* vec_part, void* feats, void* part,
    void* qbuf, void* dw_out, void* db_out, int n, int n_pad, int group,
    int width, int depth, int num_dims, int num_degs, int use_contract,
    int skip_mask, int bwd_bf16, int bn, int stages, int grid, int f_bn,
    int f_splits, int f_per, int h_bn, int h_splits, int h_per, int s8_bn,
    int s8_splits, int s8_per, void* stream) {
  using namespace mnt;
  const int num_feats = 2 * num_degs * num_dims;
  const int kpad32 = i8_kpad(num_feats);
  const int kpad64 = round_up(num_feats, 64);
  const int tiles = n_pad / kI8Tile;
  const int skips = __builtin_popcount((unsigned)skip_mask);
  if (width % bn != 0 || (bn != 64 && bn != 128) || depth < 1 ||
      n_pad % kI8Tile != 0 || group % kQuantRows != 0 || n_pad % group != 0 ||
      n < 1 || n > n_pad || stages < 1 || grid < 1 || grid > tiles)
    return (int)cudaErrorInvalidValue;
  const int smem =
      i8_tile_layout(width, kpad64, num_dims, bn, stages, true).total;
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);

  // The weight maps of the tile pass: [BN][64-byte] K-major slabs.
  CUtensorMap maps[4];
  cudaError_t err = i8_forward_maps(maps, w0t, wqt, tailt, width, depth,
                                    kpad32, skips, bn);
  if (err != cudaSuccess) return (int)err;
  maps[3] = maps[0];  // Unused without hidden layers.
  if (depth > 1) {
    err = i8_slab_map(&maps[3], wdx, bwd_bf16 != 0,
                      (long long)(depth - 1) * width, width, bn);
    if (err != cudaSuccess) return (int)err;
  }
  auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  __nv_bfloat16* d16_h = static_cast<__nv_bfloat16*>(d16);
  unsigned* x_max_u = static_cast<unsigned*>(x_max);
  unsigned* d_max_u = static_cast<unsigned*>(d_max);
  const I8TileArgs args{
      {f32(means), f32(covs), f32(basis_t), f32(bb_t), f32(sw), f32(biases),
       n, width, depth, kpad32, kpad64, num_dims, num_degs, use_contract,
       stages, tiles, (unsigned)skip_mask},
      f32(swdx), static_cast<const __nv_bfloat16*>(g), acts, das, d16_h,
      static_cast<float*>(stage), x_max_u, d_max_u,
      static_cast<float*>(vec_part), n_pad, group, bwd_bf16};
  err = bn == 128 ? launch_tile_pass<128>(maps, args, grid, smem, st)
                  : launch_tile_pass<64>(maps, args, grid, smem, st);
  if (err != cudaSuccess) return (int)err;

  // The bf16 features of the n samples, once, for dW_0 and the skip tails.
  __nv_bfloat16* feats_h = static_cast<__nv_bfloat16*>(feats);
  err = featurize_cast(f32(means), f32(covs), f32(basis_t), f32(bb_t),
                       nullptr, n, width, num_dims, num_degs, use_contract,
                       kpad64, feats_h, nullptr, st);
  if (err != cudaSuccess) return (int)err;

  float* dw = static_cast<float*>(dw_out);
  float* part_f = static_cast<float*>(part);
  const size_t plane = (size_t)n_pad * width;
  const int groups = n_pad / group;
  // Layer l's bf16 da, the B operand of its feature dW (and, in hybrid
  // mode, of its hidden dW).
  auto da16 = [&](int l) {
    return bwd_bf16 ? static_cast<const __nv_bfloat16*>(das) + l * plane
                    : d16_h + feature_slot((unsigned)skip_mask, l) * plane;
  };
  // Layer l's feature rows: bf16(features)^T @ bf16(da_l), at dw.
  auto feature_rows = [&](int l) {
    return dw_gemm<Int8TrunkBwd>(feats_h, da16(l), n, kpad64, width,
                                 num_feats, f_bn, f_splits, f_per, part_f,
                                 dw, st);
  };
  // One hidden layer's f32 x_in or da quantized per channel over groups.
  auto quantize = [&](const float* x, const unsigned* maxes, int8_t* q) {
    const dim3 qgrid(width / kQuantCols, n_pad / kQuantRows);
    group_quantize_kernel<<<qgrid, kQuantThreads, 0, st>>>(x, maxes, group,
                                                           width, q);
    return cudaGetLastError();
  };
  err = feature_rows(0);
  if (err != cudaSuccess) return (int)err;
  dw += (size_t)num_feats * width;
  for (int l = 1; l < depth; ++l) {
    if (bwd_bf16) {
      err = dw_gemm<Int8TrunkBwd>(
          static_cast<const __nv_bfloat16*>(acts) + (l - 1) * plane, da16(l),
          n, width, width, width, h_bn, h_splits, h_per, part_f, dw, st);
    } else {
      const unsigned* xm = x_max_u + (size_t)(l - 1) * groups * width;
      const unsigned* dm = d_max_u + (size_t)l * groups * width;
      int8_t* qx = static_cast<int8_t*>(qbuf);
      int8_t* qd = qx + plane;
      err = quantize(static_cast<const float*>(acts) + (l - 1) * plane, xm,
                     qx);
      if (err == cudaSuccess)
        err = quantize(static_cast<const float*>(das) + (l - 1) * plane, dm,
                       qd);
      if (err == cudaSuccess)
        err = int8_dw(qx, qd, xm, dm, width, group, groups, s8_bn, s8_splits,
                      s8_per, part_f, dw, st);
    }
    if (err != cudaSuccess) return (int)err;
    dw += (size_t)width * width;
    if (((unsigned)skip_mask >> l) & 1u) {
      err = feature_rows(l);
      if (err != cudaSuccess) return (int)err;
      dw += (size_t)num_feats * width;
    }
  }
  return (int)reduce_splits(static_cast<const float*>(vec_part), tiles,
                            (long long)depth * width,
                            (long long)depth * width,
                            static_cast<float*>(db_out), st);
}

// Dynamic shared memory of the tile pass and of the s8 dW GEMM, for the
// launch plans' checks.
extern "C" int int8_bwd_tile_smem(int width, int num_feats, int num_dims,
                                  int bn, int stages) {
  return mnt::i8_tile_layout(width, mnt::round_up(num_feats, 64), num_dims,
                             bn, stages, true)
      .total;
}

extern "C" int int8_dw_gemm_smem(int bn) { return mnt::s8_dw_smem(bn); }
