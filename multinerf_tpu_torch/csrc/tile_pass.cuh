// The persistent wgmma tile pass of the fused density MLP kernels, forward
// (K1, density_mlp.cu) and backward (K3, density_mlp_bwd.cu), and of the
// fused featurize -> Dense forward (K2, featurize_dense.cu).
//
// A CTA is one producer warp and two consumer warpgroups (wgmma_dw.cuh's
// 288 threads).  It walks 128-sample tiles, one per step of a persistent
// loop; each consumer warpgroup owns 64 of the tile's samples.  The producer
// streams weight slabs with TMA through a ring of shared-memory stages with
// full/empty mbarriers, in the order the consumers multiply them, so a slab
// crosses L2 once per 128 samples and the next slabs load while this one is
// multiplied.  A slab is 32 k rows of a weight matrix: MN-major [32][64]
// boxes side by side (128-byte swizzle) or, for K3's backward products,
// K-major, one [W][32] box (64-byte swizzle).  The consumers keep their
// samples' operand in shared memory as a K-major [64][K] bf16 tile of
// 128-byte-swizzled 64-column blocks (swizzled_offset): the features, which
// the warpgroup computes straight into it, then the activations its
// epilogues write.  Products are wgmma m64nWk16 with f32 accumulators in
// registers.
#pragma once

#include "wgmma_dw.cuh"

namespace mnt {

constexpr int kTileRows = 128;  // Samples per tile: two warpgroups of 64.
constexpr int kRing = 4;        // Stages of K3's weight ring (K1/K2: a plan).
constexpr int kSlabK = 32;      // k depth of one ring slab.

// The weight ring: `stages` slabs of `slab_bytes` at `base`, each with a
// full barrier (the producer's TMA bytes) and an empty barrier (one arrival
// per consumer warp).  With a cluster of 2 CTAs (K1, K2) the two CTAs walk
// the same slab sequence and share it: each producer loads every other slab
// and multicasts it into both CTAs' rings, so a slab crosses L2 once per
// 256 samples; a stage is free again once the consumer warps of both CTAs
// have released it (each arrives on both CTAs' empty barriers).
struct SlabRing {
  unsigned char* base;
  uint64_t* full;
  uint64_t* empty;
  int slab_bytes;
  int stages;
  int cluster = 1;     // CTAs sharing the slabs: 1 or 2.
  uint32_t rank = 0;   // This CTA's rank in the cluster.
};

// A position in the ring: the stage, and the parity of the barrier phase
// that the slab at that stage completes.  Producer and consumers each keep
// their own and advance it slab by slab, in the same order.
struct RingPos {
  int stage = 0;
  uint32_t phase = 0;
  uint32_t count = 0;  // Slabs passed.
  __device__ __forceinline__ void advance(int stages) {
    ++count;
    if (++stage == stages) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

// One thread: the barriers of a ring, before any of them is used.
__device__ __forceinline__ void ring_init(const SlabRing& r) {
  for (int s = 0; s < r.stages; ++s) {
    mbar_init(&r.full[s], 1);
    mbar_init(&r.empty[s], r.cluster * (kConsumerThreads / 32));
  }
  mbar_fence_init();
}

// Producer: the next stage, once its readers have released it; `bar`, its
// full barrier, now expects the slab's bytes.
__device__ __forceinline__ unsigned char* ring_acquire(const SlabRing& r,
                                                       RingPos& pos,
                                                       uint64_t*& bar) {
  const int s = pos.stage;
  mbar_wait(&r.empty[s], pos.phase ^ 1u);
  bar = &r.full[s];
  mbar_expect_tx(bar, r.slab_bytes);
  pos.advance(r.stages);
  return r.base + s * r.slab_bytes;
}

// Consumer warp: its release of a stage, in every CTA of the cluster.
__device__ __forceinline__ void ring_release(const SlabRing& r, int stage) {
  if (r.cluster == 1) {
    mbar_arrive(&r.empty[stage]);
  } else {
    for (int c = 0; c < r.cluster; ++c) mbar_arrive_cluster(&r.empty[stage], c);
  }
}

// Producer: k_slabs slabs of rows row0, row0 + 32, ... of `map` (a
// row-major bf16 matrix in [32][64] boxes), each `boxes` boxes wide from
// column col0.  In a cluster, this CTA loads its share of the slabs and
// multicasts them.
__device__ __forceinline__ void produce_rows(const SlabRing& r, RingPos& it,
                                             const CUtensorMap* map, int row0,
                                             int k_slabs, int col0,
                                             int boxes) {
  constexpr int kBox = kSlabK * 128;  // One [32][64] box.
  for (int kb = 0; kb < k_slabs; ++kb) {
    const uint32_t slab = it.count;
    uint64_t* bar;
    unsigned char* dst = ring_acquire(r, it, bar);
    if (r.cluster == 1) {
      for (int j = 0; j < boxes; ++j)
        tma_load(dst + j * kBox, map, bar, col0 + j * 64, row0 + kb * kSlabK);
    } else if (slab % r.cluster == r.rank) {
      const uint16_t all = (uint16_t)((1u << r.cluster) - 1u);
      for (int j = 0; j < boxes; ++j)
        tma_load_multicast(dst + j * kBox, map, bar, col0 + j * 64,
                           row0 + kb * kSlabK, all);
    }
  }
}

// Producer: a trunk's forward slabs for one tile, W_0's kpad64 rows, then
// the W rows of each hidden layer of w_hidden [(depth - 1) W][W].
template <int W>
__device__ __forceinline__ void produce_trunk_forward(
    const SlabRing& r, RingPos& it, const CUtensorMap* w0_map,
    const CUtensorMap* wh_map, int kpad64, int depth) {
  produce_rows(r, it, w0_map, 0, kpad64 / kSlabK, 0, W / 64);
  for (int l = 1; l < depth; ++l)
    produce_rows(r, it, wh_map, (l - 1) * W, W / kSlabK, 0, W / 64);
}

// acc = A @ B over k_slabs ring slabs: A [64][32 * k_slabs] K-major in `a`
// (128-byte swizzled 64-column blocks), B the next k_slabs slabs of the
// ring: MN-major (a layer's rows, [32][64] boxes, 128-byte swizzle) or
// K-major (a layer's columns, one [W][32] box, 64-byte swizzle).  `it` is
// the ring position, as the producer's.  Each warp releases a stage once
// its products have read it.  accumulate: add to acc (K3's second K-part of
// layer 0) instead of starting from zero.
template <int W, bool kBMnMajor>
__device__ __forceinline__ void tile_product(float (&acc)[W / 2],
                                             const unsigned char* a,
                                             int k_slabs, const SlabRing& r,
                                             RingPos& it, int lane,
                                             bool accumulate = false) {
  int prev = 0;  // The stage of the previous slab.
  for (int kb = 0; kb < k_slabs; ++kb) {
    const int s = it.stage;
    mbar_wait(&r.full[s], it.phase);
    const unsigned char* b = r.base + s * r.slab_bytes;
    const unsigned char* a_kb = a + (kb >> 1) * kBoxBytes + (kb & 1) * 64;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kSlabK / 16; ++k) {
      const uint64_t da = smem_desc(a_kb + k * 32, 16, 1024);
      const int scale_d = accumulate || (kb | k) != 0;
      if constexpr (kBMnMajor)
        wgmma<W, 0, 1>(acc, da,
                       smem_desc(b + k * 2048, kSlabK * 128, 1024), scale_d);
      else
        wgmma<W, 0, 0>(acc, da, smem_desc(b + k * 32, 16, 512, kSwizzle64),
                       scale_d);
    }
    wgmma_commit();
    fence_acc(acc);
    wgmma_wait<1>();
    fence_acc(acc);
    if (kb > 0 && lane == 0) ring_release(r, prev);
    prev = s;
    it.advance(r.stages);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (lane == 0) ring_release(r, prev);
}

// A warpgroup's thread in the wgmma accumulator layout: its rows r_lo and
// r_lo + 8 of the warpgroup's 64, and its first column c_lo in each 8.
struct AccPos {
  int r_lo, c_lo;
  __device__ __forceinline__ explicit AccPos(int wtid)
      : r_lo((wtid / 32) * 16 + (wtid % 32) / 4), c_lo(2 * (wtid % 4)) {}
};

// bf16 (v0, v1) to (row, col), (row, col + 1) of a swizzled operand tile.
__device__ __forceinline__ void put_bf16x2(unsigned char* dst, int row,
                                           int col, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(dst + swizzled_offset(row, col)) =
      __floats2bfloat162_rn(v0, v1);
}

// dst = bf16(relu(acc + bias)), the [64][W] activation tile of a layer;
// visit(i, v0, v1) sees accumulators i and i + 1 after the bias and ReLU.
template <int W, typename Visit>
__device__ __forceinline__ void bias_relu_bf16(const float (&acc)[W / 2],
                                               const float* __restrict__ bias,
                                               unsigned char* dst, AccPos p,
                                               Visit visit) {
#pragma unroll
  for (int q = 0; q < W / 8; ++q) {
    const int col = q * 8 + p.c_lo;
    const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * q + 2 * h;
      const float v0 = fmaxf(acc[i] + b0, 0.0f);
      const float v1 = fmaxf(acc[i + 1] + b1, 0.0f);
      visit(i, v0, v1);
      put_bf16x2(dst, p.r_lo + 8 * h, col, v0, v1);
    }
  }
}

// The IPE features of samples row0 .. row0 + 63 into the K-major operand
// tile x (columns from 2 * num_degs * num_dims up to kpad64 zero), by the
// warpgroup's 128 threads, with `scratch` for the featurizer
// (featurizer_smem_floats(num_dims, 64) floats).  Ends with the
// warpgroup's barrier `bar_id`; the caller fences for the async proxy.
__device__ __forceinline__ void featurize_tile(
    const float* __restrict__ means, const float* __restrict__ covs,
    const float* __restrict__ basis_t, const float* __restrict__ bb_t,
    int row0, int n, int num_dims, int num_degs, bool use_contract,
    int kpad64, unsigned char* x, float* scratch, int wtid, int bar_id) {
  featurize_rows<64>(
      means, covs, basis_t, bb_t, row0, n, num_dims, num_degs, use_contract,
      scratch, wtid, 128, kpad64,
      [=](int s, int f, __nv_bfloat16 v) {
        *reinterpret_cast<__nv_bfloat16*>(x + swizzled_offset(s, f)) = v;
      },
      [=] { named_sync(bar_id, 128); });
}

// The warpgroup's writes to shared memory, visible to wgmma and TMA.
__device__ __forceinline__ void publish(int bar_id) {
  fence_proxy_async();
  named_sync(bar_id, 128);
}

// Shared memory of K1's and K2's tile pass (byte offsets from a
// 1,024-aligned base): each warpgroup's operand tile of x_cols bf16
// columns, the ring, each warpgroup's `out_bytes` of output staging (K2's
// TMA stores; 1,024-aligned), each warpgroup's featurizer scratch, the
// barriers.
struct FwdLayout {
  int x_bytes, ring, out, out_bytes, scratch, scratch_bytes, bars, total;
};

__host__ __device__ inline FwdLayout fwd_layout(int x_cols, int slab_bytes,
                                                int stages, int num_dims,
                                                int out_bytes) {
  FwdLayout l;
  l.x_bytes = x_cols * 128;
  l.ring = 2 * l.x_bytes;
  l.out = l.ring + stages * slab_bytes;
  l.out_bytes = out_bytes;
  l.scratch = l.out + 2 * out_bytes;
  l.scratch_bytes = round_up(featurizer_smem_floats(num_dims, 64) * 4, 16);
  l.bars = l.scratch + 2 * l.scratch_bytes;
  l.total = l.bars + 2 * stages * 8 + 1024;
  return l;
}

// Byte offset of element (row, col) of a [64][32] f32 tile, 128-byte
// swizzled: TMA's SWIZZLE_128B layout of one [64][32] f32 box.
__device__ __forceinline__ int swizzled_f32_offset(int row, int col) {
  return row * 128 + (((col >> 2) ^ (row & 7)) << 4) + (col & 3) * 4;
}

// The ring of a forward tile pass, in the layout above, shared by the
// cluster's two CTAs.
constexpr int kFwdCluster = 2;

__device__ __forceinline__ SlabRing fwd_ring(unsigned char* smem,
                                             const FwdLayout& lay,
                                             int slab_bytes, int stages) {
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  return SlabRing{smem + lay.ring, full,       full + stages, slab_bytes,
                  stages,          kFwdCluster, cluster_rank()};
}

// The most clusters of `kernel` (kFwdCluster CTAs each, `smem` bytes of
// dynamic shared memory per CTA) that the card holds at once: the
// persistent grid of a forward tile pass.
template <typename Kernel>
inline cudaError_t max_active_clusters(Kernel* kernel, int smem,
                                       int* count) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kFwdCluster, 1, 1);
  cfg.blockDim = dim3(kHopperThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  return cudaOccupancyMaxActiveClusters(count, kernel, &cfg);
}

// The tiles of a forward tile pass: cluster c of `clusters` takes the tile
// pairs c, c + clusters, ...; its CTA of rank r tile 2 * pair + r.  Both
// CTAs walk the same number of pairs (so the same slabs): past the last
// tile, a CTA runs a tile whose rows are all >= n and stores nothing.
struct FwdTiles {
  int first, step, pairs;
  __device__ __forceinline__ explicit FwdTiles(int tiles)
      : first(blockIdx.x / kFwdCluster),
        step(gridDim.x / kFwdCluster),
        pairs((tiles + kFwdCluster - 1) / kFwdCluster) {}
};

}  // namespace mnt
