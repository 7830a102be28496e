// Fused featurize -> Dense forward for Hopper (sm_90a).
//
// Replaces the TPU kernel multinerf_tpu/ops/pallas/featurize_dense.py
// (_fwd_kernel, reached through pallas_call in _forward):
//   out[N, W] = bf16(IPE(contract(means, covs))) [N, F] @ bf16(W) [F, W] + bias
// with F = 2 * D * L IPE features (504 at the 360 config), f32 accumulation
// and an f32 bias.  The features never touch device memory.
//
// What bounds it: at the 360 config (N = 131,072 samples of one 4,096-ray
// chunk, W = 1,024) the 537 MB of f32 output take 0.162 ms at 3.35 TB/s and
// the 2 * N * 512 * 1024 = 137 GFLOP of products 0.139 ms at the bf16 peak:
// the two are close, so the tensor cores and the store stream have to be
// busy at the same time.  Writing the features to device memory first and
// running a GEMM would add 268 MB of bf16 traffic to a kernel bound by its
// bytes, so the features stay in shared memory, as on the TPU.
//
// Design: a persistent tile pass (tile_pass.cuh).  One CTA per SM walks
// 128-sample tiles; its two consumer warpgroups compute their 64 samples'
// features once into a 128-byte-swizzled K-major bf16 tile ([64][512] at
// 360.gin: 64 KB each), then walk W's columns in BN-wide slabs (BN = 256
// for W > 128).  For each column slab the producer warp streams the 32-deep
// k slabs of W ([32][BN] bf16, 16 KB) by TMA through a ring of up to 4
// stages, so the next slabs load while this one is multiplied.  CTAs run in
// clusters of two that walk pairs of tiles and share that stream by TMA
// multicast (each producer loads every other slab into both rings), so the
// 1 MB weight matrix crosses L2 once per 256 samples.  The products are wgmma
// m64nBNk16 with f32 accumulators in registers.  The epilogue adds the bias
// in registers and writes the f32 result in [64][32] chunks into two
// 128-byte-swizzled staging buffers per warpgroup, each chunk stored by one
// TMA store: the stores stream out while the warpgroup fills the next chunk
// and runs the next slab's products.  (Storing straight from the
// accumulator layout, 8 bytes a thread, did not overlap the products: the
// stores cost 0.36 ms of 0.82 at 360.gin.)  Rows >= N and columns >= W are
// not written: the TMA map ends at the output's edges (the wrapper pads the
// weights' columns to a whole number of slabs, never the output).  The
// staging takes 32 KB, so the ring keeps 3 stages at 360.gin.  Where the
// feature tile leaves no room for it (672 features: a [64][704] tile per
// warpgroup), the plan turns the staging off and the epilogue stores
// straight from the accumulator layout, 8 bytes a thread (the 4 lanes of a
// row cover 32 contiguous bytes, whole sectors), rows >= N masked.

#include <cuda_runtime.h>

#include "tile_pass.cuh"

namespace mnt {

constexpr int kOutCols = 32;             // f32 columns of one TMA store box.
constexpr int kOutBox = 64 * kOutCols * 4;  // One warpgroup's box: 8 KB.

// Shared memory of K2 with BN-wide column slabs: the feature tile, kpad64
// columns per warpgroup, and (staged) two output boxes per warpgroup.
__host__ __device__ inline FwdLayout k2_layout(int kpad64, int bn, int stages,
                                               int num_dims, int staged) {
  return fwd_layout(kpad64, bn * kSlabK * 2, stages, num_dims,
                    staged ? 2 * kOutBox : 0);
}

template <int BN>
__global__ void __cluster_dims__(kFwdCluster, 1, 1)
    __launch_bounds__(kHopperThreads, 1) featurize_dense_fwd_kernel(
    const __grid_constant__ CUtensorMap w_map,    // w [kpad64][col_slabs * BN]
    const __grid_constant__ CUtensorMap out_map,  // out f32 [n][width]
    const float* __restrict__ means, const float* __restrict__ covs,
    const float* __restrict__ basis_t, const float* __restrict__ bb_t,
    const float* __restrict__ bias, float* __restrict__ out, int n,
    int width, int num_dims, int num_degs, int use_contract, int kpad64,
    int stages, int staged) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const FwdLayout lay = k2_layout(kpad64, BN, stages, num_dims, staged);
  const SlabRing ring = fwd_ring(smem, lay, BN * kSlabK * 2, stages);
  const FwdTiles t((n + kTileRows - 1) / kTileRows);
  const int col_slabs = (width + BN - 1) / BN;
  const int k_slabs = kpad64 / kSlabK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) ring_init(ring);
  cluster_sync();

  if (warp == kProducerWarp) {
    if (lane == 0) {
      RingPos it;
      for (int p = t.first; p < t.pairs; p += t.step)
        for (int j = 0; j < col_slabs; ++j)
          produce_rows(ring, it, &w_map, 0, k_slabs, j * BN, BN / 64);
    }
  } else {
    const int wg = warp / 4;             // Consumer warpgroup: 0 or 1.
    const int wtid = threadIdx.x % 128;  // Thread in the warpgroup.
    const int bar_id = 1 + wg;
    unsigned char* x = smem + wg * lay.x_bytes;
    unsigned char* boxes = smem + lay.out + wg * lay.out_bytes;
    float* scratch =
        reinterpret_cast<float*>(smem + lay.scratch + wg * lay.scratch_bytes);
    const AccPos pos(wtid);
    int stored = 0;  // Output boxes this warpgroup has stored.
    RingPos it;
    for (int p = t.first; p < t.pairs; p += t.step) {
      const int row0 =
          (kFwdCluster * p + (int)ring.rank) * kTileRows + wg * 64;
      // Writes x only after its barriers: by then the last tile's products
      // have read it.
      featurize_tile(means, covs, basis_t, bb_t, row0, n, num_dims,
                     num_degs, use_contract != 0, kpad64, x, scratch, wtid,
                     bar_id);
      publish(bar_id);
      float acc[BN / 2];  // Dead while the next tile featurizes.
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
      for (int j = 0; j < col_slabs; ++j) {
        tile_product<BN, true>(acc, x, k_slabs, ring, it, lane);
        // A tile past the last row stores nothing (and stages nothing, so
        // that every staged box has its store in the wait below).
        if (row0 >= n) continue;
        if (!staged) {
          const long long r0 = row0 + pos.r_lo;  // Its rows: r0, r0 + 8.
#pragma unroll
          for (int q = 0; q < BN / 8; ++q) {
            const int col = j * BN + q * 8 + pos.c_lo;
            if (col < width) {  // width is even: col + 1 < width too.
              const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
#pragma unroll
              for (int h = 0; h < 2; ++h)
                if (r0 + 8 * h < n)
                  *reinterpret_cast<float2*>(out + (r0 + 8 * h) * width +
                                             col) =
                      make_float2(acc[4 * q + 2 * h] + b0,
                                  acc[4 * q + 2 * h + 1] + b1);
            }
          }
          continue;
        }
#pragma unroll
        for (int c = 0; c < BN / kOutCols; ++c) {
          const int col0 = j * BN + c * kOutCols;
          if (col0 >= width) break;  // width is a multiple of kOutCols.
          unsigned char* box = boxes + (stored & 1) * kOutBox;
          // The store that last read this box, two boxes ago, is done
          // reading it.
          if (wtid == 0) bulk_wait_read<1>();
          named_sync(bar_id, 128);
#pragma unroll
          for (int q = 0; q < kOutCols / 8; ++q) {
            const int col = q * 8 + pos.c_lo;  // In the box.
            const float b0 = __ldg(bias + col0 + col);
            const float b1 = __ldg(bias + col0 + col + 1);
            const int i = 4 * (c * (kOutCols / 8) + q);
#pragma unroll
            for (int h = 0; h < 2; ++h)
              *reinterpret_cast<float2*>(
                  box + swizzled_f32_offset(pos.r_lo + 8 * h, col)) =
                  make_float2(acc[i + 2 * h] + b0, acc[i + 2 * h + 1] + b1);
          }
          publish(bar_id);
          if (wtid == 0) {  // Rows past n are not written: the map ends.
            tma_store(&out_map, box, col0, row0);
            bulk_commit();
          }
          ++stored;
        }
      }
    }
    // The boxes are read before the CTA's shared memory goes.
    if (wtid == 0) bulk_wait();
  }
  // The partner CTA's remote releases and multicast writes are done.
  cluster_sync();
}

template <int BN>
cudaError_t launch_fwd(const CUtensorMap* maps, const void* means,
                       const void* covs, const void* basis_t,
                       const void* bb_t, const void* bias, void* out, int n,
                       int width, int num_dims, int num_degs,
                       int use_contract, int kpad64, int stages, int staged,
                       int grid, int smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      featurize_dense_fwd_kernel<BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  featurize_dense_fwd_kernel<BN><<<grid, kHopperThreads, smem, st>>>(
      maps[0], maps[1], f32(means), f32(covs), f32(basis_t), f32(bb_t),
      f32(bias), static_cast<float*>(out), n, width, num_dims, num_degs,
      use_contract, kpad64, stages, staged);
  return cudaGetLastError();
}

}  // namespace mnt

// Inputs: means f32 [n][3], covs f32 [n][9], w bf16 [kpad64][wpad] (the
// kernel, rows past F and columns past width zero; wpad = width rounded up
// to bn), bias f32 [width]; width a multiple of 32, bn 64, 128 or 256, kpad64
// F rounded up to 64.  Output: out f32 [n][width].  grid: persistent CTAs,
// a multiple of the cluster size; stages: the weight ring's depth; staged:
// TMA stores through shared memory (1) or stores from registers (0)
// (plans.py).
extern "C" int featurize_dense_forward(const void* means, const void* covs,
                                       const void* basis_t, const void* bb_t,
                                       const void* w, const void* bias,
                                       void* out, int n, int width,
                                       int num_dims, int num_degs,
                                       int use_contract, int bn, int grid,
                                       int stages, int staged, void* stream) {
  using namespace mnt;
  const int kpad64 = round_up(2 * num_degs * num_dims, 64);
  if (n < 1 || width < 32 || width % 32 != 0 || grid < 1 ||
      grid % kFwdCluster != 0 || stages < 2 || (staged != 0 && staged != 1) ||
      (long long)n * width >= (1ll << 40))
    return (int)cudaErrorInvalidValue;
  const int smem = k2_layout(kpad64, bn, stages, num_dims, staged).total;
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[2];
  cudaError_t err =
      bf16_tile_map(&maps[0], w, kpad64, round_up(width, bn), kSlabK);
  if (err == cudaSuccess)
    err = tile_map(&maps[1], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, out, n,
                   width, 64, kOutCols, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bn == 256)
    err = launch_fwd<256>(maps, means, covs, basis_t, bb_t, bias, out, n,
                          width, num_dims, num_degs, use_contract, kpad64,
                          stages, staged, grid, smem, st);
  else if (bn == 128)
    err = launch_fwd<128>(maps, means, covs, basis_t, bb_t, bias, out, n,
                          width, num_dims, num_degs, use_contract, kpad64,
                          stages, staged, grid, smem, st);
  else if (bn == 64)
    err = launch_fwd<64>(maps, means, covs, basis_t, bb_t, bias, out, n,
                         width, num_dims, num_degs, use_contract, kpad64,
                         stages, staged, grid, smem, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

// Dynamic shared memory of the kernel, for the launch plans' checks.
extern "C" int featurize_dense_smem(int num_feats, int num_dims, int bn,
                                    int stages, int staged) {
  using namespace mnt;
  return k2_layout(round_up(num_feats, 64), bn, stages, num_dims, staged)
      .total;
}

// The most clusters of the bn-wide kernel that the card holds at once with
// `smem` bytes per CTA (< 0: a CUDA error, negated).
extern "C" int featurize_dense_max_clusters(int bn, int smem) {
  using namespace mnt;
  int count = 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (bn == 256)
    err = max_active_clusters(featurize_dense_fwd_kernel<256>, smem, &count);
  else if (bn == 128)
    err = max_active_clusters(featurize_dense_fwd_kernel<128>, smem, &count);
  else if (bn == 64)
    err = max_active_clusters(featurize_dense_fwd_kernel<64>, smem, &count);
  return err == cudaSuccess ? count : -(int)err;
}
