// Fully fused density MLP forward for Hopper (sm_90a):
//   raw_density[N] = head(relu-trunk(bf16(IPE(contract(means, covs)))))
//
// Replaces the TPU kernel multinerf_tpu/ops/pallas/density_mlp.py
// (_fwd_kernel with _trunk_forward and _density_row, reached through
// pallas_call in _forward).  Per sample: the 504 IPE features, a trunk of
// `depth` ReLU layers of width W (bf16 inputs, f32 accumulation, f32 bias,
// ReLU, activations rounded to bf16), then the density head as an f32 sum
// of bf16-rounded activation * bf16-rounded weight, plus the bias.
//
// What bounds it: at the 360 config (4 x 256 trunk, N = 262,144 samples per
// proposal level of a 4,096-ray chunk) the trunk is 2 * N * (512 * 256 +
// 3 * 256 * 256) = 172 GFLOP, while device memory sees only 48 bytes in and
// 4 bytes out per sample: the unfused trunk would move ~2 KB of activations
// per sample instead.  So the tensor cores bound it (0.17 ms at the bf16
// peak).  The TPU kept the whole 0.65 MB bf16 trunk resident in VMEM; a
// Hopper block has at most 227 KB of shared memory, so the weights stream
// from L2, and the design is about reading them as few times as possible
// and keeping the tensor cores fed.
//
// Design: the forward half of K3's tile pass (tile_pass.cuh).  One
// persistent CTA per SM walks 128-sample tiles; its two consumer
// warpgroups own 64 samples each and compute their features straight into
// a 128-byte-swizzled K-major bf16 tile.  The producer warp streams W_0 and
// the hidden layers by TMA through a ring of 16 KB slabs (32 k rows each;
// 4 stages at 360.gin, fewer where the feature tile is wider), so each
// slab serves all 128 samples and the next slabs load while this one is
// multiplied.  CTAs run in clusters of two that walk pairs of tiles and
// share one weight stream: each producer loads every other slab and
// multicasts it into both rings, so a slab crosses L2 once per 256
// samples.  Each layer is wgmma m64nWk16 over the swizzled tile, f32
// accumulators in registers; its epilogue (bias, ReLU, bf16) writes the
// next layer's operand tile, the two activation buffers ping-ponging
// inside the feature tile's space.  The last layer's epilogue is the
// density head: each thread dots its columns of its two rows with bf16(wd)
// and the 4 lanes of a row add theirs by shuffles (a fixed order: bitwise
// deterministic).  Rows >= N are masked at the store; the only device
// memory traffic besides the weights is 48 bytes in and 4 out per sample.
// Widths 64, 128 and 256 are built; the wrapper zero-pads narrower trunks.

#include <cuda_runtime.h>

#include "tile_pass.cuh"

namespace mnt {

// Shared memory of K1 at trunk width W: the operand tile holds the
// features, then each layer's [64][W] activations, written in place once
// the layer's products have read their input.
__host__ __device__ inline FwdLayout k1_layout(int width, int kpad64,
                                               int stages, int num_dims) {
  return fwd_layout(kpad64 > width ? kpad64 : width, width * kSlabK * 2,
                    stages, num_dims, 0);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int W>
__global__ void __cluster_dims__(kFwdCluster, 1, 1)
    __launch_bounds__(kHopperThreads, 1) density_mlp_fwd_kernel(
    const __grid_constant__ CUtensorMap w0_map,  // w0 [kpad64][W]
    const __grid_constant__ CUtensorMap wh_map,  // w_hidden [(L-1)W][W]
    const float* __restrict__ means, const float* __restrict__ covs,
    const float* __restrict__ basis_t, const float* __restrict__ bb_t,
    const float* __restrict__ biases, const __nv_bfloat16* __restrict__ wd,
    const float* __restrict__ bd, float* __restrict__ out, int n, int depth,
    int num_dims, int num_degs, int use_contract, int kpad64, int stages) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const FwdLayout lay = k1_layout(W, kpad64, stages, num_dims);
  const SlabRing ring = fwd_ring(smem, lay, W * kSlabK * 2, stages);
  const FwdTiles t((n + kTileRows - 1) / kTileRows);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) ring_init(ring);
  cluster_sync();

  if (warp == kProducerWarp) {
    if (lane == 0) {
      RingPos it;
      for (int p = t.first; p < t.pairs; p += t.step)
        produce_trunk_forward<W>(ring, it, &w0_map, &wh_map, kpad64, depth);
    }
  } else {
    const int wg = warp / 4;             // Consumer warpgroup: 0 or 1.
    const int wtid = threadIdx.x % 128;  // Thread in the warpgroup.
    const int bar_id = 1 + wg;
    unsigned char* x = smem + wg * lay.x_bytes;
    float* scratch =
        reinterpret_cast<float*>(smem + lay.scratch + wg * lay.scratch_bytes);
    const AccPos pos(wtid);
    const float bias_d = __ldg(bd);
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
      float acc[W / 2];  // Dead while the next tile featurizes.
#pragma unroll
      for (int i = 0; i < W / 2; ++i) acc[i] = 0.0f;
      // Layer l reads x and writes its activations back into x; the last
      // layer's epilogue is the density head.
      int k_slabs = kpad64 / kSlabK;
      for (int l = 0; l < depth; ++l) {
        tile_product<W, true>(acc, x, k_slabs, ring, it, lane);
        const float* bias = biases + (size_t)l * W;
        if (l < depth - 1) {
          named_sync(bar_id, 128);  // Every warp's product has read x.
          bias_relu_bf16<W>(acc, bias, x, pos, [](int, float, float) {});
          publish(bar_id);
          k_slabs = W / kSlabK;
        } else {
          float s[2] = {0.0f, 0.0f};
#pragma unroll
          for (int q = 0; q < W / 8; ++q) {
            const int col = q * 8 + pos.c_lo;
            const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
            const float wd0 = __bfloat162float(wd[col]);
            const float wd1 = __bfloat162float(wd[col + 1]);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int i = 4 * q + 2 * h;
              s[h] += bf16_round(fmaxf(acc[i] + b0, 0.0f)) * wd0;
              s[h] += bf16_round(fmaxf(acc[i + 1] + b1, 0.0f)) * wd1;
            }
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            s[h] += __shfl_xor_sync(0xffffffffu, s[h], 1);
            s[h] += __shfl_xor_sync(0xffffffffu, s[h], 2);
            const int row = row0 + pos.r_lo + 8 * h;
            if (lane % 4 == 0 && row < n) out[row] = s[h] + bias_d;
          }
        }
      }
    }
  }
  // The partner CTA's remote releases and multicast writes are done.
  cluster_sync();
}

template <int W>
cudaError_t launch_fwd(const CUtensorMap* maps, const void* means,
                       const void* covs, const void* basis_t,
                       const void* bb_t, const void* biases, const void* wd,
                       const void* bd, void* out, int n, int depth,
                       int num_dims, int num_degs, int use_contract,
                       int kpad64, int stages, int grid, int smem,
                       cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      density_mlp_fwd_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  density_mlp_fwd_kernel<W><<<grid, kHopperThreads, smem, st>>>(
      maps[0], maps[1], f32(means), f32(covs), f32(basis_t), f32(bb_t),
      f32(biases), static_cast<const __nv_bfloat16*>(wd), f32(bd),
      static_cast<float*>(out), n, depth, num_dims, num_degs, use_contract,
      kpad64, stages);
  return cudaGetLastError();
}

}  // namespace mnt

// Inputs: means f32 [n][3], covs f32 [n][9], w0 bf16 [kpad64][width] (rows
// past F zero), w_hidden bf16 [depth-1][width][width] (unread when depth is
// 1), biases f32 [depth][width], wd bf16 [width], bd f32 [1]; width is 64,
// 128 or 256 (the caller pads narrower trunks with zeros) and kpad64 is F
// rounded up to 64.  Output: out f32 [n].  grid: persistent CTAs, a multiple
// of the cluster size; stages: the weight ring's depth (plans.py).
extern "C" int density_mlp_forward(const void* means, const void* covs,
                                   const void* basis_t, const void* bb_t,
                                   const void* w0, const void* w_hidden,
                                   const void* biases, const void* wd,
                                   const void* bd, void* out, int n,
                                   int width, int depth, int num_dims,
                                   int num_degs, int use_contract, int grid,
                                   int stages, void* stream) {
  using namespace mnt;
  const int kpad64 = round_up(2 * num_degs * num_dims, 64);
  if (n < 1 || depth < 1 || grid < 1 || grid % kFwdCluster != 0 ||
      stages < 2 ||
      (long long)(depth - 1) * width >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const int smem = k1_layout(width, kpad64, stages, num_dims).total;
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[2];
  cudaError_t err = bf16_tile_map(&maps[0], w0, kpad64, width, kSlabK);
  if (err == cudaSuccess)
    err = depth > 1 ? bf16_tile_map(&maps[1], w_hidden,
                                    (long long)(depth - 1) * width, width,
                                    kSlabK)
                    : bf16_tile_map(&maps[1], w0, kpad64, width, kSlabK);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (width == 256)
    err = launch_fwd<256>(maps, means, covs, basis_t, bb_t, biases, wd, bd,
                          out, n, depth, num_dims, num_degs, use_contract,
                          kpad64, stages, grid, smem, st);
  else if (width == 128)
    err = launch_fwd<128>(maps, means, covs, basis_t, bb_t, biases, wd, bd,
                          out, n, depth, num_dims, num_degs, use_contract,
                          kpad64, stages, grid, smem, st);
  else if (width == 64)
    err = launch_fwd<64>(maps, means, covs, basis_t, bb_t, biases, wd, bd,
                         out, n, depth, num_dims, num_degs, use_contract,
                         kpad64, stages, grid, smem, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

// Dynamic shared memory of the kernel, for the launch plans' checks.
extern "C" int density_mlp_smem(int width, int num_feats, int num_dims,
                                int stages) {
  using namespace mnt;
  return k1_layout(width, round_up(num_feats, 64), stages, num_dims).total;
}

// The most clusters of the width-`width` kernel that the card holds at once
// with `smem` bytes per CTA (< 0: a CUDA error, negated).
extern "C" int density_mlp_max_clusters(int width, int smem) {
  using namespace mnt;
  int count = 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (width == 256)
    err = max_active_clusters(density_mlp_fwd_kernel<256>, smem, &count);
  else if (width == 128)
    err = max_active_clusters(density_mlp_fwd_kernel<128>, smem, &count);
  else if (width == 64)
    err = max_active_clusters(density_mlp_fwd_kernel<64>, smem, &count);
  return err == cudaSuccess ? count : -(int)err;
}
