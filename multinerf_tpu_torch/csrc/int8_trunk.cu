// Fused int8 NerfMLP trunk forward for Hopper (sm_90a), K5:
//   out[N, W] = bf16(trunk(bf16(IPE(contract(means, covs)))))
// with layer 0 in bf16, layers 1.. as int8 products with per-sample
// activation scales and per-output-channel weight scales, and the skip
// layers' bf16 feature projection (numerics in int8_tile_pass.cuh).
//
// Replaces the TPU kernel multinerf_tpu/ops/pallas/int8_trunk.py
// (_fwd_kernel with _tile_forward and _qcols, reached through pallas_call
// in _forward).
//
// What bounds it: at the 360 config (8 x 1,024 trunk, skip at layer 5,
// N = 131,072 samples of one 4,096-ray chunk) layer 0 and the skip tail are
// 2 * N * 512 * 1024 * 2 = 275 GFLOP of bf16 products (0.28 ms at 989
// TFLOP/s) and the seven hidden layers 2 * N * 1024^2 * 7 = 1,924 GOP of
// int8 products (0.97 ms at 1,979 TOPS), against 48 bytes in and 2 KB out
// per sample (0.27 GB, 0.08 ms at 3.35 TB/s): the tensor cores bound it,
// at 1.25 ms.  Design: K6's tile pass run forward only
// (int8_tile_pass.cuh: persistent CTAs over 64-sample tiles, s8 and bf16
// wgmma fed by a TMA weight ring per consumer warpgroup).  A hidden layer's
// f32 rows go, block by block, to a per-CTA staging block [grid][64][W]
// in device memory (34.6 MB at 132 CTAs and W = 1,024: it stays in L2),
// from which pass 2 quantizes them per sample.  The last layer's epilogue
// writes bf16 rows straight to `out`, rows >= N masked.  Summation orders
// are fixed, so two launches agree bit for bit; the scales are per sample,
// so the tile size changes no value.

#include <cuda_runtime.h>

#include "int8_tile_pass.cuh"

namespace mnt {

struct I8FwdArgs : I8TrunkArgs {
  float* stage;        // [gridDim.x][64][W] f32: a hidden layer's rows.
  __nv_bfloat16* out;  // [n][W].
};

template <int BN>
__global__ void __launch_bounds__(kI8TileThreads, 1)
int8_fwd_tile_kernel(const __grid_constant__ CUtensorMap w0_map,
                     const __grid_constant__ CUtensorMap wq_map,
                     const __grid_constant__ CUtensorMap tail_map,
                     const __grid_constant__ I8FwdArgs p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const int width = p.width, stages = p.stages;
  const I8TileLayout lay =
      i8_tile_layout(width, p.kpad64, p.num_dims, BN, stages, false);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bars);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
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
    if (lane == 0 && w < 2 && w < width / BN) {
      const SlabRing r = ring(w);
      RingPos it;
      for (int t = blockIdx.x; t < p.tiles; t += gridDim.x)
        produce_forward<BN>(r, it, &w0_map, &wq_map, &tail_map, p, w);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kI8ConsumerRegs));
  const int wg = warp / 4;
  const AccPos pos(tid % 128);
  const I8Consumer cons{ring(wg),
                        smem,
                        smem + lay.f,
                        reinterpret_cast<float*>(smem + lay.rowmax),
                        reinterpret_cast<float*>(smem + lay.scale),
                        reinterpret_cast<float*>(smem + lay.recip),
                        pos,
                        tid,
                        wg,
                        lane};
  RingPos it;
  float* stage = p.stage + (size_t)blockIdx.x * kI8Tile * width;
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const long long row0 = (long long)t * kI8Tile;
    float rmax[2];
    tile_forward<BN>(
        p, cons, it, row0, rmax,
        [&](int, const float (&y)[BN / 2], int col0) {
          store_block<BN>(y, stage, width, pos, col0);
        },
        [&](int) { return stage; },
        [&](const float (&y)[BN / 2], int col0) {
          // The trunk's output: bf16 rows, those past n not stored.
#pragma unroll
          for (int q = 0; q < BN / 8; ++q)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const long long row = row0 + pos.r_lo + 8 * h;
              if (row < p.n)
                *reinterpret_cast<__nv_bfloat162*>(
                    p.out + row * width + col0 + 8 * q + pos.c_lo) =
                    __floats2bfloat162_rn(y[4 * q + 2 * h],
                                          y[4 * q + 2 * h + 1]);
            }
        });
  }
}

template <int BN>
cudaError_t launch_fwd_tile_pass(const CUtensorMap (&maps)[3],
                                 const I8FwdArgs& args, int grid, int smem,
                                 cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      int8_fwd_tile_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  int8_fwd_tile_kernel<BN><<<grid, kI8TileThreads, smem, st>>>(
      maps[0], maps[1], maps[2], args);
  return cudaGetLastError();
}

}  // namespace mnt

// Weights (ops/kernels/int8_trunk.py: _operands): w0t [W][kpad32] bf16, wqt
// [depth-1][W][W] int8 ([out][in]), sw [depth-1][W], tailt [skips][W]
// [kpad32] bf16, biases [depth][W]; kpad32 the features rounded up to 32.
// stage: [grid][64][W] f32 scratch (allocated by the caller).  Plan
// (plans.i8_fwd_plan): bn, stages, grid.
extern "C" int int8_trunk_forward(const void* means, const void* covs,
                                  const void* basis_t, const void* bb_t,
                                  const void* w0t, const void* wqt,
                                  const void* sw, const void* tailt,
                                  const void* biases, void* stage, void* out,
                                  int n, int width, int depth, int num_dims,
                                  int num_degs, int use_contract,
                                  int skip_mask, int bn, int stages, int grid,
                                  void* stream) {
  using namespace mnt;
  const int num_feats = 2 * num_degs * num_dims;
  const int kpad32 = i8_kpad(num_feats);
  const int kpad64 = round_up(num_feats, 64);
  const int tiles = (n + kI8Tile - 1) / kI8Tile;
  if (width % bn != 0 || (bn != 64 && bn != 128) || depth < 1 || n < 0 ||
      stages < 1 || (n > 0 && (grid < 1 || grid > tiles)))
    return (int)cudaErrorInvalidValue;
  const int smem =
      i8_tile_layout(width, kpad64, num_dims, bn, stages, false).total;
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  CUtensorMap maps[3];
  cudaError_t err =
      i8_forward_maps(maps, w0t, wqt, tailt, width, depth, kpad32,
                      __builtin_popcount((unsigned)skip_mask), bn);
  if (err != cudaSuccess) return (int)err;
  auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  const I8FwdArgs args{
      {f32(means), f32(covs), f32(basis_t), f32(bb_t), f32(sw), f32(biases),
       n, width, depth, kpad32, kpad64, num_dims, num_degs, use_contract,
       stages, tiles, (unsigned)skip_mask},
      static_cast<float*>(stage), static_cast<__nv_bfloat16*>(out)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = bn == 128 ? launch_fwd_tile_pass<128>(maps, args, grid, smem, st)
                  : launch_fwd_tile_pass<64>(maps, args, grid, smem, st);
  return (int)err;
}

// Dynamic shared memory of the tile pass, for the launch plans' checks.
extern "C" int int8_fwd_tile_smem(int width, int num_feats, int num_dims,
                                  int bn, int stages) {
  return mnt::i8_tile_layout(width, mnt::round_up(num_feats, 64), num_dims,
                             bn, stages, false)
      .total;
}
