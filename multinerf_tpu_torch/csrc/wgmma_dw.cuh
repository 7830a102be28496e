// Hopper (sm_90a) building blocks of the backward kernels K3
// (density_mlp_bwd.cu), K4 (featurize_dense_dw.cu) and K6
// (int8_trunk_bwd.cu): mbarriers, TMA copies, wgmma.mma_async (bf16 and
// s8), the ordered reduce of split partials, and the weight-gradient GEMM
// the three share,
//   dW[R, W] = A^T @ B summed over all samples,
// with A bf16 [N, R] and B bf16 [N, W] in device memory (row = sample) and
// f32 accumulation.
//
// The GEMM: a CTA owns a 128 x BN block of dW (BN = 256, 128 or 64, the
// widest that divides W, so a 256-wide layer's A is read once) and one
// contiguous range of 64-sample slabs: split-K over samples, with enough
// splits to fill one wave of the SMs.  One producer warp streams each slab's
// A and B tiles with TMA into a 4-stage ring of 128-byte-swizzled shared
// memory, tracked by full/empty mbarriers, so the loads of the next slabs
// overlap the products of this one.  Two consumer warpgroups, 64 rows of dW
// each, run wgmma m64nBNk16 on the tiles, accumulating in registers.  The
// sample axis is the product's K and both operands are stored sample-major,
// so wgmma reads both MN-major (transposed, tnspA = tnspB = 1): nothing is
// transposed in memory.  Each split stores its [R, W] partial and
// reduce_splits sums the splits in order.  No atomics: the result is
// bitwise deterministic.
#pragma once

// cuda.h for CUtensorMap and its enums only: the encoder comes from the
// runtime (cudaGetDriverEntryPoint), so nothing links against libcuda.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "features.cuh"

namespace mnt {

constexpr int kBoxBytes = 64 * 128;  // One [64][64] bf16 TMA box: 8 KB.
constexpr int kSlab = 64;            // Samples per GEMM pipeline stage.
constexpr int kDwTileRows = 128;     // dW rows per CTA: two warpgroups.
constexpr int kDwStages = 4;
constexpr int kConsumerThreads = 256;  // Two consumer warpgroups.
constexpr int kProducerWarp = kConsumerThreads / 32;
constexpr int kHopperThreads = kConsumerThreads + 32;  // + the producer warp.
constexpr int kSmemLimit = 232448;  // Dynamic shared memory a block may use.

// 8 consecutive values, rounded to bf16, as one 16-byte word (p is
// 16-byte aligned for bf16 and 32-byte aligned for f32).
__device__ __forceinline__ uint4 load8_bf16(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ uint4 load8_bf16(const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  uint4 out;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&out);
  h[0] = __floats2bfloat162_rn(a.x, a.y);
  h[1] = __floats2bfloat162_rn(a.z, a.w);
  h[2] = __floats2bfloat162_rn(b.x, b.y);
  h[3] = __floats2bfloat162_rn(b.z, b.w);
  return out;
}

// out[i] = sum_p part[p * stride + i] for i < count, p = 0, 1, ... in order:
// the fixed-order sum of split partials that keeps the backward kernels
// deterministic (the TPU kernels accumulated over an ordered grid).
__global__ void reduce_splits_kernel(const float* __restrict__ part,
                                     int num_splits, long long stride,
                                     long long count,
                                     float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float sum = 0.0f;
  for (int p = 0; p < num_splits; ++p) sum += part[p * stride + i];
  out[i] = sum;
}

inline cudaError_t reduce_splits(const float* part, int num_splits,
                                 long long stride, long long count,
                                 float* out, cudaStream_t stream) {
  if (count == 0) return cudaSuccess;
  const int threads = 256;
  const long long blocks = (count + threads - 1) / threads;
  reduce_splits_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      part, num_splits, stride, count, out);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- PTX ---

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1,024-byte aligned byte at or after p (128-byte swizzled tiles
// repeat every 1,024 bytes; TMA and wgmma assume the pattern starts there).
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024u - (smem_addr(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Arrives and expects `bytes` more of TMA transfers in the current phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` has completed.  A wait that
// never ends (a pipeline fault) traps, which the launch reports as an
// error, instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  long long spins = 0;
  do {
    if (++spins > (1ll << 26)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Barrier `id` (1..15) of `threads` threads (whole warps).
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Orders this thread's shared-memory writes before later reads by the
// async proxy (TMA stores, wgmma operands).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// TMA: the box at (col, row) of `map` into shared memory at dst,
// completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col),
      "r"(row)
      : "memory");
}

// TMA: shared memory at src to the box at (col, row) of `map`.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(col), "r"(row)
      : "memory");
}

// TMA multicast: the box at (col, row) of `map` into shared memory at dst
// in each CTA of the cluster named by `mask` (bit i: rank i), completing on
// the mbarrier at bar's offset in each of them.
__device__ __forceinline__ void tma_load_multicast(void* dst,
                                                   const CUtensorMap* map,
                                                   uint64_t* bar, int col,
                                                   int row, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col),
      "r"(row), "h"(mask)
      : "memory");
}

// This CTA's rank in its cluster.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
  return rank;
}

// Every thread of every CTA of the cluster: a barrier that orders their
// shared-memory operations (mbarrier initialisation before remote use;
// remote arrivals and multicast writes before a CTA exits).
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n\t"
      "barrier.cluster.wait.acquire;" ::
          : "memory");
}

// Arrives on the mbarrier at bar's offset in cluster CTA `rank`.
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar,
                                                    uint32_t rank) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(rank)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// All but the newest kPending of this thread's committed TMA store groups
// have read their shared memory.
template <int kPending = 0>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(kPending)
               : "memory");
}

// This thread's committed TMA stores are complete.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending)
               : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma region.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a swizzled operand (the swizzle atom
// aligned to 8 rows).  kSwizzle128: 128-byte rows; K-major: rows of 64 k
// values, 8-row groups `sbo` bytes apart (`lbo` unused); MN-major: rows of
// 64 m (or n) values, one per k, 8-k-row groups `sbo` bytes apart and
// 64-wide m (or n) blocks `lbo` bytes apart.  kSwizzle64: K-major rows of
// 32 k values (64 bytes), 8-row groups `sbo` bytes apart.
constexpr uint64_t kSwizzle128 = 1, kSwizzle64 = 2;
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo,
                                              uint64_t swizzle = kSwizzle128) {
  return (uint64_t)((smem_addr(p) & 0x3FFFFu) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) | (swizzle << 62);
}

// Byte offset of element (row, col) of a [64][cols] bf16 tile stored as
// 64-column blocks of [64 rows][128 bytes], 128-byte swizzled: TMA's
// SWIZZLE_128B layout of consecutive [64][64] boxes, and wgmma's K-major
// operand layout.
__device__ __forceinline__ int swizzled_offset(int row, int col) {
  return (col >> 6) * kBoxBytes + row * 128 +
         ((((col & 63) >> 3) ^ (row & 7)) << 4) + (col & 7) * 2;
}

// wgmma.mma_async m64nNk16 (bf16 inputs, f32 accumulators) and m64nNk32
// (s8 inputs, s32 accumulators), A and B from shared memory.  Both keep d
// in the register layout of PTX's "wgmma D" fragment: d[i] is row 16 *
// warp + lane / 4 + 8 * ((i / 2) % 2), column 8 * (i / 4) + 2 * (lane % 4)
// + i % 2.  d = A @ B + (scale_d ? d : 0).  8-bit wgmma has no transpose:
// both s8 operands are K-major.
#define MNT_R4(c, d, i) c(d[i]), c(d[(i) + 1]), c(d[(i) + 2]), c(d[(i) + 3])
#define MNT_R16(c, d, i)                                         \
  MNT_R4(c, d, i), MNT_R4(c, d, (i) + 4), MNT_R4(c, d, (i) + 8), \
      MNT_R4(c, d, (i) + 12)
#define MNT_R32(c, d, i) MNT_R16(c, d, i), MNT_R16(c, d, (i) + 16)
#define MNT_R64(c, d, i) MNT_R32(c, d, i), MNT_R32(c, d, (i) + 32)
#define MNT_R128(c, d, i) MNT_R64(c, d, i), MNT_R64(c, d, (i) + 64)
#define MNT_REGS32 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define MNT_REGS64 \
  MNT_REGS32 ", " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define MNT_REGS128 \
  MNT_REGS64 ", " \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"

template <int kTnspA, int kTnspB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t desc_a,
                                          uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" MNT_REGS32
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : MNT_R32("+f", d, 0)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTnspA), "n"(kTnspB));
}

template <int kTnspA, int kTnspB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t desc_a,
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" MNT_REGS64
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : MNT_R64("+f", d, 0)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTnspA), "n"(kTnspB));
}

template <int kTnspA, int kTnspB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t desc_a,
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" MNT_REGS128
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : MNT_R128("+f", d, 0)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTnspA), "n"(kTnspB));
}

__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {" MNT_REGS32
      "}, %32, %33, p;\n}\n"
      : MNT_R32("+r", d, 0)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {" MNT_REGS64
      "}, %64, %65, p;\n}\n"
      : MNT_R64("+r", d, 0)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <int N, int kTnspA, int kTnspB>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t desc_a,
                                      uint64_t desc_b, int scale_d) {
  if constexpr (N == 64) {
    wgmma_n64<kTnspA, kTnspB>(d, desc_a, desc_b, scale_d);
  } else if constexpr (N == 128) {
    wgmma_n128<kTnspA, kTnspB>(d, desc_a, desc_b, scale_d);
  } else {
    static_assert(N == 256, "wgmma width must be 64, 128 or 256");
    wgmma_n256<kTnspA, kTnspB>(d, desc_a, desc_b, scale_d);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  if constexpr (N == 64) {
    wgmma_s8_n64(d, desc_a, desc_b, scale_d);
  } else {
    static_assert(N == 128, "s8 wgmma width must be 64 or 128");
    wgmma_s8_n128(d, desc_a, desc_b, scale_d);
  }
}

// --------------------------------------------------------------- host ---

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// The TMA map of a row-major [rows][cols] matrix of `elem_bytes`-byte
// elements moved in boxes of [box_rows][box_cols] (box_cols * elem_bytes
// bytes a row, the swizzle's span).  Rows and columns past the end read as
// zeros and are not written.
inline cudaError_t tile_map(CUtensorMap* map, CUtensorMapDataType type,
                            int elem_bytes, const void* base, long long rows,
                            int cols, int box_rows, int box_cols,
                            CUtensorMapSwizzle swizzle) {
  static EncodeTiledFn encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  if (rows < 1 || box_rows < 1 || box_rows > 256)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The TMA map of a row-major bf16 [rows][cols] matrix moved in boxes of
// [box_rows][box_cols], swizzled in shared memory: 128-byte rows (box_cols
// 64) or 64-byte rows (box_cols 32).  Rows past the end read as zeros and
// are not written.
inline cudaError_t bf16_tile_map(CUtensorMap* map, const void* base,
                                 long long rows, int cols, int box_rows,
                                 int box_cols = 64) {
  if (cols % 64 != 0 || (box_cols != 64 && box_cols != 32))
    return cudaErrorInvalidValue;
  return tile_map(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, rows, cols, box_rows,
      box_cols,
      box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
}

// --------------------------------------------------------------- GEMM ---

__host__ __device__ constexpr int dw_stage_bytes(int bn) {
  return kSlab * (kDwTileRows + bn) * 2;
}

// Dynamic shared memory of dw_gemm_kernel<bn>: the ring, its barriers, and
// slack to align the ring to 1,024 bytes.
__host__ __device__ constexpr int dw_gemm_smem(int bn) {
  return kDwStages * dw_stage_bytes(bn) + 2 * kDwStages * 8 + 1024;
}

// part[z][rows][width] = the share of slabs [z * per, z * per + per) of
// A^T @ B, for the 128 x BN block (blockIdx.x, blockIdx.y) of dW.  A map:
// [N][rows], B map: [N][width], both in [64][64] boxes.  Caller, a type
// the launching kernel declares, only names the instance, so that a
// profile tells K3's dW products from K4's.
template <int BN, typename Caller>
__global__ void __launch_bounds__(kHopperThreads, 1)
dw_gemm_kernel(const __grid_constant__ CUtensorMap a_map,
               const __grid_constant__ CUtensorMap b_map, int rows,
               int width, int num_slabs, int per,
               float* __restrict__ part) {
  constexpr int kStage = dw_stage_bytes(BN);
  constexpr int kABytes = kSlab * kDwTileRows * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kDwStages * kStage);
  uint64_t* empty = full + kDwStages;
  const int m0 = blockIdx.x * kDwTileRows;
  const int n0 = blockIdx.y * BN;
  const int slab0 = blockIdx.z * per;
  const int count = min(per, num_slabs - slab0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDwStages; ++s) {
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
    const bool two = m0 + 64 < rows;
    if (lane == 0) {
      for (int it = 0; it < count; ++it) {
        const int s = it % kDwStages;
        mbar_wait(&empty[s], ((it / kDwStages) & 1) ^ 1);
        unsigned char* a = smem + s * kStage;
        unsigned char* b = a + kABytes;
        const int row = (slab0 + it) * kSlab;
        mbar_expect_tx(&full[s], kStage - (two ? 0 : kBoxBytes));
        tma_load(a, &a_map, &full[s], m0, row);
        if (two) tma_load(a + kBoxBytes, &a_map, &full[s], m0 + 64, row);
        for (int j = 0; j < BN / 64; ++j)
          tma_load(b + j * kBoxBytes, &b_map, &full[s], n0 + j * 64, row);
      }
    }
    return;
  }

  const int wg = warp / 4;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  for (int it = 0; it < count; ++it) {
    const int s = it % kDwStages;
    mbar_wait(&full[s], (it / kDwStages) & 1);
    const unsigned char* a = smem + s * kStage + wg * kBoxBytes;
    const unsigned char* b = smem + s * kStage + kABytes;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kSlab / 16; ++k)
      wgmma<BN, 1, 1>(acc, smem_desc(a + k * 2048, kBoxBytes, 1024),
                      smem_desc(b + k * 2048, kBoxBytes, 1024), 1);
    wgmma_commit();
    fence_acc(acc);
    // The products of the previous slab are done: release its stage.
    wgmma_wait<1>();
    fence_acc(acc);
    if (it > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % kDwStages]);
  }
  wgmma_wait<0>();
  fence_acc(acc);

  float* out = part + (size_t)blockIdx.z * rows * width;
  const int r0 = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int q = 0; q < BN / 8; ++q) {
    const int col = n0 + q * 8 + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      if (row < rows)
        *reinterpret_cast<float2*>(out + (size_t)row * width + col) =
            make_float2(acc[4 * q + 2 * h], acc[4 * q + 2 * h + 1]);
    }
  }
}

template <int BN, typename Caller>
cudaError_t dw_gemm_launch(const CUtensorMap& a_map, const CUtensorMap& b_map,
                           int rows, int width, int num_slabs, int splits,
                           int per, float* part, cudaStream_t stream) {
  const int smem = dw_gemm_smem(BN);
  cudaError_t err = cudaFuncSetAttribute(
      dw_gemm_kernel<BN, Caller>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((rows + kDwTileRows - 1) / kDwTileRows, width / BN, splits);
  dw_gemm_kernel<BN, Caller><<<grid, kHopperThreads, smem, stream>>>(
      a_map, b_map, rows, width, num_slabs, per, part);
  return cudaGetLastError();
}

// out[rows_out][width] = the first rows_out rows of A^T @ B over n_rows
// samples, A bf16 [n_rows][rows], B bf16 [n_rows][width]; part holds
// splits * rows * width floats.  The plan (bn, splits, per) comes from the
// caller (plans.dw_gemm_plan): slab ranges of `per` slabs cover every
// sample once.
template <typename Caller>
cudaError_t dw_gemm(const void* a, const void* b, long long n_rows, int rows,
                    int width, int rows_out, int bn, int splits, int per,
                    float* part, float* out, cudaStream_t stream) {
  const long long slabs = (n_rows + kSlab - 1) / kSlab;
  if (n_rows < 1 || n_rows >= (1ll << 31) || rows % 64 != 0 || rows < 64 ||
      rows_out > rows || (bn != 64 && bn != 128 && bn != 256) ||
      width % bn != 0 || splits < 1 || per < 1 ||
      (long long)(splits - 1) * per >= slabs ||
      (long long)splits * per < slabs)
    return cudaErrorInvalidValue;
  CUtensorMap a_map, b_map;
  cudaError_t err = bf16_tile_map(&a_map, a, n_rows, rows, 64);
  if (err != cudaSuccess) return err;
  err = bf16_tile_map(&b_map, b, n_rows, width, 64);
  if (err != cudaSuccess) return err;
  const int num_slabs = (int)slabs;
  if (bn == 256)
    err = dw_gemm_launch<256, Caller>(a_map, b_map, rows, width,
                                      num_slabs, splits, per, part, stream);
  else if (bn == 128)
    err = dw_gemm_launch<128, Caller>(a_map, b_map, rows, width,
                                      num_slabs, splits, per, part, stream);
  else
    err = dw_gemm_launch<64, Caller>(a_map, b_map, rows, width, num_slabs,
                                     splits, per, part, stream);
  if (err != cudaSuccess) return err;
  return reduce_splits(part, splits, (long long)rows * width,
                       (long long)rows_out * width, out, stream);
}

}  // namespace mnt
