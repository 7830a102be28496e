// Shared device code of the fused kernels: per-sample contraction, lifting
// onto the basis and the recurrence IPE, written as bf16 rows into shared
// memory.
//
// The numerics follow multinerf_tpu/ops/pallas/featurize_dense.py:53-114
// (_safe_sin/_safe_cos and _tile_features_t) term for term:
//   * the contraction's f32 formula order (samples reach r^2 ~ 1e12 at
//     far = 1e6, where its three terms cancel);
//   * trig arguments >= 100*pi are reduced with a floor modulo, the
//     jnp.remainder definition (fmodf alone truncates toward zero);
//   * sin/cos/exp are evaluated at degrees 0, 4, 8, ... and the degrees in
//     between follow the double-angle recurrence, the attenuation squaring
//     twice per degree;
//   * feature f = d*L + l is the sin of degree d on basis direction l, and
//     D*L + f its cos, then rounded to bf16 (round to nearest even).
#pragma once

#include <cuda_bf16.h>

namespace mnt {

constexpr int kTile = 64;        // Samples per block.
constexpr int kThreads = 256;    // 8 warps.
constexpr int kWarps = kThreads / 32;
constexpr int kAnchorEvery = 4;  // Degrees between exact sin/cos/exp.
constexpr float kTrigPeriod = 314.15926535897932f;  // f32(100 * pi).
constexpr float kF32Eps = 1.1920928955078125e-07f;

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Row stride (in bf16 elements) of a shared-memory activation tile of
// `cols` columns: +8 elements staggers the rows across banks and keeps
// every 16x16 fragment 32-byte aligned.
__host__ __device__ inline int tile_stride(int cols) { return cols + 8; }

__device__ __forceinline__ float reduce_trig(float x) {
  if (fabsf(x) < kTrigPeriod) return x;
  float r = fmodf(x, kTrigPeriod);  // Exact, sign of x.
  if (r < 0.0f) r += kTrigPeriod;   // Floor modulo: sign of the divisor.
  return r;
}

// Shared-memory scratch of the featurizer: the [L, 3] and [L, 9] lifted
// bases and the per-sample warped (mean, cov) rows of a `rows`-sample tile.
__host__ __device__ inline int featurizer_smem_floats(int num_dims,
                                                      int rows = kTile) {
  return num_dims * 12 + rows * 12;
}

// The IPE features of samples row0 .. row0+kRows-1, computed by threads
// tid = 0 .. nthreads-1: store(s, f, value) receives feature f of sample s
// for f < kpad (the columns from 2 * num_degs * num_dims on are zero), and
// sync() is the barrier of those threads.  Rows past n hold the features of
// a zero Gaussian and are never stored by the callers.  Ends with sync().
template <int kRows, typename Store, typename Sync>
__device__ void featurize_rows(const float* __restrict__ means,
                               const float* __restrict__ covs,
                               const float* __restrict__ basis_t,
                               const float* __restrict__ bb_t, long long row0,
                               int n, int num_dims, int num_degs,
                               bool use_contract, float* scratch, int tid,
                               int nthreads, int kpad, Store store,
                               Sync sync) {
  float* s_basis = scratch;                 // [L][3]
  float* s_bb = scratch + num_dims * 3;     // [L][9]
  float* s_mc = scratch + num_dims * 12;    // [kRows][12]: mean, cov.
  for (int i = tid; i < num_dims * 3; i += nthreads) s_basis[i] = basis_t[i];
  for (int i = tid; i < num_dims * 9; i += nthreads) s_bb[i] = bb_t[i];

  for (int s = tid; s < kRows; s += nthreads) {
    const long long row = row0 + s;
    float m[3] = {0.f, 0.f, 0.f};
    float c[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (row < n) {
      for (int i = 0; i < 3; ++i) m[i] = means[row * 3 + i];
      for (int i = 0; i < 9; ++i) c[i] = covs[row * 9 + i];
    }
    if (use_contract) {
      // Analytic contract() warp: outside the unit ball f(x) = g x,
      // J = g I + k x x^T, cov' = J cov J^T (featurize_dense.py:74-93).
      const float r_sq =
          fmaxf(kF32Eps, m[0] * m[0] + m[1] * m[1] + m[2] * m[2]);
      if (!(r_sq <= 1.0f)) {
        const float r = sqrtf(r_sq);
        const float g = (2.0f * r - 1.0f) / r_sq;
        const float k = (2.0f - 2.0f * r) / (r_sq * r_sq);
        float mv[3];
        for (int i = 0; i < 3; ++i)
          mv[i] = c[3 * i] * m[0] + c[3 * i + 1] * m[1] + c[3 * i + 2] * m[2];
        const float xcx = m[0] * mv[0] + m[1] * mv[1] + m[2] * mv[2];
        float nc[9];
        for (int i = 0; i < 3; ++i)
          for (int j = 0; j < 3; ++j)
            nc[3 * i + j] = g * g * c[3 * i + j] +
                            g * k * (m[i] * mv[j] + mv[i] * m[j]) +
                            k * k * xcx * m[i] * m[j];
        for (int i = 0; i < 9; ++i) c[i] = nc[i];
        for (int i = 0; i < 3; ++i) m[i] = g * m[i];
      }
    }
    for (int i = 0; i < 3; ++i) s_mc[s * 12 + i] = m[i];
    for (int i = 0; i < 9; ++i) s_mc[s * 12 + 3 + i] = c[i];
  }
  sync();

  const int num_feats = 2 * num_degs * num_dims;
  const int half = num_degs * num_dims;
  for (int p = tid; p < kRows * num_dims; p += nthreads) {
    const int s = p / num_dims;
    const int l = p - s * num_dims;
    const float* mc = s_mc + s * 12;
    const float* b = s_basis + l * 3;
    const float* bb = s_bb + l * 9;
    const float args0 = b[0] * mc[0] + b[1] * mc[1] + b[2] * mc[2];
    float var0 = 0.0f;
    for (int k = 0; k < 9; ++k) var0 += bb[k] * mc[3 + k];
    float sn = 0.f, cs = 0.f, e = 0.f;
    for (int d = 0; d < num_degs; ++d) {
      if (d % kAnchorEvery == 0) {
        const float freq = (float)(1 << d);
        const float a = d == 0 ? args0 : freq * args0;
        const float ar = reduce_trig(a);
        sn = sinf(ar);
        cs = cosf(ar);
        e = expf((-0.5f * freq * freq) * var0);
      } else {
        const float s2 = 2.0f * (sn * cs);
        cs = 1.0f - 2.0f * (sn * sn);
        sn = s2;
        const float e2 = e * e;
        e = e2 * e2;
      }
      store(s, l + d * num_dims, __float2bfloat16_rn(e * sn));
      store(s, half + l + d * num_dims, __float2bfloat16_rn(e * cs));
    }
  }
  // Zero the padding columns so they add nothing to the products.
  const int extra = kpad - num_feats;
  for (int i = tid; i < kRows * extra; i += nthreads) {
    const int s = i / extra;
    store(s, num_feats + (i - s * extra), __float2bfloat16_rn(0.0f));
  }
  sync();
}

}  // namespace mnt
