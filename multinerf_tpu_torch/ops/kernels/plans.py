"""Launch plans of the Hopper backward kernels K3 and K4, in pure Python.

The CUDA sources (``csrc/wgmma_dw.cuh``, ``density_mlp_bwd.cu``,
``featurize_dense_dw.cu``) take these numbers as launch arguments and check
them; the shared-memory sizes here mirror the sources' layouts (the C entry
points ``density_mlp_bwd_smem`` and ``featurize_dense_dw_smem`` report
theirs, and ``chip_smoke.py`` holds the two against each other).

* The weight-gradient GEMM (``wgmma_dw.cuh``): dW[R, W] = A^T @ B over the
  samples.  A CTA owns 128 rows (two wgmma warpgroups of 64) and BN columns
  of dW and a contiguous range of ``per`` 64-sample slabs; ``splits`` ranges
  cover the samples once and fill one wave of the SMs.
* K3's tile pass (``density_mlp_bwd.cu``): 128-sample tiles, one persistent
  CTA per SM, the trunk padded to a width of 64, 128 or 256.
"""

from __future__ import annotations

import dataclasses

SMEM_LIMIT = 232448  # Dynamic shared memory one block may use (H100).
SLAB = 64  # Samples per GEMM pipeline stage: the product's K per stage.
WGMMA_M = 64  # Rows of one wgmma; a consumer warpgroup's share.
WGMMA_K = 16  # Depth of one bf16 wgmma.
DW_TILE_ROWS = 2 * WGMMA_M  # dW rows per GEMM CTA.
DW_STAGES = 4
BWD_TILE = 2 * WGMMA_M  # Samples per K3 tile.
BWD_RING, BWD_SLAB_K = 4, 32  # K3's weight ring: stages, k depth of each.
WIDTHS = (64, 128, 256)  # wgmma widths the kernels are built for.
CONSUMER_THREADS = 256


def _ceil(a, b):
  return -(-a // b)


@dataclasses.dataclass(frozen=True)
class DwGemmPlan:
  rows: int  # R, a multiple of 64.
  width: int  # W, a multiple of bn.
  n: int  # Sample rows of A and B.
  bn: int  # dW columns per CTA.
  splits: int  # Sample ranges (grid z).
  per: int  # 64-sample slabs per range.
  smem: int  # Dynamic shared memory per CTA.

  @property
  def grid(self):
    return (_ceil(self.rows, DW_TILE_ROWS), self.width // self.bn,
            self.splits)

  def sample_ranges(self):
    """[start, stop) of each split, as the kernel walks them."""
    slabs = _ceil(self.n, SLAB)
    return [(z * self.per * SLAB,
             min(self.n, min(self.per, slabs - z * self.per) * SLAB +
                 z * self.per * SLAB))
            for z in range(self.splits)]


def dw_gemm_smem(bn):
  return DW_STAGES * SLAB * (DW_TILE_ROWS + bn) * 2 + 2 * DW_STAGES * 8 + 1024


def dw_gemm_plan(rows, width, n, sms):
  """The GEMM's plan for dW[rows, width] over n samples on `sms` SMs."""
  if rows < WGMMA_M or rows % WGMMA_M:
    raise ValueError(f'{rows} dW rows: the GEMM takes a multiple of 64.')
  if width < 64 or width % 64:
    raise ValueError(f'width {width}: the GEMM takes a multiple of 64.')
  if n < 1 or n >= 2**31:
    raise ValueError(f'{n} samples: the GEMM takes 1 .. 2**31 - 1.')
  bn = next(b for b in (256, 128, 64) if width % b == 0)
  slabs = _ceil(n, SLAB)
  ctas = _ceil(rows, DW_TILE_ROWS) * (width // bn)
  splits = max(1, min(slabs, sms // ctas))
  per = _ceil(slabs, splits)
  return DwGemmPlan(rows, width, n, bn, _ceil(slabs, per), per,
                    dw_gemm_smem(bn))


def padded_width(width):
  """The kernel width a trunk of `width` runs at (zero-padded)."""
  for w in WIDTHS:
    if width <= w:
      return w
  raise ValueError(f'width {width}: the backward kernel takes at most '
                   f'{WIDTHS[-1]}.')


def featurizer_floats(num_dims, rows):
  return num_dims * 12 + rows * 12


def bwd_smem(width, depth, kpad64, num_dims):
  """Dynamic shared memory of K3's tile pass (csrc/density_mlp_bwd.cu,
  bwd_layout): two warpgroups' operand tiles, the 4-stage weight ring, the
  ReLU mask bits, two column-sum buffers per warpgroup (also the
  featurizer's scratch), g, the barriers and the alignment slack."""
  x = max(kpad64, 2 * width) * 128
  slab = width * BWD_SLAB_K * 2
  masks = (depth - 1) * CONSUMER_THREADS * (width // 64) * 4
  aux = max(2 * 4 * width * 4, featurizer_floats(num_dims, 64) * 4)
  aux = _ceil(aux, 16) * 16
  return (2 * x + BWD_RING * slab + masks + 2 * aux + BWD_TILE * 4 +
          2 * BWD_RING * 8 + 1024)


@dataclasses.dataclass(frozen=True)
class BwdPlan:
  width: int  # The padded trunk width.
  kpad: int  # Features rounded up to 64.
  tiles: int
  n_pad: int
  grid: int  # Persistent CTAs of the tile pass.
  smem: int
  dw0: DwGemmPlan  # dW_0: [kpad, width] from the features.
  dw1: DwGemmPlan  # dW_1..: [width, width] from the activations.


def density_mlp_bwd_plan(num_feats, width, depth, num_dims, n, sms):
  """K3's plan: the tile pass and its four dW products."""
  if depth < 2:
    raise ValueError('the backward kernel needs a trunk of depth >= 2.')
  if num_feats < 1 or width < 1:
    raise ValueError(f'{num_feats} features, width {width}.')
  if n < 1:
    raise ValueError(f'{n} samples.')
  wp = padded_width(width)
  kpad = _ceil(num_feats, 64) * 64
  smem = bwd_smem(wp, depth, kpad, num_dims)
  if smem > SMEM_LIMIT:
    raise ValueError(f'{num_feats} features, width {width}, depth {depth}: '
                     f'{smem} bytes of shared memory, over {SMEM_LIMIT}.')
  tiles = _ceil(n, BWD_TILE)
  n_pad = tiles * BWD_TILE
  if depth * n_pad >= 2**31:
    raise ValueError(f'{n} samples: too many for one launch.')
  return BwdPlan(wp, kpad, tiles, n_pad, min(tiles, sms), smem,
                 dw_gemm_plan(kpad, wp, n_pad, sms),
                 dw_gemm_plan(wp, wp, n_pad, sms))


def featurize_smem(kpad64, num_dims):
  """K4's featurize stage: a [64][kpad64 + 8] bf16 tile and the scratch."""
  return _ceil(64 * (kpad64 + 8) * 2, 16) * 16 + featurizer_floats(
      num_dims, 64) * 4


@dataclasses.dataclass(frozen=True)
class DwPlan:
  kpad: int  # Features rounded up to 64: the GEMM's rows.
  smem: int  # The larger stage's dynamic shared memory.
  gemm: DwGemmPlan


def featurize_dense_dw_plan(num_feats, width, num_dims, n, sms):
  """K4's plan: the featurize stage, then the GEMM over n samples."""
  if num_feats < 1:
    raise ValueError(f'{num_feats} features.')
  kpad = _ceil(num_feats, 64) * 64
  gemm = dw_gemm_plan(kpad, width, n, sms)
  smem = max(featurize_smem(kpad, num_dims), gemm.smem)
  if smem > SMEM_LIMIT:
    raise ValueError(f'{num_feats} features: {smem} bytes of shared '
                     f'memory, over {SMEM_LIMIT}.')
  return DwPlan(kpad, smem, gemm)
