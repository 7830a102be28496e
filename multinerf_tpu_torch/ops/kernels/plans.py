"""Launch plans of the Hopper kernels K1-K4 and K6's dW half, in pure
Python.

The CUDA sources (``csrc/tile_pass.cuh``, ``wgmma_dw.cuh``,
``density_mlp.cu``, ``featurize_dense.cu``, ``density_mlp_bwd.cu``,
``featurize_dense_dw.cu``, ``int8_trunk_bwd.cu``) take these numbers as
launch arguments and check them; the shared-memory sizes here mirror the
sources' layouts (the C entry points ``density_mlp_smem``,
``featurize_dense_smem``, ``density_mlp_bwd_smem``,
``featurize_dense_dw_smem`` and ``int8_dw_gemm_smem`` report theirs, and
``chip_smoke.py`` holds the two against each other).

* The weight-gradient GEMM (``wgmma_dw.cuh``): dW[R, W] = A^T @ B over the
  samples.  A CTA owns 128 rows (two wgmma warpgroups of 64) and BN columns
  of dW and a contiguous range of ``per`` 64-sample slabs; ``splits`` ranges
  cover the samples once and fill one wave of the SMs.
* K6's dW products (``int8_trunk_bwd.cu``): the bf16 ones (dW_0 and each
  skip layer's feature rows; the hidden dW under 'int8_hybrid') on that
  GEMM, the int8 hidden dW on an s8 wgmma GEMM whose CTAs own 128 x BN
  blocks of dW and a contiguous range of ``per`` sample groups (the JAX
  kernel's tiles, each a whole number of 64-sample slabs).
* The tile passes of K1, K2 and K3 (``tile_pass.cuh``): 128-sample tiles,
  one persistent CTA per SM; K3's CTAs walk tiles blockIdx, blockIdx + grid,
  ...; K1's and K2's come in clusters of two that walk pairs of tiles and
  share one multicast weight stream.  K1's and K3's trunk is padded to a
  width of 64, 128 or 256; K2's output columns are walked in slabs of 64,
  128 or 256 and stored by TMA from two shared-memory boxes per warpgroup,
  or from registers where a wide feature tile leaves no room for the boxes.
"""

from __future__ import annotations

import dataclasses

SMEM_LIMIT = 232448  # Dynamic shared memory one block may use (H100).
SLAB = 64  # Samples per GEMM pipeline stage: the product's K per stage.
WGMMA_M = 64  # Rows of one wgmma; a consumer warpgroup's share.
WGMMA_K = 16  # Depth of one bf16 wgmma.
DW_TILE_ROWS = 2 * WGMMA_M  # dW rows per GEMM CTA.
DW_STAGES = 4
TILE = 2 * WGMMA_M  # Samples per tile of K1, K2 and K3.
BWD_RING, BWD_SLAB_K = 4, 32  # K3's weight ring: stages, k depth of each.
FWD_STAGES = (4, 3, 2)  # K1's and K2's ring depths, deepest that fits first.
FWD_CLUSTER = 2  # CTAs of K1's and K2's clusters, sharing a weight stream.
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
  raise ValueError(f'width {width}: the density MLP kernels take at most '
                   f'{WIDTHS[-1]}.')


def featurizer_floats(num_dims, rows):
  return num_dims * 12 + rows * 12


def bwd_smem(width, depth, kx, num_dims):
  """Dynamic shared memory of K3's tile pass (csrc/density_mlp_bwd.cu,
  bwd_layout): two warpgroups' operand tiles (a feature part of kx columns,
  later two activation buffers), the 4-stage weight ring, the ReLU mask
  bits, two column-sum buffers per warpgroup (also the featurizer's
  scratch), g, the barriers and the alignment slack."""
  x = max(kx, 2 * width) * 128
  slab = width * BWD_SLAB_K * 2
  masks = (depth - 1) * CONSUMER_THREADS * (width // 64) * 4
  aux = max(2 * 4 * width * 4, featurizer_floats(num_dims, 64) * 4)
  aux = _ceil(aux, 16) * 16
  return (2 * x + BWD_RING * slab + masks + 2 * aux + TILE * 4 +
          2 * BWD_RING * 8 + 1024)


@dataclasses.dataclass(frozen=True)
class BwdPlan:
  width: int  # The padded trunk width.
  kpad: int  # Rows of w0 and of dW_0's GEMM: parts * kx.
  tiles: int
  n_pad: int
  grid: int  # Persistent CTAs of the tile pass.
  smem: int
  dw0: DwGemmPlan  # dW_0: [kpad, width] from the features.
  dw1: DwGemmPlan  # dW_1..: [width, width] from the activations.
  parts: int = 1  # Layer 0's K-parts: 1, or 2 (the sin half, the cos half).
  kx: int = 0  # Columns of one part: its features rounded up to 64.

  def w0_rows(self, num_feats):
    """[(first feature, first row of w0, count)] of each part: part p's
    features lie in rows p * kx .. of w0 and of the feats scratch."""
    per = num_feats // self.parts
    return [(p * per, p * self.kx, per) for p in range(self.parts)]


def density_mlp_bwd_plan(num_feats, width, depth, num_dims, n, sms,
                         parts=None):
  """K3's plan: the tile pass and its four dW products.  Layer 0 runs in
  one K-part where the feature tile fits beside the rest, else in two (the
  sin and the cos half of the features, each padded to 64 columns), as
  csrc/density_mlp_bwd.cu lays them out; `parts` asks for one layout (the
  checks that hold the two against each other)."""
  if depth < 2:
    raise ValueError('the backward kernel needs a trunk of depth >= 2.')
  if num_feats < 1 or width < 1:
    raise ValueError(f'{num_feats} features, width {width}.')
  if n < 1:
    raise ValueError(f'{n} samples.')
  wp = padded_width(width)
  for parts in (1, 2) if parts is None else (parts,):
    kx = _ceil(num_feats // parts, 64) * 64
    smem = bwd_smem(wp, depth, kx, num_dims)
    if smem <= SMEM_LIMIT:
      break
  else:
    raise ValueError(f'{num_feats} features, width {width}, depth {depth}: '
                     f'{smem} bytes of shared memory, over {SMEM_LIMIT}.')
  tiles = _ceil(n, TILE)
  n_pad = tiles * TILE
  if depth * n_pad >= 2**31:
    raise ValueError(f'{n} samples: too many for one launch.')
  return BwdPlan(wp, parts * kx, tiles, n_pad, min(tiles, sms), smem,
                 dw_gemm_plan(parts * kx, wp, n_pad, sms),
                 dw_gemm_plan(wp, wp, n_pad, sms), parts, kx)


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


OUT_BOX = 64 * 32 * 4  # K2: one [64][32] f32 TMA store box.


def fwd_smem(x_cols, slab_bytes, stages, num_dims, out_bytes):
  """Dynamic shared memory of K1's and K2's tile pass (csrc/tile_pass.cuh,
  fwd_layout): two warpgroups' operand tiles of x_cols bf16 columns, the
  weight ring, two warpgroups' `out_bytes` of output staging, two
  featurizer scratch areas, the barriers and the alignment slack."""
  scratch = _ceil(featurizer_floats(num_dims, 64) * 4, 16) * 16
  return (2 * x_cols * 128 + stages * slab_bytes + 2 * out_bytes +
          2 * scratch + 2 * stages * 8 + 1024)


@dataclasses.dataclass(frozen=True)
class FwdPlan:
  """A forward tile pass: clusters of FWD_CLUSTER CTAs, each cluster
  walking pairs of 128-sample tiles and sharing one weight stream."""
  width: int  # K1: the padded trunk width; K2: the column slab (BN).
  kpad: int  # Features rounded up to 64.
  stages: int  # Depth of the weight ring.
  tiles: int  # 128-sample tiles.
  clusters: int  # Persistent clusters.
  smem: int
  col_slabs: int = 1  # K2: column slabs of `width` over the output.
  staged: bool = False  # K2: TMA stores through shared-memory boxes.

  @property
  def grid(self):
    return FWD_CLUSTER * self.clusters

  @property
  def padded_cols(self):
    """K2: the weight columns the kernel reads (the rest zero-padded)."""
    return self.col_slabs * self.width

  def cta_tiles(self, cta):
    """The tiles CTA `cta` walks, in order, as csrc/tile_pass.cuh's
    FwdTiles: rank r of cluster c takes tile 2 * pair + r of the pairs c,
    c + clusters, ...  A pair past the last tile runs with no rows."""
    c, r = divmod(cta, FWD_CLUSTER)
    pairs = _ceil(self.tiles, FWD_CLUSTER)
    return [FWD_CLUSTER * p + r for p in range(c, pairs, self.clusters)
            if FWD_CLUSTER * p + r < self.tiles]


def _fwd_plan(x_cols, slab_cols, num_dims, n, max_clusters, what,
              out_options=(0,)):
  """(stages, out_bytes, tiles, clusters, smem): the first of `out_options`
  (output staging bytes per warpgroup) with which a ring fits, the deepest
  such ring, and one cluster per tile pair up to what the card holds at
  once."""
  if n < 1 or n >= 2**31:
    raise ValueError(f'{n} samples: the kernel takes 1 .. 2**31 - 1.')
  if max_clusters < 1:
    raise ValueError(f'{max_clusters} clusters: the card holds none.')
  for out_bytes in out_options:
    for stages in FWD_STAGES:
      smem = fwd_smem(x_cols, slab_cols * BWD_SLAB_K * 2, stages, num_dims,
                      out_bytes)
      if smem <= SMEM_LIMIT:
        tiles = _ceil(n, TILE)
        return (stages, out_bytes, tiles,
                min(_ceil(tiles, FWD_CLUSTER), max_clusters), smem)
  raise ValueError(f'{what}: {smem} bytes of shared memory, over '
                   f'{SMEM_LIMIT}.')


def density_mlp_fwd_plan(num_feats, width, num_dims, n, max_clusters):
  """K1's plan: the trunk padded to a wgmma width, the ring that fits, and
  up to `max_clusters` clusters (what the card holds at once)."""
  if num_feats < 1 or width < 1:
    raise ValueError(f'{num_feats} features, width {width}.')
  wp = padded_width(width)
  kpad = _ceil(num_feats, 64) * 64
  stages, _, tiles, clusters, smem = _fwd_plan(
      max(kpad, wp), wp, num_dims, n, max_clusters,
      f'{num_feats} features, width {width}')
  return FwdPlan(wp, kpad, stages, tiles, clusters, smem)


def dense_slab(width):
  """K2's column slab for an output of `width` columns."""
  return next(b for b in WIDTHS if width <= b or b == WIDTHS[-1])


def featurize_dense_fwd_plan(num_feats, width, num_dims, n, max_clusters):
  """K2's plan: column slabs over the output, two output boxes per
  warpgroup for its TMA stores where they fit beside a ring (else stores
  from registers), the deepest ring that fits, and up to `max_clusters`
  clusters."""
  if num_feats < 1:
    raise ValueError(f'{num_feats} features.')
  if width < 32 or width % 32:
    raise ValueError(f'width {width} must be a multiple of 32.')
  bn = dense_slab(width)
  kpad = _ceil(num_feats, 64) * 64
  stages, out_bytes, tiles, clusters, smem = _fwd_plan(
      kpad, bn, num_dims, n, max_clusters, f'{num_feats} features',
      (2 * OUT_BOX, 0))
  return FwdPlan(bn, kpad, stages, tiles, clusters, smem, _ceil(width, bn),
                 out_bytes > 0)


S8_STAGES = 6  # The s8 dW GEMM's ring: [128 + BN][128] int8 per stage.
S8_SLAB = 128  # Samples per stage of the s8 GEMM (128-byte K-major rows).


def s8_dw_smem(bn):
  """Dynamic shared memory of K6's s8 dW GEMM (int8_trunk_bwd.cu,
  s8_dw_smem): the ring, each stage's group absmaxes, the barriers, the
  alignment slack."""
  return (S8_STAGES * (S8_SLAB + 4) * (DW_TILE_ROWS + bn) +
          2 * S8_STAGES * 8 + 1024)


@dataclasses.dataclass(frozen=True)
class S8DwPlan:
  width: int  # W: dW is [W, W].
  group: int  # Samples per group (a whole number of 128-sample slabs).
  groups: int
  bn: int  # dW columns per CTA.
  splits: int  # Group ranges (grid z).
  per: int  # Groups per range.
  smem: int

  @property
  def grid(self):
    return (_ceil(self.width, DW_TILE_ROWS), self.width // self.bn,
            self.splits)

  def group_ranges(self):
    """[start, stop) of each split's groups, as the kernel walks them."""
    return [(z * self.per, min(self.groups, (z + 1) * self.per))
            for z in range(self.splits)]


def s8_dw_plan(width, n_pad, group, sms):
  """K6's int8 hidden dW over n_pad samples in groups of `group`: BN = 128
  where it divides W (int32 and f32 accumulators both in registers), and
  enough group ranges to fill one wave of the SMs."""
  if width < 64 or width % 64:
    raise ValueError(f'width {width}: the s8 GEMM takes a multiple of 64.')
  if group < S8_SLAB or group % S8_SLAB:
    raise ValueError(f'group {group}: the s8 GEMM takes whole slabs of '
                     f'{S8_SLAB} samples.')
  if n_pad < group or n_pad % group:
    raise ValueError(f'{n_pad} samples are not whole groups of {group}.')
  bn = 128 if width % 128 == 0 else 64
  groups = n_pad // group
  ctas = _ceil(width, DW_TILE_ROWS) * (width // bn)
  splits = max(1, min(groups, sms // ctas))
  per = _ceil(groups, splits)
  return S8DwPlan(width, group, groups, bn, _ceil(groups, per), per,
                  s8_dw_smem(bn))


I8_TILE = 64  # Samples per tile of the int8 tile pass (K5, K6): wgmma's M.
I8_STAGES = (6, 5, 4, 3, 2)  # Its rings' depths, deepest that fits first.


def i8_tile_smem(width, kpad64, num_dims, bn, stages, backward=True):
  """Dynamic shared memory of the int8 tile pass (int8_tile_pass.cuh,
  i8_tile_layout): the int8 input tile A [64][W] in whole [64][128-byte]
  blocks (at least the featurizer's scratch), the bf16 features F [64][kpad64]
  (K6's hybrid dx: a bf16 [64][W] over both), two warpgroups' rings of
  [BN][64-byte] slabs, K6's column-reduction buffers, the row maxima, the
  per-sample scales and their reciprocals, the barriers and the alignment
  slack.  backward: K6's layout, else K5's."""
  scratch = featurizer_floats(num_dims, I8_TILE) * 4
  f = _ceil(max(I8_TILE * _ceil(width, 128) * 128, scratch), 1024) * 1024
  hybrid = I8_TILE * width * 2 if backward else 0
  region = _ceil(max(f + I8_TILE * kpad64 * 2, hybrid), 1024) * 1024
  colred = 2 * 2 * 4 * bn * 4 if backward else 0
  return (region + 2 * stages * bn * 64 + colred + 2 * I8_TILE * 4 +
          2 * I8_TILE * 4 + 2 * 2 * stages * 8 + 1024)


@dataclasses.dataclass(frozen=True)
class I8TilePlan:
  """The int8 tile pass: persistent CTAs over 64-sample tiles, the two
  consumer warpgroups taking the BN-column blocks of each layer in turn."""
  bn: int  # Output columns per wgmma block.
  stages: int  # Depth of each warpgroup's weight ring.
  tiles: int
  grid: int  # Persistent CTAs.
  smem: int

  def cta_tiles(self, cta):
    """The tiles CTA `cta` walks, in order."""
    return list(range(cta, self.tiles, self.grid))


def _i8_tile(num_feats, width, num_dims, tiles, sms, backward):
  """BN = 128 where it divides W, the deepest rings that fit, one CTA per
  SM over `tiles` tiles."""
  if width < 64 or width % 64:
    raise ValueError(f'width {width}: the tile pass takes a multiple of 64.')
  bn = 128 if width % 128 == 0 else 64
  kpad64 = _ceil(num_feats, 64) * 64
  for stages in I8_STAGES:
    smem = i8_tile_smem(width, kpad64, num_dims, bn, stages, backward)
    if smem <= SMEM_LIMIT:
      return I8TilePlan(bn, stages, tiles, min(tiles, sms), smem)
  raise ValueError(f'{num_feats} features, width {width}: {smem} bytes of '
                   f'shared memory, over {SMEM_LIMIT}.')


def i8_tile_plan(num_feats, width, num_dims, n_pad, sms):
  """K6's tile pass over n_pad samples."""
  if n_pad < I8_TILE or n_pad % I8_TILE:
    raise ValueError(f'{n_pad} samples are not whole tiles of {I8_TILE}.')
  return _i8_tile(num_feats, width, num_dims, n_pad // I8_TILE, sms, True)


@dataclasses.dataclass(frozen=True)
class I8FwdPlan(I8TilePlan):
  """K5: its tile pass and its staging block."""
  stage_floats: int  # [grid][64][W] f32: each CTA's rows of a hidden layer.


def i8_fwd_plan(num_feats, width, num_dims, n, sms):
  """K5 over n samples: ceil(n / 64) tiles, the last one ragged."""
  if n < 1:
    raise ValueError(f'{n} samples: K5 needs at least one.')
  t = _i8_tile(num_feats, width, num_dims, _ceil(n, I8_TILE), sms, False)
  return I8FwdPlan(*dataclasses.astuple(t), t.grid * I8_TILE * width)


@dataclasses.dataclass(frozen=True)
class Int8BwdPlan:
  """K6: its tile pass, its scratch and its dW products."""
  tile: I8TilePlan
  width: int
  n_pad: int  # Samples padded as the JAX kernel pads them.
  group: int  # The int8 dW's scale groups (the JAX kernel's tile).
  kpad: int  # Features rounded up to 64: the feature dW's rows.
  hybrid: bool  # 'int8_hybrid': bf16 scratch and hidden dW.
  acts_planes: int  # [n_pad][W] planes of each scratch array.
  das_planes: int
  d16_planes: int  # int8 mode: bf16 da of layer 0 and the skip layers.
  stage_floats: int  # Hybrid: the tile pass's f32 rows, [grid][64][W].
  features: DwGemmPlan  # dW_0 and the skip tails: [kpad, W] over n.
  hidden: DwGemmPlan | None  # Hybrid: the hidden dW, [W, W] over n.
  s8: S8DwPlan | None  # int8: the hidden dW over the groups.

  @property
  def scratch_bytes(self):
    """acts and das: f32 ('int8') or bf16 (hybrid) planes."""
    return ((2 if self.hybrid else 4) * (self.acts_planes + self.das_planes)
            * self.n_pad * self.width)


def int8_bwd_plan(num_feats, width, depth, num_skips, n, n_pad, group,
                  num_dims, sms, hybrid):
  """K6's plan: n samples padded to n_pad (JAX's padding), hidden dW scale
  groups of `group` samples, the 'int8' or 'int8_hybrid' backward."""
  if num_feats < 1 or depth < 1:
    raise ValueError(f'{num_feats} features, depth {depth}.')
  if n < 1 or n > n_pad:
    raise ValueError(f'{n} samples, padded to {n_pad}.')
  kpad = _ceil(num_feats, 64) * 64
  hidden = max(depth - 1, 1)
  s8 = None if hybrid else s8_dw_plan(width, n_pad, group, sms)
  tile = i8_tile_plan(num_feats, width, num_dims, n_pad, sms)
  return Int8BwdPlan(
      tile, width, n_pad, group, kpad, hybrid, hidden,
      depth if hybrid else hidden, 0 if hybrid else 1 + num_skips,
      tile.grid * I8_TILE * width if hybrid else 0,
      dw_gemm_plan(kpad, width, n, sms),
      dw_gemm_plan(width, width, n, sms) if hybrid else None, s8)
