"""Launch plans of the kernels K1-K6 (pure Python, no GPU): the persistent
tile walks, split-K sample ranges, grids, tile shapes and shared-memory
sizes that ``ops/kernels/plans.py`` hands to ``csrc/density_mlp.cu``,
``featurize_dense.cu``, ``density_mlp_bwd.cu``, ``featurize_dense_dw.cu``,
``int8_trunk.cu`` and ``int8_trunk_bwd.cu``, and the zero-padding of
narrow trunks and weight columns."""

import numpy as np
import pytest
import torch

from multinerf_tpu_torch.ops import geopoly
from multinerf_tpu_torch.ops.kernels import build
from multinerf_tpu_torch.ops.kernels import density_mlp as dm
from multinerf_tpu_torch.ops.kernels import featurize_dense as fd
from multinerf_tpu_torch.ops.kernels import plans

SMS = 132  # H100 SXM.
CLUSTERS = SMS // 2  # Clusters of two CTAs, one CTA per SM.
F360 = 504  # 360.gin's features: 2 x 12 degrees x 21 basis directions.
N_PROP = 4096 * 64  # Samples of one proposal level of a 4,096-ray batch.
N_NERF = 4096 * 32  # Samples of the NerfMLP level.


def _gemms(n):
  """The dW products of K3 (dW_0 and dW_1..) and K4 at the 360 shapes."""
  k3 = plans.density_mlp_bwd_plan(F360, 256, 4, 21, n, SMS)
  k4 = plans.featurize_dense_dw_plan(F360, 1024, 21, n, SMS)
  return {'k3_dw0': k3.dw0, 'k3_dw1': k3.dw1, 'k4': k4.gemm}


@pytest.mark.parametrize('n', [N_PROP, N_NERF, N_PROP - 37, N_NERF - 37, 1,
                               63, 65, 129])
@pytest.mark.parametrize('which', ['k3_dw0', 'k3_dw1', 'k4'])
def test_dw_splits_cover_every_sample_once(n, which):
  plan = _gemms(n)[which]
  ranges = plan.sample_ranges()
  assert len(ranges) == plan.splits == plan.grid[2]
  assert ranges[0][0] == 0 and ranges[-1][1] == plan.n
  for (start, stop), (nxt, _) in zip(ranges, ranges[1:] + [(plan.n, 0)]):
    assert start < stop == nxt  # Non-empty, contiguous, no overlap.
  assert plan.n >= n  # K3's GEMMs run over the padded tile rows.


@pytest.mark.parametrize('which', ['k3_dw0', 'k3_dw1', 'k4'])
def test_dw_grid_fills_one_wave_at_the_360_shapes(which):
  plan = _gemms(N_PROP if which != 'k4' else N_NERF)[which]
  ctas = np.prod(plan.grid)
  assert SMS - plan.grid[0] * plan.grid[1] < ctas <= SMS
  assert plan.grid[0] * plans.DW_TILE_ROWS >= plan.rows
  assert plan.grid[1] * plan.bn == plan.width
  # The widest block: one CTA covers a 256-wide layer, so A is read once.
  assert plan.bn == 256


@pytest.mark.parametrize('num_feats,width,depth', [
    (F360, 256, 4), (F360, 32, 2), (F360, 64, 6), (F360, 128, 4),
    (F360, 200, 3), (96, 256, 2)])
def test_bwd_plan_tiles_and_shared_memory(num_feats, width, depth):
  plan = plans.density_mlp_bwd_plan(num_feats, width, depth, 21, N_PROP - 37,
                                    SMS)
  assert plan.smem <= plans.SMEM_LIMIT
  assert max(plan.dw0.smem, plan.dw1.smem) <= plans.SMEM_LIMIT
  assert plan.width in plans.WIDTHS and plan.width >= width
  assert plan.kpad % plans.WGMMA_M == 0 and plan.kpad >= num_feats
  assert plan.n_pad == plan.tiles * plans.TILE
  assert 0 <= plan.n_pad - (N_PROP - 37) < plans.TILE
  assert plan.grid == min(plan.tiles, SMS)
  assert (plan.dw0.rows, plan.dw0.width) == (plan.kpad, plan.width)
  assert (plan.dw1.rows, plan.dw1.width) == (plan.width, plan.width)


def test_tiles_are_whole_wgmma_shapes():
  assert plans.TILE % plans.WGMMA_M == 0
  assert plans.DW_TILE_ROWS % plans.WGMMA_M == 0
  assert plans.SLAB % plans.WGMMA_K == 0
  for width in plans.WIDTHS:
    assert width % 64 == 0 and width <= 256  # wgmma n: up to 256.
  for width in (64, 192, 320, 1024):
    plan = plans.dw_gemm_plan(512, width, N_NERF, SMS)
    assert plan.bn in (64, 128, 256) and width % plan.bn == 0
    assert plan.smem <= plans.SMEM_LIMIT


def test_360_shared_memory_matches_the_layout():
  # The tile pass at 360.gin: two 64 KB operand tiles, a 4 x 16 KB ring,
  # 12 KB of mask bits, 16 KB of column sums, g, barriers, alignment.
  assert plans.bwd_smem(256, 4, 512, 21) == (
      2 * 65536 + 4 * 16384 + 12288 + 2 * 8192 + 512 + 64 + 1024)
  assert plans.dw_gemm_smem(256) == 4 * 64 * (128 + 256) * 2 + 64 + 1024


@pytest.mark.parametrize('call,match', [
    (lambda: plans.density_mlp_bwd_plan(F360, 512, 4, 21, 100, SMS),
     'at most 256'),
    (lambda: plans.density_mlp_bwd_plan(F360, 256, 1, 21, 100, SMS),
     'depth >= 2'),
    (lambda: plans.density_mlp_bwd_plan(F360, 256, 40, 21, 100, SMS),
     'shared memory'),
    (lambda: plans.density_mlp_bwd_plan(2000, 256, 4, 21, 100, SMS),
     'shared memory'),
    (lambda: plans.density_mlp_bwd_plan(F360, 256, 4, 21, 0, SMS),
     'samples'),
    (lambda: plans.featurize_dense_dw_plan(F360, 96, 21, 100, SMS),
     'multiple of 64'),
    (lambda: plans.featurize_dense_dw_plan(F360, 32, 21, 100, SMS),
     'multiple of 64'),
    (lambda: plans.featurize_dense_dw_plan(4000, 1024, 21, 100, SMS),
     'shared memory'),
    (lambda: plans.dw_gemm_plan(100, 256, 100, SMS), 'multiple of 64'),
    (lambda: plans.dw_gemm_plan(512, 256, 2**31, SMS), 'samples'),
    (lambda: plans.density_mlp_fwd_plan(F360, 512, 21, 100, CLUSTERS),
     'at most 256'),
    (lambda: plans.density_mlp_fwd_plan(F360, 256, 21, 0, CLUSTERS), 'samples'),
    (lambda: plans.density_mlp_fwd_plan(3000, 256, 21, 100, CLUSTERS),
     'shared memory'),
    (lambda: plans.featurize_dense_fwd_plan(F360, 48, 21, 100, CLUSTERS),
     'multiple of 32'),
    (lambda: plans.featurize_dense_fwd_plan(3000, 1024, 21, 100, CLUSTERS),
     'shared memory'),
    (lambda: plans.featurize_dense_fwd_plan(F360, 1024, 21, 100, 0),
     'clusters'),
])
def test_plans_reject_what_the_kernels_do_not_take(call, match):
  with pytest.raises(ValueError, match=match):
    call()


@pytest.mark.parametrize('width,depth', [(32, 2), (48, 3), (100, 2)])
def test_padded_trunk_gives_the_same_gradients(width, depth):
  # The K3 wrapper runs a narrow trunk zero-padded to the kernel's width:
  # the padded units are 0 forward and get cotangent 0, so the real
  # gradients do not change.  Checked on the plain version.
  rng = np.random.RandomState(width)
  basis = np.array(geopoly.generate_basis('icosahedron', 2)).T
  n = 40
  means = torch.tensor(rng.randn(n, 3).astype(np.float32))
  a = rng.randn(n, 3, 3).astype(np.float32) * 0.05
  covs = torch.tensor(a @ np.swapaxes(a, -1, -2))
  shapes = [(F360, width)] + [(width, width)] * (depth - 1)
  ws = [torch.tensor(rng.uniform(-0.1, 0.1, s).astype(np.float32))
        for s in shapes]
  bs = [torch.tensor(rng.randn(width).astype(np.float32) * 0.1) for _ in ws]
  wd = torch.tensor(rng.uniform(-0.2, 0.2, (width, 1)).astype(np.float32))
  g = torch.tensor(rng.randn(n).astype(np.float32))
  wp = plans.padded_width(width)
  pws, pbs, pwd = dm._pad_trunk(ws, bs, wd, wp)
  assert [tuple(w.shape) for w in pws] == (
      [(F360, wp)] + [(wp, wp)] * (depth - 1))
  want = dm.density_mlp_bwd_plain(means, covs, ws, bs, wd, g, basis)
  got = dm.density_mlp_bwd_plain(means, covs, pws, pbs, pwd, g, basis)
  pairs = list(zip(got[0], want[0])) + list(zip(got[1], want[1])) + [
      (got[2], want[2]), (got[3], want[3])]
  for i, (p, w) in enumerate(pairs):
    if p.dim() == 2:
      p = p[:w.shape[0], :w.shape[1]]
    elif p.dim() == 1:
      p = p[:w.numel()]
    np.testing.assert_allclose(p.numpy(), w.numpy(), rtol=1e-5, atol=1e-6,
                               err_msg=f'leaf {i}')


def _fwd_plans(n, num_feats=F360, num_dims=21, k1_width=256,
               k2_width=1024):
  return {'k1': plans.density_mlp_fwd_plan(num_feats, k1_width, num_dims, n,
                                           CLUSTERS),
          'k2': plans.featurize_dense_fwd_plan(num_feats, k2_width, num_dims,
                                               n, CLUSTERS)}


@pytest.mark.parametrize('n', [1, 127, 128, 129, N_NERF - 37, N_PROP])
@pytest.mark.parametrize('which', ['k1', 'k2'])
def test_fwd_persistent_ctas_cover_every_tile_once(n, which):
  plan = _fwd_plans(n)[which]
  assert 2 <= plan.grid <= SMS and plan.grid % plans.FWD_CLUSTER == 0
  assert plan.tiles == -(-n // plans.TILE)
  assert (plan.tiles - 1) * plans.TILE < n <= plan.tiles * plans.TILE
  walked = [t for cta in range(plan.grid) for t in plan.cta_tiles(cta)]
  assert sorted(walked) == list(range(plan.tiles))  # Each tile once.
  # No idle cluster; the two CTAs of a cluster walk the same number of
  # tile pairs, so the same weight slabs.
  pairs = -(-plan.tiles // plans.FWD_CLUSTER)
  assert plan.clusters == min(pairs, CLUSTERS)
  for c in range(plan.clusters):
    assert plan.cta_tiles(2 * c)
    assert len(plan.cta_tiles(2 * c)) - len(plan.cta_tiles(2 * c + 1)) in (
        0, 1)


def test_fwd_plan_takes_the_clusters_the_card_holds():
  plan = plans.density_mlp_fwd_plan(F360, 256, 21, N_PROP, 60)
  assert (plan.clusters, plan.grid) == (60, 120)
  walked = [t for cta in range(plan.grid) for t in plan.cta_tiles(cta)]
  assert sorted(walked) == list(range(plan.tiles))


@pytest.mark.parametrize('k1_width,k2_width', [(256, 1024), (64, 64),
                                                 (128, 128)])
def test_fwd_shared_memory_fits_at_the_360_shapes_and_narrow_widths(
    k1_width, k2_width):
  for which, plan in _fwd_plans(N_PROP, k1_width=k1_width,
                                k2_width=k2_width).items():
    assert plan.smem <= plans.SMEM_LIMIT, which
    assert plan.stages in plans.FWD_STAGES
    assert plan.kpad == 512
  # 360.gin: two 64 KB feature tiles, a 4 x 16 KB ring (K1) or a 3 x 16 KB
  # ring and two 2 x 8 KB output staging areas (K2), two 4,080-byte
  # featurizer scratch areas (rounded to 16), the barriers, alignment.
  if k1_width == 256:
    k1, k2 = _fwd_plans(N_PROP)['k1'], _fwd_plans(N_PROP)['k2']
    assert k1.smem == 2 * 65536 + 4 * 16384 + 2 * 4080 + 64 + 1024
    assert k2.smem == 2 * 65536 + 3 * 16384 + 4 * 8192 + 2 * 4080 + 48 + 1024
    assert (k1.stages, k2.stages, k1.staged, k2.staged) == (4, 3, False, True)


def test_fwd_ring_shrinks_to_fit_a_wide_feature_tile():
  # blender_512.gin: 2 x 16 degrees x 21 directions = 672 features, a
  # [64][704] tile per warpgroup: K1 keeps 2 stages of its 16 KB ring, and
  # K2 too, with no room left for its output staging (stores from
  # registers).
  k1 = plans.density_mlp_fwd_plan(672, 256, 21, N_PROP, CLUSTERS)
  assert (k1.kpad, k1.stages) == (704, 2) and k1.smem <= plans.SMEM_LIMIT
  k2 = plans.featurize_dense_fwd_plan(672, 512, 21, N_NERF, CLUSTERS)
  assert (k2.width, k2.col_slabs, k2.stages) == (256, 2, 2)
  assert not k2.staged and k2.smem <= plans.SMEM_LIMIT


@pytest.mark.parametrize('width,slab,slabs', [
    (32, 64, 1), (64, 64, 1), (96, 128, 1), (128, 128, 1), (160, 256, 1),
    (256, 256, 1), (288, 256, 2), (1024, 256, 4)])
def test_fwd_dense_column_slabs_cover_the_width(width, slab, slabs):
  plan = plans.featurize_dense_fwd_plan(F360, width, 21, 1000, CLUSTERS)
  assert (plan.width, plan.col_slabs) == (slab, slabs)
  assert plan.padded_cols >= width > plan.padded_cols - slab
  # The wrapper pads the weights' rows to kpad and columns to whole slabs
  # with zeros, and keeps the values.
  kernel = torch.randn(F360, width)
  w = fd.padded_bf16_rows(kernel, plan.kpad, plan.padded_cols)
  assert tuple(w.shape) == (plan.kpad, plan.padded_cols)
  assert w.dtype == torch.bfloat16 and w.is_contiguous()
  assert torch.equal(w[:F360, :width], kernel.to(torch.bfloat16))
  assert not w[F360:].any() and not w[:, width:].any()


@pytest.mark.parametrize('width,wp', [(32, 64), (48, 64), (64, 64),
                                      (100, 128), (200, 256), (256, 256)])
def test_density_mlp_forward_plan_pads_narrow_trunks(width, wp):
  plan = plans.density_mlp_fwd_plan(F360, width, 21, 300, CLUSTERS)
  assert plan.width == wp and plan.kpad == 512
  assert (plan.tiles, plan.clusters, plan.grid) == (3, 2, 4)


@pytest.mark.parametrize('width,depth', [(32, 2), (48, 3), (100, 1)])
def test_padded_trunk_gives_the_same_density(width, depth):
  # The K1 wrapper runs a narrow trunk zero-padded to the kernel's width:
  # the padded units are ReLU(0) = 0 and the head's padded weights 0, so
  # the density is the same, up to the order of the CPU matmul's sums.
  # Checked on the plain version.
  rng = np.random.RandomState(width)
  basis = np.array(geopoly.generate_basis('icosahedron', 2)).T
  n = 40
  means = torch.tensor(rng.randn(n, 3).astype(np.float32))
  a = rng.randn(n, 3, 3).astype(np.float32) * 0.05
  covs = torch.tensor(a @ np.swapaxes(a, -1, -2))
  shapes = [(F360, width)] + [(width, width)] * (depth - 1)
  ws = [torch.tensor(rng.uniform(-0.1, 0.1, s).astype(np.float32))
        for s in shapes]
  bs = [torch.tensor(rng.randn(width).astype(np.float32) * 0.1) for _ in ws]
  wd = torch.tensor(rng.uniform(-0.2, 0.2, (width, 1)).astype(np.float32))
  bd = torch.tensor(0.1)
  pws, pbs, pwd = dm._pad_trunk(ws, bs, wd, plans.padded_width(width))
  want = dm.density_mlp_plain(means, covs, ws, bs, wd, bd, basis)
  got = dm.density_mlp_plain(means, covs, pws, pbs, pwd, bd, basis)
  np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                             atol=1e-6)


def test_ptxas_log_gives_each_kernels_registers_and_spills():
  log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN3mnt27density_mlp_bwd_tile_kernelILi256EEEv14CUtensorMap_stPKfi' for 'sm_90a'
ptxas info    : Function properties for _ZN3mnt27density_mlp_bwd_tile_kernelILi256EEEv14CUtensorMap_stPKfi
    112 bytes stack frame, 88 bytes spill stores, 120 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers, 112 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN3mnt14dw_gemm_kernelILi64ENS_13DensityMlpBwdEEEv14CUtensorMap_stS2_iiiiPf' for 'sm_90a'
ptxas info    : Function properties for _ZN3mnt14dw_gemm_kernelILi64ENS_13DensityMlpBwdEEEv14CUtensorMap_stS2_iiiiPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 58 registers, used 1 barriers
ptxas info    : Function properties for _ZN3mnt20reduce_splits_kernelEPKfixxPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers
"""
  assert build.kernel_resources(log) == {
      'density_mlp_bwd_tile_kernel<256>': {
          'registers': 168, 'spill_stores': 88, 'spill_loads': 120},
      'dw_gemm_kernel<64, DensityMlpBwd>': {
          'registers': 58, 'spill_stores': 0, 'spill_loads': 0},
      'reduce_splits_kernel': {
          'registers': 32, 'spill_stores': 0, 'spill_loads': 0}}
  assert build.short_name('cudaMemcpy') == 'cudaMemcpy'


# K6's dW half (csrc/int8_trunk_bwd.cu): the s8 GEMM over the JAX kernel's
# scale groups and the bf16 GEMMs of the feature rows and the hybrid hidden
# dW.  n_pad and the group come from int8_trunk.jax_groups, as the wrapper
# takes them.
def _k6_plan(n, width=1024, depth=8, skips=1, hybrid=False, sms=SMS):
  from multinerf_tpu_torch.ops.kernels import int8_trunk as i8t
  n_pad, group = i8t.jax_groups(n)
  return plans.int8_bwd_plan(F360, width, depth, skips, n, n_pad, group,
                             21, sms, hybrid)


@pytest.mark.parametrize('n', [1, 63, 300, 1100, N_NERF - 37, N_NERF])
@pytest.mark.parametrize('width', [64, 1024])
def test_s8_dw_groups_cover_every_padded_sample_once(n, width):
  plan = _k6_plan(n, width)
  s8 = plan.s8
  # A slab divides a group, a group divides the padded samples.
  assert s8.group % plans.S8_SLAB == 0 and plan.n_pad % s8.group == 0
  assert s8.group in (128, 256, 512) and plan.n_pad >= n
  assert s8.groups * s8.group == plan.n_pad
  ranges = s8.group_ranges()
  assert len(ranges) == s8.splits == s8.grid[2]
  assert ranges[0][0] == 0 and ranges[-1][1] == s8.groups
  for (start, stop), (nxt, _) in zip(ranges, ranges[1:] + [(s8.groups, 0)]):
    assert start < stop == nxt
  assert s8.grid[0] * plans.DW_TILE_ROWS >= width
  assert s8.grid[1] * s8.bn == width


def test_s8_dw_plan_at_the_360_shapes():
  s8 = _k6_plan(N_NERF).s8
  # 256 groups of 512 samples (4 slabs, 16 k32 steps each), 128 x 128
  # blocks of dW, two group ranges: 128 CTAs, one wave.
  assert (s8.group, s8.groups, s8.bn, s8.splits, s8.per) == (
      512, 256, 128, 2, 128)
  assert s8.grid == (8, 8, 2)
  # A 6-stage ring of [128 + 128][128] int8 slabs, each stage with its
  # group's 128 + 128 absmaxes, barriers, alignment.
  assert s8.smem == 6 * 256 * 128 + 6 * 256 * 4 + 96 + 1024
  assert s8.smem <= plans.SMEM_LIMIT
  assert plans.s8_dw_smem(64) == 6 * 192 * 128 + 6 * 192 * 4 + 96 + 1024


@pytest.mark.parametrize('width,bn', [(64, 64), (192, 64), (256, 128),
                                      (1024, 128)])
def test_s8_dw_bn_and_splits(width, bn):
  s8 = plans.s8_dw_plan(width, N_NERF, 512, SMS)
  assert s8.bn == bn and width % s8.bn == 0
  ctas = s8.grid[0] * s8.grid[1]
  # As many group ranges as one wave holds, each of `per` whole groups.
  assert s8.per == -(-s8.groups // min(s8.groups, SMS // ctas))
  assert s8.splits == -(-s8.groups // s8.per)
  assert ctas * s8.splits <= SMS


@pytest.mark.parametrize('hybrid', [False, True])
def test_k6_feature_and_hidden_gemms_at_the_360_shapes(hybrid):
  plan = _k6_plan(N_NERF, hybrid=hybrid)
  assert plan.kpad == 512
  f = plan.features
  assert (f.rows, f.width, f.n, f.bn) == (512, 1024, N_NERF, 256)
  assert SMS - f.grid[0] * f.grid[1] < np.prod(f.grid) <= SMS
  if hybrid:
    h = plan.hidden
    assert (h.rows, h.width, h.n, h.bn) == (1024, 1024, N_NERF, 256)
    assert SMS - h.grid[0] * h.grid[1] < np.prod(h.grid) <= SMS
    assert plan.s8 is None
  else:
    assert plan.hidden is None and plan.s8 is not None
  for gemm in (plan.features, plan.hidden):
    if gemm is not None:
      assert gemm.smem <= plans.SMEM_LIMIT


def test_k6_scratch_is_bf16_under_hybrid():
  n, w = N_NERF, 1024
  i8, hy = _k6_plan(n), _k6_plan(n, hybrid=True)
  # 'int8': f32 activations of layers 0-6 and da_1..7, + bf16 da_0 and the
  # skip layer's da for the feature dW (7.5 GB + 0.5 GB); hybrid: bf16
  # activations and da_0..7 (4.0 GB).
  assert (i8.acts_planes, i8.das_planes, i8.d16_planes) == (7, 7, 2)
  assert (hy.acts_planes, hy.das_planes, hy.d16_planes) == (7, 8, 0)
  assert i8.scratch_bytes == 4 * 14 * n * w
  assert hy.scratch_bytes == 2 * 15 * n * w
  assert hy.scratch_bytes < 0.55 * i8.scratch_bytes


@pytest.mark.parametrize('call,match', [
    (lambda: plans.s8_dw_plan(96, 512, 512, SMS), 'multiple of 64'),
    (lambda: plans.s8_dw_plan(1024, 512, 64, SMS), 'whole slabs'),
    (lambda: plans.s8_dw_plan(1024, 700, 256, SMS), 'whole groups'),
    (lambda: plans.int8_bwd_plan(F360, 1024, 8, 1, 0, 256, 256, 21, SMS,
                                 False), 'samples'),
    (lambda: plans.int8_bwd_plan(F360, 1024, 8, 1, 300, 256, 256, 21, SMS,
                                 False), 'samples'),
    (lambda: plans.i8_tile_plan(F360, 96, 21, 512, SMS), 'multiple of 64'),
    (lambda: plans.i8_tile_plan(F360, 1024, 21, 300, SMS), 'whole tiles'),
    (lambda: plans.i8_tile_plan(6000, 1024, 21, 512, SMS),
     'shared memory'),
])
def test_k6_plans_reject_what_the_kernels_do_not_take(call, match):
  with pytest.raises(ValueError, match=match):
    call()


# K6's tile pass: 64-sample tiles (wgmma's M), both warpgroups on every
# tile, splitting each layer's columns into BN-wide blocks.
@pytest.mark.parametrize('n', [1, 63, 300, 1100, N_NERF - 37, N_NERF])
@pytest.mark.parametrize('width', [64, 192, 1024])
def test_k6_tile_pass_covers_every_padded_tile_once(n, width):
  tile = _k6_plan(n, width).tile
  assert tile.tiles * plans.I8_TILE == _k6_plan(n, width).n_pad
  assert tile.grid == min(tile.tiles, SMS)
  walked = [t for cta in range(tile.grid) for t in tile.cta_tiles(cta)]
  assert sorted(walked) == list(range(tile.tiles))
  # A tile never straddles two scale groups: they are whole tiles.
  assert _k6_plan(n, width).group % plans.I8_TILE == 0
  assert width % tile.bn == 0 and tile.bn in (64, 128)
  assert tile.smem <= plans.SMEM_LIMIT


def test_k6_tile_pass_shared_memory_at_the_360_shapes():
  tile = _k6_plan(N_NERF).tile
  # A [64][1024] int8 and F [64][512] bf16 (64 KB each; the hybrid dx's
  # bf16 [64][1024] spans both), two 5-stage rings of [128][64] slabs, the
  # column-reduction buffers, row maxima, scales and their reciprocals,
  # barriers, alignment.
  assert (tile.bn, tile.stages, tile.tiles, tile.grid) == (128, 5, 2048, 132)
  assert tile.smem == (2 * 65536 + 2 * 5 * 8192 + 8192 + 512 + 256 + 256 +
                       2 * 2 * 5 * 8 + 1024)
  assert tile.smem <= plans.SMEM_LIMIT < plans.i8_tile_smem(
      1024, 512, 21, 128, 6)


@pytest.mark.parametrize('num_feats,width,stages', [
    (F360, 64, 6), (F360, 256, 6), (672, 1024, 4), (F360, 1024, 5)])
def test_k6_tile_rings_shrink_to_fit(num_feats, width, stages):
  tile = plans.i8_tile_plan(num_feats, width, 21, 4096, SMS)
  assert tile.stages == stages and tile.smem <= plans.SMEM_LIMIT


# K5's tile pass (csrc/int8_trunk.cu on int8_tile_pass.cuh): the same
# 64-sample tiles over ceil(n / 64), the last one ragged, no padding of n.
@pytest.mark.parametrize('n', [1, 63, 64, 65, 1100, N_NERF - 37, N_NERF,
                               4 * N_NERF])
@pytest.mark.parametrize('width', [64, 192, 1024])
def test_k5_tiles_cover_every_sample_once(n, width):
  plan = plans.i8_fwd_plan(F360, width, 21, n, SMS)
  assert plan.tiles == -(-n // plans.I8_TILE)
  assert plan.grid == min(plan.tiles, SMS)
  walked = [t for cta in range(plan.grid) for t in plan.cta_tiles(cta)]
  assert sorted(walked) == list(range(plan.tiles))
  samples = [s for t in walked
             for s in range(t * plans.I8_TILE, (t + 1) * plans.I8_TILE)
             if s < n]
  assert sorted(samples) == list(range(n))
  assert width % plan.bn == 0 and plan.bn in (64, 128)
  assert plan.stage_floats == plan.grid * plans.I8_TILE * width


def test_k5_shared_memory_and_staging_at_the_360_shapes():
  plan = plans.i8_fwd_plan(F360, 1024, 21, N_NERF, SMS)
  # A [64][1024] int8 and F [64][512] bf16 (64 KB each), two 6-stage rings
  # of [128][64] slabs, row maxima, scales and their reciprocals, barriers,
  # alignment: no column-reduction buffers and no hybrid dx tile, so one
  # stage deeper than K6's tile pass.
  assert (plan.bn, plan.stages, plan.tiles, plan.grid) == (128, 6, 2048, 132)
  assert plan.smem == (2 * 65536 + 2 * 6 * 8192 + 512 + 256 + 256 +
                       2 * 2 * 6 * 8 + 1024)
  assert plan.smem <= plans.SMEM_LIMIT
  assert plans.i8_tile_smem(1024, 512, 21, 128, 6, backward=False) == (
      plan.smem)
  assert plans.i8_tile_smem(1024, 512, 21, 128, 6) > plans.SMEM_LIMIT
  # The staging block, [132][64][1024] f32: 34.6 MB, under the 50 MB L2.
  assert plan.stage_floats == 132 * 64 * 1024
  assert 4 * plan.stage_floats < 50 * 2**20
  # The render chunk (16,384 rays x 32 samples) keeps the grid and block.
  chunk = plans.i8_fwd_plan(F360, 1024, 21, 4 * N_NERF, SMS)
  assert (chunk.tiles, chunk.grid, chunk.stage_floats) == (
      8192, 132, plan.stage_floats)


@pytest.mark.parametrize('num_feats,width,stages', [
    (F360, 64, 6), (F360, 1024, 6), (672, 1024, 4), (1008, 1024, 2)])
def test_k5_ring_shrinks_to_fit(num_feats, width, stages):
  plan = plans.i8_fwd_plan(num_feats, width, 21, 4096, SMS)
  assert plan.stages == stages and plan.smem <= plans.SMEM_LIMIT
  if stages < plans.I8_STAGES[0]:
    deeper = plans.I8_STAGES[plans.I8_STAGES.index(stages) - 1]
    assert plans.i8_tile_smem(width, -(-num_feats // 64) * 64, 21, plan.bn,
                              deeper, backward=False) > plans.SMEM_LIMIT


@pytest.mark.parametrize('call,match', [
    (lambda: plans.i8_fwd_plan(F360, 96, 21, 512, SMS), 'multiple of 64'),
    (lambda: plans.i8_fwd_plan(F360, 32, 21, 512, SMS), 'multiple of 64'),
    (lambda: plans.i8_fwd_plan(F360, 1024, 21, 0, SMS), 'at least one'),
    (lambda: plans.i8_fwd_plan(6000, 1024, 21, 512, SMS), 'shared memory'),
])
def test_k5_plan_rejects_what_the_kernel_does_not_take(call, match):
  with pytest.raises(ValueError, match=match):
    call()
