"""The port's CUDA kernels, render path and training step on a GPU, against
the kernels' plain PyTorch versions.  Every test carries the ``cuda`` marker
and skips without a GPU.

This file imports neither jax nor the JAX package, so it runs on a machine
that has only PyTorch; there, skip the JAX conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

Tolerances: the kernels and their plain versions round features, weights
and activations to bf16 at the same places and differ only in summation
order and in the last bits of sin/exp, so the bound is the bf16-level one
of tests/test_pallas_*.py, max |diff| <= 2e-2 * max(1, max |plain|); for
the dW kernel (K4) per gradient leaf, 2e-2 * max |plain|.  The density MLP's
backward (K3) gets the gradient bound of tests/test_pallas_density_mlp.py:
83-85, 5e-2 * max |plain| per leaf: with a random-signed cotangent each
leaf is a sum over 262,107 samples that cancels to a small fraction of the
summed magnitudes, so the few activations and ReLU masks that land on the
other side of a bf16 boundary weigh more.  On these inputs the plain
version run on the GPU and on the CPU (the same formula, another summation
order) is 2.6e-2 * max |plain| apart at the worst leaf, and the kernel
3.8e-2 from either.  The backward kernels sum in a fixed order, so two
launches agree bit for bit.
"""

import argparse
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), 'helpers'))
import torch_parity as tp  # noqa: E402

from multinerf_tpu_torch import configs  # noqa: E402
from multinerf_tpu_torch import train_lib  # noqa: E402
from multinerf_tpu_torch.data import datasets  # noqa: E402
from multinerf_tpu_torch.data import types  # noqa: E402
from multinerf_tpu_torch.models import mlp as mlp_lib  # noqa: E402
from multinerf_tpu_torch.models import nerf  # noqa: E402
from multinerf_tpu_torch.ops import coord  # noqa: E402
from multinerf_tpu_torch.ops import geopoly  # noqa: E402
from multinerf_tpu_torch.ops.kernels import density_mlp as dm  # noqa: E402
from multinerf_tpu_torch.ops.kernels import featurize_dense as fd  # noqa: E402
from multinerf_tpu_torch.ops.kernels import int8_trunk as i8t  # noqa: E402

BASIS = np.array(geopoly.generate_basis('icosahedron', 2)).T  # [3, 21]
NUM_FEATS = 504
KERNEL_TOL = 2e-2
K3_TOL = 5e-2
# Full-width shapes of one 4,096-ray chunk, cut by 37 to leave a ragged tile.
K1_N = 4096 * 64 - 37
K2_N = 4096 * 32 - 37

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA GPU.')
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  return torch.device('cuda')


def _gaussians(n, seed, device, far_frac=0.1):
  means, covs = tp.gaussians(n, seed=seed, far_frac=far_frac)
  return (torch.as_tensor(means, device=device),
          torch.as_tensor(covs, device=device))


def _uniform(rng, shape, fan_in, device):
  lim = np.sqrt(6.0 / fan_in)
  return torch.as_tensor(rng.uniform(-lim, lim, shape).astype(np.float32),
                         device=device)


def _check(got, want, what):
  torch.cuda.synchronize()
  assert got.shape == want.shape, what
  assert bool(torch.isfinite(got).all()), what
  err = float((got - want).abs().max())
  bound = KERNEL_TOL * max(1.0, float(want.abs().max()))
  assert err <= bound, f'{what}: max |kernel - plain| {err:.3e} > {bound:.3e}'


@pytest.mark.parametrize('use_contract', [True, False])
def test_featurize_dense_kernel_matches_plain(cuda, use_contract):
  rng = np.random.RandomState(0)
  means, covs = _gaussians(K2_N, 1, cuda, 0.1 if use_contract else 0.0)
  kernel = _uniform(rng, (NUM_FEATS, 1024), NUM_FEATS, cuda)
  bias = torch.as_tensor(rng.randn(1024).astype(np.float32) * 0.1,
                         device=cuda)
  args = (means, covs, kernel, bias, BASIS)
  fd.reset_counts()
  got = fd.featurize_dense(*args, use_contract=use_contract)
  assert fd.counts == {'launches': 1, 'plain_calls': 0}
  want = fd.featurize_dense_plain(*args, use_contract=use_contract)
  _check(got, want, f'featurize_dense contract={use_contract}')


@pytest.mark.parametrize('use_contract', [True, False])
def test_density_mlp_kernel_matches_plain(cuda, use_contract):
  rng = np.random.RandomState(0)
  means, covs = _gaussians(K1_N, 2, cuda, 0.1 if use_contract else 0.0)
  ws = [_uniform(rng, (NUM_FEATS, 256), NUM_FEATS, cuda)] + [
      _uniform(rng, (256, 256), 256, cuda) for _ in range(3)]
  bs = [torch.as_tensor(rng.randn(256).astype(np.float32) * 0.1, device=cuda)
        for _ in ws]
  wd = _uniform(rng, (256, 1), 256, cuda)
  bd = torch.tensor(-0.3, device=cuda)
  args = (means, covs, ws, bs, wd, bd, BASIS)
  dm.reset_counts()
  got = dm.density_mlp(*args, use_contract=use_contract)
  assert dm.counts == {'launches': 1, 'plain_calls': 0}
  want = dm.density_mlp_plain(*args, use_contract=use_contract)
  _check(got, want, f'density_mlp contract={use_contract}')


def _trunk(rng, device, depth=4, width=256):
  ws = [_uniform(rng, (NUM_FEATS, width), NUM_FEATS, device)] + [
      _uniform(rng, (width, width), width, device) for _ in range(depth - 1)]
  bs = [torch.as_tensor(rng.randn(width).astype(np.float32) * 0.1,
                        device=device) for _ in ws]
  return ws, bs, _uniform(rng, (width, 1), width, device)


# The forward kernels at the edges of their 128-sample tiles (one sample,
# half a tile +- 1, one tile + 1, a ragged third tile) and at narrow widths:
# K1's trunk of 64 and 128 (and narrower ones, zero-padded by the wrapper),
# K2's output of 64 and 1,024 columns (and widths that end inside a column
# slab, masked in the kernel).  Two launches bitwise equal.
def _check_twice(got, again, want, what):
  assert torch.equal(got, again), f'{what}: two launches differ'
  _check(got, want, what)


def _density_mlp_twice(cuda, n, width, depth):
  rng = np.random.RandomState(n + width)
  means, covs = _gaussians(n, 8, cuda)
  ws, bs, wd = _trunk(rng, cuda, depth=depth, width=width)
  args = (means, covs, ws, bs, wd, torch.tensor(-0.3, device=cuda), BASIS)
  dm.reset_counts()
  got, again = dm.density_mlp(*args), dm.density_mlp(*args)
  assert dm.counts == {'launches': 2, 'plain_calls': 0}
  _check_twice(got, again, dm.density_mlp_plain(*args),
               f'density_mlp N={n} width {width} depth {depth}')


def _featurize_dense_twice(cuda, n, width, max_deg=12):
  rng = np.random.RandomState(n + width)
  means, covs = _gaussians(n, 9, cuda)
  feats = 2 * max_deg * BASIS.shape[-1]
  kernel = _uniform(rng, (feats, width), feats, cuda)
  bias = torch.as_tensor(rng.randn(width).astype(np.float32) * 0.1,
                         device=cuda)
  args = (means, covs, kernel, bias, BASIS, 0, max_deg)
  fd.reset_counts()
  got, again = fd.featurize_dense(*args), fd.featurize_dense(*args)
  assert fd.counts == {'launches': 2, 'plain_calls': 0}
  _check_twice(got, again, fd.featurize_dense_plain(*args),
               f'featurize_dense N={n} width {width} max_deg {max_deg}')


@pytest.mark.parametrize('width', [64, 128])
@pytest.mark.parametrize('n', [1, 63, 65, 129, 300])
def test_density_mlp_kernel_matches_plain_at_tile_edges(cuda, n, width):
  _density_mlp_twice(cuda, n, width, depth=4)


@pytest.mark.parametrize('width,depth', [(32, 2), (96, 1), (160, 3)])
def test_density_mlp_kernel_pads_narrow_trunks(cuda, width, depth):
  _density_mlp_twice(cuda, 300, width, depth)


@pytest.mark.parametrize('width', [64, 1024])
@pytest.mark.parametrize('n', [1, 63, 65, 129, 300])
def test_featurize_dense_kernel_matches_plain_at_tile_edges(cuda, n, width):
  _featurize_dense_twice(cuda, n, width)


@pytest.mark.parametrize('width', [32, 96, 288])
def test_featurize_dense_kernel_masks_the_column_edge(cuda, width):
  _featurize_dense_twice(cuda, 300, width)


# 672 features (16 degrees, the blender and llff configs): the feature tile
# leaves no room for the output staging, so K2 stores from registers.
@pytest.mark.parametrize('n,width', [(1, 1024), (129, 288), (300, 1024)])
def test_featurize_dense_kernel_with_wide_features(cuda, n, width):
  _featurize_dense_twice(cuda, n, width, max_deg=16)


def test_forward_kernels_shared_memory_matches_the_plans(cuda):
  import ctypes
  from multinerf_tpu_torch.ops.kernels import build
  from multinerf_tpu_torch.ops.kernels import plans
  k1 = build.load('density_mlp').density_mlp_smem
  k2 = build.load('featurize_dense').featurize_dense_smem
  for fn, args in ((k1, 4), (k2, 5)):
    fn.argtypes = [ctypes.c_int] * args
    fn.restype = ctypes.c_int
  for feats, width in ((NUM_FEATS, 256), (NUM_FEATS, 64), (672, 256)):
    plan = fd.fwd_plan(plans.density_mlp_fwd_plan, 'density_mlp', feats,
                       width, 21, 1000)
    assert k1(plan.width, feats, 21, plan.stages) == plan.smem
    assert 1 <= plan.clusters <= fd.num_sms(cuda) // 2
  for feats, width in ((NUM_FEATS, 1024), (NUM_FEATS, 64), (672, 512)):
    plan = fd.fwd_plan(plans.featurize_dense_fwd_plan, 'featurize_dense',
                       feats, width, 21, 1000)
    assert k2(feats, 21, plan.width, plan.stages, plan.staged) == plan.smem
    assert 1 <= plan.clusters <= fd.num_sms(cuda) // 2


def _check_leaves(got, again, want, what, tol):
  torch.cuda.synchronize()
  for i, (a, b, w) in enumerate(zip(got, again, want)):
    assert a.shape == w.shape, (what, i)
    assert torch.equal(a, b), f'{what} leaf {i}: two launches differ'
    err = float((a - w).abs().max())
    bound = tol * float(w.abs().max())
    assert err <= bound, f'{what} leaf {i}: {err:.3e} > {bound:.3e}'


@pytest.mark.parametrize('use_contract', [True, False])
def test_density_mlp_backward_kernel_matches_plain(cuda, use_contract):
  rng = np.random.RandomState(1)
  means, covs = _gaussians(K1_N, 4, cuda, 0.1 if use_contract else 0.0)
  ws, bs, wd = _trunk(rng, cuda)
  g = torch.as_tensor(rng.randn(K1_N).astype(np.float32), device=cuda)
  args = (means, covs, ws, bs, wd, g, BASIS)
  flat = lambda out: [*out[0], *out[1], out[2], out[3]]
  dm.reset_counts()
  got = flat(dm.density_mlp_backward(*args, use_contract=use_contract))
  again = flat(dm.density_mlp_backward(*args, use_contract=use_contract))
  assert dm.bwd_counts == {'launches': 2, 'plain_calls': 0}
  want = flat(dm.density_mlp_bwd_plain(*args, use_contract=use_contract))
  _check_leaves(got, again, want, f'density_mlp_bwd contract={use_contract}',
                K3_TOL)


@pytest.mark.parametrize('use_contract', [True, False])
def test_featurize_dense_dw_kernel_matches_plain(cuda, use_contract):
  rng = np.random.RandomState(2)
  means, covs = _gaussians(K2_N, 5, cuda, 0.1 if use_contract else 0.0)
  g = torch.as_tensor(rng.randn(K2_N, 1024).astype(np.float32), device=cuda)
  args = (means, covs, g, BASIS)
  fd.reset_counts()
  got = fd.featurize_dense_dw(*args, use_contract=use_contract)
  again = fd.featurize_dense_dw(*args, use_contract=use_contract)
  assert fd.bwd_counts == {'launches': 2, 'plain_calls': 0}
  want = fd.featurize_dense_dw_plain(*args, use_contract=use_contract)
  _check_leaves([got], [again], [want],
                f'featurize_dense_dw contract={use_contract}', KERNEL_TOL)


# The edges of the tiles: one sample, fewer than one tile (K3's tile pass
# takes 128 samples, the dW GEMM's stage 64), one tile + 1.  Two launches
# bitwise equal, as at the full shapes above.  K3 at these N by the rule of
# train_lib.leaf_gaps (relative L2 per leaf <= 5e-2 + twice the plain
# version's own move when the means move by a relative 1e-6): over a few
# samples one ReLU mask that flips between two summation orders moves a
# whole column of dW_l (0.35 of 2.5 at N = 100, "NVIDIA H100 80GB HBM3,
# 700.00 W"), which a bound on the largest entry cannot tell from a fault.
@pytest.mark.parametrize('use_contract', [True, False])
@pytest.mark.parametrize('n', [1, 100, 129])
def test_density_mlp_backward_kernel_matches_plain_at_tile_edges(
    cuda, n, use_contract):
  rng = np.random.RandomState(n)
  means, covs = _gaussians(n, 6, cuda, 0.1 if use_contract else 0.0)
  ws, bs, wd = _trunk(rng, cuda)
  g = torch.as_tensor(rng.randn(n).astype(np.float32), device=cuda)
  args = (covs, ws, bs, wd, g, BASIS)
  leaves = lambda out: {f'leaf {i}': t.cpu() for i, t in enumerate(
      [*out[0], *out[1], out[2], out[3]])}
  dm.reset_counts()
  got = leaves(dm.density_mlp_backward(means, *args,
                                       use_contract=use_contract))
  again = leaves(dm.density_mlp_backward(means, *args,
                                         use_contract=use_contract))
  assert dm.bwd_counts == {'launches': 2, 'plain_calls': 0}
  want = leaves(dm.density_mlp_bwd_plain(means, *args,
                                         use_contract=use_contract))
  nudged = leaves(dm.density_mlp_bwd_plain(
      means * (1 + train_lib.NUDGE), *args, use_contract=use_contract))
  for k, w in list(want.items()):
    assert torch.equal(got[k], again[k]), f'{k}: two launches differ'
    assert bool(torch.isfinite(got[k]).all()), k
    if not bool(w.any()):  # No relative gap to a zero leaf: match it.
      assert not bool(got[k].any()), k
      del want[k], nudged[k]
  for k, (gap, _, bound) in train_lib.leaf_gaps(got, want, nudged).items():
    assert gap <= bound, f'N={n} {k}: {gap:.3e} > {bound:.3e}'


@pytest.mark.parametrize('use_contract', [True, False])
@pytest.mark.parametrize('n', [1, 50, 65])
def test_featurize_dense_dw_kernel_matches_plain_at_tile_edges(
    cuda, n, use_contract):
  rng = np.random.RandomState(n)
  means, covs = _gaussians(n, 7, cuda, 0.1 if use_contract else 0.0)
  g = torch.as_tensor(rng.randn(n, 1024).astype(np.float32), device=cuda)
  args = (means, covs, g, BASIS)
  fd.reset_counts()
  got = fd.featurize_dense_dw(*args, use_contract=use_contract)
  again = fd.featurize_dense_dw(*args, use_contract=use_contract)
  assert fd.bwd_counts == {'launches': 2, 'plain_calls': 0}
  want = fd.featurize_dense_dw_plain(*args, use_contract=use_contract)
  _check_leaves([got], [again], [want], f'featurize_dense_dw N={n}',
                KERNEL_TOL)


def test_train_step_on_the_gpu_matches_the_cpu(cuda):
  # One train step at the test widths (PropMLP width 32, which K3 runs
  # zero-padded to 64; NerfMLP 64, K4's narrowest), randomized=False, the same
  # seeded weights: kernels on the GPU, plain versions on the CPU.  Bounds
  # as tests/test_torch_train_step.py: loss terms 1e-3 relative, each
  # gradient leaf by train_lib.leaf_gaps, with the CPU step as the
  # reference, run a second time on nudged rays.
  args = argparse.Namespace(
      gin_configs=[tp.CONFIG_360],
      gin_bindings=list(tp.SMALL_BINDINGS) + [
          "Config.dataset_loader = 'dummy_unbounded'",
          'Config.batch_size = 256', 'Config.randomized = False'])
  config = configs.load_config(args)
  host = next(datasets.load_dataset('train', None, config, seed=0))
  runs = []
  for device, nudge in ((cuda, False), ('cpu', False), ('cpu', True)):
    model = train_lib.setup_model(config, 0, device)[0]
    batch = train_lib.batch_to_device(host, device)
    if nudge:
      batch = train_lib.nudge_origins(batch)
    dm.reset_counts()
    fd.reset_counts()
    loss, losses, _, grads = train_lib.loss_and_grads(model, config, batch,
                                                      0.5)
    if device == cuda:
      assert dm.bwd_counts['launches'] == fd.bwd_counts['launches'] == 2
    runs.append((dict(losses, loss=loss),
                 {k: v.cpu() for k, v in grads.items()}))
  (got_l, got), (want_l, want), (_, nudged) = runs
  for k, v in want_l.items():
    assert float(got_l[k]) == pytest.approx(float(v), rel=1e-3), k
  for k, (gap, _, bound) in train_lib.leaf_gaps(got, want, nudged).items():
    assert gap <= bound, f'{k}: {gap:.3e} > {bound:.3e}'


# K3 at 672 features (16 degrees: configs/blender_512.gin, llff_512.gin),
# where layer 0 runs in two K-parts, the sin and the cos half of the
# features.  Where both layouts fit (width 128) they give every leaf bit
# for bit; at width 256 (two parts only) the kernel is held as at 504
# features, at the full chunk by K3_TOL and at the tile edges by
# train_lib.leaf_gaps.
F672 = 672


def _trunk672(rng, device, width):
  ws = [_uniform(rng, (F672, width), F672, device)] + [
      _uniform(rng, (width, width), width, device) for _ in range(3)]
  bs = [torch.as_tensor(rng.randn(width).astype(np.float32) * 0.1,
                        device=device) for _ in ws]
  return ws, bs, _uniform(rng, (width, 1), width, device)


def _k3_leaves(out):
  return [*out[0], *out[1], out[2], out[3]]


@pytest.mark.parametrize('n', [1, 129, 300, K1_N])
def test_density_mlp_backward_two_parts_match_one_part_bitwise(cuda, n,
                                                               monkeypatch):
  from multinerf_tpu_torch.ops.kernels import plans
  rng = np.random.RandomState(n)
  means, covs = _gaussians(n, 10, cuda, 0.0)
  ws, bs, wd = _trunk672(rng, cuda, 128)
  g = torch.as_tensor(rng.randn(n).astype(np.float32), device=cuda)
  plan = plans.density_mlp_bwd_plan
  out = []
  for parts in (1, 2):
    monkeypatch.setattr(plans, 'density_mlp_bwd_plan',
                        lambda *a, parts=parts: plan(*a, parts=parts))
    out.append(_k3_leaves(dm.density_mlp_backward(
        means, covs, ws, bs, wd, g, BASIS, 0, 16, False)))
  torch.cuda.synchronize()
  for i, (a, b) in enumerate(zip(*out)):
    assert torch.equal(a, b), f'N={n} leaf {i}: the layouts differ'


@pytest.mark.parametrize('use_contract', [True, False])
def test_density_mlp_backward_kernel_at_672_features(cuda, use_contract):
  rng = np.random.RandomState(11)
  means, covs = _gaussians(K1_N, 12, cuda, 0.1 if use_contract else 0.0)
  ws, bs, wd = _trunk672(rng, cuda, 256)
  g = torch.as_tensor(rng.randn(K1_N).astype(np.float32), device=cuda)
  args = (means, covs, ws, bs, wd, g, BASIS, 0, 16, use_contract)
  dm.reset_counts()
  got = _k3_leaves(dm.density_mlp_backward(*args))
  again = _k3_leaves(dm.density_mlp_backward(*args))
  assert dm.bwd_counts == {'launches': 2, 'plain_calls': 0}
  assert got[0].shape == (F672, 256)
  want = _k3_leaves(dm.density_mlp_bwd_plain(*args))
  _check_leaves(got, again, want,
                f'density_mlp_bwd 672 contract={use_contract}', K3_TOL)


@pytest.mark.parametrize('n', [1, 100, 129])
def test_density_mlp_backward_at_672_features_at_tile_edges(cuda, n):
  rng = np.random.RandomState(n + 672)
  means, covs = _gaussians(n, 13, cuda, 0.0)
  ws, bs, wd = _trunk672(rng, cuda, 256)
  g = torch.as_tensor(rng.randn(n).astype(np.float32), device=cuda)
  rest = (covs, ws, bs, wd, g, BASIS, 0, 16, False)
  leaves = lambda out: {f'leaf {i}': t.cpu()
                        for i, t in enumerate(_k3_leaves(out))}
  got = leaves(dm.density_mlp_backward(means, *rest))
  again = leaves(dm.density_mlp_backward(means, *rest))
  want = leaves(dm.density_mlp_bwd_plain(means, *rest))
  nudged = leaves(dm.density_mlp_bwd_plain(means * (1 + train_lib.NUDGE),
                                           *rest))
  for k, w in list(want.items()):
    assert torch.equal(got[k], again[k]), f'{k}: two launches differ'
    assert bool(torch.isfinite(got[k]).all()), k
    if not bool(w.any()):
      assert not bool(got[k].any()), k
      del want[k], nudged[k]
  for k, (gap, _, bound) in train_lib.leaf_gaps(got, want, nudged).items():
    assert gap <= bound, f'N={n} {k}: {gap:.3e} > {bound:.3e}'


def test_backward_shared_memory_at_672_features_matches_the_plan(cuda):
  import ctypes
  from multinerf_tpu_torch.ops.kernels import build
  from multinerf_tpu_torch.ops.kernels import plans
  fn = build.load('density_mlp_bwd').density_mlp_bwd_smem
  fn.argtypes = [ctypes.c_int] * 5
  fn.restype = ctypes.c_int
  for feats, width in ((F672, 256), (F672, 128), (NUM_FEATS, 256)):
    plan = plans.density_mlp_bwd_plan(feats, width, 4, 21, 1000,
                                      fd.num_sms(cuda))
    assert fn(plan.width, 4, feats, 21, plan.parts) == plan.smem
  assert plans.density_mlp_bwd_plan(F672, 256, 4, 21, 1000, 132).parts == 2


def test_kernel_wrappers_reject_what_the_kernels_do_not_take(cuda):
  means, covs = _gaussians(64, 3, cuda)
  kernel = torch.zeros((NUM_FEATS, 64), device=cuda)
  bias = torch.zeros((64,), device=cuda)
  with pytest.raises(TypeError, match='float32'):
    fd.featurize_dense(means.double(), covs.double(), kernel, bias, BASIS)
  with pytest.raises(ValueError, match='multiple of 32'):
    fd.featurize_dense(means, covs, kernel[:, :48], bias[:48], BASIS)
  with pytest.raises(ValueError, match='features'):
    fd.featurize_dense(means, covs, kernel[:500], bias, BASIS)
  with pytest.raises(ValueError, match='one device'):
    fd.featurize_dense(means, covs, kernel.cpu(), bias, BASIS)
  with pytest.raises(ValueError, match='trunk shapes'):
    dm.density_mlp(means, covs, [kernel, kernel], [bias, bias],
                   torch.zeros((64, 1), device=cuda),
                   torch.zeros((), device=cuda), BASIS)
  wide = torch.zeros((NUM_FEATS, 512), device=cuda)
  with pytest.raises(ValueError, match='at most 256'):
    dm.density_mlp(means, covs, [wide], [torch.zeros((512,), device=cuda)],
                   torch.zeros((512, 1), device=cuda),
                   torch.zeros((), device=cuda), BASIS)


def test_model_forward_on_the_gpu_matches_the_cpu(cuda):
  # The whole Model at the test widths: kernels on the GPU, their plain
  # versions on the CPU, the same seeded weights.  The two differ where a
  # value crosses a bf16 rounding boundary, which the JAX parity tests
  # (tests/test_torch_model.py) bound at the same 3e-3 / 2e-3.
  args = argparse.Namespace(gin_configs=[tp.CONFIG_360],
                            gin_bindings=list(tp.SMALL_BINDINGS))
  config = configs.load_config(args)
  fields = tp.rays(256, seed=4)
  out = []
  for device in (cuda, torch.device('cpu')):
    model = nerf.construct_model(config, torch.Generator().manual_seed(0),
                                 device)
    rays = types.Rays(**{k: torch.as_tensor(v, device=device)
                         for k, v in fields.items()})
    renderings, history = train_lib.create_render_fn(model)(1.0, rays)
    out.append((renderings[-1], history))
  (got, got_h), (want, want_h) = out
  for level, (g, w) in enumerate(zip(got_h, want_h)):
    tp.assert_close(g['sdist'].cpu().numpy(), w['sdist'].numpy(), atol=2e-3,
                    what=f'level {level} sdist')
  for key in ('rgb', 'acc'):
    tp.assert_close(got[key].cpu().numpy(), want[key].numpy(), atol=3e-3,
                    what=key)
  for key in ('distance_mean', 'distance_median'):
    tp.assert_close(0.2 / got[key].cpu().numpy(), 0.2 / want[key].numpy(),
                    atol=2e-3, what=f'near / {key}')


# The int8 trunk (K5, K6) against its plain versions: relative L2 < 2e-2
# for the output (tests/test_pallas_int8_trunk.py:74) and for each gradient
# leaf.  Both sides quantize the same f32 values and differ where a
# summation order moves one across an int8 or bf16 rounding step; through
# eight layers such flips compound, and with a random-signed cotangent the
# plain version's own leaves move by up to 0.15 when the means move by a
# relative 1e-6.  So K6 is held with a cotangent >= 0, whose sums do not
# cancel (chip_smoke.py: I8_TOL).  K6 sums in a fixed order: two launches
# agree bit for bit.
def _nerf_trunk(rng, device, depth=8, width=1024, skip=(5,)):
  ws = [_uniform(rng, (NUM_FEATS if l == 0 else
                       width + (NUM_FEATS if l in skip else 0), width),
                 NUM_FEATS if l == 0 else width, device)
        for l in range(depth)]
  bs = [torch.as_tensor(rng.randn(width).astype(np.float32) * 0.1,
                        device=device) for _ in ws]
  return ws, bs


def _rel_l2(got, want):
  return float(torch.linalg.vector_norm((got - want).double()) /
               torch.linalg.vector_norm(want.double()))


def test_int8_trunk_kernel_matches_plain(cuda):
  rng = np.random.RandomState(3)
  means, covs = _gaussians(K2_N, 6, cuda)
  ws, bs = _nerf_trunk(rng, cuda)
  args = (means, covs, ws, bs, BASIS)
  i8t.reset_counts()
  got = i8t.int8_trunk(*args, skip_layers=(5,))
  assert i8t.counts == {'launches': 1, 'plain_calls': 0}
  want = i8t.int8_trunk_plain(*args, skip_layers=(5,))
  torch.cuda.synchronize()
  assert got.dtype == want.dtype == torch.bfloat16
  assert got.shape == want.shape == (K2_N, 1024)
  assert bool(torch.isfinite(got.float()).all())
  assert _rel_l2(got.float(), want.float()) < 2e-2


# K5 at the edges of its 64-sample tiles (N = 1, 63, 64, 65, 300, 1,100),
# at a narrow trunk and at 360.gin's width, with and without a skip layer
# and with layer 0 alone: relative L2 < 2e-2, two launches bitwise equal,
# one launch and no plain call per call.
@pytest.mark.parametrize('shape', ['skip', 'no_skip', 'layer0'])
@pytest.mark.parametrize('width', [64, 1024])
@pytest.mark.parametrize('n', [1, 63, 64, 65, 300, 1100])
def test_int8_trunk_kernel_at_small_n(cuda, n, width, shape):
  depth, skip = {'skip': (8, (5,)), 'no_skip': (8, ()),
                 'layer0': (1, ())}[shape]
  if width == 64 and shape == 'skip':
    depth, skip = 4, (2,)
  rng = np.random.RandomState(n + width + depth)
  means, covs = _gaussians(n, 9, cuda)
  ws, bs = _nerf_trunk(rng, cuda, depth, width, skip)
  args = (means, covs, ws, bs, BASIS)
  i8t.reset_counts()
  got = i8t.int8_trunk(*args, skip_layers=skip)
  assert i8t.counts == {'launches': 1, 'plain_calls': 0}
  again = i8t.int8_trunk(*args, skip_layers=skip)
  want = i8t.int8_trunk_plain(*args, skip_layers=skip)
  torch.cuda.synchronize()
  assert got.dtype == want.dtype == torch.bfloat16
  assert got.shape == want.shape == (n, width)
  assert torch.equal(got, again), 'two launches differ'
  assert bool(torch.isfinite(got.float()).all())
  assert _rel_l2(got.float(), want.float()) < 2e-2


def test_int8_trunk_shared_memory_matches_the_plans(cuda):
  import ctypes
  from multinerf_tpu_torch.ops.kernels import build
  from multinerf_tpu_torch.ops.kernels import plans
  k5 = build.load('int8_trunk').int8_fwd_tile_smem
  k6 = build.load('int8_trunk_bwd').int8_bwd_tile_smem
  for fn in (k5, k6):
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_int
  sms = fd.num_sms(cuda)
  for feats, width in ((NUM_FEATS, 1024), (NUM_FEATS, 64), (NUM_FEATS, 192),
                       (672, 1024)):
    plan = plans.i8_fwd_plan(feats, width, 21, 1000, sms)
    assert k5(width, feats, 21, plan.bn, plan.stages) == plan.smem
    tile = plans.i8_tile_plan(feats, width, 21, 1024, sms)
    assert k6(width, feats, 21, tile.bn, tile.stages) == tile.smem


@pytest.mark.parametrize('bwd_bf16', [False, True])
def test_int8_trunk_backward_kernel_matches_plain(cuda, bwd_bf16):
  rng = np.random.RandomState(4)
  means, covs = _gaussians(K2_N, 7, cuda)
  ws, bs = _nerf_trunk(rng, cuda)
  g = torch.as_tensor(np.abs(rng.randn(K2_N, 1024)).astype(np.float32),
                      device=cuda).to(torch.bfloat16)
  args = (means, covs, ws, bs, g, BASIS)
  kw = dict(skip_layers=(5,), bwd_bf16=bwd_bf16)
  flat = lambda out: [*out[0], *out[1]]
  i8t.reset_counts()
  got = flat(i8t.int8_trunk_backward(*args, **kw))
  again = flat(i8t.int8_trunk_backward(*args, **kw))
  assert i8t.bwd_counts == {'launches': 2, 'plain_calls': 0}
  want = flat(i8t.int8_trunk_bwd_plain(*args, **kw))
  torch.cuda.synchronize()
  for i, (a, b, w) in enumerate(zip(got, again, want)):
    assert a.shape == w.shape, i
    assert torch.equal(a, b), f'leaf {i}: two launches differ'
    assert _rel_l2(a, w) < 2e-2, (i, _rel_l2(a, w))


# K6 at small N against its plain version, both bindings: N = 1 (one group
# of 256 padded samples), N = 300 (not a whole 64-sample tile; padded to
# one group of 512) and N = 1,100 (padded to 1,280: five groups of 256),
# at a narrow trunk and at 360.gin's width, with two launches bitwise
# equal.  Each leaf is held by train_lib.leaf_gaps against the plain
# version's own move when the means move by a relative 1e-6: with few
# samples the dW sums are short and one int8 flip weighs more, and at
# width 1,024 and N = 300 the plain version's dW_0 moves by 4.6e-2 under
# that nudge, the kernel being 3.3e-2 from it (as the previous K6 was, to
# two digits; "NVIDIA H100 80GB HBM3, 700.00 W").
@pytest.mark.parametrize('bwd_bf16', [False, True])
@pytest.mark.parametrize('width,depth,skip', [(64, 4, (2,)),
                                              (1024, 8, (5,))])
@pytest.mark.parametrize('n', [1, 300, 1100])
def test_int8_trunk_backward_kernel_at_small_n(cuda, n, width, depth, skip,
                                               bwd_bf16):
  rng = np.random.RandomState(n + width)
  means, covs = _gaussians(n, 8, cuda)
  ws, bs = _nerf_trunk(rng, cuda, depth, width, skip)
  g = torch.as_tensor(np.abs(rng.randn(n, width)).astype(np.float32),
                      device=cuda).to(torch.bfloat16)
  kw = dict(skip_layers=skip, bwd_bf16=bwd_bf16)

  def leaves(fn, m):
    dws, dbs = fn(m, covs, ws, bs, g, BASIS, **kw)
    return {f'leaf {i}': t.cpu() for i, t in enumerate([*dws, *dbs])}

  i8t.reset_counts()
  got = leaves(i8t.int8_trunk_backward, means)
  again = leaves(i8t.int8_trunk_backward, means)
  assert i8t.bwd_counts == {'launches': 2, 'plain_calls': 0}
  want = leaves(i8t.int8_trunk_bwd_plain, means)
  nudged = leaves(i8t.int8_trunk_bwd_plain, means * (1 + train_lib.NUDGE))
  torch.cuda.synchronize()
  for k, a in got.items():
    assert a.shape == want[k].shape, k
    assert torch.equal(a, again[k]), f'{k}: two launches differ'
    assert bool(torch.isfinite(a).all()), k
  gaps = train_lib.leaf_gaps(got, want, nudged)
  assert all(gap <= bound for gap, _, bound in gaps.values()), gaps


# The exact bf16 split of an f32 weight (models/mlp.py: _SplitProduct), which
# the heads and the skip layer's activation rows take for a bf16 activation,
# on the tensor cores at 65,536 rows of the 360 NerfMLP's products (1,024 in,
# 1,024 / 256 / 1 out).  Against a float64 product its error is held to
# twice that of the product it replaces, the promoted activation's f32
# product with TF32 off (readings: 0.9-1.3 times); bf16 partial sums in a
# split-K reduction would miss that by orders of magnitude.
@pytest.mark.parametrize('m', [1024, 256, 1])
def test_split_product_error_is_within_twice_the_f32_products(cuda, m):
  gen = torch.Generator(device=cuda).manual_seed(m)
  x = torch.relu(torch.randn(65536, 1024, device=cuda, generator=gen)).to(
      torch.bfloat16)
  w = (torch.rand(1024, m, device=cuda, generator=gen) * 2 - 1) * np.sqrt(
      6.0 / 1024)
  want = x.double() @ w.double()
  mlp_lib.reset_split_counts()
  got = mlp_lib._SplitProduct.apply(x, w)
  promoted = x.float() @ w
  torch.cuda.synchronize()
  assert mlp_lib.split_counts['forward'] == 1 and got.dtype == torch.float32
  err = float((got.double() - want).abs().max())
  bound = 2 * float((promoted.double() - want).abs().max())
  assert err <= bound, f'm={m}: {err:.3e} > {bound:.3e}'


def test_split_products_match_the_promoted_ones_in_the_360_mlp(
    cuda, monkeypatch):
  # The 360 NerfMLP (8 x 1,024, bf16 trunk, K2/K4 on the card) forward and
  # backward on 65,536 samples, its four split products (skip layer,
  # density, bottleneck, rgb) against the same model with them promoted.
  # Bounds of test_train_step_on_the_gpu_matches_the_cpu: the loss terms
  # 1e-3 relative, each gradient leaf by train_lib.leaf_gaps, the promoted
  # run on nudged means giving the reference's own move.
  cfg = mlp_lib.NerfMLP(net_depth=8, net_width=1024, warp_fn=coord.contract,
                        disable_density_normals=True, trunk_dtype='bfloat16')
  model = mlp_lib.MLP(cfg, generator=torch.Generator().manual_seed(0),
                      device=cuda)
  n_rays, n_samples = 2048, 32
  means, covs = _gaussians(n_rays * n_samples, 9, cuda)
  viewdirs = torch.as_tensor(tp.rays(n_rays, seed=10)['viewdirs'],
                             device=cuda)
  gen = torch.Generator(device=cuda).manual_seed(11)
  cot_density = torch.rand(n_rays, n_samples, device=cuda, generator=gen)
  cot_rgb = torch.rand(n_rays, n_samples, 3, device=cuda, generator=gen)

  def run(means):
    model.zero_grad()
    mlp_lib.reset_split_counts()
    out = model(means.view(n_rays, n_samples, 3),
                covs.view(n_rays, n_samples, 3, 3), viewdirs)
    terms = {'density': (out['density'] * cot_density).sum(),
             'rgb': (out['rgb'] * cot_rgb).sum()}
    sum(terms.values()).backward()
    return ({k: float(v) for k, v in terms.items()},
            {k: p.grad.cpu() for k, p in model.named_parameters()},
            mlp_lib.split_counts['forward'])

  got_terms, got, split = run(means)
  monkeypatch.setattr(
      mlp_lib, '_f32_product',
      lambda x, kernel, split: x.to(kernel.dtype) @ kernel)
  want_terms, want, promoted = run(means)
  _, nudged, _ = run(means * (1 + train_lib.NUDGE))
  assert (split, promoted) == (4, 0)
  for k, v in want_terms.items():
    assert got_terms[k] == pytest.approx(v, rel=1e-3), k
  for k, (gap, _, bound) in train_lib.leaf_gaps(got, want, nudged).items():
    assert gap <= bound, f'{k}: {gap:.3e} > {bound:.3e}'
