"""The pieces of the port's training step against the JAX package: the
losses and schedule, the jittered sampler, the fused kernels' backward
passes (plain versions, through autograd), the optimizer, the train split
and the train entry point.

Tolerances:
* losses, gradients of the losses and the schedule: the same f32 formulas,
  1e-5 relative.
* the kernels' plain backward against the interpreted Pallas backward
  kernels: both round features, activations and cotangents to bf16 at the
  same places and differ in summation order and where an f32 value lands on
  the other side of a bf16 boundary, so the bf16-level bound of
  tests/test_pallas_*.py, per leaf 2e-2 * max |want|.
* the optimizer: the same arithmetic in another order, 1e-6 relative.
"""

import dataclasses
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), 'helpers'))
import torch_parity as tp  # noqa: E402

from multinerf_tpu import configs as jconfigs  # noqa: E402
from multinerf_tpu import train_lib as jtrain_lib  # noqa: E402
from multinerf_tpu.data import datasets as jdatasets  # noqa: E402
from multinerf_tpu.ops import geopoly as jgeopoly  # noqa: E402
from multinerf_tpu.ops import mathx as jmathx  # noqa: E402
from multinerf_tpu.ops import stepfun as jstepfun  # noqa: E402
from multinerf_tpu.ops.pallas import density_mlp as jdm  # noqa: E402
from multinerf_tpu.ops.pallas import featurize_dense as jfd  # noqa: E402
from multinerf_tpu_torch import bridge  # noqa: E402
from multinerf_tpu_torch import configs  # noqa: E402
from multinerf_tpu_torch import profile_step  # noqa: E402
from multinerf_tpu_torch import train  # noqa: E402
from multinerf_tpu_torch import train_lib  # noqa: E402
from multinerf_tpu_torch.data import datasets  # noqa: E402
from multinerf_tpu_torch.data import types  # noqa: E402
from multinerf_tpu_torch.models import culling  # noqa: E402
from multinerf_tpu_torch.ops import mathx  # noqa: E402
from multinerf_tpu_torch.ops import stepfun  # noqa: E402
from multinerf_tpu_torch.ops.kernels import density_mlp as dm  # noqa: E402
from multinerf_tpu_torch.ops.kernels import featurize_dense as fd  # noqa: E402
from multinerf_tpu_torch.utils import checkpoints  # noqa: E402
from multinerf_tpu_torch.utils import trace  # noqa: E402

BASIS = np.array(jgeopoly.generate_basis('icosahedron', 2)).T  # [3, 21]
KERNEL_TOL = 2e-2
N = 600  # Not a multiple of any tile: the ragged edge.
_ENV = dict(os.environ, OMP_NUM_THREADS='1', CUDA_VISIBLE_DEVICES='')


def _step_fn(rng, batch, n):
  """Random sorted fences [batch, n + 1] and normalized weights [batch, n]."""
  t = np.sort(rng.uniform(0, 1, (batch, n + 1)), axis=-1).astype(np.float32)
  w = rng.uniform(0, 1, (batch, n)).astype(np.float32)
  return t, (w / w.sum(-1, keepdims=True)).astype(np.float32)


def _close(got, want, rtol, what):
  want = np.asarray(want)
  tp.assert_close(np.asarray(got), want,
                  atol=rtol * max(float(np.abs(want).max()), 1e-30),
                  rtol=rtol, what=what)


def _value_and_grads(torch_fn, jax_fn, args, argnums, seed=0):
  """f(args) and the gradient of <f(args), ct> w.r.t. args[argnums], on
  both sides, for a random cotangent ct."""
  got_args = [torch.tensor(a, requires_grad=i in argnums)
              for i, a in enumerate(args)]
  got = torch_fn(*got_args)
  ct = np.random.RandomState(seed).randn(*got.shape).astype(np.float32)
  (got * torch.as_tensor(ct)).sum().backward()
  want, vjp = jax.vjp(jax_fn, *[jnp.asarray(a) for a in args])
  want_grads = vjp(jnp.asarray(ct))
  for i in argnums:
    yield f'grad {i}', got_args[i].grad.numpy(), want_grads[i]
  yield 'value', got.detach().numpy(), want


def test_lossfun_outer_matches_jax_in_value_and_gradient():
  rng = np.random.RandomState(0)
  t, w = _step_fn(rng, 16, 32)
  t_env, w_env = _step_fn(rng, 16, 64)
  for what, got, want in _value_and_grads(
      stepfun.lossfun_outer, jstepfun.lossfun_outer, (t, w, t_env, w_env),
      argnums=(1, 3)):
    _close(got, want, 1e-5, f'lossfun_outer {what}')


def test_lossfun_distortion_matches_jax_in_value_and_gradient():
  rng = np.random.RandomState(1)
  t, w = _step_fn(rng, 16, 32)
  for what, got, want in _value_and_grads(
      stepfun.lossfun_distortion, jstepfun.lossfun_distortion, (t, w),
      argnums=(0, 1)):
    _close(got, want, 1e-5, f'lossfun_distortion {what}')


@pytest.mark.parametrize('delay_steps', [0, 100])
def test_learning_rate_decay_matches_jax(delay_steps):
  steps = np.array([0, 1, 7, 50, 99, 100, 101, 500, 999, 1000])
  kw = dict(lr_init=2e-3, lr_final=2e-5, max_steps=1000,
            lr_delay_steps=delay_steps, lr_delay_mult=0.01)
  got = mathx.learning_rate_decay(steps, **kw)
  want = jmathx.learning_rate_decay(jnp.asarray(steps, jnp.float32), **kw)
  _close(got, want, 1e-5, 'learning_rate_decay')
  assert mathx.learning_rate_decay(0, **kw) == pytest.approx(
      2e-3 * (0.01 if delay_steps else 1.0))


@pytest.mark.parametrize('single_jitter', [True, False])
def test_jittered_sample_keeps_each_sample_in_its_stratum(single_jitter):
  num_rays, n = 64, 16
  # A uniform step function on [0, 1]: the inverse CDF is the identity, so
  # the samples are the jittered u themselves.
  t = torch.linspace(0, 1, 9).expand(num_rays, 9).contiguous()
  logits = torch.zeros(num_rays, 8)
  draw = lambda seed: stepfun.sample(torch.Generator().manual_seed(seed), t,
                                     logits, n, single_jitter=single_jitter)
  u = draw(3).numpy().astype(np.float64)
  eps = float(np.finfo(np.float32).eps)
  pitch = (1 - (eps + (1 - eps) / n)) / (n - 1)
  offset = u - np.arange(n) * pitch
  assert offset.min() >= -1e-6 and offset.max() < pitch - eps + 1e-6
  if single_jitter:
    np.testing.assert_allclose(offset, offset[:, :1].repeat(n, 1), atol=1e-6)
  else:
    assert np.abs(offset - offset[:, :1]).max() > 1e-3
  assert torch.equal(draw(3), draw(3))
  assert not torch.equal(draw(3), draw(4))


def _dense_inputs(n, use_contract, seed=0):
  means, covs = tp.gaussians(n, seed=seed, far_frac=0.1 if use_contract
                             else 0.0)
  rng = np.random.RandomState(seed)
  kernel = (rng.randn(504, 64) * 0.05).astype(np.float32)
  bias = (rng.randn(64) * 0.1).astype(np.float32)
  g = rng.randn(n, 64).astype(np.float32)
  return means, covs, kernel, bias, g


@pytest.mark.parametrize('use_contract', [True, False])
def test_featurize_dense_backward_matches_the_pallas_dw_kernel(use_contract):
  means, covs, kernel, bias, g = _dense_inputs(N, use_contract, seed=1)

  def jax_fn(k, b):
    return jfd.featurize_dense(jnp.asarray(means), jnp.asarray(covs), k, b,
                               BASIS, use_contract=use_contract,
                               interpret=True)
  _, vjp = jax.vjp(jax_fn, jnp.asarray(kernel), jnp.asarray(bias))
  want_dw, want_db = vjp(jnp.asarray(g))

  m = torch.tensor(means, requires_grad=True)
  k = torch.tensor(kernel, requires_grad=True)
  b = torch.tensor(bias, requires_grad=True)
  fd.reset_counts()
  out = fd.featurize_dense(m, torch.as_tensor(covs), k, b, BASIS,
                           use_contract=use_contract)
  out.backward(torch.as_tensor(g))
  assert fd.counts == {'launches': 0, 'plain_calls': 1}
  assert fd.bwd_counts == {'launches': 0, 'plain_calls': 1}
  assert m.grad is None  # Stop-gradient inputs, as the JAX custom VJP.
  _close(k.grad.numpy(), want_dw, KERNEL_TOL, 'dW')
  _close(b.grad.numpy(), want_db, 1e-5, 'db')
  # The Function's backward is the plain dW version itself.
  np.testing.assert_array_equal(
      k.grad.numpy(), fd.featurize_dense_dw_plain(
          torch.as_tensor(means), torch.as_tensor(covs), torch.as_tensor(g),
          BASIS, use_contract=use_contract).numpy())


def _trunk_inputs(depth=3, width=32, seed=0):
  rng = np.random.RandomState(seed)
  ws, bs, c_in = [], [], 504
  for _ in range(depth):
    ws.append((rng.randn(c_in, width) * np.sqrt(2 / c_in)).astype(np.float32))
    bs.append((rng.randn(width) * 0.1).astype(np.float32))
    c_in = width
  wd = (rng.randn(width, 1) / np.sqrt(width)).astype(np.float32)
  return ws, bs, wd, np.float32(0.1), rng.randn(N).astype(np.float32)


@pytest.mark.parametrize('use_contract', [True, False])
def test_density_mlp_backward_matches_the_pallas_bwd_kernel(use_contract):
  means, covs = tp.gaussians(N, seed=2, far_frac=0.1 if use_contract else 0.0)
  ws, bs, wd, bd, g = _trunk_inputs(seed=2)

  def jax_fn(ws_, bs_, wd_, bd_):
    return jdm.density_mlp(jnp.asarray(means), jnp.asarray(covs), ws_, bs_,
                           wd_, bd_, BASIS, use_contract=use_contract,
                           interpret=True)
  _, vjp = jax.vjp(jax_fn, [jnp.asarray(w) for w in ws],
                   [jnp.asarray(b) for b in bs], jnp.asarray(wd),
                   jnp.asarray(bd))
  want = vjp(jnp.asarray(g))

  leaves = [torch.tensor(x, requires_grad=True)
            for x in (*ws, *bs, wd, np.asarray(bd))]
  m = torch.tensor(means, requires_grad=True)
  c = torch.tensor(covs, requires_grad=True)
  dm.reset_counts()
  out = dm.density_mlp(m, c, leaves[:3], leaves[3:6], leaves[6], leaves[7],
                       BASIS, use_contract=use_contract)
  out.backward(torch.as_tensor(g))
  assert dm.counts == {'launches': 0, 'plain_calls': 1}
  assert dm.bwd_counts == {'launches': 0, 'plain_calls': 1}
  assert m.grad is None and c.grad is None
  want_flat = [*want[0], *want[1], want[2], want[3]]
  names = ['dW0', 'dW1', 'dW2', 'db0', 'db1', 'db2', 'dwd', 'dbd']
  for name, leaf, w in zip(names, leaves, want_flat):
    assert leaf.grad.shape == tuple(np.shape(w)), name
    _close(leaf.grad.numpy(), w, KERNEL_TOL, name)


def _optimizer_trees(seed=0):
  """Initial parameters and 3 gradient trees: NerfMLP_0's are over
  grad_max_norm, and one PropMLP_0 leaf is NaN at the second update."""
  rng = np.random.RandomState(seed)
  shapes = {'NerfMLP_0/Dense_0/kernel': (6, 4), 'NerfMLP_0/Dense_0/bias': (4,),
            'NerfMLP_0/Dense_1/kernel': (4, 3), 'PropMLP_0/Dense_0/kernel': (5, 4),
            'PropMLP_0/Dense_0/bias': (4,)}
  params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
  grads = []
  for i in range(3):
    g = {k: (rng.randn(*s) * (1e-2 if k.startswith('NerfMLP') else 1e-4))
         .astype(np.float32) for k, s in shapes.items()}
    if i == 1:
      g['PropMLP_0/Dense_0/bias'][2] = np.nan
    grads.append(g)
  return params, grads


@pytest.mark.parametrize('grad_max_val', [0.0, 3e-3])
def test_clip_nan_to_num_and_adam_match_optax(grad_max_val):
  params, grads = _optimizer_trees()
  kw = dict(lr_init=1e-2, lr_final=1e-4, max_steps=10, lr_delay_steps=4,
            lr_delay_mult=0.1, grad_max_norm=1e-3, grad_max_val=grad_max_val)
  jconfig = jconfigs.Config(**kw)
  state, _ = jtrain_lib.create_optimizer(
      jconfig, {'params': bridge.unflatten(
          {k: jnp.asarray(v) for k, v in params.items()})})
  for g in grads:
    tree = {'params': bridge.unflatten({k: jnp.asarray(v)
                                        for k, v in g.items()})}
    tree = jtrain_lib.clip_gradients(tree, jconfig)
    state = state.apply_gradients(
        grads=jax.tree_util.tree_map(jnp.nan_to_num, tree))
  want = bridge.flatten(state.params['params'])

  config = configs.Config(**kw)
  named = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in params.items()}
  optimizer, lr_fn = train_lib.create_optimizer(config, named)
  tstate = checkpoints.TrainState(step=0, params=named, optimizer=optimizer)
  for g in grads:
    tstate = train_lib.apply_gradients(
        tstate, {k: torch.tensor(v) for k, v in g.items()}, config, lr_fn)
  assert tstate.step == 3
  # Adam's moments under the flax names, against optax's state.
  moments = bridge.adam_moments(named, optimizer)
  adam_state = state.opt_state[0]
  for key in ('mu', 'nu'):
    for k, v in bridge.flatten(getattr(adam_state, key)['params']).items():
      _close(bridge.flatten(moments[key])[k], v, 1e-6, f'{key} {k}')
  for k, v in want.items():
    _close(named[k].detach().numpy(), v, 1e-6, k)
    # The updates themselves, which the parameters dwarf.
    _close(named[k].detach().numpy() - params[k], np.asarray(v) - params[k],
           1e-4, f'{k} update')


@pytest.mark.parametrize('batching,patch_size', [('all_images', 1),
                                                 ('single_image', 1),
                                                 ('all_images', 2)])
def test_train_split_matches_jax_make_ray_batch(batching, patch_size):
  bindings = ("Config.dataset_loader = 'dummy_unbounded'",
              'Config.batch_size = 32', f"Config.batching = '{batching}'",
              f'Config.patch_size = {patch_size}')
  jax_config, torch_config = tp.configs(bindings)
  got = next(datasets.load_dataset('train', None, torch_config, seed=7))
  # The same draws, in the order of datasets.py:256-282.
  rng = np.random.RandomState(7)
  num_patches = 32 // patch_size**2
  x = rng.randint(0, 64 - (patch_size - 1), (num_patches, 1, 1))
  y = rng.randint(0, 64 - (patch_size - 1), (num_patches, 1, 1))
  dx, dy = np.meshgrid(np.arange(patch_size), np.arange(patch_size),
                       indexing='xy')
  cam_shape = (num_patches, 1, 1) if batching == 'all_images' else (1,)
  cam_idx = rng.randint(0, 48, cam_shape)
  want = jdatasets.load_dataset('train', None, jax_config)._make_ray_batch(
      x + dx, y + dy, cam_idx)
  assert got.rgb.shape == (num_patches, patch_size, patch_size, 3)
  np.testing.assert_array_equal(got.rgb, want.rgb)
  for key in ('origins', 'directions', 'viewdirs', 'radii', 'imageplane',
              'lossmult', 'near', 'far', 'cam_idx'):
    np.testing.assert_allclose(np.asarray(getattr(got.rays, key)),
                               np.asarray(getattr(want.rays, key)),
                               rtol=1e-6, atol=1e-7, err_msg=key)


def test_train_cli_runs_steps_prints_and_saves(tmp_path):
  bindings = tp.SMALL_BINDINGS + (
      "Config.dataset_loader = 'dummy_unbounded'", 'Config.batch_size = 32',
      'Config.max_steps = 3', 'Config.print_every = 2',
      f"Config.checkpoint_dir = '{tmp_path}/ckpt'")
  cmd = [sys.executable, '-m', 'multinerf_tpu_torch.train', '--device=cpu',
         f'--gin_configs={tp.CONFIG_360}']
  cmd += [f'--gin_bindings={b}' for b in bindings]
  proc = subprocess.run(cmd, cwd=tp.REPO, env=_ENV, capture_output=True,
                        text=True, timeout=300, check=False)
  assert proc.returncode == 0, proc.stderr[-3000:]
  # train.py:411-415: step/max_steps, loss, psnr, lr | the loss terms, r/s.
  line = re.compile(r'^ *2/3: loss=\d+\.\d{5}, psnr= *\d+\.\d{3}, '
                    r'lr=\d\.\d\de-\d\d \| data=[\d.e-]+, inte=[\d.e-]+, '
                    r'dist=[\d.e-]+, \d+ r/s$', re.M)
  assert line.search(proc.stdout), proc.stdout
  saved = torch.load(tmp_path / 'ckpt' / 'checkpoint_3.pt',
                     weights_only=True)
  assert saved['step'] == 3
  assert 'NerfMLP_0/Dense_5/kernel' in saved['params']
  assert saved['opt_state']['state'], 'the optimizer state was not saved'


def test_train_first_step_computes_the_tree_statistics(tmp_path):
  # train.py:265: the tree statistics on the first step of a run, whatever
  # print_every says.  One step: max_steps = 1 divides by zero in train_frac,
  # in JAX's train.py as in the port, so the run exits early instead.
  argv = ['--device=cpu', f'--gin_configs={tp.CONFIG_360}'] + [
      f'--gin_bindings={b}' for b in tp.SMALL_BINDINGS + (
          "Config.dataset_loader = 'dummy_unbounded'",
          'Config.batch_size = 32', 'Config.max_steps = 100',
          'Config.early_exit_steps = 1', 'Config.print_every = 100',
          f"Config.checkpoint_dir = '{tmp_path}/ckpt'")]
  stats = train.main(argv)['stats']
  for prefix in ('weight_l2s/', 'grad_norms/', 'grad_maxes/',
                 'opt_update_norms/', 'opt_update_maxes/'):
    keys = [k for k in stats if k.startswith(prefix)]
    assert keys, f'no {prefix} statistics on the first step'
    assert all(np.isfinite(stats[k]).all() for k in keys), prefix


def test_train_refuses_cuda_without_a_gpu(tmp_path):
  if torch.cuda.is_available():
    pytest.skip('a GPU is present: nothing to refuse.')
  with pytest.raises(RuntimeError, match='CUDA is not available'):
    train.main(['--device=cuda', f'--gin_configs={tp.CONFIG_360}',
                f"--gin_bindings=Config.checkpoint_dir='{tmp_path}'"])


def test_training_options_outside_the_slice_raise():
  # An unknown data loss raises JAX's error; RawNeRF's is ported
  # (tests/test_torch_rawnerf.py holds it against JAX).
  batch = types.Batch(rays=tp.torch_rays(tp.rays(4)), rgb=torch.ones(4, 3))
  for loss_type in ('rawnerf', 'l1'):
    _, config = tp.configs(tp.SMALL_BINDINGS + (
        f"Config.data_loss_type = '{loss_type}'",))
    model = train_lib.setup_model(config, 0, 'cpu')[0]
    if loss_type == 'l1':
      with pytest.raises(ValueError, match='Unknown data loss type l1'):
        train_lib.loss_and_grads(model, config, batch, 0.5)
    else:
      loss = train_lib.loss_and_grads(model, config, batch, 0.5)[0]
      assert torch.isfinite(loss)
  # Density noise: drawn from a generator, none without one (the JAX
  # rng=None).
  _, config = tp.configs(tp.SMALL_BINDINGS + ('NerfMLP.density_noise = 1.0',))
  model = train_lib.setup_model(config, 0, 'cpu')[0]
  rays = tp.torch_rays(tp.rays(4))
  with torch.no_grad():
    clean = model(rays, 0.5, False)[1][-1]['density']
    assert torch.equal(clean, model(rays, 0.5, False)[1][-1]['density'])
    noisy = model(rays, 0.5, False,
                  generator=torch.Generator().manual_seed(0))[1][-1]
  assert not torch.equal(noisy['density'], clean)


def test_leaf_gaps_bound_by_the_reference_sensitivity_and_a_cap():
  want = {'a': np.ones(4), 'b': np.ones(4)}
  nudged = {'a': np.full(4, 1.01), 'b': np.full(4, 2.0)}
  got = {'a': np.full(4, 1.03), 'b': np.full(4, 1.5)}
  gaps = train_lib.leaf_gaps(got, want, nudged)
  assert gaps['a'] == pytest.approx((0.03, 0.01, train_lib.GAP_BASE + 0.02))
  assert gaps['b'] == pytest.approx((0.5, 1.0, train_lib.GAP_CAP))
  assert train_lib.leaf_gaps(got, want, nudged, cap=0.5)['b'][2] == 0.5
  rays = tp.torch_rays(tp.rays(4))
  batch = types.Batch(rays=rays, rgb=torch.zeros(4, 3))
  origins = rays.origins.clone()
  moved = train_lib.nudge_origins(batch)
  torch.testing.assert_close(moved.rays.origins,
                             origins * (1 + train_lib.NUDGE))
  assert torch.equal(batch.rays.origins, origins)
  assert moved.rays.directions is rays.directions and moved.rgb is batch.rgb


PROFILE = tp.SMALL_BINDINGS + ("Config.dataset_loader = 'dummy_unbounded'",
                               'Config.batch_size = 64',
                               'Config.occupancy_grid_resolution = 8')
PROFILE_CAP = 0.33


def _profile_config(bindings=()):
  return tp.configs(PROFILE + tuple(bindings))[1]


def _params(state):
  return {k: v.detach().clone() for k, v in state.params.items()}


def test_profile_step_forced_rung_is_the_culled_step_on_the_half_grid():
  config = _profile_config()
  dataset, state, run, info = profile_step.setup(config, 'cpu', PROFILE_CAP)
  with dataset:
    state, stats = run(1, state)
  got = _params(state)
  samples = 64 * 8  # The final level's samples: rays x num_nerf_samples.
  assert info == {'capacity': PROFILE_CAP, 'compact_n': 256, 'window': 1}
  assert info['compact_n'] == culling.round_capacity(samples, PROFILE_CAP)
  # The half grid keeps more than the rung holds: the step overflows.
  assert float(stats['occ_keep_frac']) > PROFILE_CAP

  config = dataclasses.replace(config, occupancy_culling=True,
                               occupancy_capacity_frac=PROFILE_CAP)
  with datasets.load_dataset('train', None, config,
                             seed=train.DATA_SEED) as dataset:
    model, state, _, _, _ = train_lib.setup_model(config, train.SEED, 'cpu',
                                                  dataset)
    model.occupancy.grid.copy_(culling.half_grid(8))
    step = train_lib.create_train_step(model, config, 'cpu', cull=PROFILE_CAP,
                                       dataset=dataset)
    state, want_stats = step(torch.Generator().manual_seed(train.SEED), state,
                             train_lib.batch_to_device(next(dataset), 'cpu'),
                             0.0, False)
  want = _params(state)
  assert set(got) == set(want) and 'occupancy/grid' in got
  for name in want:
    assert torch.equal(got[name], want[name]), name
  assert torch.equal(stats['loss'], want_stats['loss'])


def test_profile_step_window_is_its_single_forced_steps():
  config = _profile_config(('Config.device_data_plane = True',))
  runs = {}
  for window in (4, 1):
    dataset, state, run, info = profile_step.setup(config, 'cpu', PROFILE_CAP,
                                                   window)
    with dataset:
      for i in range(1, 5 if window == 1 else 2):
        state, stats = run(i, state)
    runs[window] = _params(state), stats
  assert info['window'] == 1 and runs[4][1]['loss'].shape == (4,)
  for name, value in runs[1][0].items():
    assert torch.equal(runs[4][0][name], value), name
  assert torch.equal(runs[4][1]['loss'][-1], runs[1][1]['loss'])
  with pytest.raises(ValueError, match='device_data_plane'):
    profile_step.setup(_profile_config(), 'cpu', None, 4)


def test_profile_step_compaction_is_read_from_the_profilers_parents():
  config = _profile_config()
  dataset, state, run, _ = profile_step.setup(config, 'cpu', PROFILE_CAP)
  with dataset, torch.profiler.profile(
      activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
    run(1, state)
  spans = trace._Spans(prof.events())  # pylint: disable=protected-access
  names = {e.name for e in spans.cpu if culling.COMPACTION in spans.of(e)}
  engine = 'autograd::engine::evaluate_function: '
  assert {culling.COMPACTION, 'aten::cumsum', 'GatherRows',
          engine + 'GatherRowsBackward', engine + 'CatBackward0'} <= names
  # Nothing of the MLPs, forward or backward.
  assert not [n for n in names if 'DensityMLP' in n or 'FeaturizeDense' in n
              or 'Mm' in n or 'mm' in n]


def test_profile_step_busy_time_is_the_union_of_intervals():
  assert trace.union_us([]) == 0
  assert trace.union_us([(5, 6), (0, 2), (1, 3), (1.5, 2.5)]) == 4
  if not torch.cuda.is_available():
    with pytest.raises(RuntimeError, match='needs CUDA'):
      profile_step.main([f'--gin_configs={tp.CONFIG_360}'])
