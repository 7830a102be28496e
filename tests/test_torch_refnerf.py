"""Ref-NeRF and the unfused MLP path of the port against the JAX package, on
the same (bridged) weights with rng=None, at test size: NerfMLP 4 x 32,
view branch 2 x 16, bottleneck 16, 16 + 16 samples, 12-16 rays, on
``configs/blender_refnerf.gin``; the unfused 360 MLP at the widths of
tests/test_torch_model.py.

Both packages run these paths as plain f32 products (the JAX package takes
its XLA path on the CPU, and neither may fuse with density normals on), so
the tolerances are f32-level: those of tests/test_model_parity.py:272-290
for the Ref-NeRF outputs (predicted normals rtol 1e-3 / atol 1e-4,
roughness rtol 1e-3 / atol 1e-5, rgb atol 1e-4), with two exceptions.
Across two frameworks the f32 sums of the IPE's 2^15-scaled terms in a
density gradient round differently, by ~3e-5 of the largest gradient, so
its atol is 1e-4 of that largest value (not 1e-5), and a density normal,
that gradient over its own length, carries the gap further where the
gradient is short: atol 1e-3 (not 1e-4; 3.3e-4 measured, 0.02 degrees).
The measured gaps: raw density gradients 4.4e-3 of values up to 133,
predicted normals 4.3e-5, rgb 3e-7.  The train steps are held by
``train_lib.leaf_gaps`` against the JAX step and the JAX step on nudged
rays, as tests/test_torch_train_step.py holds the 360 step.
The JAX steps run under ``jax.jit`` of ``create_train_step(jit=False)``.
"""

import os
import sys

from flax import linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), 'helpers'))
import torch_parity as tp  # noqa: E402

from multinerf_tpu import ginlite as jax_gin  # noqa: E402
from multinerf_tpu import train_lib as jtrain_lib  # noqa: E402
from multinerf_tpu.data import types as jtypes  # noqa: E402
from multinerf_tpu.parallel import mesh as mesh_lib  # noqa: E402
from multinerf_tpu_torch import bridge  # noqa: E402
from multinerf_tpu_torch import train_lib  # noqa: E402
from multinerf_tpu_torch.data import datasets  # noqa: E402
from multinerf_tpu_torch.models import mlp as mlp_lib  # noqa: E402
from multinerf_tpu_torch.models import nerf  # noqa: E402

CONFIG_REFNERF = os.path.join(tp.REPO, 'configs', 'blender_refnerf.gin')
SMALL_REFNERF = (
    "Config.dataset_loader = 'dummy_specular'",
    'NerfMLP.net_depth = 4',
    'NerfMLP.net_width = 32',
    'NerfMLP.net_depth_viewdirs = 2',
    'NerfMLP.net_width_viewdirs = 16',
    'NerfMLP.bottleneck_width = 16',
    'Model.num_prop_samples = 16',
    'Model.num_nerf_samples = 16',
)
TRAIN_FRAC = 0.5


def _refnerf_configs(*more):
  return tp.configs(SMALL_REFNERF + tuple(more), files=(CONFIG_REFNERF,))


def _model_pair(jax_config, torch_config, seed=0):
  """(JAX Model, its params, port Model holding the same weights)."""
  params = tp.jax_params(jax_config, seed=seed)
  model = nerf.construct_model(torch_config,
                               torch.Generator().manual_seed(0), 'cpu')
  bridge.load_jax_params(model, params)
  return jax_gin.make('Model', config=jax_config), params, model


def test_jax_refnerf_tree_loads_by_renaming_alone():
  jax_config, torch_config = _refnerf_configs()
  want = {k: tuple(v.shape) for k, v in bridge.flatten(
      tp.jax_params(jax_config, shapes_only=True)).items()}
  model = nerf.construct_model(torch_config,
                               torch.Generator().manual_seed(0), 'cpu')
  got = {k: tuple(v.shape)
         for k, v in bridge.named_parameters(model).items()}
  assert got == want
  # The JAX creation order (mlp.py:300-489): trunk 0-3, density 4,
  # grad_pred 5, diffuse 6, tint 7, roughness 8, bottleneck 9, view branch
  # 10-11, rgb 12.  IDE at deg_view 5: 72 features, + n.v + bottleneck.
  heads = model.NerfMLP_0.heads
  names = {k: n for n, m in model.NerfMLP_0.named_children()
           for k, h in heads.items() if h is m}
  assert names == {'density': 'Dense_4', 'grad_pred': 'Dense_5',
                   'diffuse': 'Dense_6', 'tint': 'Dense_7',
                   'roughness': 'Dense_8', 'bottleneck': 'Dense_9',
                   'rgb': 'Dense_12'}
  assert want['NerfMLP_0/Dense_10/kernel'] == (72 + 1 + 16, 16)
  assert not hasattr(model, 'PropMLP_0')  # single_mlp


@pytest.mark.parametrize('deg_view', [3, 5])
def test_refnerf_model_forward_matches_jax(deg_view):
  jax_config, torch_config = _refnerf_configs(
      f'NerfMLP.deg_view = {deg_view}')
  jmodel, params, model = _model_pair(jax_config, torch_config)
  assert not model.NerfMLP_0.fused  # Density normals: the unfused path.
  fields = tp.rays(12, seed=4, near=2.0, far=6.0)
  want_r, want_h = jax.jit(lambda p, r: jmodel.apply(
      {'params': p}, None, r, train_frac=1.0, compute_extras=True))(
          params, tp.jax_rays(fields))
  # As the renderer runs it: no graph but the density gradient's own.
  with torch.no_grad():
    got_r, got_h = model(tp.torch_rays(fields), 1.0, True)
  for level, (g, w) in enumerate(zip(got_h, want_h)):
    # A density gradient sums features scaled by up to 2^15: its f32
    # rounding is relative to the largest of them, so its atol is relative
    # to the largest gradient (measured: 2.6e-5 and 3.3e-5 of it).
    grad_scale = float(np.abs(w['raw_grad_density']).max())
    for key, rtol, atol in (('raw_grad_density', 1e-3, 1e-4 * grad_scale),
                            ('normals', 1e-3, 1e-3),
                            ('normals_pred', 1e-3, 1e-4),
                            ('roughness', 1e-3, 1e-5),
                            ('density', 1e-3, 1e-5),
                            ('weights', 0, 1e-5), ('sdist', 0, 1e-5)):
      tp.assert_close(g[key].numpy(), w[key], atol=atol, rtol=rtol,
                      what=f'level {level} {key}')
    tp.assert_close(g['rgb'].numpy(), w['rgb'], atol=1e-4,
                    what=f'level {level} rgb')
  for key in ('rgb', 'acc', 'normals', 'normals_pred', 'roughness'):
    tp.assert_close(got_r[-1][key].numpy(), want_r[-1][key], atol=1e-4,
                    what=f'rendered {key}')
  assert got_r[-1]['normals'].shape == (12, 3)
  assert got_r[-1]['roughness'].shape == (12, 1)


@pytest.mark.parametrize('bindings', [
    (),  # 360.gin's NerfMLP cut to depth 6: the skip at layer 5.
    ('NerfMLP.net_depth = 5',),  # A skip after the trunk's last layer.
    ("NerfMLP.trunk_dtype = 'bfloat16'",),
])
def test_unfused_360_mlp_matches_jax(bindings):
  tp.configs(tp.SMALL_BINDINGS + ('NerfMLP.use_fused_featurize = False',) +
             tuple(bindings))
  jmlp = jax_gin.make('NerfMLP')
  cfg = mlp_lib.ginlite.make('NerfMLP')
  means, covs = tp.gaussians(16 * 8, seed=1, far_frac=0.1)
  means, covs = means.reshape(16, 8, 3), covs.reshape(16, 8, 3, 3)
  viewdirs = tp.rays(16, seed=2)['viewdirs']
  variables = jmlp.init(jax.random.PRNGKey(3), None,
                        (jnp.asarray(means), jnp.asarray(covs)),
                        viewdirs=jnp.asarray(viewdirs))
  model = mlp_lib.MLP(cfg, generator=torch.Generator().manual_seed(0),
                      device='cpu')
  bridge.load_jax_params(model, variables['params'])
  assert not model.fused
  want = jmlp.apply(variables, None, (jnp.asarray(means), jnp.asarray(covs)),
                    viewdirs=jnp.asarray(viewdirs))
  with torch.inference_mode():
    got = model(torch.as_tensor(means), torch.as_tensor(covs),
                torch.as_tensor(viewdirs))
  # f32: plain products on both sides.  bf16 trunk: both round the same
  # activations to bf16; a crossing of a rounding boundary moves one by
  # 2^-8 of itself (the bound of tests/test_torch_model.py).
  tol = 1e-2 if bindings and 'bfloat16' in bindings[0] else 1e-4
  tp.assert_close(got['density'].numpy(), want['density'], atol=tol,
                  rtol=tol, what='density')
  tp.assert_close(got['rgb'].numpy(), want['rgb'], atol=tol, what='rgb')


def _jax_batch(batch):
  fields = {k: jnp.asarray(v.numpy()) for k, v in vars(batch).items()
            if k != 'rays' and v is not None}
  return jtypes.Batch(
      rays=jtypes.Rays(**{k: jnp.asarray(v.numpy()) for k, v in
                          vars(batch.rays).items() if v is not None}),
      **fields)


def _jax_steps(jax_config, params, batch):
  """JAX's step on `batch` and on its nudged copy: per run, the stats, the
  raw gradient (what the step hands clip_gradients) and the update."""
  jmodel = jax_gin.make('Model', config=jax_config)
  jstate, _ = jtrain_lib.create_optimizer(jax_config, {'params': params})
  step = jtrain_lib.create_train_step(jmodel, jax_config,
                                      mesh_lib.create_mesh(), jit=False)
  clip = jtrain_lib.clip_gradients

  def run(state, b):
    captured = {}

    def recording_clip(grad, config):
      captured['grad'] = grad['params']
      return clip(grad, config)

    jtrain_lib.clip_gradients = recording_clip
    try:
      new_state, stats, _ = step(jax.random.PRNGKey(0), state, b,
                                 TRAIN_FRAC, 1.0)
    finally:
      jtrain_lib.clip_gradients = clip
    return new_state.params['params'], stats, captured['grad']

  run = jax.jit(run)
  params0 = bridge.flatten(jax.device_get(params))
  out = []
  for b in (batch, train_lib.nudge_origins(batch)):
    params1, stats, grads = jax.device_get(run(jstate, _jax_batch(b)))
    out.append({
        'stats': stats, 'grads': bridge.flatten(grads),
        'updates': {k: np.asarray(v) - np.asarray(params0[k])
                    for k, v in bridge.flatten(params1).items()}})
  return out


def _assert_within_gaps(got, want, want_nudged, what):
  for name, (gap, sens, bound) in train_lib.leaf_gaps(
      got, want, want_nudged).items():
    assert gap <= bound, (f'{name}: {what} relative L2 error {gap:.3e} > '
                          f'{bound:.3e} (JAX moved {sens:.3e})')


@pytest.fixture(scope='module')
def refnerf_steps():
  """One Ref-NeRF train step of 16 rays (both Ref-NeRF losses and their
  coarse multipliers, normal metrics on) in JAX and in the port."""
  jax_config, torch_config = _refnerf_configs('Config.batch_size = 16',
                                              'Config.randomized = False')
  params = tp.jax_params(jax_config, seed=1)
  host = next(datasets.load_dataset('train', None, torch_config, seed=3))
  batch = train_lib.batch_to_device(host, 'cpu')
  want, want_nudged = _jax_steps(jax_config, params, batch)
  model, state, _, train_step, _ = train_lib.setup_model(torch_config, 0,
                                                         'cpu')
  bridge.load_jax_params(model, params)
  _, _, _, grads = train_lib.loss_and_grads(model, torch_config, batch,
                                            TRAIN_FRAC)
  got = {'grads': {k: v.clone() for k, v in grads.items()}}
  params0 = {k: v.detach().clone() for k, v in state.params.items()}
  state, got['stats'] = train_step(None, state, batch, TRAIN_FRAC, False)
  got['updates'] = {k: (v.detach() - params0[k]).numpy()
                    for k, v in state.params.items()}
  return got, want, want_nudged


def test_refnerf_step_losses_and_normal_metrics_match_jax(refnerf_steps):
  got, want, _ = refnerf_steps
  terms = {f'losses/{k}' for k in want['stats']['losses']}
  assert terms == {'losses/data', 'losses/orientation',
                   'losses/predicted_normals'}
  assert float(got['stats']['loss']) == pytest.approx(
      float(want['stats']['loss']), rel=1e-5)
  for key in terms:
    assert float(got['stats'][key]) == pytest.approx(
        float(want['stats']['losses'][key[7:]]), rel=1e-4), key
  for key in ('mses', 'psnrs', 'normal_maes'):
    np.testing.assert_allclose(got['stats'][key].numpy(),
                               want['stats'][key], rtol=1e-4, err_msg=key)
  assert got['stats']['normal_maes'].shape == (2,)


def test_refnerf_step_gradients_and_updates_match_jax(refnerf_steps):
  got, want, want_nudged = refnerf_steps
  assert set(got['grads']) == set(want['grads'])
  _assert_within_gaps(got['grads'], want['grads'], want_nudged['grads'],
                      'gradient')
  _assert_within_gaps(got['updates'], want['updates'],
                      want_nudged['updates'], 'update')
  # Both sides are f32: every gradient leaf is within 2e-4 relative L2 of
  # JAX's (1.7e-5 measured).  Without the double backward (the density
  # gradient's own gradient, through which the predicted-normal loss
  # reaches the trunk) the trunk's leaves would move by up to 7.6e-3.
  for name, w in want['grads'].items():
    w = np.asarray(w, np.float64)
    gap = np.linalg.norm(got['grads'][name].numpy() - w) / np.linalg.norm(w)
    assert gap <= 2e-4, (name, gap)


def test_stop_level_grad_false_gradients_match_jax(monkeypatch):
  # The JAX Model marks its MLPs' inputs as differentiable with
  # ``mlp.clone(inputs_have_stop_gradient=False)`` inside its compact
  # __call__ (nerf.py:95-105); the clone has no parent, and calling it
  # raises flax's CallCompactUnboundModuleError, so the JAX package cannot
  # run stop_level_grad=False as it stands.  Here gin binds the same field
  # on the MLPs, and that clone returns the (bound) MLP itself: the model
  # nerf.py:95-105 means to build.
  clone = flax_nn.Module.clone

  def bound_clone(self, **updates):
    if updates == {'inputs_have_stop_gradient': False}:
      assert self.inputs_have_stop_gradient is False
      return self
    return clone(self, **updates)

  monkeypatch.setattr(flax_nn.Module, 'clone', bound_clone)
  jax_config, torch_config = tp.configs(tp.SMALL_BINDINGS + (
      "Config.dataset_loader = 'dummy_unbounded'", 'Config.batch_size = 16',
      'Config.randomized = False', 'Model.stop_level_grad = False',
      'NerfMLP.inputs_have_stop_gradient = False',
      'PropMLP.inputs_have_stop_gradient = False'))
  params = tp.jax_params(jax_config, seed=2)
  host = next(datasets.load_dataset('train', None, torch_config, seed=4))
  batch = train_lib.batch_to_device(host, 'cpu')
  want, want_nudged = _jax_steps(jax_config, params, batch)
  model = nerf.construct_model(torch_config,
                               torch.Generator().manual_seed(0), 'cpu')
  bridge.load_jax_params(model, params)
  assert not model.NerfMLP_0.fused and not model.PropMLP_0.fused
  loss, _, _, grads = train_lib.loss_and_grads(model, torch_config, batch,
                                               TRAIN_FRAC)
  assert float(loss) == pytest.approx(float(want['stats']['loss']), rel=1e-4)
  _assert_within_gaps(grads, want['grads'], want_nudged['grads'], 'gradient')
  # Gradients cross the levels: the PropMLP now also learns from the data
  # loss through the NerfMLP's sample positions, which stop_level_grad cuts.
  stopped = nerf.construct_model(
      tp.configs(tp.SMALL_BINDINGS + (
          "Config.dataset_loader = 'dummy_unbounded'",
          'Config.randomized = False',
          'NerfMLP.use_fused_featurize = False',
          'PropMLP.use_fused_featurize = False'))[1],
      torch.Generator().manual_seed(0), 'cpu')
  bridge.load_jax_params(stopped, params)
  stopped_grads = train_lib.loss_and_grads(stopped, torch_config, batch,
                                           TRAIN_FRAC)[3]
  name = 'PropMLP_0/Dense_0/kernel'
  gap = train_lib.leaf_gaps({name: stopped_grads[name]},
                            {name: want['grads'][name]},
                            {name: want_nudged['grads'][name]})[name]
  assert gap[0] > gap[2], gap


def test_render_fn_keeps_inference_mode_unless_normals_need_gradients():
  # 360: the render runs under inference_mode, as before.
  _, config = tp.configs(tp.SMALL_BINDINGS)
  model = nerf.construct_model(config, torch.Generator().manual_seed(0),
                               'cpu')
  assert not train_lib.needs_gradients(model)
  rays = tp.torch_rays(tp.rays(4))
  renderings, _ = train_lib.create_render_fn(model)(1.0, rays)
  assert renderings[-1]['rgb'].is_inference()
  # Ref-NeRF: no_grad, with gradients on only around the density gradient;
  # nothing it returns holds a graph.
  _, config = _refnerf_configs()
  model = nerf.construct_model(config, torch.Generator().manual_seed(0),
                               'cpu')
  assert train_lib.needs_gradients(model)
  renderings, history = train_lib.create_render_fn(model)(
      1.0, tp.torch_rays(tp.rays(4, near=2.0, far=6.0)))
  for key in ('rgb', 'normals', 'normals_pred', 'roughness'):
    out = renderings[-1][key]
    assert not out.is_inference() and not out.requires_grad, key
    assert torch.isfinite(out).all(), key
  assert not history[-1]['raw_grad_density'].requires_grad
