"""GLO (configs/360_glo4.gin) and the synthetic scenes in the port against
the JAX package, and the bridge of the two embedding tables.

- ``dummy`` and ``dummy_sphere``, both splits, with their disparity and
  normal targets: bitwise (the same numpy).
- The Model's forward with 4 GLO features on bridged weights, in training
  (each ray's ``cam_idx`` row, ``zero_glo=False``) and at eval (zero
  vectors): the bounds of tests/test_torch_model.py (3e-3 for colors and
  weights, 2e-3 for the sampled distances).
- One 360_glo4.gin train step at test widths by ``train_lib.leaf_gaps``
  (the GLO table's gradient included; the cap 0.15, as JAX's own step is
  that sensitive here, see the test), its data loss within 1e-3.
- The bridge: a JAX-initialised llff_raw and 360_glo4 tree (the
  ``exposure_scaling_offsets`` and ``Embed_0`` tables) lands in the port
  and comes back bitwise, and Adam's moments come out under optax's names,
  within 1e-6 of optax's after the same update.
- The train driver refuses more train images than GLO embeddings.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), 'helpers'))
import torch_parity as tp  # noqa: E402

from multinerf_tpu import ginlite as jax_gin  # noqa: E402
from multinerf_tpu import train_lib as jtrain_lib  # noqa: E402
from multinerf_tpu.data import datasets as jdatasets  # noqa: E402
from multinerf_tpu.data import types as jtypes  # noqa: E402
from multinerf_tpu.models import nerf as jnerf  # noqa: E402
from multinerf_tpu.parallel import mesh as mesh_lib  # noqa: E402
from multinerf_tpu_torch import bridge  # noqa: E402
from multinerf_tpu_torch import train  # noqa: E402
from multinerf_tpu_torch import train_lib  # noqa: E402
from multinerf_tpu_torch.data import datasets  # noqa: E402
from multinerf_tpu_torch.models import nerf  # noqa: E402

GLO4 = os.path.join(tp.REPO, 'configs', '360_glo4.gin')
LLFF_RAW = os.path.join(tp.REPO, 'configs', 'llff_raw.gin')
BINDINGS = tp.SMALL_BINDINGS + tp.FUSED_BINDINGS + (
    "Config.dataset_loader = 'dummy_unbounded'",)


@pytest.mark.parametrize('loader', ['dummy', 'dummy_sphere'])
@pytest.mark.parametrize('split', ['train', 'test'])
def test_synthetic_scene_matches_jax(loader, split):
  jax_config, config = tp.configs((
      f"Config.dataset_loader = '{loader}'", 'Config.compute_disp_metrics = '
      'True', 'Config.compute_normal_metrics = True'))
  want = jdatasets.load_dataset(split, None, jax_config)
  with datasets.load_dataset(split, None, config) as got:
    assert got.size == want.size
    for key in ('images', 'camtoworlds', 'pixtocams', 'disp_images',
                'normal_images', 'alphas'):
      g, w = getattr(got, key), getattr(want, key)
      assert g.dtype == w.dtype, key
      np.testing.assert_array_equal(g, w, err_msg=key)
    got_rays = got.generate_ray_batch(1).rays
    want_rays = want.generate_ray_batch(1).rays
    for key in ('origins', 'directions', 'radii', 'cam_idx'):
      np.testing.assert_array_equal(getattr(got_rays, key),
                                    getattr(want_rays, key), err_msg=key)


@pytest.fixture(scope='module')
def glo_pair():
  """(JAX config, port config, JAX params, JAX Model, port Model on the
  same weights) of 360_glo4.gin at test widths, 64-ray steps."""
  jax_config, config = tp.configs(BINDINGS + (
      'Config.batch_size = 64', 'Config.randomized = False'), files=(GLO4,))
  params = tp.jax_params(jax_config, seed=3)
  assert params['Embed_0']['embedding'].shape == (1000, 4)
  jmodel = jax_gin.make('Model', config=jax_config)
  model = nerf.construct_model(config, torch.Generator().manual_seed(0),
                               'cpu')
  bridge.load_jax_params(model, params)
  return jax_config, config, params, jmodel, model


@pytest.mark.parametrize('zero_glo', [False, True])
def test_model_with_glo_matches_jax(glo_pair, zero_glo):
  _, _, params, jmodel, model = glo_pair
  fields = tp.rays(24, seed=4)
  fields['cam_idx'] = np.random.RandomState(5).randint(
      0, 48, (24, 1)).astype(np.int32)
  want_r, want_h = jax.jit(lambda p, r: jmodel.apply(
      {'params': p}, None, r, train_frac=1.0, compute_extras=False,
      zero_glo=zero_glo))(params, tp.jax_rays(fields))
  with torch.inference_mode():
    got_r, got_h = model(tp.torch_rays(fields), 1.0, False,
                         zero_glo=zero_glo)
  for level, (g, w) in enumerate(zip(got_h, want_h)):
    tp.assert_close(g['sdist'].numpy(), w['sdist'], atol=2e-3,
                    what=f'level {level} sdist')
    tp.assert_close(g['weights'].numpy(), w['weights'], atol=3e-3,
                    what=f'level {level} weights')
  tp.assert_close(got_r[-1]['rgb'].numpy(), want_r[-1]['rgb'], atol=3e-3,
                  what='rgb')
  # The GLO vectors reach the colors only in training.
  with torch.inference_mode():
    moved = model.Embed_0.embedding.clone()
    model.Embed_0.embedding.add_(1.0)
    again = model(tp.torch_rays(fields), 1.0, False, zero_glo=zero_glo)[0]
    model.Embed_0.embedding.copy_(moved)
  assert torch.equal(again[-1]['rgb'], got_r[-1]['rgb']) == zero_glo


def _jax_batch(batch):
  return jtypes.Batch(
      rays=jtypes.Rays(**{k: jnp.asarray(v.numpy()) for k, v in
                          vars(batch.rays).items() if v is not None}),
      rgb=jnp.asarray(batch.rgb.numpy()))


def test_train_step_matches_jax(glo_pair):
  jax_config, config, params, jmodel, _ = glo_pair
  with datasets.load_dataset('train', None, config, seed=3) as dataset:
    batch = train_lib.batch_to_device(next(dataset), 'cpu')
  jstate, _ = jtrain_lib.create_optimizer(jax_config, {'params': params})
  step = jtrain_lib.create_train_step(jmodel, jax_config,
                                      mesh_lib.create_mesh(), jit=False)
  clip = jtrain_lib.clip_gradients

  def run(state, b):
    captured = {}

    def recording_clip(grad, cfg):
      captured['grad'] = grad['params']
      return clip(grad, cfg)

    jtrain_lib.clip_gradients = recording_clip
    try:
      _, stats, _ = step(jax.random.PRNGKey(0), state, b, 0.5, 1.0)
    finally:
      jtrain_lib.clip_gradients = clip
    return stats, captured['grad']

  run = jax.jit(run)
  want = [jax.device_get(run(jstate, _jax_batch(b)))
          for b in (batch, train_lib.nudge_origins(batch))]
  model, _, _, _, _ = train_lib.setup_model(config, 0, 'cpu')
  bridge.load_jax_params(model, params)
  _, losses, _, grads = train_lib.loss_and_grads(model, config, batch, 0.5)
  want_data = float(want[0][0]['losses']['data'])
  assert abs(float(losses['data']) - want_data) <= 1e-3 * abs(want_data)
  assert float(grads['Embed_0/embedding'].abs().sum()) > 0
  # On these weights JAX's own step moves NerfMLP_0/Dense_0/kernel by
  # 0.102 under the nudge, over the 0.1 cap of the test widths; such a
  # step takes the cap chip_smoke.py gives full-width steps, where the
  # reference is that sensitive too (TRAIN_GAP_CAP, 0.15).
  gaps = train_lib.leaf_gaps({k: v.numpy() for k, v in grads.items()},
                             bridge.flatten(want[0][1]),
                             bridge.flatten(want[1][1]), cap=0.15)
  assert len(gaps) == len(grads) and 'Embed_0/embedding' in gaps
  for name, (gap, sens, bound) in gaps.items():
    assert gap <= bound, (f'{name}: relative L2 error {gap:.3e} > '
                          f'{bound:.3e} (JAX moved {sens:.3e})')


@pytest.mark.parametrize('gin,table', [
    (LLFF_RAW, 'exposure_scaling_offsets/embedding'),
    (GLO4, 'Embed_0/embedding')], ids=['llff_raw', '360_glo4'])
def test_bridge_round_trip_with_adam(gin, table):
  jax_config, config = tp.configs(tp.SMALL_BINDINGS, files=(gin,))
  dummy = jtypes.dummy_rays(include_exposure_idx=jax_config.rawnerf_mode,
                            include_exposure_values=True)
  params = jax.device_get(jax.jit(lambda k: jnerf.construct_model(
      k, dummy, jax_config)[1]['params'])(jax.random.PRNGKey(1)))
  flat = bridge.flatten(params)
  assert table in flat
  model, state, _, _, _ = train_lib.setup_model(config, 0, 'cpu')
  named = bridge.named_parameters(model)
  assert sorted(named) == sorted(flat)
  bridge.load_jax_params(model, params)
  back = bridge.flatten(bridge.jax_params(model))
  for name, want in flat.items():
    assert back[name].dtype == np.asarray(want).dtype, name
    np.testing.assert_array_equal(back[name], want, err_msg=name)

  # One update from the same gradients on both sides.
  rng = np.random.RandomState(2)
  grads = {k: (1e-3 * rng.randn(*np.shape(v))).astype(np.float32)
           for k, v in flat.items()}
  tx = optax.adam(1e-3, b1=config.adam_beta1, b2=config.adam_beta2,
                  eps=config.adam_eps)
  opt_state = tx.init(params)
  _, opt_state = tx.update(bridge.unflatten(grads), opt_state, params)
  for k, v in grads.items():
    named[k].grad = torch.tensor(v)
  state.optimizer.step()
  moments = bridge.adam_moments(named, state.optimizer)
  for key in ('mu', 'nu'):
    want = bridge.flatten(getattr(opt_state[0], key))
    got = bridge.flatten(moments[key])
    assert sorted(got) == sorted(want), key
    for k, v in want.items():
      tp.assert_close(got[k], v, atol=0, rtol=1e-6, what=f'{key} {k}')


def test_driver_refuses_more_images_than_embeddings(tmp_path):
  with pytest.raises(ValueError, match='glo embeddings 4'):
    train.main(['--device=cpu', f'--gin_configs={GLO4}'] + [
        f'--gin_bindings={b}' for b in BINDINGS + (
            'Model.num_glo_embeddings = 4',
            f"Config.checkpoint_dir = '{tmp_path}'")])
