"""RobustNeRF in the port against the JAX package: the mask
(multinerf_tpu_torch/robust.py) on the cases of tests/test_robust.py and
on random patches, the ``dummy_distractor`` scene bitwise, one
configs/360_robustnerf.gin train step at test widths by
``train_lib.leaf_gaps``, and the train driver feeding the threshold back.

Bounds: the mask is 0 or 1 per pixel and must agree exactly; its shares
within 1e-6 (means of 0/1 values over at most 4,096 pixels); the loss
threshold, a quantile of the same f32 errors, within 1e-6 relative (jnp
and torch interpolate between the two order statistics with different
formulas: one ulp apart measured).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), 'helpers'))
import torch_parity as tp  # noqa: E402

from multinerf_tpu import configs as jconfigs  # noqa: E402
from multinerf_tpu import ginlite as jax_gin  # noqa: E402
from multinerf_tpu import robust as jrobust  # noqa: E402
from multinerf_tpu import train_lib as jtrain_lib  # noqa: E402
from multinerf_tpu.data import datasets as jdatasets  # noqa: E402
from multinerf_tpu.data import types as jtypes  # noqa: E402
from multinerf_tpu.parallel import mesh as mesh_lib  # noqa: E402
from multinerf_tpu_torch import bridge  # noqa: E402
from multinerf_tpu_torch import configs  # noqa: E402
from multinerf_tpu_torch import robust  # noqa: E402
from multinerf_tpu_torch import train  # noqa: E402
from multinerf_tpu_torch import train_lib  # noqa: E402
from multinerf_tpu_torch.data import datasets  # noqa: E402

CONFIG = os.path.join(tp.REPO, 'configs', '360_robustnerf.gin')
STATS = ('loss_threshold', 'is_inlier_loss', 'has_inlier_neighbors',
         'is_inlier_patch', 'mask')


def _settings(**kw):
  base = dict(patch_size=16, enable_robustnerf_loss=True,
              robustnerf_inlier_quantile=0.5,
              robustnerf_inner_patch_size=8,
              robustnerf_smoothed_filter_size=3,
              robustnerf_smoothed_inlier_quantile=0.5,
              robustnerf_inner_patch_inlier_quantile=0.5)
  base.update(kw)
  return jconfigs.Config(**base), configs.Config(**base)


def _cases():
  """The errors of tests/test_robust.py's cases, then random ones."""
  rng = np.random.RandomState(0)
  outlier_patch = rng.rand(4, 16, 16, 3).astype(np.float32) * 0.01
  outlier_patch[0] += 10.0
  isolated = np.full((1, 16, 16, 3), 0.001, np.float32)
  isolated[0, 8, 8] = 5.0
  rand = np.random.RandomState(1).rand(16, 16, 16, 3).astype(np.float32)**4
  return {
      'disabled': (np.full((4, 16, 16, 3), 0.5, np.float32), 1.0,
                   dict(enable_robustnerf_loss=False)),
      'outlier_patch': (outlier_patch, 0.05, {}),
      'isolated_pixel': (isolated, 0.05, {}),
      'stats': (np.full((2, 16, 16, 3), 0.01, np.float32), 0.05, {}),
      'random': (rand, 0.1, dict(robustnerf_inlier_quantile=0.8)),
      'random_filter_5': (rand, 0.2, dict(robustnerf_smoothed_filter_size=5,
                                          robustnerf_inner_patch_size=12)),
  }


@pytest.mark.parametrize('case', list(_cases()))
def test_mask_matches_jax(case):
  errors, threshold, kw = _cases()[case]
  jconfig, config = _settings(**kw)
  want_mask, want_stats = jrobust.robustnerf_mask(jnp.asarray(errors),
                                                  threshold, jconfig)
  got_mask, got_stats = robust.robustnerf_mask(
      torch.as_tensor(errors), torch.tensor(threshold), config)
  np.testing.assert_array_equal(
      np.broadcast_to(got_mask.numpy(), errors.shape[:3] + (1,)),
      np.broadcast_to(np.asarray(want_mask), errors.shape[:3] + (1,)))
  assert sorted(got_stats) == sorted(want_stats)
  for k in want_stats:
    tp.assert_close(got_stats[k].numpy(), want_stats[k],
                    atol=0 if k == 'loss_threshold' else 1e-6,
                    rtol=1e-6 if k == 'loss_threshold' else 0, what=k)
  if case == 'outlier_patch':
    assert got_mask[0].mean() < 0.05 and got_mask[1:].mean() > 0.95
  if case == 'isolated_pixel':
    assert got_mask[0, 8, 8, 0] == 1.0


def test_inner_patch_larger_than_the_patch_raises():
  _, config = _settings(robustnerf_inner_patch_size=20)
  with pytest.raises(ValueError, match='patch_size'):
    robust.robustnerf_mask(torch.ones(1, 16, 16, 3), 1.0, config)


@pytest.mark.parametrize('split', ['train', 'test'])
def test_dummy_distractor_matches_jax(split):
  jax_config, config = tp.configs(("Config.dataset_loader = "
                                   "'dummy_distractor'",))
  want = jdatasets.load_dataset(split, None, jax_config)
  with datasets.load_dataset(split, None, config) as got:
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.camtoworlds, want.camtoworlds)
    np.testing.assert_array_equal(got.pixtocams, want.pixtocams)
    assert hasattr(got, 'distractor_masks') == (split == 'train')
    if split == 'train':
      np.testing.assert_array_equal(got.distractor_masks,
                                    want.distractor_masks)
      assert 0.1 < got.distractor_masks.mean() < 0.2


# The config cut to test size: patches of 8 x 8 (inner patch 4) so that a
# 256-ray batch holds 4 patches.
STEP_BINDINGS = tp.SMALL_BINDINGS + tp.FUSED_BINDINGS + (
    "Config.dataset_loader = 'dummy_distractor'", 'Config.batch_size = 256',
    'Config.patch_size = 8', 'Config.robustnerf_inner_patch_size = 4',
    'Config.randomized = False', 'NerfMLP.net_width = 64')


def _jax_batch(batch):
  return jtypes.Batch(
      rays=jtypes.Rays(**{k: jnp.asarray(v.numpy()) for k, v in
                          vars(batch.rays).items() if v is not None}),
      rgb=jnp.asarray(batch.rgb.numpy()))


def test_train_step_matches_jax():
  jax_config, config = tp.configs(STEP_BINDINGS, files=(CONFIG,))
  assert config.data_loss_type == 'robustnerf' and config.patch_size == 8
  params = tp.jax_params(jax_config, seed=7)
  with datasets.load_dataset('train', None, config, seed=3) as dataset:
    batch = train_lib.batch_to_device(next(dataset), 'cpu')
  assert batch.rgb.shape == (4, 8, 8, 3)
  jmodel = jax_gin.make('Model', config=jax_config)
  jstate, _ = jtrain_lib.create_optimizer(jax_config, {'params': params})
  step = jtrain_lib.create_train_step(jmodel, jax_config,
                                      mesh_lib.create_mesh(), jit=False)
  clip = jtrain_lib.clip_gradients
  threshold = 0.05

  def run(state, b):
    captured = {}

    def recording_clip(grad, cfg):
      captured['grad'] = grad['params']
      return clip(grad, cfg)

    jtrain_lib.clip_gradients = recording_clip
    try:
      _, stats, _ = step(jax.random.PRNGKey(0), state, b, 0.5, threshold)
    finally:
      jtrain_lib.clip_gradients = clip
    return stats, captured['grad']

  run = jax.jit(run)
  want = [jax.device_get(run(jstate, _jax_batch(b)))
          for b in (batch, train_lib.nudge_origins(batch))]
  model, _, _, _, _ = train_lib.setup_model(config, 0, 'cpu')
  bridge.load_jax_params(model, params)
  _, losses, stats, grads = train_lib.loss_and_grads(
      model, config, batch, 0.5, loss_threshold=torch.tensor(threshold))
  want_data = float(want[0][0]['losses']['data'])
  assert abs(float(losses['data']) - want_data) <= 1e-3 * abs(want_data)
  # The mask's shares: the errors are the two frameworks' renders, so a
  # pixel near the threshold may vote the other way; 1 of the 256 pixels.
  for k in STATS:
    tp.assert_close(float(stats[k]), float(want[0][0][k]),
                    atol=1e-3 if k == 'loss_threshold' else 1 / 256, what=k)
  gaps = train_lib.leaf_gaps({k: v.numpy() for k, v in grads.items()},
                             bridge.flatten(want[0][1]),
                             bridge.flatten(want[1][1]))
  assert len(gaps) == len(grads)
  for name, (gap, sens, bound) in gaps.items():
    assert gap <= bound, (f'{name}: relative L2 error {gap:.3e} > '
                          f'{bound:.3e} (JAX moved {sens:.3e})')


def test_driver_feeds_the_threshold_back(tmp_path, monkeypatch):
  seen = []
  create = train_lib.create_train_step

  def recording(*args, **kwargs):
    step_fn = create(*args, **kwargs)

    def step(*step_args):
      seen.append(step_args[5])
      return step_fn(*step_args)
    return step

  monkeypatch.setattr(train_lib, 'create_train_step', recording)
  out = train.main(['--device=cpu', f'--gin_configs={CONFIG}'] + [
      f'--gin_bindings={b}' for b in STEP_BINDINGS + (
          'Config.max_steps = 3', 'Config.randomized = True',
          f"Config.checkpoint_dir = '{tmp_path}'")])
  assert len(out['losses']) == 3 and np.isfinite(out['losses']).all()
  assert seen[0] == 1.0
  # Each later step takes the previous step's inlier quantile, a tensor.
  assert all(torch.is_tensor(t) and t.dim() == 0 for t in seen[1:])
  assert 0 < float(seen[-1]) < 1
  assert 0 <= out['stats']['is_inlier_loss'] <= 1
