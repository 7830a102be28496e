"""The port's entry points on ``configs/blender_refnerf.gin`` at test size
(the NerfMLP of tests/test_torch_refnerf.py, ``dummy_specular``): eval's
normal metrics against JAX eval.py's ``evaluate_checkpoint`` on identical
weights, render's ``normals`` frames, and the train driver's
``test_true_normals`` summary.

Bounds: both packages render this path as f32 products (no fused kernel
runs with density normals), so the per-view PSNR and SSIM agree to 1e-3 dB
and 1e-4 (the eval bounds of tests/test_torch_eval.py are 1e-2 and 5e-3
for the bf16 kernels), and a normal MAE, a weighted mean of angles in
degrees, to 1e-2 degrees.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

sys.path.insert(0, os.path.join(os.path.dirname(__file__), 'helpers'))
import torch_parity as tp  # noqa: E402

import eval as jeval  # noqa: E402
from multinerf_tpu import train_lib as jtrain_lib  # noqa: E402
from multinerf_tpu.data import datasets as jdatasets  # noqa: E402
from multinerf_tpu.models import nerf as jnerf  # noqa: E402
from multinerf_tpu.ops import image_ops as jimage_ops  # noqa: E402
from multinerf_tpu.parallel import mesh as mesh_lib  # noqa: E402
from multinerf_tpu_torch import bridge  # noqa: E402
from multinerf_tpu_torch import eval as eval_lib  # noqa: E402
from multinerf_tpu_torch import render  # noqa: E402
from multinerf_tpu_torch import train  # noqa: E402
from multinerf_tpu_torch.utils import checkpoints  # noqa: E402
from multinerf_tpu_torch.utils import summary  # noqa: E402

CONFIG_REFNERF = os.path.join(tp.REPO, 'configs', 'blender_refnerf.gin')
STEP = 5
VIEWS = 2
SMALL_REFNERF = (
    "Config.dataset_loader = 'dummy_specular'",
    'NerfMLP.net_depth = 4',
    'NerfMLP.net_width = 32',
    'NerfMLP.net_depth_viewdirs = 2',
    'NerfMLP.net_width_viewdirs = 16',
    'NerfMLP.bottleneck_width = 16',
    'Model.num_prop_samples = 16',
    'Model.num_nerf_samples = 16',
    'Config.max_steps = 10',
)


def _argv(bindings):
  return ['--device=cpu', f'--gin_configs={CONFIG_REFNERF}'] + [
      f'--gin_bindings={b}' for b in SMALL_REFNERF + tuple(bindings)]


def _save_jax_weights(jax_config, ckpt_dir, seed):
  params = tp.jax_params(jax_config, seed=seed)
  flat = {k: torch.tensor(np.asarray(v))
          for k, v in bridge.flatten(params).items()}
  checkpoints.CheckpointManager(ckpt_dir).save(
      STEP, checkpoints.TrainState(step=STEP, params=flat))
  return params


def _read(out_dir, name):
  with open(os.path.join(out_dir, name)) as f:
    return np.array([float(v) for v in f.read().split()])


def test_eval_normal_metrics_match_jax_eval(tmp_path):
  port_dir = str(tmp_path / 'port')
  bindings = (f'Config.eval_dataset_limit = {VIEWS}',
              f"Config.checkpoint_dir = '{port_dir}'")
  jax_config, _ = tp.configs(SMALL_REFNERF + bindings,
                             files=(CONFIG_REFNERF,))
  assert jax_config.compute_normal_metrics
  params = _save_jax_weights(jax_config, port_dir, seed=3)
  out = eval_lib.main(_argv(bindings))

  mesh = mesh_lib.create_mesh()
  _, state, render_pfn, _, _ = jtrain_lib.setup_model(
      jax_config, jax.random.PRNGKey(0), mesh=mesh)
  state = state.replace(params={'params': params}, step=STEP)
  dataset = jdatasets.load_dataset('test', None, jax_config)
  renderer = jnerf.DeviceImageRenderer(render_pfn, jax_config, dataset,
                                       mesh=mesh)
  postprocess_fn, cc_fn = jeval.make_postprocess_fns(jax_config, dataset)
  jax_dir = str(tmp_path / 'jax_preds')
  os.makedirs(jax_dir)
  jeval.evaluate_checkpoint(state, STEP, renderer, dataset, jax_config,
                            jax_dir, None, postprocess_fn, cc_fn,
                            jimage_ops.MetricHarness(),
                            device_cast=renderer.supports())

  got_names = set(os.listdir(out['out_dir']))
  assert got_names == set(os.listdir(jax_dir))
  for name in (f'metric_normals_mae_{STEP}.txt',
               f'metric_normals_pred_mae_{STEP}.txt', 'normals_000.png'):
    assert name in got_names, name
  for name, tol in (('psnr', 1e-3), ('ssim', 1e-4), ('normals_mae', 1e-2),
                    ('normals_pred_mae', 1e-2)):
    fname = f'metric_{name}_{STEP}.txt'
    got, want = _read(out['out_dir'], fname), _read(jax_dir, fname)
    assert got.shape == want.shape == (VIEWS,)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=name)
  normals = np.asarray(Image.open(os.path.join(out['out_dir'],
                                               'normals_000.png')))
  want = np.asarray(Image.open(os.path.join(jax_dir, 'normals_000.png')))
  assert normals.shape == (48, 48, 3)
  # A density normal is a gradient through ReLUs: where a rounding gap
  # flips one unit of one sample, its normal jumps (0.25 measured, at one
  # sample of 16 on a ray), and the ray's composited normal by ~1e-2.
  # Elsewhere the images agree to the u8 rounding.
  off = np.abs(normals.astype(int) - want.astype(int)).max(-1) > 1
  assert off.mean() <= 0.01, off.sum()


def test_render_writes_normals_frames(tmp_path):
  bindings = (f"Config.checkpoint_dir = '{tmp_path}/ckpt'",
              f"Config.render_dir = '{tmp_path}/render'",
              'Config.render_num_jobs = 16')  # One frame: test view 0.
  jax_config, _ = tp.configs(SMALL_REFNERF + bindings,
                             files=(CONFIG_REFNERF,))
  _save_jax_weights(jax_config, f'{tmp_path}/ckpt', seed=4)
  out = render.main(_argv(bindings))
  assert out['frames'] == [0]
  names = sorted(os.listdir(out['out_dir']))
  assert names == ['acc_000.tiff', 'color_000.png', 'distance_mean_000.tiff',
                   'distance_median_000.tiff', 'normals_000.png']
  normals = np.asarray(Image.open(os.path.join(out['out_dir'],
                                               'normals_000.png')))
  assert normals.shape == (48, 48, 3) and normals.dtype == np.uint8
  # As render.py:87-89 writes them: the rendered normals mapped to [0, 1].
  want = out['renderings'][0]['normals'] / 2 + 0.5
  want_u8 = (np.clip(want, 0, 1) * 255).astype(np.uint8)
  np.testing.assert_array_equal(normals, want_u8)


def test_train_driver_logs_true_normals(tmp_path):
  ckpt_dir = str(tmp_path)
  out = train.main(_argv(('Config.batch_size = 16', 'Config.max_steps = 2',
                          'Config.early_exit_steps = 1',
                          'Config.train_render_every = 1',
                          f"Config.checkpoint_dir = '{ckpt_dir}'")))
  assert len(out['losses']) == 1 and np.isfinite(out['losses']).all()
  assert {'losses/orientation', 'losses/predicted_normals',
          'normal_maes'} <= set(out['stats'])
  events = summary.read_events(ckpt_dir)
  tags = {e['tag'] for e in events}
  assert {'test_true_normals', 'test_true_color', 'test_output_normals',
          'train_avg_normal_maes/1', 'train_avg_losses/orientation'} <= tags
  image = [e for e in events if e['tag'] == 'test_true_normals'][0]
  assert image['kind'] == 'image' and image['step'] == 1


def test_eval_summaries_show_the_true_normals(tmp_path):
  ckpt_dir = str(tmp_path)
  bindings = (f"Config.checkpoint_dir = '{ckpt_dir}'",
              'Config.eval_only_once = False', 'Config.max_steps = 5',
              'Config.num_showcase_images = 1',
              'Config.eval_dataset_limit = 1')
  jax_config, _ = tp.configs(SMALL_REFNERF + bindings,
                             files=(CONFIG_REFNERF,))
  _save_jax_weights(jax_config, ckpt_dir, seed=5)
  out = eval_lib.main(_argv(bindings))
  assert list(out) == ['out_dir', STEP]
  tags = {e['tag'] for e in summary.read_events(
      os.path.join(ckpt_dir, 'eval'))}
  assert {'true_normals_0', 'output_normals_0', 'true_color_0',
          'eval_metrics/normals_mae', 'eval_metrics/normals_pred_mae'} <= tags
