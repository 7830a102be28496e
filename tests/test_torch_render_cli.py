"""The port's render entry point, its image files, and its import hygiene.

``python -m multinerf_tpu_torch.render --device=cpu`` runs in a subprocess
at the small test widths; the package is also imported in a subprocess in
which ``import jax`` fails.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

sys.path.insert(0, os.path.join(os.path.dirname(__file__), 'helpers'))
import torch_parity as tp  # noqa: E402

from multinerf_tpu_torch import bridge  # noqa: E402
from multinerf_tpu_torch import render  # noqa: E402
from multinerf_tpu_torch import train_lib  # noqa: E402
from multinerf_tpu_torch.data import datasets  # noqa: E402
from multinerf_tpu_torch.models import nerf  # noqa: E402
from multinerf_tpu_torch.utils import checkpoints  # noqa: E402
from multinerf_tpu_torch.utils import io as io_lib  # noqa: E402

_ENV = dict(os.environ, OMP_NUM_THREADS='1', CUDA_VISIBLE_DEVICES='')


def _bindings(tmp_path):
  return tp.SMALL_BINDINGS + (
      "Config.dataset_loader = 'dummy_unbounded'",
      f"Config.checkpoint_dir = '{tmp_path}/ckpt'",
      f"Config.render_dir = '{tmp_path}/render'",
      'Config.render_num_jobs = 48',  # One frame: test view 0.
  )


def test_cli_restores_the_latest_checkpoint_and_writes_jax_file_names(
    tmp_path):
  bindings = _bindings(tmp_path)
  jax_config, torch_config = tp.configs(bindings)
  # A checkpoint of JAX-initialized weights, written through the bridge.
  params = tp.jax_params(jax_config, seed=5)
  flat = {k: torch.tensor(np.asarray(v))
          for k, v in bridge.flatten(params).items()}
  checkpoints.CheckpointManager(f'{tmp_path}/ckpt').save(
      7, checkpoints.TrainState(step=7, params=flat))

  cmd = [sys.executable, '-m', 'multinerf_tpu_torch.render', '--device=cpu',
         f'--gin_configs={tp.CONFIG_360}']
  cmd += [f'--gin_bindings={b}' for b in bindings]
  proc = subprocess.run(cmd, cwd=tp.REPO, env=_ENV, capture_output=True,
                        text=True, timeout=300, check=False)
  assert proc.returncode == 0, proc.stderr[-3000:]
  assert 'Rendering checkpoint at step 7.' in proc.stdout

  out_dir = tmp_path / 'render' / 'test_preds_step_7'
  assert sorted(os.listdir(out_dir)) == [
      'acc_000.tiff', 'color_000.png', 'distance_mean_000.tiff',
      'distance_median_000.tiff']
  color = np.asarray(Image.open(out_dir / 'color_000.png'))
  assert color.shape == (64, 64, 3) and color.dtype == np.uint8
  for tag in ('acc', 'distance_mean', 'distance_median'):
    img = Image.open(out_dir / f'{tag}_000.tiff')
    assert img.mode == 'F' and img.size == (64, 64)
    assert np.isfinite(np.asarray(img)).all()

  # The frame is the checkpoint's model: render it here and compare.
  model = nerf.construct_model(torch_config,
                               torch.Generator().manual_seed(0), 'cpu')
  bridge.load_jax_params(model, params)
  renderer = nerf.DeviceImageRenderer(
      train_lib.create_render_fn(model), torch_config,
      datasets.load_dataset('test', None, torch_config), 'cpu')
  want = renderer(1.0, 0)
  want_u8 = (np.clip(want['rgb'], 0, 1) * 255).astype(np.uint8)
  assert np.abs(color.astype(int) - want_u8).max() <= 1
  np.testing.assert_allclose(
      np.asarray(Image.open(out_dir / 'acc_000.tiff')), want['acc'],
      atol=1e-6)


def test_render_refuses_cuda_without_a_gpu(tmp_path):
  if torch.cuda.is_available():
    pytest.skip('a GPU is present: nothing to refuse.')
  with pytest.raises(RuntimeError, match='CUDA is not available'):
    render.main(['--device=cuda', f'--gin_configs={tp.CONFIG_360}'] +
                [f'--gin_bindings={b}' for b in _bindings(tmp_path)])


def test_frame_store_names_and_job_striping(tmp_path):
  store = render.FrameStore(str(tmp_path), 48, use_async=False)
  assert store.frame_name('color', 5).endswith('color_005.png')
  assert store.frame_name('distance_mean', 16).endswith(
      'distance_mean_016.tiff')

  class Cfg:
    render_job_id = 1
    render_num_jobs = 16
  assert list(render.plan_frames(Cfg, store, 48)) == [1, 17, 33]
  # Resume: a frame is skipped only once its successor in the stripe
  # exists, so the last written frame is rendered again.
  for idx in (1, 17):
    open(store.frame_name('color', idx), 'wb').close()
  assert list(render.plan_frames(Cfg, store, 48)) == [17, 33]


def test_png_and_tiff_writers_read_back_exactly(tmp_path):
  rng = np.random.RandomState(0)
  rgb = rng.rand(5, 7, 3).astype(np.float32)
  io_lib.save_img_u8(rgb, str(tmp_path / 'a.png'))
  np.testing.assert_array_equal(
      np.asarray(Image.open(tmp_path / 'a.png')),
      (np.clip(rgb, 0, 1) * 255).astype(np.uint8))
  gray = (rng.rand(6, 4) * 255).astype(np.uint8)
  io_lib.write_png(str(tmp_path / 'g.png'), gray)
  np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / 'g.png')),
                                gray)
  depth = (rng.rand(5, 7) * 1e6).astype(np.float32)
  depth[0, 0] = np.nan  # Written as 0, like the JAX writer.
  io_lib.save_img_f32(depth, str(tmp_path / 'd.tiff'))
  back = np.asarray(Image.open(tmp_path / 'd.tiff'))
  assert back.dtype == np.float32
  np.testing.assert_array_equal(back, np.nan_to_num(depth))


def test_package_never_imports_jax():
  # Every module of the port imports in a process where jax, flax, optax,
  # orbax, absl, tensorboard, tensorflow, matplotlib and Pillow cannot be
  # imported at all.
  code = '\n'.join([
      'import importlib, pkgutil, sys',
      "banned = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'absl',",
      "          'tensorboard', 'tensorflow', 'matplotlib', 'PIL')",
      'for name in banned:',
      '  sys.modules[name] = None',
      'import multinerf_tpu_torch as pkg',
      'names = [m.name for m in pkgutil.walk_packages(pkg.__path__,',
      "                                               pkg.__name__ + '.')]",
      "for name in ('eval', 'train', 'utils.summary', 'utils.visualize',",
      "             'data.device_sampler', 'data.colmap', 'data.raw',",
      "             'robust', 'utils.jpeg', 'ops.lpips', 'utils.video',",
      "             'parallel', 'parallel.mesh', 'harness', 'cull_quality',",
      "             'keep_frac_probe', 'int8_eval_decision', 'render_bench',",
      "             'stability_run'):",
      "  assert 'multinerf_tpu_torch.' + name in names, name",
      'for name in names:',
      '  importlib.import_module(name)',
      "assert not any(m.split('.')[0] in banned + ('multinerf_tpu',) for m in",
      '           sys.modules if sys.modules[m] is not None)',
      'print(len(names))',
  ])
  proc = subprocess.run([sys.executable, '-c', code], cwd=tp.REPO, env=_ENV,
                        capture_output=True, text=True, timeout=120,
                        check=False)
  assert proc.returncode == 0, proc.stderr[-3000:]
  assert int(proc.stdout.strip()) >= 20  # Every submodule was imported.
