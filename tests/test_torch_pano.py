"""Pano rendering in the port against the JAX package, at the small widths
of tests/helpers/torch_parity.py, on a COLMAP capture written here
(tests/test_torch_datasets_capture.py's), under ``Config.render_path =
True`` and ``Config.render_camtype = 'pano'`` (the shape of JAX's
tests/test_render_paths.py:39-50).

- ``cameras.cast_spherical_rays`` against JAX's: bitwise on numpy (both
  float64, the same operations); torch float32 against ``jnp`` within 1e-5
  (the two frameworks' sin, cos and norm round their last bits apart).
- The llff loader's pano batch against JAX's loader, every field bitwise.
- A pano frame of ``ImageRenderer`` (host-cast rays) and of
  ``render_image`` against JAX's ``ImageRenderer`` and ``render_image``
  under both ``Config.render_scan_chunks`` settings, on the same (bridged)
  weights, 128 rays in chunks of 48 (the last one padded); the JAX MLPs
  take their Pallas kernels in interpret mode, as the other parity tests
  run them.  Bounds: those of tests/test_torch_capture_slice.py (rgb and acc
  3e-3; distances as near / t within 2e-3).
- ``render.main`` with pano on a checkpoint of those weights: the frames
  and the AVIs of the path, its frames against JAX's within the same bounds.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), 'helpers'))
import test_torch_datasets_capture as capture  # noqa: E402
import torch_parity as tp  # noqa: E402

from multinerf_tpu import ginlite as jax_gin  # noqa: E402
from multinerf_tpu.data import cameras as jcameras  # noqa: E402
from multinerf_tpu.data import datasets as jdatasets  # noqa: E402
from multinerf_tpu.models import nerf as jnerf  # noqa: E402
from multinerf_tpu_torch import bridge  # noqa: E402
from multinerf_tpu_torch import render  # noqa: E402
from multinerf_tpu_torch import train_lib  # noqa: E402
from multinerf_tpu_torch.data import cameras  # noqa: E402
from multinerf_tpu_torch.data import datasets  # noqa: E402
from multinerf_tpu_torch.models import nerf  # noqa: E402
from multinerf_tpu_torch.utils import checkpoints  # noqa: E402

RAY_FIELDS = ('origins', 'directions', 'viewdirs', 'radii', 'imageplane',
              'lossmult', 'near', 'far', 'cam_idx')
PANO = ('Config.render_path = True', "Config.render_camtype = 'pano'",
        'Config.render_resolution = (16, 8)', 'Config.render_path_frames = 3',
        'Config.render_chunk_size = 48')


def _camtoworld(seed):
  rng = np.random.RandomState(seed)
  rot, _ = np.linalg.qr(rng.randn(3, 3))
  return np.concatenate([rot, rng.randn(3, 1)], -1)


@pytest.mark.parametrize('xnp', ['numpy', 'torch'])
def test_cast_spherical_rays_matches_jax(xnp):
  c2w = _camtoworld(0)
  if xnp == 'numpy':
    want = jcameras.cast_spherical_rays(c2w, 10, 20, 0.2, 1e6, xnp=np)
    got = cameras.cast_spherical_rays(c2w, 10, 20, 0.2, 1e6, xnp=np)
  else:
    c2w = c2w.astype(np.float32)
    want = jcameras.cast_spherical_rays(jnp.asarray(c2w), 10, 20, 0.2, 1e6,
                                        xnp=jnp)
    got = cameras.cast_spherical_rays(torch.as_tensor(c2w), 10, 20, 0.2,
                                      1e6, xnp=torch)
  for key in RAY_FIELDS:
    g, w = np.asarray(getattr(got, key)), np.asarray(getattr(want, key))
    assert g.shape == w.shape, (key, g.shape, w.shape)
    if xnp == 'numpy':
      assert g.dtype == w.dtype, key
      np.testing.assert_array_equal(g, w, err_msg=key)
    else:
      tp.assert_close(g, w, atol=1e-5, rtol=1e-5, what=key)
  assert np.asarray(got.origins).shape == (10, 20, 3)
  np.testing.assert_allclose(
      np.linalg.norm(np.asarray(got.directions), axis=-1), 1, rtol=1e-5)


@pytest.fixture(scope='module')
def scene(tmp_path_factory):
  data_dir = str(tmp_path_factory.mktemp('pano') / 'capture')
  capture.write_capture(data_dir, capture.ring_poses(6), seed=3)
  return data_dir


def _configs(scene, *more):
  return tp.configs(tp.SMALL_BINDINGS + tp.FUSED_BINDINGS + (
      f"Config.data_dir = '{scene}'", 'Config.factor = 2',
      'Config.batch_size = 64') + PANO + more)


def test_pano_batch_matches_jax_loader(scene):
  jax_config, torch_config = _configs(scene)
  want = jdatasets.load_dataset('test', scene, jax_config)
  with datasets.load_dataset('test', scene, torch_config) as got:
    assert got.size == want.size == 3
    assert (got.height, got.width) == (want.height, want.width) == (8, 16)
    for idx in range(got.size):
      got_rays = got.generate_ray_batch(idx).rays
      want_rays = want.generate_ray_batch(idx).rays
      for key in RAY_FIELDS:
        g, w = getattr(got_rays, key), np.asarray(getattr(want_rays, key))
        assert g.dtype == w.dtype, key
        np.testing.assert_array_equal(g, w, err_msg=f'view {idx} {key}')
    # The test split's iterator gives the same fan, the cameras in turn.
    np.testing.assert_array_equal(next(got).rays.directions,
                                  got.generate_ray_batch(0).rays.directions)


def _model_pair(jax_config, torch_config, seed=5):
  params = tp.jax_params(jax_config, seed=seed)
  model = nerf.construct_model(torch_config,
                               torch.Generator().manual_seed(0), 'cpu')
  bridge.load_jax_params(model, params)
  return jax_gin.make('Model', config=jax_config), params, model


def _assert_frames_close(got, want, near):
  assert got['rgb'].shape == np.asarray(want['rgb']).shape == (8, 16, 3)
  tp.assert_close(got['rgb'], np.asarray(want['rgb']), atol=3e-3, what='rgb')
  tp.assert_close(got['acc'], np.asarray(want['acc']), atol=3e-3, what='acc')
  for key in ('distance_mean', 'distance_median'):
    tp.assert_close(near / got[key], near / np.asarray(want[key]), atol=2e-3,
                    what=key)


@pytest.mark.parametrize('scan', [True, False])
def test_pano_frame_matches_jax(scene, scan):
  jax_config, torch_config = _configs(
      scene, f'Config.render_scan_chunks = {scan}')
  jmodel, params, model = _model_pair(jax_config, torch_config)
  with datasets.load_dataset('test', scene, torch_config) as test:
    rays = test.generate_ray_batch(1).rays
    renderer = nerf.choose_renderer(train_lib.create_render_fn(model),
                                    torch_config, test, 'cpu')
    assert isinstance(renderer, nerf.ImageRenderer)
    got = renderer(1.0, 1)  # The camera's host rays, cast by the dataset.
  jax_rays = jdatasets.load_dataset('test', scene,
                                    jax_config).generate_ray_batch(1).rays

  def jax_render_fn(variables, train_frac, _, chunk_rays):
    return jmodel.apply(variables, None, chunk_rays, train_frac=train_frac,
                        compute_extras=True)

  want = jnerf.ImageRenderer(jax_render_fn, jax_config)(
      {'params': params}, 1.0, jax_rays)
  _assert_frames_close(got, want, torch_config.near)
  for key, value in renderer.render_rays(1.0, rays).items():
    if not key.startswith('ray_'):
      np.testing.assert_array_equal(value, got[key], err_msg=key)
  assert [b.shape for b in got['ray_weights']] == [
      np.asarray(b).shape for b in want['ray_weights']]

  # The one-shot wrapper: JAX's scan or host loop, the port's one loop.
  want_once = jnerf.render_image(
      jax.jit(lambda _, chunk_rays: jax_render_fn({'params': params}, 1.0,
                                                  None, chunk_rays)),
      jax_rays, None, jax_config, verbose=False)
  render_fn = train_lib.create_render_fn(model)
  got_once = nerf.render_image(lambda r: render_fn(1.0, r), rays,
                               torch_config, 'cpu')
  _assert_frames_close(got_once, want_once, torch_config.near)
  for key in ('rgb', 'acc', 'distance_mean'):
    np.testing.assert_array_equal(got_once[key], got[key], err_msg=key)


def test_device_renderer_refuses_pano(scene):
  _, torch_config = _configs(scene)
  model = nerf.construct_model(torch_config,
                               torch.Generator().manual_seed(0), 'cpu')
  with datasets.load_dataset('test', scene, torch_config) as test:
    renderer = nerf.DeviceImageRenderer(train_lib.create_render_fn(model),
                                        torch_config, test, 'cpu')
  assert not renderer.supports()
  with pytest.raises(ValueError, match='ImageRenderer'):
    renderer(1.0, 0)


def test_render_main_pano_matches_jax(scene, tmp_path):
  jax_config, torch_config = _configs(scene)
  jmodel, params, model = _model_pair(jax_config, torch_config, seed=6)
  checkpoints.CheckpointManager(str(tmp_path / 'ckpt')).save(
      3, checkpoints.TrainState(step=3,
                                params=bridge.named_variables(model)))
  argv = ['--device=cpu', f'--gin_configs={tp.CONFIG_360}'] + [
      f'--gin_bindings={b}' for b in tp.SMALL_BINDINGS + tp.FUSED_BINDINGS +
      PANO + (f"Config.data_dir = '{scene}'", 'Config.factor = 2',
              f"Config.checkpoint_dir = '{tmp_path}/ckpt'",
              f"Config.render_dir = '{tmp_path}/render'")]
  summary = render.main(argv)
  assert summary['frames'] == [0, 1, 2]
  assert os.path.basename(summary['out_dir']) == 'path_renders_step_3'
  assert sorted(v.rsplit('path_renders_step_3_')[-1]
                for v in summary['videos']) == [
                    'acc.avi', 'color.avi', 'distance_mean.avi',
                    'distance_median.avi']
  assert 'color_002.png' in os.listdir(summary['out_dir'])

  def jax_render_fn(variables, train_frac, _, chunk_rays):
    return jmodel.apply(variables, None, chunk_rays, train_frac=train_frac,
                        compute_extras=True)

  jax_test = jdatasets.load_dataset('test', scene, jax_config)
  renderer = jnerf.ImageRenderer(jax_render_fn, jax_config)
  for idx in (0, 2):
    want = renderer({'params': params}, 1.0,
                    jax_test.generate_ray_batch(idx).rays)
    _assert_frames_close(summary['renderings'][idx], want, torch_config.near)
