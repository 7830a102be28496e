"""``DeviceImageRenderer.render_many`` against per-frame calls and against
JAX's ``render_many``, after JAX's tests/test_image_renderer.py:158-180:
the ``dummy_sphere`` test cameras (near 2, far 6) in chunks of 256 rays,
at the small widths of tests/helpers/torch_parity.py.

The stacked frames are the per-frame calls' bitwise (the same chunks
through the same model on the CPU).  Against JAX, on the same (bridged)
weights, the bounds of tests/test_torch_model.py's whole-image render
(rgb and acc 3e-3, distances as near / t within 2e-3); the JAX MLPs take
their Pallas kernels in interpret mode.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), 'helpers'))
import torch_parity as tp  # noqa: E402

from multinerf_tpu import ginlite as jax_gin  # noqa: E402
from multinerf_tpu.data import datasets as jdatasets  # noqa: E402
from multinerf_tpu.models import nerf as jnerf  # noqa: E402
from multinerf_tpu_torch import bridge  # noqa: E402
from multinerf_tpu_torch import train_lib  # noqa: E402
from multinerf_tpu_torch.data import datasets  # noqa: E402
from multinerf_tpu_torch.models import nerf  # noqa: E402

CAMS = [0, 2, 5]
BINDINGS = tp.SMALL_BINDINGS + tp.FUSED_BINDINGS + (
    "Config.dataset_loader = 'dummy_sphere'", 'Config.near = 2.0',
    'Config.far = 6.0', 'Config.render_chunk_size = 256')


@pytest.fixture(scope='module')
def renderers():
  jax_config, torch_config = tp.configs(BINDINGS)
  params = tp.jax_params(jax_config, seed=7)
  jmodel = jax_gin.make('Model', config=jax_config)
  model = nerf.construct_model(torch_config,
                               torch.Generator().manual_seed(0), 'cpu')
  bridge.load_jax_params(model, params)

  def jax_render_fn(variables, train_frac, _, rays):
    return jmodel.apply(variables, None, rays, train_frac=train_frac,
                        compute_extras=True)

  jax_renderer = jnerf.DeviceImageRenderer(
      jax_render_fn, jax_config,
      jdatasets.load_dataset('test', None, jax_config))
  renderer = nerf.DeviceImageRenderer(
      train_lib.create_render_fn(model), torch_config,
      datasets.load_dataset('test', None, torch_config), 'cpu')
  return renderer, lambda cams: jax_renderer.render_many(
      {'params': params}, 1.0, cams)


def test_render_many_equals_per_frame_calls(renderers):
  renderer, _ = renderers
  stacked = renderer.render_many(1.0, CAMS)
  assert stacked['rgb'].shape[0] == len(CAMS)
  for row, cam_idx in enumerate(CAMS):
    single = renderer(1.0, cam_idx)
    assert set(single) == set(stacked)
    for key, value in single.items():
      if key.startswith('ray_'):
        for level, bundle in enumerate(value):
          np.testing.assert_array_equal(stacked[key][level][row], bundle,
                                        err_msg=f'{key} level {level}')
      else:
        np.testing.assert_array_equal(stacked[key][row], value, err_msg=key)


def test_render_many_matches_jax(renderers):
  renderer, jax_render_many = renderers
  got, want = renderer.render_many(1.0, CAMS), jax_render_many(CAMS)
  assert got['rgb'].shape == np.asarray(want['rgb']).shape
  assert got['rgb'].shape[:1] == (len(CAMS),)
  tp.assert_close(got['rgb'], np.asarray(want['rgb']), atol=3e-3, what='rgb')
  tp.assert_close(got['acc'], np.asarray(want['acc']), atol=3e-3, what='acc')
  for key in ('distance_mean', 'distance_median'):
    tp.assert_close(2.0 / got[key], 2.0 / np.asarray(want[key]), atol=2e-3,
                    what=key)
  for key in ('ray_sdist', 'ray_weights', 'ray_rgbs'):
    assert [g.shape for g in got[key]] == [np.asarray(w).shape
                                           for w in want[key]], key
