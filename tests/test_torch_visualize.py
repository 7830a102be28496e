"""The port's visualization suite against multinerf_tpu.utils.visualize.

Both are host numpy over the same arrays, so the images agree to rounding:
each within 1e-5 (max abs).  The colormaps agree with matplotlib's within
1e-6.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), 'helpers'))
import torch_parity as tp  # noqa: E402

from multinerf_tpu.data import types as jtypes  # noqa: E402
from multinerf_tpu.utils import visualize as jvis  # noqa: E402
from multinerf_tpu_torch.data import types  # noqa: E402
from multinerf_tpu_torch.utils import visualize as vis  # noqa: E402

TOL = 1e-5


def _rendering(seed, height=12, width=10, levels=3, rays=16, samples=9):
  """A rendering dict with the keys DeviceImageRenderer returns, plus a
  color-corrected image, and the rays of its pixels."""
  rng = np.random.RandomState(seed)
  hw = (height, width)
  p5 = rng.uniform(0.5, 2.0, hw)
  median = p5 + rng.uniform(0, 1, hw)
  mean = median + rng.normal(0, 0.1, hw)
  mean[0, 0] = np.nan  # A diverged ray: unaccumulated in every layer.
  rendering = {
      'rgb': rng.uniform(0, 1, hw + (3,)),
      'rgb_cc': rng.uniform(0, 1, hw + (3,)),
      'acc': rng.uniform(0, 1, hw),
      'distance_mean': mean,
      'distance_median': median,
      'distance_percentile_5': p5,
      'distance_percentile_95': median + rng.uniform(0, 3, hw),
      'ray_sdist': [np.sort(rng.uniform(0, 1, (rays, samples + 1)), -1)
                    for _ in range(levels)],
      'ray_weights': [rng.dirichlet(np.ones(samples), rays)
                      for _ in range(levels)],
      'ray_rgbs': [rng.uniform(-0.1, 1.1, (rays, samples, 3))
                   for _ in range(levels)],
  }
  fields = tp.rays(height * width, seed=seed)
  fields = {k: v.reshape(hw + v.shape[1:]) for k, v in fields.items()}
  return rendering, fields


@pytest.mark.parametrize('seed', [0, 1])
def test_visualize_suite_matches_jax(seed):
  rendering, fields = _rendering(seed)
  got = vis.visualize_suite(rendering, types.Rays(**fields))
  want = jvis.visualize_suite(rendering, jtypes.Rays(**fields))
  assert got.keys() == want.keys()
  assert {'color', 'acc', 'color_matte', 'depth_mean', 'depth_median',
          'depth_triplet', 'coords_mod', 'ray_colors', 'ray_weights',
          'color_corrected'} == set(got)
  for key, img in want.items():
    # coords_mod keeps the diverged ray's NaN, on both sides.
    np.testing.assert_allclose(got[key], img, rtol=0, atol=TOL,
                               equal_nan=True, err_msg=key)


def test_colorize_and_charts_match_jax():
  rng = np.random.RandomState(2)
  value = rng.lognormal(0, 1, (9, 11))
  weight = rng.uniform(0, 1, (9, 11))
  for cmap, jcmap in ((vis.turbo, jvis._get_cmap('turbo')),
                      (vis.gray, jvis._get_cmap('gray'))):
    tp.assert_close(
        vis.colorize(value, weight, cmap, curve_fn=np.log),
        jvis.colorize(value, weight, jcmap, curve_fn=np.log), atol=TOL,
        what='colorize')
  tp.assert_close(
      vis.visualize_cmap(value, weight, vis.turbo, lo=0, hi=3, modulus=2.0),
      jvis.visualize_cmap(value, weight, jvis._get_cmap('turbo'), lo=0,
                          hi=3, modulus=2.0), atol=TOL, what='modulus')
  rendering, _ = _rendering(3)
  args = (rendering['ray_sdist'], (0.0, 1.0), rendering['ray_weights'],
          rendering['ray_rgbs'])
  for kw in ({}, {'accumulate': True, 'renormalize': True,
                  'resolution': 97}):
    for got, want in zip(vis.ray_strip_chart(*args, **kw),
                         jvis.ray_strip_chart(*args, **kw)):
      tp.assert_close(got, want, atol=TOL, what=f'strip chart {kw}')


def test_colormaps_match_matplotlib():
  matplotlib = pytest.importorskip('matplotlib')
  x = np.concatenate([np.linspace(-0.2, 1.2, 4001), np.arange(256) / 256,
                      [0.0, 1.0, np.nan]])
  for name, cmap in (('turbo', vis.turbo), ('gray', vis.gray)):
    want = matplotlib.colormaps[name]
    assert cmap.N == want.N == 256
    tp.assert_close(cmap(np.arange(256) / 256), want(np.arange(256) / 256),
                    atol=1e-6, what=f'{name} table')
    tp.assert_close(cmap(x), want(x), atol=1e-6, what=name)


def test_decimate_thins_images_batches_and_ray_bundles():
  rendering, fields = _rendering(4)
  thin = vis.decimate(rendering, 3)
  assert thin['rgb'].shape == (4, 4, 3)
  np.testing.assert_array_equal(thin['acc'], rendering['acc'][::3, ::3])
  assert [r.shape for r in thin['ray_sdist']] == [(6, 4)] * 3
  batch = vis.decimate(types.Batch(rays=types.Rays(**fields),
                                   rgb=rendering['rgb']), 2)
  assert batch.rgb.shape == (6, 5, 3) and batch.disps is None
  assert batch.rays.origins.shape == (6, 5, 3)
