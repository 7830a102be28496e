"""The port's metric harness against multinerf_tpu.ops.image_ops.

Tolerances: PSNR and SSIM are the same float32 formulas (SSIM's
convolutions sum in another order), max |port - JAX| <= 1e-5;
``color_correct`` is the same float64 numpy, <= 1e-5 too.
"""

import os
import sys
import types

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), 'helpers'))
import torch_parity as tp  # noqa: E402

from multinerf_tpu.ops import image_ops as jimage_ops  # noqa: E402
from multinerf_tpu_torch.data import raw  # noqa: E402
from multinerf_tpu_torch.ops import image_ops  # noqa: E402

TOL = 1e-5


def _images(shape, seed):
  """A random image and a noisy copy of it, in [0, 1]."""
  rng = np.random.RandomState(seed)
  img = rng.uniform(0, 1, shape).astype(np.float32)
  noisy = np.clip(img + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
  return img, noisy


@pytest.mark.parametrize('shape', [(40, 52, 3), (33, 27)])
def test_ssim_matches_jax(shape):
  img0, img1 = _images(shape, seed=len(shape))
  got = image_ops.ssim(img0, img1)
  want = jimage_ops.ssim(img0, img1)
  assert abs(float(got) - float(want)) <= TOL
  got_map = image_ops.ssim(img0, img1, return_map=True).numpy()
  want_map = np.asarray(jimage_ops.ssim(img0, img1, return_map=True))
  tp.assert_close(got_map, want_map, atol=TOL, what='ssim map')


def test_metric_harness_matches_jax():
  img0, img1 = _images((31, 45, 3), seed=4)
  # eval.py hands the harness float64 frames.
  pred, gt = img0.astype(np.float64), img1.astype(np.float64)
  got = image_ops.MetricHarness()(pred, gt, name_fn=lambda s: s + '_cc')
  want = jimage_ops.MetricHarness()(pred, gt, name_fn=lambda s: s + '_cc')
  assert got.keys() == want.keys() == {'psnr_cc', 'ssim_cc'}
  for k in got:
    assert abs(got[k] - want[k]) <= TOL, (k, got[k], want[k])
  psnr = float(image_ops.mse_to_psnr(
      image_ops.torch.tensor(np.float32(np.mean((pred - gt)**2)))))
  assert got['psnr_cc'] == pytest.approx(psnr, abs=TOL)


def test_color_correct_matches_jax():
  rng = np.random.RandomState(5)
  ref = rng.uniform(0, 1, (24, 20, 3))
  # A smooth color warp of the reference, plus clipped pixels.
  img = np.clip(0.8 * ref**1.3 + 0.05 * ref[..., ::-1] + 0.02, 0, 1)
  img[:3] = 1.0
  got = image_ops.color_correct(img, ref)
  want = jimage_ops.color_correct(img, ref)
  tp.assert_close(got, want, atol=TOL, what='color_correct')
  assert np.mean((got - ref)**2) < np.mean((img - ref)**2)
  with pytest.raises(ValueError, match='channels'):
    image_ops.color_correct(img, ref[..., :2])


def test_postprocess_fns_and_what_is_not_ported():
  _, config = tp.configs(("Config.dataset_loader = 'dummy_unbounded'",))
  tonemap, cc_fn = image_ops.make_postprocess_fns(config, None)
  x = np.arange(6.0)
  assert tonemap(x) is x and cc_fn is image_ops.color_correct
  # RawNeRF's: the dataset's raw tonemap and the affine match
  # (tests/test_torch_rawnerf.py holds them against JAX).
  _, config = tp.configs(('Config.rawnerf_mode = True',
                          'Config.eval_raw_affine_cc = True'))
  dataset = types.SimpleNamespace(metadata={'postprocess_fn': np.sqrt})
  tonemap, cc_fn = image_ops.make_postprocess_fns(config, dataset)
  assert tonemap is np.sqrt and cc_fn is raw.match_images_affine
  # LPIPS is ported (tests/test_torch_lpips.py); weights that cannot be
  # read leave it out, as the JAX harness does.
  assert image_ops.MetricHarness(
      lpips_weights_path='missing-lpips.npz').lpips_fn is None
