"""The port's LPIPS (multinerf_tpu_torch/ops/lpips.py) against the JAX
package's (multinerf_tpu/ops/lpips.py) on the random weights of
``random_params`` (the pretrained VGG weights are not in the repository):
the same parameters, the same 64 x 64 images, distances within a relative
1e-4 (both sum the same float32 convolutions on the CPU, in other orders);
the npz round trip; the metric harness's ``lpips`` entry."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multinerf_tpu.ops import lpips as jax_lpips
from multinerf_tpu_torch.ops import image_ops
from multinerf_tpu_torch.ops import lpips

RTOL = 1e-4


@pytest.fixture(scope='module')
def weights_file(tmp_path_factory):
  path = tmp_path_factory.mktemp('lpips') / 'w.npz'
  np.savez(path, **lpips.random_params(np.random.RandomState(0)))
  return str(path)


def _images(seed, shape=(64, 64, 3)):
  rng = np.random.RandomState(seed)
  base = rng.rand(*shape).astype(np.float32)
  return base, np.clip(base + 0.1 * rng.randn(*shape), 0, 1).astype(
      np.float32)


def test_random_params_match_jax():
  ours = lpips.random_params(np.random.RandomState(3))
  theirs = jax_lpips.random_params(np.random.RandomState(3))
  assert list(ours) == list(theirs)
  for k in ours:
    np.testing.assert_array_equal(ours[k], theirs[k])


@pytest.mark.parametrize('seed', [1, 2])
def test_matches_jax(weights_file, seed):
  img0, img1 = _images(seed)
  ours = lpips.LPIPS(weights_file)(img0, img1)
  theirs = jax_lpips.lpips(jax_lpips.load_params(weights_file),
                           jnp.asarray(img0), jnp.asarray(img1))
  np.testing.assert_allclose(ours, float(theirs), rtol=RTOL)
  assert ours > 0


def test_batched_matches_jax_and_loop(weights_file):
  a = np.stack([_images(s)[0] for s in (3, 4)])
  b = np.stack([_images(s)[1] for s in (3, 4)])
  params = lpips.load_params(weights_file)
  batched = lpips.lpips(params, a, b).numpy()
  theirs = np.asarray(jax_lpips.lpips(jax_lpips.load_params(weights_file),
                                      a, b))
  np.testing.assert_allclose(batched, theirs, rtol=RTOL)
  for i in range(2):
    np.testing.assert_allclose(batched[i], float(lpips.lpips(params, a[i],
                                                             b[i])),
                               rtol=1e-6)


def test_odd_size_and_identity(weights_file):
  img0, img1 = _images(5, (37, 45, 3))
  model = lpips.LPIPS(weights_file)
  theirs = jax_lpips.lpips(jax_lpips.load_params(weights_file), img0, img1)
  np.testing.assert_allclose(model(img0, img1), float(theirs), rtol=RTOL)
  assert model(img0, img0) == 0.0
  np.testing.assert_allclose(model(img1, img0), model(img0, img1), rtol=1e-6)


def test_npz_round_trip(weights_file, tmp_path):
  params = lpips.load_params(weights_file)
  path = tmp_path / 'again.npz'
  np.savez(path, **{k: v.numpy() for k, v in params.items()})
  again = lpips.load_params(str(path))
  assert set(again) == set(params)
  for k in params:
    assert again[k].dtype == params[k].dtype == torch.float32
    np.testing.assert_array_equal(again[k].numpy(), params[k].numpy())


def test_metric_harness(weights_file):
  img0, img1 = _images(6)
  harness = image_ops.MetricHarness(lpips_weights_path=weights_file)
  out = harness(img0, img1, name_fn=lambda s: f'x_{s}')
  assert set(out) == {'x_psnr', 'x_ssim', 'x_lpips'}
  np.testing.assert_allclose(out['x_lpips'],
                             lpips.LPIPS(weights_file)(img0, img1), rtol=0)
  assert set(image_ops.MetricHarness()(img0, img1)) == {'psnr', 'ssim'}
  assert lpips.try_load(weights_file + '.missing') is None
  assert lpips.try_load(None) is None


def test_psnr_and_dssim_helpers():
  from multinerf_tpu.ops import image_ops as jax_image_ops
  psnr = torch.tensor([10.0, 27.5, 40.0])
  np.testing.assert_allclose(
      image_ops.psnr_to_mse(psnr).numpy(),
      np.asarray(jax_image_ops.psnr_to_mse(jnp.asarray(psnr.numpy()))),
      rtol=1e-6)
  np.testing.assert_allclose(
      image_ops.mse_to_psnr(image_ops.psnr_to_mse(psnr)).numpy(), psnr,
      rtol=1e-5)
  for v in (0.0, 0.25, 0.9):
    assert image_ops.ssim_to_dssim(v) == jax_image_ops.ssim_to_dssim(v)
    assert image_ops.dssim_to_ssim(image_ops.ssim_to_dssim(v)) == v
