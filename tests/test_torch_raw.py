"""The port's RawNeRF helpers (multinerf_tpu_torch/data/raw.py) against the
JAX package's data/raw.py, on inputs made from a numpy seed.

Bounds: numpy against numpy is exact (the same operations in the same
order): the Bayer mask, the demosaic, the Exif processing, the ISP and the
affine match.  The demosaic in torch is exact too (shifts, products by
powers of two and sums, in the same order).  The jitted JAX demosaic, the
loader's, is held bitwise against the port's numpy one as well.  The ISP
in torch takes its percentile from ``torch.quantile`` and its color matrix
through ``mathx.matmul_hp``, so it is held within 1e-6 of numpy's.
"""

import io
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), 'helpers'))
import torch_parity as tp  # noqa: E402

from multinerf_tpu.data import raw as jraw  # noqa: E402
from multinerf_tpu_torch.data import raw  # noqa: E402


def _mosaic(h=12, w=16, seed=0):
  return np.random.RandomState(seed).rand(h, w).astype(np.float32)


@pytest.mark.parametrize('xnp', ['numpy', 'torch'])
def test_bayer_mask_matches_jax(xnp):
  rng = np.random.RandomState(1)
  pix_x = rng.randint(0, 64, (7, 3, 3))
  pix_y = rng.randint(0, 64, (7, 3, 3))
  want = jraw.pixels_to_bayer_mask(pix_x, pix_y)
  if xnp == 'torch':
    got = raw.pixels_to_bayer_mask(torch.as_tensor(pix_x),
                                   torch.as_tensor(pix_y), xnp=torch)
    assert got.dtype == torch.float32
    got = got.numpy()
  else:
    got = raw.pixels_to_bayer_mask(pix_x, pix_y)
  assert got.dtype == want.dtype and got.shape == (7, 3, 3, 3)
  np.testing.assert_array_equal(got, want)
  np.testing.assert_array_equal(got.sum(-1), 1.0)


@pytest.mark.parametrize('shape', [(12, 16), (8, 10)])
def test_demosaic_numpy_torch_and_jit_match_jax(shape):
  bayer = _mosaic(*shape, seed=2)
  want = jraw.bilinear_demosaic(bayer, xnp=np)
  got = raw.bilinear_demosaic(bayer)
  assert got.dtype == np.float32 and got.shape == shape + (3,)
  np.testing.assert_array_equal(got, want)
  got_t = raw.bilinear_demosaic(torch.as_tensor(bayer), xnp=torch)
  np.testing.assert_array_equal(got_t.numpy(), want)
  # The JAX loader demosaics under jit.
  np.testing.assert_array_equal(
      got, np.asarray(jraw.bilinear_demosaic_jax(jnp.asarray(bayer))))
  # Observed samples pass through: R at (0, 0), G at (0, 1), B at (1, 1).
  assert got[0, 0, 0] == bayer[0, 0] and got[0, 1, 1] == bayer[0, 1]
  assert got[1, 1, 2] == bayer[1, 1]


def _exifs(n=3, seed=3):
  rng = np.random.RandomState(seed)
  shutters = ['1/50', '1/200', '1/50', '1/800'][:n]
  out = []
  for i in range(n):
    cm = np.eye(3) + 0.1 * rng.randn(3, 3)
    out.append({
        'BlackLevel': 64, 'WhiteLevel': 1023,
        'AsShotNeutral': ' '.join(f'{v:.4f}' for v in rng.uniform(0.4, 1, 3)),
        'ColorMatrix2': ' '.join(f'{v:.5f}' for v in cm.ravel()),
        'NoiseProfile': '0.001 0.0001',
        'ShutterSpeed': shutters[i],
    })
  return out


def test_process_exif_matches_jax():
  exifs = _exifs()
  got = raw.process_exif(exifs)
  want = jraw.process_exif(exifs)
  assert sorted(got) == sorted(want)
  for k in want:
    np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize('exposure', [None, 0.4])
def test_postprocess_raw_matches_jax(exposure):
  rng = np.random.RandomState(4)
  img = rng.rand(6, 8, 3) * 0.7
  cam2rgb = raw.process_exif(_exifs())['cam2rgb'][0]
  want = jraw.postprocess_raw(img, cam2rgb, exposure, xnp=np)
  np.testing.assert_array_equal(
      raw.postprocess_raw(img, cam2rgb, exposure), want)
  got = raw.postprocess_raw(torch.as_tensor(img, dtype=torch.float32),
                            torch.as_tensor(cam2rgb, dtype=torch.float32),
                            exposure, xnp=torch)
  tp.assert_close(got.numpy(), want, atol=1e-6, what='torch ISP')
  with pytest.raises(ValueError, match='expected 3'):
    raw.postprocess_raw(img[..., :2], cam2rgb)


def test_match_images_affine_matches_jax():
  rng = np.random.RandomState(5)
  gt = rng.rand(10, 12, 3)
  est = 1.7 * gt + 0.2 + 0.01 * rng.randn(10, 12, 3)
  got = raw.match_images_affine(est, gt)
  np.testing.assert_array_equal(got, jraw.match_images_affine(est, gt))
  assert np.abs(got - gt).max() < 0.05
  a, b = raw.best_fit_affine(gt, est, axis=(0, 1))
  want_a, want_b = jraw.best_fit_affine(gt, est, axis=(0, 1))
  np.testing.assert_array_equal(a, want_a)
  np.testing.assert_array_equal(b, want_b)


def test_read_dng_takes_the_sidecar_or_raises_jax_text(tmp_path):
  mosaic = _mosaic(seed=6)
  np.save(tmp_path / 'a.npy', mosaic)
  (tmp_path / 'a.dng').write_bytes(b'placeholder')
  with open(tmp_path / 'a.dng', 'rb') as f:
    np.testing.assert_array_equal(raw._read_dng(f), mosaic)  # pylint: disable=protected-access
  (tmp_path / 'b.dng').write_bytes(b'placeholder')
  with open(tmp_path / 'b.dng', 'rb') as f:
    with pytest.raises(ImportError) as got:
      raw._read_dng(f)  # pylint: disable=protected-access
  with open(tmp_path / 'b.dng', 'rb') as f:
    with pytest.raises(ImportError) as want:
      jraw._read_dng(f)  # pylint: disable=protected-access
  assert str(got.value) == str(want.value)
  with pytest.raises(ImportError, match='sidecar'):
    raw._read_dng(io.BytesIO(b''))  # pylint: disable=protected-access
