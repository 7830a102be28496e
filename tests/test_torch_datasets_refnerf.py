"""The data of the Ref-NeRF path against the JAX package's: the
``dummy_specular`` scene and its batches (images, normals, alphas,
disparities, rays) bitwise, the ``blender`` loader on a two-view fixture
written here with Pillow, the port's PNG reader against Pillow's on every
filter type, the sRGB curve and area downsampling, and the device sampler's
metric targets against the host batches.
"""

import io
import json
import os
import struct
import sys
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

sys.path.insert(0, os.path.join(os.path.dirname(__file__), 'helpers'))
import torch_parity as tp  # noqa: E402

from multinerf_tpu.data import datasets as jdatasets  # noqa: E402
from multinerf_tpu.ops import image_ops as jimage_ops  # noqa: E402
from multinerf_tpu_torch import train_lib  # noqa: E402
from multinerf_tpu_torch.data import datasets  # noqa: E402
from multinerf_tpu_torch.data import device_sampler  # noqa: E402
from multinerf_tpu_torch.ops import image_ops  # noqa: E402
from multinerf_tpu_torch.utils import io as io_lib  # noqa: E402

CONFIG_REFNERF = os.path.join(tp.REPO, 'configs', 'blender_refnerf.gin')
RAY_FIELDS = ('origins', 'directions', 'viewdirs', 'radii', 'imageplane',
              'lossmult', 'near', 'far', 'cam_idx')


def _configs(*bindings):
  return tp.configs(("Config.dataset_loader = 'dummy_specular'",
                     'Config.batch_size = 32') + bindings,
                    files=(CONFIG_REFNERF,))


def _assert_batches_equal(got, want):
  for key in ('rgb', 'normals', 'alphas', 'disps'):
    g, w = getattr(got, key), getattr(want, key)
    assert (g is None) == (w is None), key
    if g is not None:
      np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                    err_msg=key)
  for key in RAY_FIELDS:
    np.testing.assert_array_equal(np.asarray(getattr(got.rays, key)),
                                  np.asarray(getattr(want.rays, key)),
                                  err_msg=key)


@pytest.mark.parametrize('split', ['train', 'test'])
def test_dummy_specular_is_bitwise_jax(split):
  jax_config, torch_config = _configs('Config.compute_disp_metrics = True')
  got = datasets.load_dataset(split, None, torch_config)
  want = jdatasets.load_dataset(split, None, jax_config)
  for key in ('images', 'normal_images', 'alphas', 'disp_images',
              'camtoworlds', 'pixtocams'):
    np.testing.assert_array_equal(getattr(got, key), getattr(want, key),
                                  err_msg=key)
  assert (got.height, got.width, got.near, got.far, got.size) == (
      want.height, want.width, want.near, want.far, want.size)
  # A batch of given pixels (the train draws' indices), and a whole view.
  rng = np.random.RandomState(1)
  x, y = rng.randint(0, 48, (2, 16, 1, 1))
  cam = rng.randint(0, 16, (16, 1, 1))
  _assert_batches_equal(got._make_ray_batch(x, y, cam),
                        want._make_ray_batch(x, y, cam))
  _assert_batches_equal(got.generate_ray_batch(3),
                        want.generate_ray_batch(3))
  got.close()


def test_dummy_specular_train_batches_follow_the_draws_of_jax():
  # The producer thread draws as datasets.py:256-282 does, from its seed.
  jax_config, torch_config = _configs()
  batch = next(datasets.load_dataset('train', None, torch_config, seed=7))
  rng = np.random.RandomState(7)
  x = rng.randint(0, 48, (32, 1, 1))
  y = rng.randint(0, 48, (32, 1, 1))
  cam = rng.randint(0, 16, (1,))  # blender_refnerf.gin: single_image.
  want = jdatasets.load_dataset('train', None, jax_config)._make_ray_batch(
      x, y, cam)
  _assert_batches_equal(batch, want)
  assert batch.normals.shape == (32, 1, 1, 3)
  assert batch.alphas.shape == (32, 1, 1) and batch.disps is None
  device = train_lib.batch_to_device(batch, 'cpu')
  assert device.normals.shape == (32, 3) and device.alphas.shape == (32,)


def test_device_sampler_carries_the_metric_targets():
  _, config = _configs('Config.compute_disp_metrics = True',
                       "Config.batching = 'all_images'")
  dataset = datasets.load_dataset('train', None, config)
  plane = device_sampler.DeviceDataPlane(dataset, config, 'cpu')
  pix_x, pix_y, cam_idx = plane.draw(torch.Generator().manual_seed(0))
  got = plane.make_batch(pix_x, pix_y, cam_idx)
  want = train_lib.batch_to_device(dataset._make_ray_batch(
      pix_x.numpy(), pix_y.numpy(), cam_idx.numpy()), 'cpu')
  for key in ('rgb', 'normals', 'alphas', 'disps'):
    assert torch.equal(getattr(got, key), getattr(want, key)), key


def _write_blender_fixture(root):
  """Two RGBA views per split of a tiny scene, with _normal.png."""
  rng = np.random.RandomState(0)
  for split in ('train', 'test'):
    frames = []
    for i in range(2):
      name = f'{split}/r_{i}'
      os.makedirs(os.path.join(root, split), exist_ok=True)
      rgba = (rng.rand(8, 12, 4) * 255).astype(np.uint8)
      rgba[..., 3] = np.where(rng.rand(8, 12) < 0.3, 0, rgba[..., 3])
      Image.fromarray(rgba, 'RGBA').save(os.path.join(root, name + '.png'))
      normal = (rng.rand(8, 12, 4) * 255).astype(np.uint8)
      Image.fromarray(normal, 'RGBA').save(
          os.path.join(root, name + '_normal.png'))
      theta = 0.7 * i + (0.3 if split == 'test' else 0.0)
      pose = np.eye(4)
      pose[:3, 3] = [4 * np.cos(theta), 4 * np.sin(theta), 1.0]
      frames.append({'file_path': './' + name,
                     'transform_matrix': pose.tolist()})
    with open(os.path.join(root, f'transforms_{split}.json'), 'w') as f:
      json.dump({'camera_angle_x': 0.69, 'frames': frames}, f)


@pytest.mark.parametrize('factor', [0, 2])
def test_blender_loader_matches_jax(tmp_path, factor):
  _write_blender_fixture(str(tmp_path))
  bindings = ("Config.dataset_loader = 'blender'", f'Config.factor = {factor}',
              f"Config.data_dir = '{tmp_path}'")
  jax_config, torch_config = tp.configs(bindings, files=(CONFIG_REFNERF,))
  for split in ('train', 'test'):
    got = datasets.load_dataset(split, str(tmp_path), torch_config)
    want = jdatasets.load_dataset(split, str(tmp_path), jax_config)
    assert got.images.shape == (2, 8 // max(factor, 1), 12 // max(factor, 1),
                                3)
    for key in ('images', 'normal_images', 'alphas', 'camtoworlds',
                'pixtocams'):
      np.testing.assert_allclose(getattr(got, key), getattr(want, key),
                                 rtol=1e-6, atol=1e-7, err_msg=key)
    _assert_batches_equal(got.generate_ray_batch(1),
                          want.generate_ray_batch(1))


def test_blender_loader_refuses_tiffs(tmp_path):
  # The TIFF branch is ported (tests/test_torch_512.py holds it against
  # JAX); a scene without the TIFFs it names fails as JAX's loader does.
  _write_blender_fixture(str(tmp_path))
  for binding, missing in (('Config.use_tiffs = True', 'r_0_R.tiff'),
                           ('Config.compute_disp_metrics = True',
                            'r_0_disp.tiff')):
    jax_config, config = tp.configs(
        ("Config.dataset_loader = 'blender'", binding),
        files=(CONFIG_REFNERF,))
    with pytest.raises(FileNotFoundError, match=missing):
      datasets.load_dataset('train', str(tmp_path), config)
    with pytest.raises(FileNotFoundError, match=missing):
      jdatasets.load_dataset('train', str(tmp_path), jax_config)


def _filter_rows(img, filters):
  """The inverse of the reader: PNG scanlines with filter `filters[y]`."""
  h = img.shape[0]
  bpp = 1 if img.ndim == 2 else img.shape[-1]
  rows = img.reshape(h, -1).astype(np.int64)
  out = []
  for y in range(h):
    row, prior = rows[y], rows[y - 1] if y else np.zeros_like(rows[0])
    left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
    upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
    kind = filters[y]
    if kind == 0:
      pred = 0
    elif kind == 1:
      pred = left
    elif kind == 2:
      pred = prior
    elif kind == 3:
      pred = (left + prior) // 2
    else:
      p = left + prior - upleft
      pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - upleft)
      pred = np.where((pa <= pb) & (pa <= pc), left,
                      np.where(pb <= pc, prior, upleft))
    out.append(np.concatenate([[kind], (row - pred) % 256]).astype(np.uint8))
  return np.stack(out).tobytes()


def _png(img, color_type, filters):
  h, w = img.shape[:2]
  chunk = lambda k, d: (struct.pack('>I', len(d)) + k + d + struct.pack(
      '>I', zlib.crc32(k + d) & 0xffffffff))
  return (b'\x89PNG\r\n\x1a\n' +
          chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, color_type, 0, 0,
                                     0)) +
          chunk(b'IDAT', zlib.compress(_filter_rows(img, filters))) +
          chunk(b'IEND', b''))


@pytest.mark.parametrize('channels,color_type', [(1, 0), (2, 4), (3, 2),
                                                 (4, 6)])
def test_png_reader_matches_pillow_on_every_filter(channels, color_type):
  rng = np.random.RandomState(channels)
  shape = (10, 7) if channels == 1 else (10, 7, channels)
  img = (rng.rand(*shape) * 255).astype(np.uint8)
  img[4:6] = img[3:4]  # Flat runs, where Up and Average predict exactly.
  data = _png(img, color_type, [0, 1, 2, 3, 4, 4, 3, 2, 1, 0])
  got = io_lib.decode_png(data)
  want = np.asarray(Image.open(io.BytesIO(data)))
  assert got.dtype == np.uint8 and got.shape == want.shape
  np.testing.assert_array_equal(got, want)
  np.testing.assert_array_equal(got, img)
  # Pillow's own encoder (adaptive filters), and the port's writer.
  buf = io.BytesIO()
  Image.fromarray(img).save(buf, 'PNG', optimize=True)
  np.testing.assert_array_equal(io_lib.decode_png(buf.getvalue()), img)
  if channels in (1, 3):
    np.testing.assert_array_equal(io_lib.decode_png(io_lib.encode_png(img)),
                                  img)


def test_srgb_to_linear_and_downsample_match_jax():
  x = np.linspace(0, 1, 101, dtype=np.float32)
  np.testing.assert_allclose(image_ops.srgb_to_linear(x),
                             jimage_ops.srgb_to_linear(jnp.asarray(x)),
                             rtol=1e-6, atol=1e-7)
  np.testing.assert_allclose(
      image_ops.srgb_to_linear(torch.as_tensor(x), xnp=torch).numpy(),
      jimage_ops.srgb_to_linear(jnp.asarray(x)), rtol=1e-6, atol=1e-7)
  img = np.random.RandomState(0).rand(8, 12, 3).astype(np.float32)
  np.testing.assert_allclose(image_ops.downsample(img, 4),
                             jimage_ops.downsample(img, 4), rtol=1e-6)
  with pytest.raises(ValueError, match='evenly divide'):
    image_ops.downsample(img, 5)
