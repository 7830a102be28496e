"""The port's capture loaders against the JAX package's, on small captures
written here: ``llff`` unbounded (an OPENCV camera, JPEG originals with
Exif and a PNG pyramid), forward-facing (``poses_bounds.npy``, NDC), with a
spline render path, and from a ``transforms.json``; ``tat_nerfpp`` with its
``camera_path``; ``tat_fvs``; ``dtu``.  Images, cameras, distortion,
``pixtocam_ndc``, render poses, exposures and split sizes must be equal,
and so must ``generate_ray_batch(0)``: the loaders are the same numpy
arithmetic (bitwise), except where a render path comes from the ellipse,
whose resampled angles JAX takes in float32 under ``jnp`` (held to
ELLIPSE_TOL, see tests/test_torch_cameras_capture.py).  Also ``load_exif``
against Pillow's, and the refusals: an arithmetic-coded JPEG pyramid, pano
rendering, a RawNeRF config on a capture without ``raw/``.
"""

import io
import json
import os
import struct
import sys

import numpy as np
import pytest
from PIL import Image
from PIL import TiffImagePlugin

sys.path.insert(0, os.path.join(os.path.dirname(__file__), 'helpers'))
import fabricate_colmap  # noqa: E402
import torch_parity as tp  # noqa: E402

from multinerf_tpu.data import cameras as jcam  # noqa: E402
from multinerf_tpu.data import datasets as jdatasets  # noqa: E402
from multinerf_tpu.utils import io as jio  # noqa: E402
from multinerf_tpu_torch.data import datasets  # noqa: E402
from multinerf_tpu_torch.utils import io as io_lib  # noqa: E402

# The ellipse path's poses (and the rays cast from them), within a scene
# scaled into [-1, 1]^3: see tests/test_torch_cameras_capture.py.
ELLIPSE_TOL = 1e-5
RAY_FIELDS = ('origins', 'directions', 'viewdirs', 'radii', 'imageplane',
              'lossmult', 'near', 'far', 'cam_idx', 'exposure_values')
OPENCV = (28.0, 27.0, 16.5, 12.25, 0.03, -0.006, 0.0012, -0.0009)


def _write_png(path, img):
  Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(path)


def _write_exif_jpeg(path, img, exposure, iso):
  exif = Image.Exif()
  ifd = exif.get_ifd(0x8769)
  ifd[0x829A] = TiffImagePlugin.IFDRational(*exposure)
  ifd[0x8827] = iso
  exif[0x010F] = 'Fabricated'
  Image.fromarray((img * 255).astype(np.uint8)).save(path, exif=exif)


def ring_poses(n):
  """[n, 3, 4] NeRF-convention cameras on a wavy ring, looking inward."""
  return fabricate_colmap.ring_poses(n)


def forward_poses(n):
  """[n, 3, 4] forward-facing cameras on a plane, looking down -z."""
  poses = []
  for i in range(n):
    pos = np.array([0.3 * np.cos(1.3 * i), 0.2 * np.sin(2.1 * i), 0.05 * i])
    poses.append(jcam.viewmatrix(np.array([0.02 * np.sin(i), 0.0, 1.0]),
                                 np.array([0.0, 1.0, 0.0]), pos))
  return np.stack(poses)


def write_colmap(sparse, poses, names, model_id, params, width, height):
  """A binary COLMAP model: one shared camera, one image per pose."""
  os.makedirs(sparse, exist_ok=True)
  with open(os.path.join(sparse, 'cameras.bin'), 'wb') as f:
    f.write(struct.pack('<Q', 1))
    f.write(struct.pack('<iiQQ', 1, model_id, width, height))
    f.write(struct.pack(f'<{len(params)}d', *params))
  with open(os.path.join(sparse, 'images.bin'), 'wb') as f:
    f.write(struct.pack('<Q', len(names)))
    for i, (name, pose) in enumerate(zip(names, poses)):
      c2w = np.concatenate([pose @ np.diag([1.0, -1.0, -1.0, 1.0]),
                            [[0, 0, 0, 1.0]]], axis=0)
      w2c = np.linalg.inv(c2w)
      f.write(struct.pack('<i', i + 1))
      f.write(struct.pack('<4d', *fabricate_colmap.rotmat_to_qvec(
          w2c[:3, :3])))
      f.write(struct.pack('<3d', *w2c[:3, 3]))
      f.write(struct.pack('<i', 1))
      f.write(name.encode() + b'\x00')
      f.write(struct.pack('<Q', 0))


def write_capture(root, poses, model_id=4, params=OPENCV, width=32,
                  height=24, factor=2, originals='jpg', images=None,
                  seed=0):
  """A capture as COLMAP leaves it after scripts/local_colmap_and_resize.sh:
  ``sparse/0``, originals under ``images/`` (JPEGs with Exif, or PNGs) and
  the PNG level ``images_{factor}/``.  `images` ([N, H/f, W/f, 3] in
  [0, 1]) fills the level; random pixels otherwise.  Returns the COLMAP
  image names (the originals' names, in a shuffled order)."""
  n = len(poses)
  rng = np.random.RandomState(seed)
  order = rng.permutation(n)  # COLMAP lists images in its own order.
  ext = 'JPG' if originals == 'jpg' else 'png'
  names = [f'IMG_{i:04d}.{ext}' for i in range(n)]
  write_colmap(os.path.join(root, 'sparse', '0'), poses[order],
               [names[i] for i in order], model_id, params, width, height)
  os.makedirs(os.path.join(root, 'images'), exist_ok=True)
  os.makedirs(os.path.join(root, f'images_{factor}'), exist_ok=True)
  for i, name in enumerate(names):
    full = rng.rand(height, width, 3)
    if originals == 'jpg':
      _write_exif_jpeg(os.path.join(root, 'images', name), full,
                       (1, 100 + 25 * i), 100 * (1 + i % 4))
    else:
      _write_png(os.path.join(root, 'images', name), full)
    level = (rng.rand(height // factor, width // factor, 3)
             if images is None else images[i])
    _write_png(os.path.join(root, f'images_{factor}', f'IMG_{i:04d}.png'),
               level)
  return [names[i] for i in order]


def _assert_same(got, want, what, ellipse=False):
  if want is None or got is None:
    assert got is None and want is None, what
    return
  got, want = np.asarray(got), np.asarray(want)
  assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
  if ellipse:
    tp.assert_close(got, want, ELLIPSE_TOL, what=what)
  else:
    np.testing.assert_array_equal(got, want, err_msg=what)


def assert_loaders_match(split, data_dir, bindings, ellipse=False,
                         files=(tp.CONFIG_360,)):
  """The port's and JAX's loader of one split: every field and
  generate_ray_batch(0).  Returns the port's dataset (closed)."""
  jax_config, torch_config = tp.configs(('Config.batch_size = 64',) +
                                        tuple(bindings), files=files)
  want = jdatasets.load_dataset(split, data_dir, jax_config)
  got = datasets.load_dataset(split, data_dir, torch_config)
  assert got.size == want.size
  assert (got.height, got.width) == (want.height, want.width)
  assert got.camtype.value == want.camtype.value
  assert got.distortion_params == want.distortion_params
  render_ellipse = ellipse and torch_config.render_path
  for key in ('images', 'pixtocams', 'pixtocam_ndc', 'exposures',
              'render_exposures'):
    _assert_same(getattr(got, key), getattr(want, key), key)
  _assert_same(got.camtoworlds, want.camtoworlds, 'camtoworlds',
               render_ellipse)
  _assert_same(getattr(got, 'render_poses', None),
               getattr(want, 'render_poses', None), 'render_poses', ellipse)
  if hasattr(want, 'focal'):
    assert got.focal == want.focal
  got_batch, want_batch = got.generate_ray_batch(0), want.generate_ray_batch(0)
  _assert_same(got_batch.rgb, want_batch.rgb, 'rgb')
  for key in RAY_FIELDS:
    _assert_same(getattr(got_batch.rays, key), getattr(want_batch.rays, key),
                 f'rays.{key}', render_ellipse)
  got.close()
  return got


@pytest.mark.parametrize('split', ['train', 'test'])
def test_llff_unbounded_matches_jax(tmp_path, split):
  write_capture(str(tmp_path), ring_poses(9))
  got = assert_loaders_match(split, str(tmp_path), (
      'Config.factor = 2', 'Config.llffhold = 4'), ellipse=True)
  assert got.size == (3 if split == 'test' else 6)
  assert got.exposures is not None and got.distortion_params['p1'] != 0


def test_llff_render_path_and_all_images_match_jax(tmp_path):
  write_capture(str(tmp_path), ring_poses(9))
  got = assert_loaders_match('test', str(tmp_path), (
      'Config.factor = 2', 'Config.render_path = True',
      'Config.render_path_frames = 5', 'Config.render_focal = 20.0'),
                             ellipse=True)
  assert got.size == 5 and got.distortion_params is None
  got = assert_loaders_match('test', str(tmp_path), (
      'Config.factor = 2', 'Config.render_path = True',
      'Config.render_path_frames = 5', "Config.render_camtype = 'fisheye'"),
                             ellipse=True)
  assert got.camtype.value == 'fisheye'
  got = assert_loaders_match('train', str(tmp_path), (
      'Config.factor = 2', 'Config.llff_use_all_images_for_training = True',
      'Config.load_alphabetical = False'), ellipse=True)
  assert got.size == 9


@pytest.mark.parametrize('split', ['train', 'test'])
def test_llff_forward_facing_matches_jax(tmp_path, split):
  n = 8
  write_capture(str(tmp_path), forward_poses(n), model_id=1,
                params=OPENCV[:4], originals='png')
  bounds = np.stack([np.linspace(0.9, 1.3, n), np.linspace(6, 9, n)], -1)
  np.save(tmp_path / 'poses_bounds.npy',
          np.concatenate([np.zeros((n, 15)), bounds], -1))
  bindings = ('Config.factor = 2', 'Config.render_path_frames = 6')
  llff = os.path.join(tp.REPO, 'configs', 'llff_256.gin')
  got = assert_loaders_match(split, str(tmp_path), bindings, files=(llff,))
  assert got.pixtocam_ndc is not None and got.exposures is None
  assert got.render_poses.shape == (6, 3, 4)
  got = assert_loaders_match('test', str(tmp_path), bindings + (
      'Config.render_path = True',), files=(llff,))
  assert got.size == 6


def test_llff_spline_path_matches_jax(tmp_path):
  names = write_capture(str(tmp_path), ring_poses(9))
  keyframes = tmp_path / 'keyframes.txt'
  keyframes.write_text('\n'.join(sorted(names)[1:8]))
  got = assert_loaders_match('train', str(tmp_path), (
      'Config.factor = 2', f"Config.render_spline_keyframes = '{keyframes}'",
      'Config.render_spline_n_interp = 2',
      'Config.render_spline_interpolate_exposure = True'))
  assert got.render_poses.shape == (12, 3, 4)
  assert got.render_exposures.shape == (12,)


def test_llff_from_transforms_json_matches_jax(tmp_path):
  n, width, height = 6, 32, 24
  poses = ring_poses(n)
  os.makedirs(tmp_path / 'images')
  os.makedirs(tmp_path / 'images_2')
  rng = np.random.RandomState(4)
  frames = []
  for i in range(n - 1, -1, -1):
    name = f'frame_{i:02d}.png'
    _write_png(tmp_path / 'images' / name, rng.rand(height, width, 3))
    _write_png(tmp_path / 'images_2' / name,
               rng.rand(height // 2, width // 2, 3))
    pose = np.eye(4)
    pose[:3] = poses[i]
    frames.append({'file_path': f'images/{name}',
                   'transform_matrix': pose.tolist()})
  frames.append({'file_path': 'images/missing.png',
                 'transform_matrix': np.eye(4).tolist()})
  meta = {'w': width, 'h': height, 'fl_x': 30.0, 'camera_angle_y': 0.7,
          'cx': 16.5, 'k1': 0.02, 'p2': -0.001, 'frames': frames}
  (tmp_path / 'transforms.json').write_text(json.dumps(meta))
  for got, want in zip(datasets.load_blender_posedata(str(tmp_path)),
                       jdatasets.load_blender_posedata(str(tmp_path))):
    if isinstance(want, np.ndarray):
      np.testing.assert_array_equal(got, want)
    elif hasattr(want, 'value'):
      assert got.value == want.value
    else:
      assert got == want
  got = assert_loaders_match('train', str(tmp_path), (
      'Config.factor = 2', 'Config.llffhold = 3'), ellipse=True)
  assert got.size == 4 and got.distortion_params['k1'] == 0.02


def write_tat_nerfpp(root, seed=5):
  """A Tanks and Temples scene in the NeRF++ layout: 4 train views, 2 test
  views and a 3-pose ``camera_path``, 16 x 12 PNGs."""
  rng = np.random.RandomState(seed)
  for split, n in (('train', 4), ('test', 2), ('camera_path', 3)):
    base = os.path.join(root, split)
    for sub in ('rgb', 'pose', 'intrinsics'):
      os.makedirs(os.path.join(base, sub))
    poses = ring_poses(n)
    for i in range(n):
      if split != 'camera_path':
        _write_png(os.path.join(base, 'rgb', f'{i:06d}.png'),
                   rng.rand(12, 16, 3))
      pose = np.eye(4)
      pose[:3] = poses[i]
      np.savetxt(os.path.join(base, 'pose', f'{i:06d}.txt'), pose.reshape(-1))
      intrinsics = np.eye(4)
      intrinsics[0, 0] = intrinsics[1, 1] = 11.0 + i
      np.savetxt(os.path.join(base, 'intrinsics', f'{i:06d}.txt'),
                 intrinsics.reshape(-1))


@pytest.fixture
def tat_nerfpp_scene(tmp_path):
  write_tat_nerfpp(str(tmp_path))
  return str(tmp_path)


@pytest.mark.parametrize('split,render_path', [
    ('train', False), ('test', False), ('test', True)])
def test_tat_nerfpp_matches_jax(tat_nerfpp_scene, split, render_path):
  got = assert_loaders_match(split, tat_nerfpp_scene, (
      f'Config.render_path = {render_path}',),
                             files=(tp.CONFIG_360, os.path.join(
                                 tp.REPO, 'configs', 'tat.gin')))
  assert got.size == {('train', False): 4, ('test', False): 2,
                      ('test', True): 3}[split, render_path]


@pytest.fixture
def tat_fvs_scene(tmp_path):
  rng = np.random.RandomState(6)
  n = 6
  poses = ring_poses(n)
  for size in ('ibr3d_pw_0.50', 'ibr3d_pw_0.25'):
    base = tmp_path / 'dense' / size
    os.makedirs(base)
    rots, trans = [], []
    for i in range(n):
      _write_png(base / f'im_{i:08d}.png', rng.rand(10, 12, 3))
      w2c = np.linalg.inv(jcam.pad_poses(poses[i][None]))[0]
      rots.append(w2c[:3, :3])
      trans.append(w2c[:3, 3])
    np.save(base / 'Ks.npy',
            np.stack([jcam.intrinsic_matrix(11.0, 11.0, 6.0, 5.0)] * n))
    np.save(base / 'Rs.npy', np.stack(rots))
    np.save(base / 'ts.npy', np.stack(trans))
  return str(tmp_path)


@pytest.mark.parametrize('split,render_path', [
    ('train', False), ('test', False), ('test', True)])
def test_tat_fvs_matches_jax(tat_fvs_scene, split, render_path):
  got = assert_loaders_match(split, tat_fvs_scene, (
      "Config.dataset_loader = 'tat_fvs'", 'Config.factor = 1',
      'Config.llffhold = 3', f'Config.render_path = {render_path}',
      'Config.render_path_frames = 4'), ellipse=True)
  assert got.size == {('train', False): 4, ('test', False): 2,
                      ('test', True): 4}[split, render_path]


@pytest.fixture
def dtu_scene(tmp_path):
  rng = np.random.RandomState(7)
  scan = tmp_path / 'mvs' / 'rect' / 'scan1'
  cal = tmp_path / 'mvs' / 'cal18'
  os.makedirs(scan)
  os.makedirs(cal)
  n = 5
  poses = ring_poses(n)
  for i in range(1, n + 1):
    for light in list(range(7)) + ['max']:
      tag = f'{light}_r5000' if light != 'max' else 'max'
      _write_png(scan / f'rect_{i:03d}_{tag}.png', rng.rand(8, 12, 3))
    k = jcam.intrinsic_matrix(10.0 + i, 10.5, 6.0, 4.0)
    w2c = np.linalg.inv(jcam.pad_poses(poses[i - 1][None]))[0]
    np.savetxt(cal / f'pos_{i:03d}.txt', k @ w2c[:3])
  return str(scan)


@pytest.mark.parametrize('split', ['train', 'test'])
def test_dtu_matches_jax(dtu_scene, split):
  got = assert_loaders_match(split, dtu_scene, (
      "Config.dataset_loader = 'dtu'", 'Config.factor = 2',
      'Config.dtu_light_cond = 3', 'Config.dtuhold = 4', 'Config.near = 0.5',
      'Config.far = 6.0'))
  assert got.size == (2 if split == 'test' else 3)
  assert got.images.shape[1:3] == (4, 6)


def test_load_exif_matches_pillow(tmp_path):
  img = np.random.RandomState(8).rand(16, 16, 3)
  path = str(tmp_path / 'shot.jpg')
  _write_exif_jpeg(path, img, (10, 3000), 640)
  got, want = io_lib.load_exif(path), jio.load_exif(path)
  assert {'ExposureTime', 'ISOSpeedRatings', 'Make'} <= set(got)
  for key, value in got.items():
    if isinstance(want[key], TiffImagePlugin.IFDRational):
      assert float(value) == float(want[key]), key
    else:
      assert value == want[key], key
  # Pillow's own Exif block, parsed as the TIFF block it is.
  exif = Image.Exif()
  exif.get_ifd(0x8769)[0x8827] = 250
  exif[0x0110] = 'Model'
  block = exif.tobytes()
  tags = io_lib.parse_tiff_exif(block[6:] if block[:4] == b'Exif' else block)
  assert tags[0x8827] == 250 and tags[0x0110] == 'Model'
  # PNGs and Exif-less JPEGs have no tags.
  _write_png(tmp_path / 'a.png', img)
  Image.fromarray((img * 255).astype(np.uint8)).save(tmp_path / 'b.jpg')
  for name in ('a.png', 'b.jpg'):
    assert io_lib.load_exif(str(tmp_path / name)) == {} == jio.load_exif(
        str(tmp_path / name))


def test_big_endian_exif():
  # Pillow writes little-endian blocks; a big-endian one is built by hand.
  entries = [(0x829A, 5, 1, 12), (0x8827, 3, 1, 800 << 16)]
  body = struct.pack('>H', len(entries))
  for tag, kind, count, value in entries:
    body += struct.pack('>HHII', tag, kind, count, value)
  # IFD0 at 8: one entry, the Exif sub-IFD's offset (26).
  ifd0 = struct.pack('>H', 1) + struct.pack('>HHII', 0x8769, 4, 1, 26) + (
      struct.pack('>I', 0))
  sub = body + struct.pack('>I', 0)
  tiff = b'MM\x00*' + struct.pack('>I', 8) + ifd0 + sub
  rational_at = len(tiff)
  tiff = tiff.replace(struct.pack('>HHII', 0x829A, 5, 1, 12),
                      struct.pack('>HHII', 0x829A, 5, 1, rational_at))
  tiff += struct.pack('>II', 1, 60)
  tags = io_lib.parse_tiff_exif(tiff)
  assert float(tags[0x829A]) == 1 / 60 and tags[0x8827] == 800


def test_refusals(tmp_path):
  write_capture(str(tmp_path), ring_poses(4))
  # A JPEG pyramid level of arithmetic-coded files: the one JPEG coding
  # (with 12-bit samples) the decoder refuses, naming it.
  src = tmp_path / 'images' / 'IMG_0000.JPG'
  buf = io.BytesIO()
  Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(buf, 'JPEG')
  arithmetic = buf.getvalue().replace(b'\xff\xc0', b'\xff\xc9', 1)
  os.makedirs(tmp_path / 'images_4')
  for name in os.listdir(tmp_path / 'images'):
    (tmp_path / 'images_4' / name).write_bytes(arithmetic)
  _, config = tp.configs(('Config.factor = 4',))
  with pytest.raises(NotImplementedError, match='arithmetic-coded'):
    datasets.load_dataset('train', str(tmp_path), config)
  # The Huffman-coded originals decode to Pillow's array.
  np.testing.assert_array_equal(io_lib.load_img(str(src)),
                                np.asarray(Image.open(src), np.float32))
  # RawNeRF reads raw/, which this capture lacks: JAX's error.
  _, config = tp.configs(('Config.factor = 2', 'Config.rawnerf_mode = True'))
  with pytest.raises(ValueError, match='Raw image folder .*raw does not'):
    datasets.load_dataset('train', str(tmp_path), config)
  # The synthetic scenes are ported (tests/test_torch_glo.py,
  # tests/test_torch_robust.py hold them against JAX).
  for loader, size in (('dummy', 4), ('dummy_sphere', 12),
                       ('dummy_distractor', 24)):
    _, config = tp.configs((f"Config.dataset_loader = '{loader}'",))
    with datasets.load_dataset('train', None, config) as dataset:
      assert dataset.size == size
  _, config = tp.configs(('Config.factor = 2', 'Config.render_path = True',
                          "Config.render_camtype = 'pano'"))
  dataset = datasets.load_dataset('test', str(tmp_path), config)
  # Pano is ported (tests/test_torch_pano.py holds it against JAX): the
  # equirectangular fan over the whole render resolution, unit directions.
  rays = dataset.generate_ray_batch(0).rays
  assert rays.origins.shape == (dataset.height, dataset.width, 3)
  np.testing.assert_allclose(np.linalg.norm(rays.directions, axis=-1), 1,
                             rtol=1e-6)
