"""A reader for COLMAP sparse reconstructions (port of data/colmap.py).

Parses ``cameras.bin`` / ``images.bin`` (or their ``.txt`` equivalents)
and turns the model into the NeRF convention: camera-to-world poses with
(right, up, back) axes, the shared inverse intrinsics, the distortion
parameters and the projection type.  Pure numpy, the same arithmetic as
the JAX package's reader, so both give the same bits.

Binary format reference: COLMAP src/colmap/scene/reconstruction_io.cc.
"""

from __future__ import annotations

import os
import struct
from typing import Mapping, Optional, Tuple

import numpy as np

from multinerf_tpu_torch.data import cameras as camera_lib

# model_id -> (name, num_params)
CAMERA_MODELS = {
    0: ('SIMPLE_PINHOLE', 3),   # f, cx, cy
    1: ('PINHOLE', 4),          # fx, fy, cx, cy
    2: ('SIMPLE_RADIAL', 4),    # f, cx, cy, k1
    3: ('RADIAL', 5),           # f, cx, cy, k1, k2
    4: ('OPENCV', 8),           # fx, fy, cx, cy, k1, k2, p1, p2
    5: ('OPENCV_FISHEYE', 8),   # fx, fy, cx, cy, k1, k2, k3, k4
    6: ('FULL_OPENCV', 12),
    7: ('FOV', 5),
    8: ('SIMPLE_RADIAL_FISHEYE', 4),
    9: ('RADIAL_FISHEYE', 5),
    10: ('THIN_PRISM_FISHEYE', 12),
}
_NAME_TO_ID = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


class Camera:
  """One COLMAP camera: intrinsics + distortion params."""

  def __init__(self, camera_id, model_id, width, height, params):
    self.camera_id = camera_id
    self.model_id = model_id
    self.model_name = CAMERA_MODELS[model_id][0]
    self.width = width
    self.height = height
    self.params = np.asarray(params, np.float64)

  @property
  def fx(self):
    return self.params[0]

  @property
  def fy(self):
    # Single-focal models store f once.
    return self.params[0] if self.model_name.startswith('SIMPLE') else (
        self.params[1])

  @property
  def cx(self):
    return self.params[1] if self.model_name.startswith('SIMPLE') else (
        self.params[2])

  @property
  def cy(self):
    return self.params[2] if self.model_name.startswith('SIMPLE') else (
        self.params[3])

  def distortion(self) -> Optional[Mapping[str, float]]:
    """Distortion params in the framework's undistortion convention."""
    name, p = self.model_name, self.params
    if name in ('SIMPLE_PINHOLE', 'PINHOLE'):
      return None
    base = {k: 0.0 for k in ['k1', 'k2', 'k3', 'p1', 'p2']}
    if name == 'SIMPLE_RADIAL':
      base['k1'] = p[3]
    elif name == 'RADIAL':
      base['k1'], base['k2'] = p[3], p[4]
    elif name == 'OPENCV':
      base['k1'], base['k2'], base['p1'], base['p2'] = p[4], p[5], p[6], p[7]
    elif name == 'OPENCV_FISHEYE':
      return {'k1': p[4], 'k2': p[5], 'k3': p[6], 'k4': p[7]}
    else:
      raise NotImplementedError(f'COLMAP camera model {name} not supported')
    return base

  def projection_type(self) -> camera_lib.ProjectionType:
    if self.model_name == 'OPENCV_FISHEYE':
      return camera_lib.ProjectionType.FISHEYE
    return camera_lib.ProjectionType.PERSPECTIVE


class Image:
  """One registered COLMAP image: pose (world-to-camera) + name."""

  def __init__(self, image_id, qvec, tvec, camera_id, name):
    self.image_id = image_id
    self.qvec = np.asarray(qvec, np.float64)  # (w, x, y, z)
    self.tvec = np.asarray(tvec, np.float64)
    self.camera_id = camera_id
    self.name = name

  def rotmat(self) -> np.ndarray:
    """World-to-camera rotation from the (w,x,y,z) quaternion."""
    w, x, y, z = self.qvec / np.linalg.norm(self.qvec)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _read(f, fmt):
  return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_bin(path: str) -> Mapping[int, Camera]:
  cameras = {}
  with open(path, 'rb') as f:
    (num,) = _read(f, '<Q')
    for _ in range(num):
      camera_id, model_id, width, height = _read(f, '<iiQQ')
      n_params = CAMERA_MODELS[model_id][1]
      params = _read(f, f'<{n_params}d')
      cameras[camera_id] = Camera(camera_id, model_id, width, height, params)
  return cameras


def read_images_bin(path: str) -> Mapping[int, Image]:
  images = {}
  with open(path, 'rb') as f:
    (num,) = _read(f, '<Q')
    for _ in range(num):
      image_id = _read(f, '<i')[0]
      qvec = _read(f, '<4d')
      tvec = _read(f, '<3d')
      camera_id = _read(f, '<i')[0]
      name = b''
      while True:
        c = f.read(1)
        if c == b'\x00':
          break
        name += c
      (num_points,) = _read(f, '<Q')
      # Skip 2D point observations: x, y (double) + point3D id (int64).
      f.seek(24 * num_points, os.SEEK_CUR)
      images[image_id] = Image(image_id, qvec, tvec, camera_id,
                               name.decode('utf-8'))
  return images


def read_cameras_txt(path: str) -> Mapping[int, Camera]:
  cameras = {}
  with open(path) as f:
    for line in f:
      line = line.strip()
      if not line or line.startswith('#'):
        continue
      parts = line.split()
      camera_id = int(parts[0])
      model_id = _NAME_TO_ID[parts[1]]
      width, height = int(parts[2]), int(parts[3])
      params = [float(x) for x in parts[4:]]
      cameras[camera_id] = Camera(camera_id, model_id, width, height, params)
  return cameras


def read_images_txt(path: str) -> Mapping[int, Image]:
  images = {}
  with open(path) as f:
    # Two lines per image: metadata, then the 2D point list (which may be
    # completely empty, so pairing must keep blank lines).
    lines = [ln.strip() for ln in f if not ln.startswith('#')]
  for meta in lines[0::2]:
    if not meta:
      continue
    parts = meta.split()
    image_id = int(parts[0])
    qvec = [float(x) for x in parts[1:5]]
    tvec = [float(x) for x in parts[5:8]]
    camera_id = int(parts[8])
    name = parts[9]
    images[image_id] = Image(image_id, qvec, tvec, camera_id, name)
  return images


def load_model(sparse_dir: str) -> Tuple[Mapping[int, Camera],
                                         Mapping[int, Image]]:
  """Load cameras/images from a sparse model dir (binary or text)."""
  if os.path.exists(os.path.join(sparse_dir, 'cameras.bin')):
    cameras = read_cameras_bin(os.path.join(sparse_dir, 'cameras.bin'))
    images = read_images_bin(os.path.join(sparse_dir, 'images.bin'))
  elif os.path.exists(os.path.join(sparse_dir, 'cameras.txt')):
    cameras = read_cameras_txt(os.path.join(sparse_dir, 'cameras.txt'))
    images = read_images_txt(os.path.join(sparse_dir, 'images.txt'))
  else:
    raise FileNotFoundError(f'No COLMAP model found in {sparse_dir}')
  return cameras, images


def process_scene(sparse_dir: str):
  """COLMAP model -> NeRF-convention scene description.

  Mirrors NeRFSceneManager.process (reference datasets.py:62-150): assumes
  shared intrinsics, converts world-to-camera to camera-to-world, and flips
  from COLMAP (right, down, fwd) to NeRF (right, up, back) axes.

  Returns:
    (image_names, poses [N,3,4], pixtocam [3,3], distortion_params or None,
     ProjectionType).
  """
  cameras, images = load_model(sparse_dir)

  cam = cameras[min(cameras.keys())]
  pixtocam = np.linalg.inv(
      camera_lib.intrinsic_matrix(cam.fx, cam.fy, cam.cx, cam.cy))

  bottom = np.array([0, 0, 0, 1.0]).reshape(1, 4)
  w2c_mats = []
  names = []
  for k in images:
    im = images[k]
    w2c = np.concatenate(
        [np.concatenate([im.rotmat(), im.tvec.reshape(3, 1)], 1), bottom],
        axis=0)
    w2c_mats.append(w2c)
    names.append(im.name)
  w2c_mats = np.stack(w2c_mats, axis=0)
  poses = np.linalg.inv(w2c_mats)[:, :3, :4]

  # COLMAP (right, down, forward) -> NeRF (right, up, back).
  poses = poses @ np.diag([1, -1, -1, 1])

  return names, poses, pixtocam, cam.distortion(), cam.projection_type()
