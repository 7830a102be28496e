"""The synthetic captures the cells train and render on, the pixel draws
of the train batches and the pinhole ray casting, in plain NumPy.

The reference works every input out again from the seed: the cameras, the
analytic images, which pixels each train step draws (a
``numpy.random.RandomState`` of the data seed, drawn as the capture's
producer draws: x, y, then the camera, per batch) and the rays through
them (mip-NeRF's pixel-center rays with cone radii).  Two scenes:

* ``dummy_unbounded``: nine textured spheres near the origin inside a
  textured shell of radius 60, 48 views of 64 x 64 on two rings; the
  scene that stands in for a 360 capture;
* ``dummy_specular``: a shiny unit sphere (a diffuse texture plus a Phong
  lobe about the reflected view direction) on white, 16 views of 48 x 48,
  with analytic normals; the Ref-NeRF scene.
"""

from __future__ import annotations

import math

import numpy as np


def _normalize(x):
  return x / np.linalg.norm(x)


def viewmatrix(lookdir, up, position):
  vec2 = _normalize(lookdir)
  vec0 = _normalize(np.cross(up, vec2))
  vec1 = _normalize(np.cross(vec2, vec0))
  return np.stack([vec0, vec1, vec2, position], axis=1)


def pixtocam(focal, width, height):
  return np.linalg.inv(np.array([[focal, 0, width * 0.5],
                                 [0, focal, height * 0.5], [0, 0, 1.0]]))


def pixels_to_rays(pix_x, pix_y, pixtocams, camtoworlds):
  """(origins, directions, viewdirs, radii) through pixel centers."""
  probes = np.stack([
      np.stack([pix_x + ox + 0.5, pix_y + oy + 0.5, np.ones_like(pix_x) * 1.0],
               -1) for ox, oy in ((0, 0), (1, 0), (0, 1))], 0)
  cam = np.matmul(pixtocams, probes[..., None])[..., 0]
  cam = np.stack([cam[..., 0], -cam[..., 1], -cam[..., 2]], -1)
  directions, dx, dy = np.matmul(camtoworlds[..., :3, :3], cam[..., None])[
      ..., 0]
  origins = np.broadcast_to(camtoworlds[..., :3, -1], directions.shape)
  norm = lambda v: np.sqrt((v * v).sum(-1))[..., None]
  viewdirs = directions / norm(directions)
  footprint = norm(dx - directions)[..., 0] + norm(dy - directions)[..., 0]
  radii = (0.5 * footprint)[..., None] * 2 / math.sqrt(12)
  return origins, directions, viewdirs, radii


class Scene:
  """Cameras and images of one split."""

  def __init__(self, name, split):
    self.name = name
    test = split == 'test'
    if name == 'dummy_unbounded':
      n, res, focal_mult = 48, 64, 1.2
      heights = lambda i: 1.0 if test else (0.6 if i % 2 == 0 else 1.4)
    elif name == 'dummy_specular':
      n, res, focal_mult = 16, 48, 1.4
      heights = lambda i: 1.25 if test else (0.7 if i % 2 == 0 else 1.6)
    else:
      raise ValueError(name)
    poses = []
    for i in range(n):
      theta = 2 * np.pi * (i + (0.5 if test else 0.0)) / n
      position = np.array([3.5 * np.cos(theta), 3.5 * np.sin(theta),
                           heights(i)])
      poses.append(viewmatrix(position, np.array([0.0, 0.0, 1.0]), position))
    self.camtoworlds = np.stack(poses).astype(np.float32)
    self.width = self.height = res
    self.focal = res * focal_mult
    self.pixtocam = pixtocam(self.focal, res, res)
    self.images = None

  def render_at(self, width, height, focal):
    """This split's cameras at another frame size and focal."""
    self.width, self.height, self.focal = width, height, focal
    self.pixtocam = pixtocam(focal, width, height)
    return self

  def shade_images(self):
    px, py = np.meshgrid(np.arange(self.width), np.arange(self.height),
                         indexing='xy')
    images = []
    for c2w in self.camtoworlds:
      o, _, v, _ = pixels_to_rays(px, py, self.pixtocam, c2w)
      images.append(_shade(self.name, o, v))
    self.images = np.stack(images)
    return self

  def rays(self, pix_x, pix_y, cam_idx, near, far):
    """{name: float32 array} rays of pixels of cameras `cam_idx`."""
    o, d, v, r = pixels_to_rays(pix_x, pix_y, self.pixtocam,
                                self.camtoworlds[cam_idx])
    ones = np.ones(pix_x.shape + (1,), np.float32)
    f32 = lambda a: np.ascontiguousarray(a, np.float32)
    return {'origins': f32(o), 'directions': f32(d), 'viewdirs': f32(v),
            'radii': f32(r), 'near': near * ones, 'far': far * ones}


_CENTERS = np.array([
    [1.0, 0.2, 0.1], [-0.8, 0.7, -0.3], [0.1, -1.1, 0.35],
    [-0.35, -0.45, -0.5], [0.55, 0.95, -0.2], [1.3, -0.6, -0.15],
    [-1.2, -0.9, 0.2], [0.0, 1.3, 0.45], [-0.2, 0.1, 0.75]], np.float32)
_LIGHT = np.array([0.40824829, -0.40824829, 0.81649658], np.float32)


def _shade(name, origins, viewdirs):
  if name == 'dummy_unbounded':
    t_best = np.full(origins.shape[:-1], np.inf, np.float32)
    nearest = np.zeros(origins.shape[:-1], np.int32)
    for k, center in enumerate(_CENTERS):
      oc = origins - center
      b = 2 * np.sum(oc * viewdirs, -1)
      c = np.sum(oc**2, -1) - 0.4**2
      disc = b**2 - 4 * c
      t = np.where(disc > 0, (-b - np.sqrt(np.maximum(disc, 0))) / 2, np.inf)
      t = np.where(t > 0, t, np.inf)
      nearest = np.where(t < t_best, k, nearest)
      t_best = np.minimum(t_best, t)
    hit = np.isfinite(t_best)
    p = origins + np.where(hit, t_best, 0.0)[..., None] * viewdirs
    phase = (2 * np.pi / len(_CENTERS)) * nearest
    texture = 0.5 + 0.5 * np.sin(4.0 * p + phase[..., None])
    b = 2 * np.sum(origins * viewdirs, -1)
    c = np.sum(origins**2, -1) - 60.0**2
    t = (-b + np.sqrt(np.maximum(b**2 - 4 * c, 0.0))) / 2
    q = (origins + t[..., None] * viewdirs) / 60.0
    shell = 0.5 + 0.5 * np.sin(6.0 * q + np.array([0.0, 2.1, 4.2],
                                                   np.float32))
    return np.where(hit[..., None], texture, shell).astype(np.float32)
  b = 2 * np.sum(origins * viewdirs, -1)
  c = np.sum(origins**2, -1) - 1.0
  disc = b**2 - 4 * c
  hit = disc > 0
  t_hit = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0))) / 2, np.inf)
  n = (origins + np.where(hit, t_hit, 0.0)[..., None] * viewdirs).astype(
      np.float32)
  v = -viewdirs
  n_dot_l = np.maximum(0.0, np.sum(n * _LIGHT, -1, keepdims=True))
  diffuse = (0.5 + 0.5 * np.sin(4.0 * n)) * (0.25 + 0.55 * n_dot_l)
  r = 2.0 * np.sum(n * v, -1, keepdims=True) * n - v
  r_dot_l = np.maximum(0.0, np.sum(r * _LIGHT, -1, keepdims=True))
  color = np.clip(diffuse + 0.9 * r_dot_l**32.0, 0.0, 1.0)
  return np.where(hit[..., None], color, 1.0).astype(np.float32)


def train_batches(scene, data_seed, batch_size, batching, near, far, count):
  """The first `count` train batches of the data seed: [(rays, rgb)]."""
  rng = np.random.RandomState(data_seed)
  out = []
  for _ in range(count):
    px = rng.randint(0, scene.width, (batch_size, 1, 1))
    py = rng.randint(0, scene.height, (batch_size, 1, 1))
    if batching == 'all_images':
      cam = rng.randint(0, len(scene.camtoworlds), (batch_size, 1, 1))
    else:
      cam = rng.randint(0, len(scene.camtoworlds), (1,))
    rays = scene.rays(px[:, 0, 0], py[:, 0, 0],
                      cam[:, 0, 0] if cam.ndim == 3 else cam[0], near, far)
    rgb = scene.images[cam, py, px].reshape(batch_size, 3)
    out.append((rays, rgb))
  return out
