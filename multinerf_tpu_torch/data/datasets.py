"""Datasets of the render and train paths (port of parts of datasets.py).

``Dataset`` holds a split's cameras, camera type, image size, near/far and
exposure records, and is an iterator of host batches (datasets.py:93-300 of
the JAX package).  A train split yields random ray batches (``_next_train``):
pixels and cameras drawn from the dataset's own
``np.random.RandomState(seed)``, rays cast on the host with numpy as in the
JAX package.  A test split yields one whole view per batch (``_next_test``),
its cameras in turn, with the view's ground-truth ``rgb``.  With
``Config.compute_disp_metrics`` / ``compute_normal_metrics`` a batch also
carries the pixels' ``disps``, or ``normals`` and ``alphas``
(datasets.py:246-253).  As in the JAX loader, a daemon thread makes the
batches into a queue of 3; it starts at the first ``next()`` and is the
only user of the random state, so the draws come in the order a
synchronous loop would make them.  ``close()`` (or leaving a ``with``
block) stops it.  The synthetic scenes ``dummy_scatter``,
``dummy_unbounded`` and ``dummy_specular`` are made with the same numpy as
the JAX loaders (datasets.py:842-959, 995-1079), so both packages see
identical cameras, images and ground truth.  ``blender`` reads
``transforms_{split}.json`` and its PNGs with the port's own PNG reader
(``utils/io.py``).
"""

from __future__ import annotations

import abc
import json
import os
import queue
import threading

import numpy as np

from multinerf_tpu_torch.data import cameras as camera_lib
from multinerf_tpu_torch.data import types
from multinerf_tpu_torch.ops import image_ops
from multinerf_tpu_torch.utils import io as io_lib


def load_dataset(split, train_dir, config, seed=0):
  """Load a split of a dataset using config.dataset_loader; `seed` seeds
  the train split's pixel draws."""
  loaders = {
      'blender': Blender,
      'dummy_scatter': DummyScatter,
      'dummy_unbounded': DummyUnbounded,
      'dummy_specular': DummySpecular,
  }
  if config.dataset_loader not in loaders:
    raise NotImplementedError(
        f'Not ported yet: dataset_loader={config.dataset_loader!r} '
        '(ROADMAP.md Queue 1: the rest of the model zoo, loaders).')
  return loaders[config.dataset_loader](split, train_dir, config, seed=seed)


class Dataset(metaclass=abc.ABCMeta):
  """Cameras and render settings of one split (see datasets.py:93-300)."""

  def __init__(self, split: str, data_dir: str, config, seed=0):
    self.split = types.DataSplit(split)
    self._rng = np.random.RandomState(seed)
    self._queue = queue.Queue(3)  # Prefetch buffer of 3 batches.
    self._stop = threading.Event()
    self._thread = None
    self._test_camera_idx = 0
    self._patch_size = max(config.patch_size, 1)
    self._batch_size = config.batch_size
    if self._patch_size**2 > self._batch_size:
      raise ValueError(f'Patch size {self._patch_size}^2 too large for '
                       f'batch size {self._batch_size}')
    self._batching = types.BatchingMethod(config.batching)
    self._load_disps = config.compute_disp_metrics
    self._load_normals = config.compute_normal_metrics
    self._num_border_pixels_to_mask = config.num_border_pixels_to_mask
    if config.apply_bayer_mask:
      raise NotImplementedError(
          'Not ported yet: the Bayer mask (ROADMAP.md Queue 1: the rest of '
          'the model zoo, RawNeRF).')
    self.data_dir = data_dir
    self.near = config.near
    self.far = config.far
    self.render_path = config.render_path
    self.distortion_params = None
    self.disp_images = None
    self.normal_images = None
    self.alphas = None
    self.pixtocam_ndc = None
    self.metadata = None
    self.camtype = camera_lib.ProjectionType.PERSPECTIVE
    self.exposures = None
    self.render_exposures = None
    self._render_spherical = False

    # Set by _load_renderings:
    self.images: np.ndarray = None
    self.camtoworlds: np.ndarray = None
    self.pixtocams: np.ndarray = None
    self.height: int = None
    self.width: int = None

    self._load_renderings(config)

    if self.render_path:
      if config.render_path_file is not None:
        with open(config.render_path_file, 'rb') as fp:
          self.camtoworlds = np.load(fp)
      if config.render_resolution is not None:
        self.width, self.height = config.render_resolution
      if config.render_focal is not None:
        self.focal = config.render_focal
      if config.render_camtype is not None:
        if config.render_camtype == 'pano':
          self._render_spherical = True
        else:
          self.camtype = camera_lib.ProjectionType(config.render_camtype)
      self.distortion_params = None
      self.pixtocams = camera_lib.get_pixtocam(self.focal, self.width,
                                               self.height)

    self._n_examples = self.camtoworlds.shape[0]
    self.cameras = (self.pixtocams, self.camtoworlds,
                    self.distortion_params, self.pixtocam_ndc)

  @property
  def size(self):
    return self._n_examples

  def __iter__(self):
    return self

  def __next__(self) -> types.Batch:
    """The next host batch (numpy arrays): random rays (patch-shaped) of a
    train split, or the next whole view of a test split."""
    if self._stop.is_set():
      raise StopIteration
    if self._thread is None:
      self._thread = threading.Thread(target=self._produce, daemon=True)
      self._thread.start()
    batch = self._queue.get()
    if isinstance(batch, Exception):
      raise batch
    return batch

  def _produce(self):
    """The producer thread: batches into the queue until close()."""
    next_fn = (self._next_train if self.split == types.DataSplit.TRAIN
               else self._next_test)
    while not self._stop.is_set():
      try:
        batch = next_fn()
      except Exception as e:
        batch = e  # Raised by the consumer's next().
      while not self._stop.is_set():
        try:
          self._queue.put(batch, timeout=0.1)
          break
        except queue.Full:
          pass
      if isinstance(batch, Exception):
        return

  def close(self):
    """Stop the producer thread and wait for it."""
    self._stop.set()
    if self._thread is not None:
      self._thread.join()

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()

  @abc.abstractmethod
  def _load_renderings(self, config):
    """Load images/poses; must set the attributes listed in __init__."""

  def exposure_records(self, cam_idx):
    """Exposure ray fields for camera(s) `cam_idx` (datasets.py:202-223)."""
    out = {}
    if self.metadata is not None:
      idx = 0 if self.render_path else cam_idx
      for key in ['exposure_idx', 'exposure_values']:
        out[key] = np.asarray(self.metadata[key])[idx]
    if self.exposures is not None:
      idx = 0 if self.render_path else cam_idx
      out['exposure_values'] = np.asarray(self.exposures)[idx]
    if self.render_path and self.render_exposures is not None:
      out['exposure_values'] = np.asarray(self.render_exposures)[cam_idx]
    return out

  def _make_ray_batch(self, pix_x_int, pix_y_int, cam_idx,
                      lossmult=None) -> types.Batch:
    """A Batch of host rays from pixel coordinates and camera indices."""
    broadcast_scalar = lambda x: np.broadcast_to(x, pix_x_int.shape)[..., None]
    ray_kwargs = {
        'lossmult': broadcast_scalar(1.0) if lossmult is None else lossmult,
        # Floats even where the config gives integers (blender's 2 and 6).
        'near': broadcast_scalar(float(self.near)),
        'far': broadcast_scalar(float(self.far)),
        'cam_idx': broadcast_scalar(cam_idx),
    }
    for key, val in self.exposure_records(cam_idx).items():
      ray_kwargs[key] = broadcast_scalar(val)
    pixels = types.Pixels(pix_x_int, pix_y_int, **ray_kwargs)
    rays = camera_lib.cast_ray_batch(self.cameras, pixels, self.camtype,
                                     xnp=np)
    batch = {'rays': rays}
    if not self.render_path:
      batch['rgb'] = self.images[cam_idx, pix_y_int, pix_x_int]
    if self._load_disps:
      batch['disps'] = self.disp_images[cam_idx, pix_y_int, pix_x_int]
    if self._load_normals:
      batch['normals'] = self.normal_images[cam_idx, pix_y_int, pix_x_int]
      batch['alphas'] = self.alphas[cam_idx, pix_y_int, pix_x_int]
    return types.Batch(**batch)

  def _next_train(self) -> types.Batch:
    """Random rays (patch_size 1) or patches, all images one resolution."""
    num_patches = self._batch_size // self._patch_size**2
    lower_border = self._num_border_pixels_to_mask
    upper_border = self._num_border_pixels_to_mask + self._patch_size - 1
    pix_x_int = self._rng.randint(lower_border, self.width - upper_border,
                                  (num_patches, 1, 1))
    pix_y_int = self._rng.randint(lower_border, self.height - upper_border,
                                  (num_patches, 1, 1))
    # Offsets broadcast each patch origin to (patch_size, patch_size).
    patch_dx_int, patch_dy_int = camera_lib.pixel_coordinates(
        self._patch_size, self._patch_size)
    pix_x_int = pix_x_int + patch_dx_int
    pix_y_int = pix_y_int + patch_dy_int
    if self._batching == types.BatchingMethod.ALL_IMAGES:
      cam_idx = self._rng.randint(0, self._n_examples, (num_patches, 1, 1))
    else:
      cam_idx = self._rng.randint(0, self._n_examples, (1,))
    return self._make_ray_batch(pix_x_int, pix_y_int, cam_idx)

  def generate_ray_batch(self, cam_idx: int) -> types.Batch:
    """The rays of every pixel of camera `cam_idx`, [H, W] batch dims."""
    if self._render_spherical:
      raise NotImplementedError(
          'Not ported yet: pano rendering (ROADMAP.md Queue 1: serving '
          'slice, deferred items).')
    pix_x_int, pix_y_int = camera_lib.pixel_coordinates(self.width,
                                                        self.height)
    return self._make_ray_batch(pix_x_int, pix_y_int, cam_idx)

  def _next_test(self) -> types.Batch:
    """One whole view, the cameras in turn."""
    cam_idx = self._test_camera_idx
    self._test_camera_idx = (self._test_camera_idx + 1) % self._n_examples
    return self.generate_ray_batch(cam_idx)


class Blender(Dataset):
  """Blender synthetic scenes (transforms_{split}.json, datasets.py:302-356):
  RGBA PNGs over a white background, ``_normal.png`` ground truth."""

  def _load_renderings(self, config):
    later = 'ROADMAP.md Queue 1 item 4: the rest of the model zoo, loaders'
    if config.render_path:
      raise ValueError('render_path cannot be used for the blender dataset.')
    if config.use_tiffs or self._load_disps:
      raise NotImplementedError(
          'Not ported yet: the TIFF images of the blender loader '
          f'(Config.use_tiffs, _disp.tiff for compute_disp_metrics; {later}).')
    pose_file = os.path.join(self.data_dir,
                             f'transforms_{self.split.value}.json')
    with open(pose_file, 'r') as fp:
      meta = json.load(fp)
    images = []
    normal_images = []
    cams = []
    for frame in meta['frames']:
      fprefix = os.path.join(self.data_dir, frame['file_path'])

      def get_img(f, fprefix=fprefix):
        image = io_lib.load_img(fprefix + f)
        if config.factor > 1:
          image = image_ops.downsample(image, config.factor)
        return image

      images.append(get_img('.png') / 255.0)
      if self._load_normals:
        normal_images.append(get_img('_normal.png')[..., :3] * 2.0 / 255.0 -
                             1.0)
      cams.append(np.array(frame['transform_matrix'], dtype=np.float32))

    self.images = np.stack(images, axis=0)
    if self._load_normals:
      self.normal_images = np.stack(normal_images, axis=0)
      self.alphas = self.images[..., -1]

    rgb, alpha = self.images[..., :3], self.images[..., -1:]
    self.images = rgb * alpha + (1.0 - alpha)  # White background.
    self.height, self.width = self.images.shape[1:3]
    self.camtoworlds = np.stack(cams, axis=0)
    self.focal = 0.5 * self.width / np.tan(
        0.5 * float(meta['camera_angle_x']))
    self.pixtocams = camera_lib.get_pixtocam(self.focal, self.width,
                                             self.height)


class DummyScatter(Dataset):
  """Small spheres scattered in mostly empty space, analytic ground truth."""

  NUM_IMAGES = 24
  RESOLUTION = 48
  RADIUS = 0.4
  CENTERS = np.array([
      [1.0, 0.2, 0.1], [-0.8, 0.7, -0.3], [0.1, -1.1, 0.35],
      [-0.35, -0.45, -0.5], [0.55, 0.95, -0.2],
  ], dtype=np.float32)

  def _load_renderings(self, config):
    n = self.NUM_IMAGES
    res = self.RESOLUTION
    test = self.split == types.DataSplit.TEST

    poses = []
    for i in range(n):
      theta = 2 * np.pi * (i + (0.5 if test else 0.0)) / n
      # Train views alternate between two heights; the test ring sits
      # between them at an offset azimuth.
      height = 1.0 if test else (0.6 if i % 2 == 0 else 1.4)
      position = np.array(
          [3.5 * np.cos(theta), 3.5 * np.sin(theta), height])
      poses.append(camera_lib.viewmatrix(
          lookdir=position, up=np.array([0.0, 0.0, 1.0]), position=position))
    self.camtoworlds = np.stack(poses).astype(np.float32)
    self.height = self.width = res
    self.focal = res * 1.2
    self.pixtocams = camera_lib.get_pixtocam(self.focal, self.width,
                                             self.height)

    images = []
    for i in range(n):
      pix_x, pix_y = camera_lib.pixel_coordinates(res, res)
      origins, _, viewdirs, _, _ = camera_lib.pixels_to_rays(
          pix_x, pix_y, self.pixtocams, self.camtoworlds[i], xnp=np)
      # Nearest positive ray-sphere hit across all spheres.
      t_best = np.full(origins.shape[:-1], np.inf, np.float32)
      nearest = np.zeros(origins.shape[:-1], np.int32)
      for k, center in enumerate(self.CENTERS):
        oc = origins - center
        b = 2 * np.sum(oc * viewdirs, -1)
        c = np.sum(oc ** 2, -1) - self.RADIUS ** 2
        disc = b ** 2 - 4 * c
        t = np.where(disc > 0, (-b - np.sqrt(np.maximum(disc, 0))) / 2,
                     np.inf)
        t = np.where(t > 0, t, np.inf)
        nearest = np.where(t < t_best, k, nearest)
        t_best = np.minimum(t_best, t)
      hit = np.isfinite(t_best)
      t_safe = np.where(hit, t_best, 0.0)
      p = origins + t_safe[..., None] * viewdirs
      phase = (2 * np.pi / len(self.CENTERS)) * nearest
      texture = 0.5 + 0.5 * np.sin(4.0 * p + phase[..., None])
      images.append(
          np.where(hit[..., None], texture,
                   self._miss_color(origins, viewdirs)).astype(np.float32))
    self.images = np.stack(images)

  def _miss_color(self, origins, viewdirs):
    """Color for rays that miss every sphere (white)."""
    del origins, viewdirs
    return np.float32(1.0)


class DummyUnbounded(DummyScatter):
  """DummyScatter plus a textured radius-60 shell: an unbounded scene."""

  NUM_IMAGES = 48
  RESOLUTION = 64
  SHELL_RADIUS = 60.0
  CENTERS = np.array([
      [1.0, 0.2, 0.1], [-0.8, 0.7, -0.3], [0.1, -1.1, 0.35],
      [-0.35, -0.45, -0.5], [0.55, 0.95, -0.2], [1.3, -0.6, -0.15],
      [-1.2, -0.9, 0.2], [0.0, 1.3, 0.45], [-0.2, 0.1, 0.75],
  ], dtype=np.float32)

  def _miss_color(self, origins, viewdirs):
    # Cameras sit inside the shell, so its far root always exists.
    b = 2 * np.sum(origins * viewdirs, -1)
    c = np.sum(origins ** 2, -1) - self.SHELL_RADIUS ** 2
    t = (-b + np.sqrt(np.maximum(b ** 2 - 4 * c, 0.0))) / 2
    q = (origins + t[..., None] * viewdirs) / self.SHELL_RADIUS
    phases = np.array([0.0, 2.1, 4.2], np.float32)
    return (0.5 + 0.5 * np.sin(6.0 * q + phases)).astype(np.float32)


class DummySpecular(Dataset):
  """A shiny unit sphere, the Ref-NeRF scene of datasets.py:995-1079: a
  diffuse texture plus a Phong lobe around the reflected view direction,
  with analytic normals, hit masks and disparities; white background,
  near/far 2/6, train and test cameras on different rings."""

  NUM_IMAGES = 16
  RESOLUTION = 48
  LIGHT = np.array([0.40824829, -0.40824829, 0.81649658], np.float32)
  SHININESS = 32.0

  @staticmethod
  def sphere_hits(origins, viewdirs):
    """Nearest unit-sphere intersection: (normals, hit mask, distance)."""
    b = 2 * np.sum(origins * viewdirs, -1)
    c = np.sum(origins ** 2, -1) - 1.0
    disc = b ** 2 - 4 * c
    hit = disc > 0
    t_hit = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0))) / 2, np.inf)
    t_safe = np.where(hit, t_hit, 0.0)
    normals = origins + t_safe[..., None] * viewdirs  # Unit: |p| = 1 at hit.
    return normals.astype(np.float32), hit, t_hit

  @classmethod
  def shade(cls, normals, viewdirs, hit):
    """Diffuse texture + Phong specular lobe; white at misses."""
    n = normals
    v = -viewdirs  # Surface -> camera.
    n_dot_l = np.maximum(0.0, np.sum(n * cls.LIGHT, -1, keepdims=True))
    albedo = 0.5 + 0.5 * np.sin(4.0 * n)
    diffuse = albedo * (0.25 + 0.55 * n_dot_l)
    r = 2.0 * np.sum(n * v, -1, keepdims=True) * n - v
    r_dot_l = np.maximum(0.0, np.sum(r * cls.LIGHT, -1, keepdims=True))
    specular = 0.9 * r_dot_l ** cls.SHININESS
    color = np.clip(diffuse + specular, 0.0, 1.0)
    return np.where(hit[..., None], color, 1.0).astype(np.float32)

  def _load_renderings(self, config):
    n = self.NUM_IMAGES
    res = self.RESOLUTION
    test = self.split == types.DataSplit.TEST

    poses = []
    for i in range(n):
      theta = 2 * np.pi * (i + (0.5 if test else 0.0)) / n
      height = 1.25 if test else (0.7 if i % 2 == 0 else 1.6)
      position = np.array(
          [3.5 * np.cos(theta), 3.5 * np.sin(theta), height])
      poses.append(camera_lib.viewmatrix(
          lookdir=position, up=np.array([0.0, 0.0, 1.0]), position=position))
    self.camtoworlds = np.stack(poses).astype(np.float32)
    self.height = self.width = res
    self.focal = res * 1.4
    self.pixtocams = camera_lib.get_pixtocam(self.focal, self.width,
                                             self.height)

    images, normal_maps, alpha_maps, disps = [], [], [], []
    for i in range(n):
      pix_x, pix_y = camera_lib.pixel_coordinates(res, res)
      origins, _, viewdirs, _, _ = camera_lib.pixels_to_rays(
          pix_x, pix_y, self.pixtocams, self.camtoworlds[i], xnp=np)
      normals, hit, t_hit = self.sphere_hits(origins, viewdirs)
      images.append(self.shade(normals, viewdirs, hit))
      normal_maps.append(np.where(hit[..., None], normals, 0.0))
      alpha_maps.append(hit.astype(np.float32))
      disps.append((1.0 / np.maximum(np.where(hit, t_hit, np.inf), 1e-3))
                   .astype(np.float32))
    self.images = np.stack(images)
    # The analytic normals and alphas always exist, as in the JAX loader.
    self.normal_images = np.stack(normal_maps).astype(np.float32)
    self.alphas = np.stack(alpha_maps)
    if self._load_disps:
      self.disp_images = np.stack(disps)
