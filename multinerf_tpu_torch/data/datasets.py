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
block) stops it.  The synthetic scenes ``dummy``, ``dummy_sphere``,
``dummy_scatter``, ``dummy_unbounded``, ``dummy_distractor`` (with its
``distractor_masks``) and ``dummy_specular`` are made with the same numpy
as the JAX loaders (datasets.py:736-1079), so both packages see identical
cameras, images and ground truth.  With ``Config.apply_bayer_mask`` a train
batch's ``lossmult`` is the RGGB mask of its pixels (``data/raw.py``).  ``blender`` reads
``transforms_{split}.json`` and its PNGs (or TIFFs) with the port's own
readers (``utils/io.py``).  The capture loaders (datasets.py:56-90,
358-733) read
real scenes the same way: ``llff`` (COLMAP's ``sparse/0`` or a
``transforms.json``, an ``images_N`` pyramid, Exif exposures, forward-facing
NDC with a spiral path or a PCA-aligned unbounded scene with an ellipse or
spline path; with ``Config.rawnerf_mode`` the raw mosaics of ``raw/``
and their exposure metadata, HDR+ test scenes included), ``tat_nerfpp``,
``tat_fvs`` and ``dtu``.  Images are PNGs, JPEGs or TIFFs, read into the
arrays Pillow gives (``utils/io.py``, ``utils/jpeg.py``).
"""

from __future__ import annotations

import abc
import concurrent.futures
import json
import os
import queue
import threading

import numpy as np

from multinerf_tpu_torch.data import cameras as camera_lib
from multinerf_tpu_torch.data import colmap
from multinerf_tpu_torch.data import raw as raw_lib
from multinerf_tpu_torch.data import types
from multinerf_tpu_torch.ops import image_ops
from multinerf_tpu_torch.parallel import mesh
from multinerf_tpu_torch.utils import io as io_lib


def load_dataset(split, train_dir, config, seed=0):
  """Load a split of a dataset using config.dataset_loader; `seed` seeds
  the train split's pixel draws.  Across ranks a train batch is this rank's
  ``config.batch_size / world size`` rays (datasets.py:108)."""
  loaders = {
      'blender': Blender,
      'llff': LLFF,
      'tat_nerfpp': TanksAndTemplesNerfPP,
      'tat_fvs': TanksAndTemplesFVS,
      'dtu': DTU,
      'dummy': Dummy,
      'dummy_sphere': DummySphere,
      'dummy_scatter': DummyScatter,
      'dummy_unbounded': DummyUnbounded,
      'dummy_specular': DummySpecular,
      'dummy_distractor': DummyDistractor,
  }
  return loaders[config.dataset_loader](split, train_dir, config, seed=seed)


def load_blender_posedata(data_dir, split=None):
  """Poses and intrinsics of a Blender/NGP ``transforms.json``
  (datasets.py:56-90): (names, poses, pixtocam, distortion, camtype)."""
  suffix = '' if split is None else f'_{split}'
  pose_file = os.path.join(data_dir, f'transforms{suffix}.json')
  with open(pose_file, 'r') as fp:
    meta = json.load(fp)
  names = []
  poses = []
  for frame in meta['frames']:
    filepath = os.path.join(data_dir, frame['file_path'])
    if os.path.exists(filepath):
      names.append(frame['file_path'].split('/')[-1])
      poses.append(np.array(frame['transform_matrix'], dtype=np.float32))
  poses = np.stack(poses, axis=0)

  w = meta['w']
  h = meta['h']
  cx = meta.get('cx', w / 2.0)
  cy = meta.get('cy', h / 2.0)
  if 'fl_x' in meta:
    fx = meta['fl_x']
  else:
    fx = 0.5 * w / np.tan(0.5 * float(meta['camera_angle_x']))
  if 'fl_y' in meta:
    fy = meta['fl_y']
  else:
    fy = 0.5 * h / np.tan(0.5 * float(meta['camera_angle_y']))
  pixtocam = np.linalg.inv(camera_lib.intrinsic_matrix(fx, fy, cx, cy))
  coeffs = ['k1', 'k2', 'p1', 'p2']
  if not any(c in meta for c in coeffs):
    params = None
  else:
    params = {c: meta.get(c, 0.0) for c in coeffs}
  camtype = camera_lib.ProjectionType.PERSPECTIVE
  return names, poses, pixtocam, params, camtype


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
    self._batch_size = mesh.process_local_slice(config.batch_size)
    if self._patch_size**2 > self._batch_size:
      raise ValueError(f'Patch size {self._patch_size}^2 too large for '
                       f'per-process batch size {self._batch_size}')
    self._batching = types.BatchingMethod(config.batching)
    self._load_disps = config.compute_disp_metrics
    self._load_normals = config.compute_normal_metrics
    self._num_border_pixels_to_mask = config.num_border_pixels_to_mask
    self._apply_bayer_mask = config.apply_bayer_mask
    self._cast_rays_in_train_step = config.cast_rays_in_train_step
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
    if self._cast_rays_in_train_step and self.split == types.DataSplit.TRAIN:
      rays = pixels  # Cast on the device by the train step.
    else:
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
    lossmult = None
    if self._apply_bayer_mask:
      # RawNeRF: each pixel's loss on its own channel of the RGGB mosaic.
      lossmult = raw_lib.pixels_to_bayer_mask(pix_x_int, pix_y_int)
    return self._make_ray_batch(pix_x_int, pix_y_int, cam_idx,
                                lossmult=lossmult)

  def generate_ray_batch(self, cam_idx: int) -> types.Batch:
    """The rays of every pixel of camera `cam_idx`, [H, W] batch dims: a
    pano camera's spherical fan under ``Config.render_camtype = 'pano'``."""
    if self._render_spherical:
      rays = camera_lib.cast_spherical_rays(
          self.camtoworlds[cam_idx], self.height, self.width, self.near,
          self.far, xnp=np)
      return types.Batch(rays=rays)
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
  RGBA PNGs over a white background (or, with ``Config.use_tiffs``, linear
  ``_R/_G/_B/_A.tiff`` channels taken to sRGB), ``_disp.tiff`` disparities
  for ``Config.compute_disp_metrics``, ``_normal.png`` ground truth."""

  def _load_renderings(self, config):
    if config.render_path:
      raise ValueError('render_path cannot be used for the blender dataset.')
    pose_file = os.path.join(self.data_dir,
                             f'transforms_{self.split.value}.json')
    with open(pose_file, 'r') as fp:
      meta = json.load(fp)
    images = []
    disp_images = []
    normal_images = []
    cams = []
    for frame in meta['frames']:
      fprefix = os.path.join(self.data_dir, frame['file_path'])

      def get_img(f, fprefix=fprefix):
        image = io_lib.load_img(fprefix + f)
        if config.factor > 1:
          image = image_ops.downsample(image, config.factor)
        return image

      if config.use_tiffs:
        channels = [get_img(f'_{ch}.tiff') for ch in 'RGBA']
        images.append(image_ops.linear_to_srgb(np.stack(channels, axis=-1)))
      else:
        images.append(get_img('.png') / 255.0)
      if self._load_disps:
        disp_images.append(get_img('_disp.tiff'))
      if self._load_normals:
        normal_images.append(get_img('_normal.png')[..., :3] * 2.0 / 255.0 -
                             1.0)
      cams.append(np.array(frame['transform_matrix'], dtype=np.float32))

    self.images = np.stack(images, axis=0)
    if self._load_disps:
      self.disp_images = np.stack(disp_images, axis=0)
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


class LLFF(Dataset):
  """Real captures with COLMAP poses, the mip-NeRF 360 and LLFF layouts
  (datasets.py:358-534), in four stages: pose recovery, pixel decode, world
  normalization with a render path, split selection."""

  def _downsampling_factor(self, config):
    """The image pyramid level to read: ``images_{factor}``; raw training
    reads level 0, as downsampling would lose the mosaic's phase."""
    raw_train = (config.rawnerf_mode and
                 self.split == types.DataSplit.TRAIN)
    if config.factor > 0 and not raw_train:
      return config.factor
    return 1

  def _recover_poses(self, config, factor):
    """Stage 1: the image names and [N, 3, 4] camera-to-world poses in the
    COLMAP world frame, from ``sparse/0`` or else ``transforms.json``; sets
    the intrinsics (the pyramid level folded into pixtocams), distortion
    and camera type."""
    sfm_dir = os.path.join(self.data_dir, 'sparse/0/')
    if os.path.exists(sfm_dir):
      names, poses, pixtocam, distortion, camtype = colmap.process_scene(
          sfm_dir)
    else:
      names, poses, pixtocam, distortion, camtype = load_blender_posedata(
          self.data_dir)

    if config.load_alphabetical:
      # Published metrics hold out every Nth image of the alphabetical order.
      order = np.argsort(names)
      names = [names[i] for i in order]
      poses = poses[order]

    # Pixel coordinates scale by `factor`, so pixtocam's pixel columns do.
    self.pixtocams = (pixtocam @ np.diag([factor, factor, 1.0])).astype(
        np.float32)
    self.focal = 1.0 / self.pixtocams[0, 0]
    self.distortion_params = distortion
    self.camtype = camtype
    return names, poses

  def _decode_pixels(self, config, image_names, factor):
    """Stage 2: (the [N, H, W, 3] images of `image_names`, whether the
    scene is a RawNeRF HDR+ test scene).  With ``rawnerf_mode`` the raw
    mosaics of ``raw/``, demosaicked (``data/raw.py``), with their metadata
    in ``self.metadata``; else the pyramid level, and the exposures (shutter
    x ISO / 1000) of the originals' Exif when they carry it."""
    if config.rawnerf_mode:
      images, self.metadata, raw_testscene = raw_lib.load_raw_dataset(
          self.split, self.data_dir, image_names,
          config.exposure_percentile, factor)
      return images, raw_testscene

    originals_dir = os.path.join(self.data_dir, 'images')
    level_dir = originals_dir if factor == 1 else (
        os.path.join(self.data_dir, f'images_{factor}'))
    for d in (level_dir, originals_dir):
      if not os.path.exists(d):
        raise ValueError(f'Image folder {d} does not exist.')
    # COLMAP names the originals; the level may name its files otherwise
    # (.JPG -> .png), so translate through the two sorted listings.
    renamed = dict(zip(sorted(os.listdir(originals_dir)),
                       sorted(os.listdir(level_dir))))
    with concurrent.futures.ThreadPoolExecutor() as pool:
      decoded = pool.map(
          lambda name: io_lib.load_img(
              os.path.join(level_dir, renamed[name])), image_names)
      images = np.stack(list(decoded), axis=0) / 255.0

    self.exifs = [io_lib.load_exif(os.path.join(originals_dir, name))
                  for name in image_names]
    if all(k in self.exifs[0] for k in ('ExposureTime', 'ISOSpeedRatings')):
      shutter_iso = np.array(
          [float(x['ExposureTime']) * float(x['ISOSpeedRatings'])
           for x in self.exifs])
      self.exposures = shutter_iso / 1000.0
    return images, False

  def _normalize_world(self, config, poses):
    """Stage 3: the COLMAP frame to the rendering frame, and a render path.

    Forward-facing captures rescale by the near bound of
    ``poses_bounds.npy``, recenter, and take NDC and a spiral path;
    unbounded ones are aligned by PCA and take an ellipse (or keyframe
    spline) path.  Sets ``colmap_to_world_transform`` and
    ``render_poses``; returns the transformed poses.
    """
    bounds = np.array([0.01, 1.0])
    bounds_file = os.path.join(self.data_dir, 'poses_bounds.npy')
    if os.path.exists(bounds_file):
      with open(bounds_file, 'rb') as fp:
        bounds = np.load(fp)[:, -2:]

    if config.forward_facing:
      self.pixtocam_ndc = self.pixtocams.reshape(-1, 3, 3)[0]
      # Rescale so the nearest scene content sits at ~0.75 depth units.
      scale = 1.0 / (bounds.min() * 0.75)
      poses = poses.copy()
      poses[:, :3, 3] *= scale
      poses, recenter = camera_lib.recenter_poses(poses)
      self.colmap_to_world_transform = recenter @ np.diag([scale] * 3 + [1])
      self.render_poses = camera_lib.generate_spiral_path(
          poses, bounds * scale, n_frames=config.render_path_frames)
      return poses

    poses, self.colmap_to_world_transform = camera_lib.transform_poses_pca(
        poses)
    if config.render_spline_keyframes is not None:
      (self.spline_indices, self.render_poses,
       self.render_exposures) = camera_lib.create_render_spline_path(
           config, self._image_names, poses, self.exposures)
    else:
      self.render_poses = camera_lib.generate_ellipse_path(
          poses,
          n_frames=config.render_path_frames,
          z_variation=config.z_variation,
          z_phase=config.z_phase)
    return poses

  def _split_indices(self, config, num_images, raw_testscene):
    """Stage 4: the image indices of this split (every llffhold-th one is
    a test view; an HDR+ test scene trains on every bracketed shot)."""
    everything = np.arange(num_images)
    held_out = everything % config.llffhold == 0
    if self.split == types.DataSplit.TEST:
      return everything[held_out]
    if config.llff_use_all_images_for_training or raw_testscene:
      return everything
    return everything[~held_out]

  def _load_renderings(self, config):
    factor = self._downsampling_factor(config)
    image_names, poses = self._recover_poses(config, factor)
    self._image_names = image_names
    images, raw_testscene = self._decode_pixels(config, image_names, factor)
    poses = self._normalize_world(config, poses)
    if raw_testscene:
      # The first COLMAP pose is the ground-truth test view's; the rest
      # train.
      poses = (poses[:1] if self.split == types.DataSplit.TEST
               else poses[1:])
    self.poses = poses

    keep = self._split_indices(config, images.shape[0], raw_testscene)
    images = images[keep]
    poses = poses[keep]
    if self.exposures is not None:
      self.exposures = self.exposures[keep]
    if config.rawnerf_mode:
      for key in ['exposure_idx', 'exposure_values']:
        self.metadata[key] = self.metadata[key][keep]

    self.images = images
    self.camtoworlds = self.render_poses if config.render_path else poses
    self.height, self.width = images.shape[1:3]


class TanksAndTemplesNerfPP(Dataset):
  """Tanks and Temples, NeRF++ directory layout (datasets.py:537-580);
  ``render_path`` reads ``camera_path/``."""

  def _load_renderings(self, config):
    split_str = 'camera_path' if config.render_path else self.split.value
    basedir = os.path.join(self.data_dir, split_str)

    def load_files(dirname, load_fn, shape=None):
      files = [
          os.path.join(basedir, dirname, f)
          for f in sorted(os.listdir(os.path.join(basedir, dirname)))
      ]
      mats = np.array([load_fn(f) for f in files])
      if shape is not None:
        mats = mats.reshape(mats.shape[:1] + shape)
      return mats

    poses = load_files('pose', np.loadtxt, (4, 4))
    # Flip Y/Z to our coordinate frame.
    poses = np.matmul(poses, np.diag(np.array([1, -1, -1, 1])))

    intrinsics = load_files('intrinsics', np.loadtxt, (4, 4))

    if not config.render_path:
      self.images = load_files('rgb', io_lib.read_image) / 255.0
      self.height, self.width = self.images.shape[1:3]
    else:
      # The resolution of a test image.
      d = os.path.join(self.data_dir, 'test', 'rgb')
      f = os.path.join(d, sorted(os.listdir(d))[0])
      self.height, self.width = io_lib.load_img(f).shape[:2]
      self.images = None

    self.camtoworlds = poses
    # Use only the first focal length.
    self.focal = intrinsics[0, 0, 0]
    self.pixtocams = camera_lib.get_pixtocam(self.focal, self.width,
                                             self.height)


class TanksAndTemplesFVS(Dataset):
  """Tanks and Temples, Free View Synthesis layout (datasets.py:583-640)."""

  def _load_renderings(self, config):
    render_only = config.render_path and self.split == types.DataSplit.TEST

    basedir = os.path.join(self.data_dir, 'dense')
    sizes = [f for f in sorted(os.listdir(basedir)) if f.startswith('ibr3d')]
    sizes = sizes[::-1]
    if config.factor >= len(sizes):
      raise ValueError(f'Factor {config.factor} larger than {len(sizes)}')

    basedir = os.path.join(basedir, sizes[config.factor])
    path = lambda f: os.path.join(basedir, f)

    files = [f for f in sorted(os.listdir(basedir)) if f.startswith('im_')]
    if render_only:
      files = files[:1]
    images = np.array([io_lib.read_image(path(f)) for f in files]) / 255.0

    intrinsics, rot, trans = (np.load(path(f'{n}.npy'))
                              for n in ('Ks', 'Rs', 'ts'))

    # COLMAP world-to-cam -> our cam-to-world.
    w2c = np.concatenate([rot, trans[..., None]], axis=-1)
    c2w_colmap = np.linalg.inv(camera_lib.pad_poses(w2c))[:, :3, :4]
    c2w = c2w_colmap @ np.diag(np.array([1, -1, -1, 1]))

    poses, _ = camera_lib.transform_poses_pca(c2w)
    self.poses = poses
    self.images = images
    self.height, self.width = self.images.shape[1:3]
    self.camtoworlds = poses
    self.focal = intrinsics[0, 0, 0]
    self.pixtocams = camera_lib.get_pixtocam(self.focal, self.width,
                                             self.height)

    if render_only:
      render_path = camera_lib.generate_ellipse_path(
          poses,
          config.render_path_frames,
          z_variation=config.z_variation,
          z_phase=config.z_phase)
      self.images = None
      self.camtoworlds = render_path
      self.render_poses = render_path
    else:
      all_indices = np.arange(images.shape[0])
      indices = {
          types.DataSplit.TEST:
              all_indices[all_indices % config.llffhold == 0],
          types.DataSplit.TRAIN:
              all_indices[all_indices % config.llffhold != 0],
      }[self.split]
      self.images = self.images[indices]
      self.camtoworlds = self.camtoworlds[indices]


class DTU(Dataset):
  """DTU MVS scans: rectified images and calibration projection matrices
  (datasets.py:643-733)."""

  def _load_renderings(self, config):
    if config.render_path:
      raise ValueError('render_path cannot be used for the DTU dataset.')

    images = []
    pixtocams = []
    camtoworlds = []

    # A scan has 49 or 65 poses, 8 images (light conditions) each.
    n_images = len(os.listdir(self.data_dir)) // 8
    for i in range(1, n_images + 1):
      if config.dtu_light_cond < 7:
        light_str = f'{config.dtu_light_cond}_r' + (
            '5000' if i < 50 else '7000')
      else:
        light_str = 'max'

      fname = os.path.join(self.data_dir, f'rect_{i:03d}_{light_str}.png')
      image = io_lib.load_img(fname) / 255.0
      if config.factor > 1:
        image = image_ops.downsample(image, config.factor)
      images.append(image)

      fname = os.path.join(self.data_dir, f'../../cal18/pos_{i:03d}.txt')
      projection = np.loadtxt(fname, dtype=np.float32)
      camera_mat, rot_mat, t = _decompose_projection_matrix(projection)
      camera_mat = camera_mat / camera_mat[2, 2]
      pose = np.eye(4, dtype=np.float32)
      pose[:3, :3] = rot_mat.transpose()
      pose[:3, 3] = (t[:3] / t[3])[:, 0]
      camtoworlds.append(pose[:3])

      if config.factor > 0:
        camera_mat = np.diag(
            [1.0 / config.factor, 1.0 / config.factor, 1.0]).astype(
                np.float32) @ camera_mat
      pixtocams.append(np.linalg.inv(camera_mat))

    pixtocams = np.stack(pixtocams)
    camtoworlds = np.stack(camtoworlds)
    images = np.stack(images)

    def rescale_poses(poses):
      s = np.max(np.abs(poses[:, :3, -1]))
      out = np.copy(poses)
      out[:, :3, -1] /= s
      return out

    camtoworlds, _ = camera_lib.recenter_poses(camtoworlds)
    camtoworlds = rescale_poses(camtoworlds)
    # Flip y/z to OpenGL convention.
    camtoworlds = camtoworlds @ np.diag([1.0, -1.0, -1.0, 1.0]).astype(
        np.float32)

    all_indices = np.arange(images.shape[0])
    split_indices = {
        types.DataSplit.TEST: all_indices[all_indices % config.dtuhold == 0],
        types.DataSplit.TRAIN: all_indices[all_indices % config.dtuhold != 0],
    }
    indices = split_indices[self.split]

    self.images = images[indices]
    self.height, self.width = images.shape[1:3]
    self.camtoworlds = camtoworlds[indices]
    self.pixtocams = pixtocams[indices]


def _decompose_projection_matrix(p: np.ndarray):
  """Decompose P = K [R | -RC] into (K, R, C homogeneous) by an RQ
  decomposition (datasets.py:716-733)."""
  import scipy.linalg
  m = p[:3, :3]
  k, r = scipy.linalg.rq(m)
  # Make the intrinsic diagonal positive.
  signs = np.diag(np.sign(np.diag(k)))
  k = k @ signs
  r = signs @ r
  if np.linalg.det(r) < 0:
    k = -k
    r = -r
  # Camera center: right null vector of P.
  _, _, vh = np.linalg.svd(p)
  c = vh[-1]
  c = c.reshape(4, 1)
  return k, r, c


class Dummy(Dataset):
  """A directional light field for tests (datasets.py:736-778): four
  cameras on a circle, each pixel's color a smooth function of its view
  direction."""

  NUM_IMAGES = 4
  RESOLUTION = 16

  def _load_renderings(self, config):
    rng = np.random.RandomState(42)
    n = self.NUM_IMAGES
    res = self.RESOLUTION
    poses = []
    for i in range(n):
      theta = 2 * np.pi * i / n
      position = np.array([4 * np.cos(theta), 4 * np.sin(theta), 1.0])
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
      _, _, viewdirs, _, _ = camera_lib.pixels_to_rays(
          pix_x, pix_y, self.pixtocams, self.camtoworlds[i], xnp=np)
      images.append(0.5 + 0.5 * np.sin(2.5 * viewdirs))
    self.images = np.stack(images).astype(np.float32)
    if self._load_disps:
      self.disp_images = rng.rand(n, res, res).astype(np.float32)
    if self._load_normals:
      normals = rng.randn(n, res, res, 3).astype(np.float32)
      self.normal_images = normals / np.linalg.norm(
          normals, axis=-1, keepdims=True)
      self.alphas = np.ones((n, res, res), np.float32)


class DummySphere(Dataset):
  """A textured unit sphere over a white background (datasets.py:
  781-839): real parallax and analytic depth; the test ring sits higher
  and at offset azimuths."""

  NUM_IMAGES = 12
  RESOLUTION = 32

  def _load_renderings(self, config):
    n = self.NUM_IMAGES
    res = self.RESOLUTION
    test = self.split == types.DataSplit.TEST
    poses = []
    for i in range(n):
      theta = 2 * np.pi * (i + (0.5 if test else 0.0)) / n
      height = 1.5 if test else 1.0
      position = np.array(
          [3.5 * np.cos(theta), 3.5 * np.sin(theta), height])
      poses.append(camera_lib.viewmatrix(
          lookdir=position, up=np.array([0.0, 0.0, 1.0]), position=position))
    self.camtoworlds = np.stack(poses).astype(np.float32)
    self.height = self.width = res
    self.focal = res * 1.4
    self.pixtocams = camera_lib.get_pixtocam(self.focal, self.width,
                                             self.height)
    images = []
    disps = []
    for i in range(n):
      pix_x, pix_y = camera_lib.pixel_coordinates(res, res)
      origins, _, viewdirs, _, _ = camera_lib.pixels_to_rays(
          pix_x, pix_y, self.pixtocams, self.camtoworlds[i], xnp=np)
      # |o + t d|^2 = 1 with a unit d.
      b = 2 * np.sum(origins * viewdirs, -1)
      c = np.sum(origins**2, -1) - 1.0
      disc = b**2 - 4 * c
      hit = disc > 0
      t_hit = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0))) / 2, np.inf)
      t_safe = np.where(hit, t_hit, 0.0)
      p = origins + t_safe[..., None] * viewdirs
      texture = 0.5 + 0.5 * np.sin(5.0 * p)
      images.append(np.where(hit[..., None], texture, 1.0).astype(np.float32))
      disps.append((1.0 / np.maximum(t_hit, 1e-3)).astype(np.float32))
    self.images = np.stack(images)
    if self._load_disps:
      self.disp_images = np.stack(disps)
    if self._load_normals:
      self.normal_images = self.images * 0  # A placeholder, as in JAX.
      self.alphas = np.ones((n, res, res), np.float32)


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
      images.append(self.shade(origins, viewdirs))
    self.images = np.stack(images)

  @classmethod
  def shade(cls, origins, viewdirs):
    """The scene's analytic color along rays (numpy [..., 3] each): the
    nearest sphere's texture, else the miss color."""
    # Nearest positive ray-sphere hit across all spheres.
    t_best = np.full(origins.shape[:-1], np.inf, np.float32)
    nearest = np.zeros(origins.shape[:-1], np.int32)
    for k, center in enumerate(cls.CENTERS):
      oc = origins - center
      b = 2 * np.sum(oc * viewdirs, -1)
      c = np.sum(oc ** 2, -1) - cls.RADIUS ** 2
      disc = b ** 2 - 4 * c
      t = np.where(disc > 0, (-b - np.sqrt(np.maximum(disc, 0))) / 2,
                   np.inf)
      t = np.where(t > 0, t, np.inf)
      nearest = np.where(t < t_best, k, nearest)
      t_best = np.minimum(t_best, t)
    hit = np.isfinite(t_best)
    t_safe = np.where(hit, t_best, 0.0)
    p = origins + t_safe[..., None] * viewdirs
    phase = (2 * np.pi / len(cls.CENTERS)) * nearest
    texture = 0.5 + 0.5 * np.sin(4.0 * p + phase[..., None])
    return np.where(hit[..., None], texture,
                    cls.miss_color(origins, viewdirs)).astype(np.float32)

  @classmethod
  def miss_color(cls, origins, viewdirs):
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

  @classmethod
  def miss_color(cls, origins, viewdirs):
    # Cameras sit inside the shell, so its far root always exists.
    b = 2 * np.sum(origins * viewdirs, -1)
    c = np.sum(origins ** 2, -1) - cls.SHELL_RADIUS ** 2
    t = (-b + np.sqrt(np.maximum(b ** 2 - 4 * c, 0.0))) / 2
    q = (origins + t[..., None] * viewdirs) / cls.SHELL_RADIUS
    phases = np.array([0.0, 2.1, 4.2], np.float32)
    return (0.5 + 0.5 * np.sin(6.0 * q + phases)).astype(np.float32)


class DummyDistractor(DummyScatter):
  """DummyScatter with transient distractors in the train views
  (datasets.py:962-992): five solid-color 8 x 8 squares at random places
  in each train image, content no 3D scene explains (RobustNeRF's
  synthetic-distractor protocol).  ``distractor_masks`` ([n, h, w] bool,
  train split only) marks them; the test views stay clean."""

  NUM_DISTRACTORS = 5
  DISTRACTOR_SIZE = 8

  def _load_renderings(self, config):
    super()._load_renderings(config)
    if self.split == types.DataSplit.TEST:
      return
    rng = np.random.RandomState(777)
    n, h, w, _ = self.images.shape
    self.images = np.array(self.images)  # An own, writable copy.
    self.distractor_masks = np.zeros((n, h, w), bool)
    s = self.DISTRACTOR_SIZE
    for i in range(n):
      for _ in range(self.NUM_DISTRACTORS):
        y = rng.randint(0, h - s)
        x = rng.randint(0, w - s)
        self.images[i, y:y + s, x:x + s] = rng.rand(3).astype(np.float32)
        self.distractor_masks[i, y:y + s, x:x + s] = True


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
