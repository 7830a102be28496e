"""The device-resident training data plane (port of data/device_sampler.py).

The train images and the camera table live on the device.  Each step draws
its pixels and cameras with ``torch.randint`` from a ``torch.Generator`` on
that device, gathers their ``rgb`` and casts their rays with
``data/cameras.py:cast_ray_batch(xnp=torch)``, the caster of
``models.nerf.DeviceImageRenderer``: no host batch and no host-to-device copy
per step.  The draws follow ``Dataset._next_train``'s rules (border mask,
patches, all-images or single-image batching), not its random stream: the
rays of given pixel and camera indices equal the host caster's, and so do
the ``disps``, ``normals`` and ``alphas`` of the metrics when the config
asks for them, the RGGB ``lossmult`` of ``Config.apply_bayer_mask`` and
RawNeRF's ``exposure_idx`` and ``exposure_values``.  ``create_scan_train_step``
runs a window of ``Config.steps_per_jit_call`` steps per call, with the
culling protocol inside it.
"""

from __future__ import annotations

import numpy as np
import torch

from multinerf_tpu_torch.data import cameras as camera_lib
from multinerf_tpu_torch.data import raw
from multinerf_tpu_torch.data import types
from multinerf_tpu_torch.parallel import mesh


class DeviceDataPlane:
  """A train split's images and cameras on `device`, sampled there."""

  def __init__(self, dataset, config, device):
    """Upload a train Dataset's images and cameras to `device`."""
    self._apply_bayer_mask = config.apply_bayer_mask
    self.device = torch.device(device)
    self.camtype = dataset.camtype
    self._patch_size = max(config.patch_size, 1)
    # This rank's share of the batch (device_sampler.py:45).
    self._num_patches = (mesh.process_local_slice(config.batch_size) //
                         self._patch_size**2)
    self._height, self._width = dataset.height, dataset.width
    self._border = config.num_border_pixels_to_mask
    self._single_image = config.batching == 'single_image'
    self.near, self.far = float(dataset.near), float(dataset.far)

    # A copy: the exposure records may be read-only broadcasts.
    as_f32 = lambda a: torch.tensor(np.asarray(a, np.float32),
                                    device=self.device)
    self.images = as_f32(dataset.images)
    # The ground truth of the disparity and normal metrics, when asked for.
    self.targets = {}
    if config.compute_disp_metrics:
      self.targets['disps'] = as_f32(dataset.disp_images)
    if config.compute_normal_metrics:
      self.targets['normals'] = as_f32(dataset.normal_images)
      self.targets['alphas'] = as_f32(dataset.alphas)
    self.cameras = camera_lib.cameras_to_device(dataset.cameras, self.device)
    records = dataset.exposure_records(np.arange(self.images.shape[0]))
    self._exposure_values = self._exposure_idx = None
    if 'exposure_values' in records:
      self._exposure_values = as_f32(np.broadcast_to(
          records['exposure_values'], (self.images.shape[0],)))
    if 'exposure_idx' in records:
      self._exposure_idx = torch.tensor(np.array(np.broadcast_to(
          records['exposure_idx'], (self.images.shape[0],))),
                                        device=self.device)

  def draw(self, generator):
    """(pix_x, pix_y, cam_idx): int64 [P, ps, ps] pixel coordinates of
    `num_patches` patches and [P, 1, 1] cameras, from `generator`."""
    ps, n = self._patch_size, self._num_patches
    randint = lambda lo, hi, shape: torch.randint(
        lo, hi, shape, generator=generator, device=self.device)
    lower = self._border
    pix_x = randint(lower, self._width - self._border - ps + 1, (n, 1, 1))
    pix_y = randint(lower, self._height - self._border - ps + 1, (n, 1, 1))
    offsets = torch.arange(ps, device=self.device)
    pix_x = (pix_x + offsets[None, None, :]).expand(n, ps, ps)
    pix_y = (pix_y + offsets[None, :, None]).expand(n, ps, ps)
    if self._single_image:
      cam_idx = randint(0, self.images.shape[0], (1, 1, 1)).expand(n, 1, 1)
    else:
      cam_idx = randint(0, self.images.shape[0], (n, 1, 1))
    return pix_x, pix_y, cam_idx

  def make_batch(self, pix_x, pix_y, cam_idx) -> types.Batch:
    """The Batch of given pixels and cameras ([P, ps, ps] / [P, 1, 1]),
    shaped as ``train_lib.batch_to_device`` shapes a host batch: patch
    axes of size 1 dropped."""
    shape = pix_x.shape
    cam = cam_idx.expand(shape)
    ones = torch.ones(shape + (1,), dtype=torch.float32, device=self.device)
    lossmult = ones
    if self._apply_bayer_mask:
      lossmult = raw.pixels_to_bayer_mask(pix_x, pix_y, xnp=torch)
    kw = dict(lossmult=lossmult, near=self.near * ones, far=self.far * ones,
              cam_idx=cam[..., None])
    if self._exposure_idx is not None:
      kw['exposure_idx'] = self._exposure_idx[cam][..., None]
    if self._exposure_values is not None:
      kw['exposure_values'] = self._exposure_values[cam][..., None]
    rays = camera_lib.cast_ray_batch(
        self.cameras, types.Pixels(pix_x, pix_y, **kw), self.camtype,
        xnp=torch)
    targets = {k: v[cam, pix_y, pix_x] for k, v in self.targets.items()}
    batch = types.Batch(rays=rays, rgb=self.images[cam, pix_y, pix_x],
                        **targets)
    if self._patch_size == 1:
      squeeze = lambda x: None if x is None else x.reshape(
          (shape[0],) + x.shape[3:])
      batch = types.Batch(
          rays=types.Rays(**{f: squeeze(getattr(rays, f))
                             for f in rays.__dataclass_fields__}),
          rgb=squeeze(batch.rgb),
          **{k: squeeze(v) for k, v in targets.items()})
    return batch

  def sample_batch(self, generator) -> types.Batch:
    """One training batch drawn and cast on the device."""
    return self.make_batch(*self.draw(generator))


def create_device_train_step(train_step, plane: DeviceDataPlane):
  """A step that samples its own batch on the device:
  (generator, state, train_frac, compute_stats[, loss_threshold]) ->
  (state, stats), around `train_step` of ``train_lib.create_train_step``.
  The generator draws the pixels, then the step's jitter."""

  def step(generator, state, train_frac, compute_stats, loss_threshold=1.0):
    batch = plane.sample_batch(generator)
    return train_step(generator, state, batch, train_frac, compute_stats,
                      loss_threshold)

  return step


def stack_window(rows):
  """Per-step stats of a window -> {key: [num_steps, ...]}.  The tree
  statistics exist on the steps that computed them, always the first
  (``create_scan_train_step``); the others get zeros there, which
  ``train.transpose_stats`` drops (JAX train.py:331-335)."""
  return {k: torch.stack([r[k] if k in r else torch.zeros_like(v)
                          for r in rows])
          for k, v in rows[0].items()}


def create_scan_train_step(train_steps, plane: DeviceDataPlane, config,
                           num_steps: int, gate=None):
  """`num_steps` whole optimizer steps in one call, each drawing its batch
  on the device (the lax.scan of device_sampler.py:150-241, as an eager
  loop):
  (generator, state, start_step, loss_threshold) ->
  (state, stats stacked [num_steps, ...], loss_threshold).

  `train_steps` maps a capacity (None: unculled) to a step of
  ``train_lib.create_train_step``; `gate` is the ``train_lib.CullingGate``
  that picks each step's capacity and refreshes the grid, as on the host
  path, or None without culling.  Inner step i of a window that starts at
  `start_step` trains at the fraction of its own step, computes the tree
  statistics at step 1, on print steps and on the window's first step, and
  hands its RobustNeRF threshold on as a device tensor.  Nothing is read
  back to the host between the steps but the gate's keep fraction at a
  refresh, so one window equals `num_steps` single steps of
  ``create_device_train_step`` with the same gate.
  """

  def window(generator, state, start_step, loss_threshold=1.0):
    rows = []
    for i in range(num_steps):
      step = start_step + i
      train_frac = float(np.clip((step - 1) / (config.max_steps - 1), 0, 1))
      compute_stats = (step % config.print_every == 0 or step == 1 or
                       i == 0)
      step_fn = train_steps[gate.cull(step) if gate is not None else None]
      batch = plane.sample_batch(generator)
      state, stats = step_fn(generator, state, batch, train_frac,
                             compute_stats, loss_threshold)
      if gate is not None:
        gate.after_step(step, stats)
      if config.enable_robustnerf_loss:
        loss_threshold = stats['loss_threshold']
      rows.append(stats)
    return state, stack_window(rows), loss_threshold

  return window
