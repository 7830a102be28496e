"""Camera math and pixel -> ray casting (port of data/cameras.py:55-519).

Perspective cameras only.  ``pixels_to_rays`` and ``cast_ray_batch`` take
``xnp=np`` (host numpy, as the dataset loaders use them) or ``xnp=torch``
(tensors, as the renderer casts rays on the device); both run the same
arithmetic.  Distortion, NDC and fisheye cameras raise NotImplementedError.
"""

from __future__ import annotations

import enum
import math
import types
from typing import Tuple

import numpy as np
import torch

from multinerf_tpu_torch.data import types as dtypes

_LATER = 'ROADMAP.md Queue 1: serving slice, deferred items'


class ProjectionType(enum.Enum):
  """Camera projection model."""
  PERSPECTIVE = 'perspective'
  FISHEYE = 'fisheye'


def normalize(x: np.ndarray) -> np.ndarray:
  return x / np.linalg.norm(x)


def viewmatrix(lookdir: np.ndarray, up: np.ndarray,
               position: np.ndarray) -> np.ndarray:
  """Construct a lookat camera-to-world matrix."""
  vec2 = normalize(lookdir)
  vec0 = normalize(np.cross(up, vec2))
  vec1 = normalize(np.cross(vec2, vec0))
  return np.stack([vec0, vec1, vec2, position], axis=1)


def intrinsic_matrix(fx: float, fy: float, cx: float, cy: float) -> np.ndarray:
  """Pinhole intrinsic matrix (OpenCV convention)."""
  return np.array([
      [fx, 0, cx],
      [0, fy, cy],
      [0, 0, 1.0],
  ])


def get_pixtocam(focal: float, width: float, height: float) -> np.ndarray:
  """Inverse intrinsics for a centered pinhole camera (host numpy)."""
  return np.linalg.inv(intrinsic_matrix(focal, focal, width * 0.5,
                                        height * 0.5))


def pixel_coordinates(width: int, height: int,
                      xnp: types.ModuleType = np) -> Tuple:
  """Integer (x, y) coordinate grids for an image."""
  return xnp.meshgrid(xnp.arange(width), xnp.arange(height), indexing='xy')


def _norm(x, xnp):
  """Euclidean norm over the last axis, keeping it (numpy or torch)."""
  return xnp.sqrt((x * x).sum(-1))[..., None]


def pixels_to_rays(pix_x_int, pix_y_int, pixtocams, camtoworlds,
                   distortion_params=None, pixtocam_ndc=None,
                   camtype=ProjectionType.PERSPECTIVE, xnp=np):
  """Cast rays through pixel centers, with cone radii for mip-NeRF.

  Args:
    pix_x_int, pix_y_int: int arrays (shape SH) of pixel coordinates.
    pixtocams: [SH +] [3, 3] inverse intrinsics.
    camtoworlds: [SH +] [3, 4] camera-to-world extrinsics.
    xnp: numpy or torch.

  Returns:
    (origins, directions, viewdirs, radii, imageplane).
  """
  if distortion_params is not None or pixtocam_ndc is not None or (
      camtype != ProjectionType.PERSPECTIVE):
    raise NotImplementedError(
        f'Not ported yet: distorted, NDC and fisheye cameras ({_LATER}).')
  rotate = lambda m, v: xnp.matmul(m, v[..., None])[..., 0]

  # The pixel center plus its +x and +y neighbours; the neighbours only
  # measure the cone footprint.
  probes = xnp.stack([
      xnp.stack([pix_x_int + ox + 0.5, pix_y_int + oy + 0.5,
                 xnp.ones_like(pix_x_int) * 1.0], -1)
      for ox, oy in ((0, 0), (1, 0), (0, 1))], 0)
  if xnp is torch:
    probes = probes.to(pixtocams.dtype)

  cam_dirs = rotate(pixtocams, probes)  # Inverse intrinsics.
  # OpenCV -> OpenGL: negate y and z.
  cam_dirs = xnp.stack([cam_dirs[..., 0], -cam_dirs[..., 1],
                        -cam_dirs[..., 2]], -1)
  imageplane = cam_dirs[0, ..., :2]

  directions, dx, dy = rotate(camtoworlds[..., :3, :3], cam_dirs)
  origins = xnp.broadcast_to(camtoworlds[..., :3, -1], directions.shape)
  viewdirs = directions / _norm(directions, xnp)
  footprint = (_norm(dx - directions, xnp)[..., 0] +
               _norm(dy - directions, xnp)[..., 0])
  # Mean neighbour distance, scaled to the std of a pixel-wide uniform
  # distribution (1/sqrt(12); see mip-NeRF).
  radii = (0.5 * footprint)[..., None] * 2 / math.sqrt(12)
  return origins, directions, viewdirs, radii, imageplane


def cast_ray_batch(cameras, pixels: dtypes.Pixels,
                   camtype=ProjectionType.PERSPECTIVE, xnp=np) -> dtypes.Rays:
  """Cast a Pixels batch into Rays with cameras (pixtocams, camtoworlds,
  distortion_params, pixtocam_ndc), stacked ones indexed by cam_idx."""
  pixtocams, camtoworlds, distortion_params, pixtocam_ndc = cameras
  cam_idx = pixels.cam_idx[..., 0]
  batch_index = lambda arr: arr if arr.ndim == 2 else arr[cam_idx]
  origins, directions, viewdirs, radii, imageplane = pixels_to_rays(
      pixels.pix_x_int, pixels.pix_y_int, batch_index(pixtocams),
      batch_index(camtoworlds), distortion_params=distortion_params,
      pixtocam_ndc=pixtocam_ndc, camtype=camtype, xnp=xnp)
  return dtypes.Rays(
      origins=origins, directions=directions, viewdirs=viewdirs,
      radii=radii, imageplane=imageplane, lossmult=pixels.lossmult,
      near=pixels.near, far=pixels.far, cam_idx=pixels.cam_idx,
      exposure_idx=pixels.exposure_idx,
      exposure_values=pixels.exposure_values)
