"""Camera math and pixel -> ray casting (port of data/cameras.py).

The pose helpers (padding, averaging, recentering, the focus point, the PCA
alignment) and the render paths (spiral, ellipse, B-spline) are host numpy,
the same calls in the same order as the JAX package's, so they give the same
bits.  ``pixels_to_rays`` and ``cast_ray_batch`` take ``xnp=np`` (host
numpy, as the dataset loaders use them) or ``xnp=torch`` (tensors, as the
device sampler and the renderer cast rays on the device); both run the same
arithmetic, for perspective and fisheye cameras, with or without OpenCV
radial-tangential distortion, and with the NDC warp of forward-facing
captures.  On tensors the rotations are full f32 products whatever the TF32
setting (``mathx.matmul_hp``), as the JAX device cast's are.
"""

from __future__ import annotations

import enum
import math
import os
import types
from typing import List, Optional, Tuple, Union

import numpy as np
import scipy.interpolate
import torch

from multinerf_tpu_torch.data import types as dtypes
from multinerf_tpu_torch.ops import mathx
from multinerf_tpu_torch.ops import stepfun


class ProjectionType(enum.Enum):
  """Camera projection model."""
  PERSPECTIVE = 'perspective'
  FISHEYE = 'fisheye'


# --- Pose algebra (host numpy). -----------------------------------------------


def normalize(x: np.ndarray) -> np.ndarray:
  return x / np.linalg.norm(x)


def pad_poses(p: np.ndarray) -> np.ndarray:
  """Append the homogeneous [0,0,0,1] row to [..., 3, 4] poses."""
  bottom = np.broadcast_to([0, 0, 0, 1.0], p[..., :1, :4].shape)
  return np.concatenate([p[..., :3, :4], bottom], axis=-2)


def unpad_poses(p: np.ndarray) -> np.ndarray:
  """Drop the homogeneous row from [..., 4, 4] poses."""
  return p[..., :3, :4]


def viewmatrix(lookdir: np.ndarray, up: np.ndarray,
               position: np.ndarray) -> np.ndarray:
  """Construct a lookat camera-to-world matrix."""
  vec2 = normalize(lookdir)
  vec0 = normalize(np.cross(up, vec2))
  vec1 = normalize(np.cross(vec2, vec0))
  return np.stack([vec0, vec1, vec2, position], axis=1)


def average_pose(poses: np.ndarray) -> np.ndarray:
  """Pose with the average position, z-axis, and up vector of the inputs."""
  position = poses[:, :3, 3].mean(0)
  z_axis = poses[:, :3, 2].mean(0)
  up = poses[:, :3, 1].mean(0)
  return viewmatrix(z_axis, up, position)


def recenter_poses(poses: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
  """Recenter poses around the origin; returns (poses, applied transform)."""
  cam2world = average_pose(poses)
  transform = np.linalg.inv(pad_poses(cam2world))
  poses = transform @ pad_poses(poses)
  return unpad_poses(poses), transform


def focus_point_fn(poses: np.ndarray) -> np.ndarray:
  """Point minimizing squared distance to all camera focal axes."""
  directions, origins = poses[:, :3, 2:3], poses[:, :3, 3:4]
  m = np.eye(3) - directions * np.transpose(directions, [0, 2, 1])
  mt_m = np.transpose(m, [0, 2, 1]) @ m
  return np.linalg.inv(mt_m.mean(0)) @ (mt_m @ origins).mean(0)[:, 0]


def transform_poses_pca(poses: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
  """Rotate and scale poses so their principal axes align with XYZ and
  their positions fill [-1, 1]^3 (cameras.py:88-122 of the JAX package).

  The rotation's rows are the right singular vectors of the centered camera
  positions (largest spread first), made a proper rotation (the last axis
  flipped if det < 0) with the mean camera up vector toward +Z (a half turn
  about X otherwise).  Returns (transformed poses, the applied [4, 4]
  world transform).
  """
  positions = poses[:, :3, 3]
  centroid = positions.mean(axis=0)
  _, _, axes = np.linalg.svd(positions - centroid, full_matrices=False)
  if np.linalg.det(axes) < 0:
    axes[2] *= -1
  if (axes @ poses[:, :3, 1].mean(axis=0))[2] < 0:
    axes = np.diag([1.0, -1.0, -1.0]) @ axes

  transform = np.eye(4)
  transform[:3, :3] = axes
  transform[:3, 3] = -(axes @ centroid)
  poses_recentered = unpad_poses(transform @ pad_poses(poses))

  # Scale into the [-1, 1]^3 cube.
  scale_factor = 1.0 / np.max(np.abs(poses_recentered[:, :3, 3]))
  poses_recentered[:, :3, 3] *= scale_factor
  transform = np.diag([scale_factor] * 3 + [1.0]) @ transform
  return poses_recentered, transform


# --- Render paths. ------------------------------------------------------------

# Forward-facing spiral-path heuristics.
NEAR_STRETCH = 0.9  # Push the near bound forward.
FAR_STRETCH = 5.0  # Push the far bound back.
FOCUS_DISTANCE = 0.75  # Near/far weighting for the focus depth.


def generate_spiral_path(poses: np.ndarray, bounds: np.ndarray,
                         n_frames: int = 120, n_rots: int = 2,
                         zrate: float = 0.5) -> np.ndarray:
  """Forward-facing spiral render path."""
  near_bound = bounds.min() * NEAR_STRETCH
  far_bound = bounds.max() * FAR_STRETCH
  # Focus depth: weighted harmonic mean of the near/far bounds.
  focal = 1 / ((1 - FOCUS_DISTANCE) / near_bound + FOCUS_DISTANCE / far_bound)

  positions = poses[:, :3, 3]
  radii = np.percentile(np.abs(positions), 90, 0)
  radii = np.concatenate([radii, [1.0]])

  render_poses = []
  cam2world = average_pose(poses)
  up = poses[:, :3, 1].mean(0)
  for theta in np.linspace(0.0, 2.0 * np.pi * n_rots, n_frames,
                           endpoint=False):
    t = radii * [np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0]
    position = cam2world @ t
    lookat = cam2world @ [0, 0, -focal, 1.0]
    z_axis = position - lookat
    render_poses.append(viewmatrix(z_axis, up, position))
  return np.stack(render_poses, axis=0)


def _constant_speed_theta(theta, lengths):
  """The ellipse's angles resampled so that the camera moves at a roughly
  constant speed: the deterministic stratified inverse-CDF samples of the
  step function (theta, log(lengths)), taken in float32 by
  ``stepfun.sample`` as the JAX package's jnp call takes them."""
  t = torch.from_numpy(theta.astype(np.float32))
  logits = torch.from_numpy(np.log(lengths).astype(np.float32))
  return stepfun.sample(None, t, logits, theta.shape[-1]).numpy()


def generate_ellipse_path(poses: np.ndarray, n_frames: int = 120,
                          const_speed: bool = True, z_variation: float = 0.0,
                          z_phase: float = 0.0) -> np.ndarray:
  """Elliptical render path around the capture's focus point."""
  center = focus_point_fn(poses)
  # Path height sits at z=0, the middle of a zero-mean capture pattern.
  offset = np.array([center[0], center[1], 0])

  sc = np.percentile(np.abs(poses[:, :3, 3] - offset), 90, axis=0)
  low = -sc + offset
  high = sc + offset
  z_low = np.percentile(poses[:, :3, 3], 10, axis=0)
  z_high = np.percentile(poses[:, :3, 3], 90, axis=0)

  def get_positions(theta):
    return np.stack([
        low[0] + (high - low)[0] * (np.cos(theta) * 0.5 + 0.5),
        low[1] + (high - low)[1] * (np.sin(theta) * 0.5 + 0.5),
        z_variation * (z_low[2] + (z_high - z_low)[2] *
                       (np.cos(theta + 2 * np.pi * z_phase) * 0.5 + 0.5)),
    ], -1)

  theta = np.linspace(0, 2.0 * np.pi, n_frames + 1, endpoint=True)
  positions = get_positions(theta)

  if const_speed:
    lengths = np.linalg.norm(positions[1:] - positions[:-1], axis=-1)
    theta = _constant_speed_theta(theta, lengths)
    positions = get_positions(theta)

  positions = positions[:-1]  # De-duplicate the wrap-around endpoint.

  # Up vector: the world axis closest to the average input up vector.
  avg_up = poses[:, :3, 1].mean(0)
  avg_up = avg_up / np.linalg.norm(avg_up)
  ind_up = np.argmax(np.abs(avg_up))
  up = np.eye(3)[ind_up] * np.sign(avg_up[ind_up])

  return np.stack([viewmatrix(p - center, up, p) for p in positions])


def generate_interpolated_path(poses: np.ndarray, n_interp: int,
                               spline_degree: int = 5,
                               smoothness: float = 0.03,
                               rot_weight: float = 0.1) -> np.ndarray:
  """Smooth B-spline path through keyframe poses, splined in (position,
  lookat point, up point) space; rot_weight sets the lookat/up lever."""

  def poses_to_points(poses, dist):
    pos = poses[:, :3, -1]
    lookat = poses[:, :3, -1] - dist * poses[:, :3, 2]
    up = poses[:, :3, -1] + dist * poses[:, :3, 1]
    return np.stack([pos, lookat, up], 1)

  def points_to_poses(points):
    return np.array([viewmatrix(p - l, u - p, p) for p, l, u in points])

  def interp(points, n, k, s):
    sh = points.shape
    pts = np.reshape(points, (sh[0], -1))
    k = min(k, sh[0] - 1)
    tck, _ = scipy.interpolate.splprep(pts.T, k=k, s=s)
    u = np.linspace(0, 1, n, endpoint=False)
    new_points = np.array(scipy.interpolate.splev(u, tck))
    return np.reshape(new_points.T, (n, sh[1], sh[2]))

  points = poses_to_points(poses, dist=rot_weight)
  new_points = interp(points, n_interp * (points.shape[0] - 1),
                      k=spline_degree, s=smoothness)
  return points_to_poses(new_points)


def interpolate_1d(x: np.ndarray, n_interp: int, spline_degree: int,
                   smoothness: float) -> np.ndarray:
  """B-spline upsample a 1D signal by a factor of n_interp."""
  t = np.linspace(0, 1, len(x), endpoint=True)
  tck = scipy.interpolate.splrep(t, x, s=smoothness, k=spline_degree)
  n = n_interp * (len(x) - 1)
  u = np.linspace(0, 1, n, endpoint=False)
  return scipy.interpolate.splev(u, tck)


def create_render_spline_path(config, image_names: Union[str, List[str]],
                              poses: np.ndarray,
                              exposures: Optional[np.ndarray]):
  """Spline render path through the keyframes named by
  ``config.render_spline_keyframes`` (a directory of images or a text file
  of image names).  Returns (keyframe indices, interpolated poses,
  interpolated exposures or None)."""
  if os.path.isdir(config.render_spline_keyframes):
    keyframe_names = sorted(os.listdir(config.render_spline_keyframes))
  else:
    with open(config.render_spline_keyframes) as fp:
      keyframe_names = fp.read().splitlines()
  spline_indices = np.array(
      [i for i, n in enumerate(image_names) if n in keyframe_names])
  keyframes = poses[spline_indices]
  render_poses = generate_interpolated_path(
      keyframes,
      n_interp=config.render_spline_n_interp,
      spline_degree=config.render_spline_degree,
      smoothness=config.render_spline_smoothness,
      rot_weight=0.1)
  if config.render_spline_interpolate_exposure:
    if exposures is None:
      raise ValueError(
          'render_spline_interpolate_exposure requires exposures.')
    # Heavy smoothing of log exposure avoids flicker.
    log_exposure = np.log(exposures[spline_indices])
    log_exposure_interp = interpolate_1d(
        log_exposure, config.render_spline_n_interp, spline_degree=5,
        smoothness=20)
    render_exposures = np.exp(log_exposure_interp)
  else:
    render_exposures = None
  return spline_indices, render_poses, render_exposures


# --- Intrinsics. --------------------------------------------------------------


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


# --- Distortion. --------------------------------------------------------------


def distort(x, y, k1=0.0, k2=0.0, k3=0.0, k4=0.0, p1=0.0, p2=0.0):
  """OpenCV radial + tangential distortion, the convention COLMAP exports:
  with r2 = x^2 + y^2 and g = 1 + k1 r2 + k2 r2^2 + k3 r2^3 + k4 r2^4,

      xd = g x + 2 p1 x y + p2 (r2 + 2 x^2)
      yd = g y + 2 p2 x y + p1 (r2 + 2 y^2).
  """
  r2 = x * x + y * y
  gain = 1.0 + r2 * (k1 + r2 * (k2 + r2 * (k3 + r2 * k4)))
  xd = gain * x + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
  yd = gain * y + 2.0 * p2 * x * y + p1 * (r2 + 2.0 * y * y)
  return xd, yd


def _radial_and_tangential_undistort(xd, yd, k1=0, k2=0, k3=0, k4=0, p1=0,
                                     p2=0, eps: float = 1e-9,
                                     max_iterations=10,
                                     xnp: types.ModuleType = np):
  """Invert ``distort`` by a fixed count of Newton steps (numpy or torch).

  The distortion field is the gradient of a scalar potential, so its
  Jacobian is symmetric: three entries, and the 2x2 solve is Cramer's rule.
  A step whose Jacobian is singular (|det| <= eps) is skipped.
  """
  x = xd.clone() if xnp is torch else xnp.array(xd)
  y = yd.clone() if xnp is torch else xnp.array(yd)
  for _ in range(max_iterations):
    fx, fy = distort(x, y, k1=k1, k2=k2, k3=k3, k4=k4, p1=p1, p2=p2)
    fx = fx - xd
    fy = fy - yd

    r2 = x * x + y * y
    gain = 1.0 + r2 * (k1 + r2 * (k2 + r2 * (k3 + r2 * k4)))
    dgain = k1 + r2 * (2.0 * k2 + r2 * (3.0 * k3 + r2 * (4.0 * k4)))
    j_xx = gain + 2.0 * dgain * x * x + 2.0 * p1 * y + 6.0 * p2 * x
    j_yy = gain + 2.0 * dgain * y * y + 2.0 * p2 * x + 6.0 * p1 * y
    j_xy = 2.0 * dgain * x * y + 2.0 * p1 * x + 2.0 * p2 * y  # == j_yx

    det = j_xx * j_yy - j_xy * j_xy
    step_ok = xnp.abs(det) > eps
    ones, zeros = xnp.ones_like(det), xnp.zeros_like(det)
    inv_det = xnp.where(step_ok, 1.0 / xnp.where(step_ok, det, ones), zeros)
    x = x - inv_det * (j_yy * fx - j_xy * fy)
    y = y - inv_det * (j_xx * fy - j_xy * fx)
  return x, y


# --- NDC. ---------------------------------------------------------------------


def convert_to_ndc(origins, directions, pixtocam, near: float = 1.0,
                   xnp: types.ModuleType = np):
  """Warp rays into NDC space for forward-facing captures (numpy or torch).

  Assumes a pinhole projection with identity pose; rays with dz < 0 map into
  the [-1,1]^3 cube with valid near/far planes at 0 and 1.  See Appendix C
  of arxiv.org/abs/2003.08934.
  """
  # Shift origins onto the near plane (oz = -near) so the new near bound is 0.
  t = -(near + origins[..., 2]) / directions[..., 2]
  origins = origins + t[..., None] * directions

  dx, dy, dz = xnp.moveaxis(directions, -1, 0)
  ox, oy, oz = xnp.moveaxis(origins, -1, 0)

  xmult = 1.0 / pixtocam[0, 2]  # == -2 * focal / width
  ymult = 1.0 / pixtocam[1, 2]  # == -2 * focal / height

  # Perspective-project the near point (t=0) and the point at infinity.
  origins_ndc = xnp.stack(
      [xmult * ox / oz, ymult * oy / oz, -xnp.ones_like(oz)], -1)
  infinity_ndc = xnp.stack(
      [xmult * dx / dz, ymult * dy / dz, xnp.ones_like(oz)], -1)

  directions_ndc = infinity_ndc - origins_ndc
  return origins_ndc, directions_ndc


# --- Pixels -> rays. ----------------------------------------------------------


def _rotate(m, v, xnp):
  """m @ v over the last axes: [..., 3, 3] x [..., 3] -> [..., 3].  On
  tensors a full f32 product whatever the TF32 setting."""
  if xnp is torch:
    return mathx.matmul_hp(m, v[..., None])[..., 0]
  return xnp.matmul(m, v[..., None])[..., 0]


def pixels_to_rays(pix_x_int, pix_y_int, pixtocams, camtoworlds,
                   distortion_params=None, pixtocam_ndc=None,
                   camtype=ProjectionType.PERSPECTIVE, xnp=np):
  """Cast rays through pixel centers, with cone radii for mip-NeRF.

  Args:
    pix_x_int, pix_y_int: int arrays (shape SH) of pixel coordinates.
    pixtocams: [SH +] [3, 3] inverse intrinsics.
    camtoworlds: [SH +] [3, 4] camera-to-world extrinsics.
    distortion_params: optional OpenCV distortion coefficients (a dict).
    pixtocam_ndc: optional [3, 3] inverse intrinsics for the NDC warp.
    camtype: perspective or fisheye.
    xnp: numpy or torch.

  Returns:
    (origins, directions, viewdirs, radii, imageplane).
  """
  # The pixel center plus its +x and +y neighbours; the neighbours only
  # measure the cone footprint.
  probes = xnp.stack([
      xnp.stack([pix_x_int + ox + 0.5, pix_y_int + oy + 0.5,
                 xnp.ones_like(pix_x_int) * 1.0], -1)
      for ox, oy in ((0, 0), (1, 0), (0, 1))], 0)
  if xnp is torch:
    probes = probes.to(pixtocams.dtype)

  cam_dirs = _rotate(pixtocams, probes, xnp)  # Inverse intrinsics.

  if distortion_params is not None:
    if xnp is torch:  # Python floats: weak scalars of the tensors' f32.
      distortion_params = {k: float(v) for k, v in distortion_params.items()}
    u, v = _radial_and_tangential_undistort(
        cam_dirs[..., 0], cam_dirs[..., 1], **distortion_params, xnp=xnp)
    cam_dirs = xnp.stack([u, v, xnp.ones_like(u)], -1)

  if camtype == ProjectionType.FISHEYE:
    # Equidistant model: the plane radius is the polar angle; spin the unit
    # plane point onto the sphere (sin(t)/t rescales xy, z = cos(t)).
    radius = xnp.sqrt((cam_dirs[..., :2] * cam_dirs[..., :2]).sum(-1))
    theta = (radius.clamp(max=math.pi) if xnp is torch else
             xnp.minimum(xnp.pi, radius))
    sinc_t = (xnp.sin(theta) / theta)[..., None]
    cat = torch.cat if xnp is torch else xnp.concatenate
    cam_dirs = cat([cam_dirs[..., :2] * sinc_t, xnp.cos(theta)[..., None]],
                   -1)

  # OpenCV -> OpenGL: negate y and z.
  cam_dirs = xnp.stack([cam_dirs[..., 0], -cam_dirs[..., 1],
                        -cam_dirs[..., 2]], -1)
  imageplane = cam_dirs[0, ..., :2]

  directions, dx, dy = _rotate(camtoworlds[..., :3, :3], cam_dirs, xnp)
  origins = xnp.broadcast_to(camtoworlds[..., :3, -1], directions.shape)
  viewdirs = directions / _norm(directions, xnp)

  if pixtocam_ndc is None:
    footprint = (_norm(dx - directions, xnp)[..., 0] +
                 _norm(dy - directions, xnp)[..., 0])
  else:
    # In NDC the footprint comes from origin offsets, not direction offsets.
    origins_dx, _ = convert_to_ndc(origins, dx, pixtocam_ndc, xnp=xnp)
    origins_dy, _ = convert_to_ndc(origins, dy, pixtocam_ndc, xnp=xnp)
    origins, directions = convert_to_ndc(origins, directions, pixtocam_ndc,
                                         xnp=xnp)
    footprint = (_norm(origins_dx - origins, xnp)[..., 0] +
                 _norm(origins_dy - origins, xnp)[..., 0])
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


def cast_spherical_rays(camtoworld, height: int, width: int, near: float,
                        far: float, xnp=np) -> dtypes.Rays:
  """The rays of every pixel of a 360 equirectangular (pano) camera at
  `camtoworld` [3, 4], [H, W] batch dims (cameras.py:541-576).  On tensors
  the grid takes `camtoworld`'s dtype and device."""
  if xnp is torch:
    kw = dict(dtype=camtoworld.dtype, device=camtoworld.device)
    theta_vals = torch.linspace(0, 2 * math.pi, width + 1, **kw)
    phi_vals = torch.linspace(0, math.pi, height + 1, **kw)
    diff = lambda a, axis: torch.diff(a, dim=axis)
    norm = lambda a: torch.linalg.vector_norm(a, dim=-1)
  else:
    theta_vals = np.linspace(0, 2 * np.pi, width + 1)
    phi_vals = np.linspace(0, np.pi, height + 1)
    diff = lambda a, axis: np.diff(a, axis=axis)
    norm = lambda a: np.linalg.norm(a, axis=-1)
  theta, phi = xnp.meshgrid(theta_vals, phi_vals, indexing='xy')

  # Spherical directions in the camera frame (y up).
  directions = xnp.stack([
      -xnp.sin(phi) * xnp.sin(theta),
      xnp.cos(phi),
      xnp.sin(phi) * xnp.cos(theta),
  ], -1)
  directions = _rotate(camtoworld[:3, :3], directions, xnp)

  dy = diff(directions[:, :-1], 0)
  dx = diff(directions[:-1, :], 1)
  directions = directions[:-1, :-1]
  origins = xnp.broadcast_to(camtoworld[:3, -1], directions.shape)
  radii = (0.5 * (norm(dx) + norm(dy)))[..., None] * 2 / math.sqrt(12)
  imageplane = xnp.zeros_like(directions[..., :2])
  if xnp is torch:
    scalar = lambda v, dtype=radii.dtype: torch.full(
        radii.shape, v, dtype=dtype, device=radii.device)
  else:
    scalar = lambda v, dtype=None: np.broadcast_to(v, radii.shape)
  return dtypes.Rays(
      origins=origins, directions=directions, viewdirs=directions,
      radii=radii, imageplane=imageplane, lossmult=scalar(1.0),
      near=scalar(near), far=scalar(far), cam_idx=scalar(0, torch.int64))


def cameras_to_device(cameras, device):
  """A dataset's (pixtocams, camtoworlds, distortion_params, pixtocam_ndc)
  with its arrays as float32 tensors on `device`, for the torch cast."""
  pixtocams, camtoworlds, distortion_params, pixtocam_ndc = cameras
  as_f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
  return (as_f32(pixtocams), as_f32(camtoworlds), distortion_params,
          None if pixtocam_ndc is None else as_f32(pixtocam_ndc))
