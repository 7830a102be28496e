"""The capture cameras of the port against the JAX package's: the pose
helpers and the render paths (host numpy, the same calls: bitwise), and
distortion, undistortion, the NDC warp and ``pixels_to_rays`` with
distortion, NDC and fisheye projection, under ``xnp=np`` against JAX's
numpy run (bitwise) and under ``xnp=torch`` against JAX's ``jnp`` run (both
float32: within 1e-5, relative to the values' scale).

The one exception is the ellipse path's constant-speed resampling: JAX
runs ``stepfun.sample`` under ``jnp`` (float32, x64 off) and the port under
torch (float32), whose softmax and cumulative sum round the last bits
otherwise: the angles of a 120-frame path differ by up to 2 float32 ulps
(9.5e-7 at 2 pi).  The poses, in a scene scaled into [-1, 1]^3, are held
to 1e-5; without the resampling the path is bitwise.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), 'helpers'))
import torch_parity as tp  # noqa: E402

from multinerf_tpu.data import cameras as jcam  # noqa: E402
from multinerf_tpu_torch.data import cameras as cam  # noqa: E402

# pylint: disable=protected-access
F32_TOL = 1e-5


def _poses(n=9, seed=0):
  """Cameras around the origin at varied heights, looking inward, with a
  little noise: a generic capture."""
  rng = np.random.RandomState(seed)
  poses = []
  for i in range(n):
    theta = 2 * np.pi * i / n + 0.1 * rng.randn()
    pos = np.array([3 * np.cos(theta), 2.5 * np.sin(theta),
                    0.8 + 0.3 * rng.randn()]) + 0.2
    poses.append(jcam.viewmatrix(pos + 0.1 * rng.randn(3),
                                 np.array([0.0, 0.05, 1.0]), pos))
  return np.stack(poses)


def _forward_poses(n=8, seed=1):
  """Forward-facing cameras on a plane, looking down -z."""
  rng = np.random.RandomState(seed)
  poses = []
  for i in range(n):
    pos = np.array([0.5 * np.cos(i), 0.3 * np.sin(1.7 * i), 0.0])
    pos += 0.02 * rng.randn(3)
    poses.append(jcam.viewmatrix(np.array([0.0, 0.0, 1.0]) +
                                 0.05 * rng.randn(3),
                                 np.array([0.0, 1.0, 0.0]), pos))
  return np.stack(poses)


def test_pose_helpers_are_bitwise_jax():
  poses = _poses()
  np.testing.assert_array_equal(cam.pad_poses(poses), jcam.pad_poses(poses))
  np.testing.assert_array_equal(cam.unpad_poses(cam.pad_poses(poses)),
                                jcam.unpad_poses(jcam.pad_poses(poses)))
  np.testing.assert_array_equal(cam.average_pose(poses),
                                jcam.average_pose(poses))
  for got, want in zip(cam.recenter_poses(poses), jcam.recenter_poses(poses)):
    np.testing.assert_array_equal(got, want)
  np.testing.assert_array_equal(cam.focus_point_fn(poses),
                                jcam.focus_point_fn(poses))
  for flip in (False, True):  # An upside-down capture takes the half turn.
    p = poses @ np.diag([1.0, -1.0, -1.0, 1.0]) if flip else poses
    for got, want in zip(cam.transform_poses_pca(p.copy()),
                         jcam.transform_poses_pca(p.copy())):
      np.testing.assert_array_equal(got, want)


def test_render_paths_are_jax():
  poses = _poses()
  fposes = _forward_poses()
  bounds = np.array([[0.9, 7.0], [1.1, 9.0]])
  np.testing.assert_array_equal(
      cam.generate_spiral_path(fposes, bounds, n_frames=12),
      jcam.generate_spiral_path(fposes, bounds, n_frames=12))
  pca, _ = jcam.transform_poses_pca(poses.copy())
  for z_variation, z_phase in ((0.0, 0.0), (0.5, 0.25)):
    kw = dict(n_frames=120, z_variation=z_variation, z_phase=z_phase)
    np.testing.assert_array_equal(
        cam.generate_ellipse_path(pca, const_speed=False, **kw),
        jcam.generate_ellipse_path(pca, const_speed=False, **kw))
    tp.assert_close(cam.generate_ellipse_path(pca, **kw),
                    jcam.generate_ellipse_path(pca, **kw), 1e-5,
                    what='ellipse path')
  np.testing.assert_array_equal(
      cam.generate_interpolated_path(pca[:6], 4),
      jcam.generate_interpolated_path(pca[:6], 4))
  x = np.log(np.linspace(0.5, 2.0, 7) ** 2)
  np.testing.assert_array_equal(cam.interpolate_1d(x, 3, 5, 20),
                                jcam.interpolate_1d(x, 3, 5, 20))


@pytest.mark.parametrize('keyframes', ['dir', 'file'])
def test_spline_path_is_jax(tmp_path, keyframes):
  pca, _ = jcam.transform_poses_pca(_poses().copy())
  names = [f'img_{i:02d}.png' for i in range(len(pca))]
  chosen = names[1:8]
  if keyframes == 'dir':
    path = tmp_path / 'keyframes'
    os.makedirs(path)
    for name in chosen:
      (path / name).write_bytes(b'')
  else:
    path = tmp_path / 'keyframes.txt'
    path.write_text('\n'.join(chosen))
  exposures = np.linspace(0.01, 0.04, len(pca))
  jax_config, torch_config = tp.configs((
      f"Config.render_spline_keyframes = '{path}'",
      'Config.render_spline_n_interp = 3',
      'Config.render_spline_interpolate_exposure = True'))
  got = cam.create_render_spline_path(torch_config, names, pca, exposures)
  want = jcam.create_render_spline_path(jax_config, names, pca, exposures)
  for g, w in zip(got, want):
    np.testing.assert_array_equal(g, w)


DISTORTIONS = {
    'radial': dict(k1=0.05, k2=-0.01, k3=0.0, p1=0.0, p2=0.0),
    'opencv': dict(k1=-0.08, k2=0.012, k3=0.0, p1=0.0015, p2=-0.001),
    'fisheye': dict(k1=0.02, k2=-0.003, k3=0.0005, k4=-0.0001),
}


def _plane_points(n=500, seed=2):
  rng = np.random.RandomState(seed)
  return (rng.uniform(-0.7, 0.7, (n,)).astype(np.float32),
          rng.uniform(-0.5, 0.5, (n,)).astype(np.float32))


@pytest.mark.parametrize('kind', sorted(DISTORTIONS))
def test_distort_and_undistort_match_jax(kind):
  params = DISTORTIONS[kind]
  x, y = _plane_points()
  # numpy: the same operations in the same order.
  for got, want in zip(cam.distort(x, y, **params),
                       jcam.distort(x, y, **params)):
    np.testing.assert_array_equal(got, want)
  xd, yd = jcam.distort(x, y, **params)
  undistort = cam._radial_and_tangential_undistort
  jundistort = jcam._radial_and_tangential_undistort
  np_got = undistort(xd, yd, **params, xnp=np)
  np_want = jundistort(xd, yd, **params, xnp=np)
  for got, want in zip(np_got, np_want):
    np.testing.assert_array_equal(got, want)
  # The Newton steps invert the distortion.
  tp.assert_close(np_got[0], x, 1e-5, what='undistorted x')
  # torch against jnp, float32.
  t_got = undistort(torch.from_numpy(xd), torch.from_numpy(yd), **params,
                    xnp=torch)
  j_want = jundistort(jnp.asarray(xd), jnp.asarray(yd), **params, xnp=jnp)
  for got, want in zip(t_got, j_want):
    assert got.dtype == torch.float32
    tp.assert_close(got.numpy(), np.asarray(want), F32_TOL, what=kind)


def test_convert_to_ndc_matches_jax():
  rng = np.random.RandomState(3)
  origins = (rng.randn(200, 3) * 0.1).astype(np.float32)
  directions = np.concatenate([rng.uniform(-0.5, 0.5, (200, 2)),
                               -rng.uniform(0.8, 1.2, (200, 1))],
                              -1).astype(np.float32)
  pixtocam = cam.get_pixtocam(40.0, 64, 48).astype(np.float32)
  for got, want in zip(cam.convert_to_ndc(origins, directions, pixtocam),
                       jcam.convert_to_ndc(origins, directions, pixtocam)):
    np.testing.assert_array_equal(got, want)
  got = cam.convert_to_ndc(*map(torch.from_numpy,
                                (origins, directions, pixtocam)), xnp=torch)
  want = jcam.convert_to_ndc(*map(jnp.asarray, (origins, directions,
                                                pixtocam)), xnp=jnp)
  for g, w in zip(got, want):
    tp.assert_close(g.numpy(), np.asarray(w), F32_TOL, F32_TOL, what='ndc')


CASTS = {
    'perspective': dict(),
    'radial': dict(distortion_params=DISTORTIONS['radial']),
    'opencv': dict(distortion_params=DISTORTIONS['opencv']),
    'fisheye': dict(distortion_params=DISTORTIONS['fisheye'],
                    camtype='fisheye'),
    'ndc': dict(ndc=True),
    'ndc_opencv': dict(distortion_params=DISTORTIONS['opencv'], ndc=True),
}


def _cast_inputs(ndc):
  """Pixels of a 24 x 20 image; per-pixel cameras of a capture (stacked,
  indexed as cast_ray_batch indexes them) or a single camera."""
  width, height = 24, 20
  pix_x, pix_y = np.meshgrid(np.arange(width), np.arange(height),
                             indexing='xy')
  pixtocam = cam.get_pixtocam(22.0, width, height).astype(np.float32)
  poses = (_forward_poses(4) if ndc else _poses(4)).astype(np.float32)
  cam_idx = (pix_x + pix_y) % 4
  return pix_x, pix_y, np.broadcast_to(pixtocam, (4, 3, 3))[cam_idx], (
      poses[cam_idx]), pixtocam


@pytest.mark.parametrize('case', sorted(CASTS))
def test_pixels_to_rays_matches_jax(case):
  kw = dict(CASTS[case])
  ndc = kw.pop('ndc', False)
  if 'camtype' in kw:
    kw['camtype'] = cam.ProjectionType(kw['camtype'])
  pix_x, pix_y, pixtocams, camtoworlds, pixtocam = _cast_inputs(ndc)
  jkw = dict(kw)
  if 'camtype' in kw:
    jkw['camtype'] = jcam.ProjectionType(kw['camtype'].value)
  ndc_np = pixtocam if ndc else None
  got = cam.pixels_to_rays(pix_x, pix_y, pixtocams, camtoworlds,
                           pixtocam_ndc=ndc_np, xnp=np, **kw)
  want = jcam.pixels_to_rays(pix_x, pix_y, pixtocams, camtoworlds,
                             pixtocam_ndc=ndc_np, xnp=np, **jkw)
  fields = ('origins', 'directions', 'viewdirs', 'radii', 'imageplane')
  for name, g, w in zip(fields, got, want):
    assert g.dtype == w.dtype, name
    np.testing.assert_array_equal(g, w, err_msg=f'{case} {name}')
  got = cam.pixels_to_rays(
      *map(torch.from_numpy, (pix_x, pix_y, pixtocams, camtoworlds)),
      pixtocam_ndc=torch.from_numpy(pixtocam) if ndc else None, xnp=torch,
      **kw)
  want = jcam.pixels_to_rays(
      *map(jnp.asarray, (pix_x, pix_y, pixtocams, camtoworlds)),
      pixtocam_ndc=jnp.asarray(pixtocam) if ndc else None, xnp=jnp, **jkw)
  for name, g, w in zip(fields, got, want):
    assert g.dtype == torch.float32, name
    w = np.asarray(w)
    tp.assert_close(g.numpy(), w, F32_TOL * max(1.0, np.abs(w).max()),
                    what=f'{case} {name}')
