"""Ray casting (frustum -> Gaussian) and volumetric rendering.

Torch port of ``multinerf_tpu.ops.rendering``: the stable conical-frustum
moments, the alpha-compositing weights (with the opaque-background option)
and the rendering dictionary with its distance statistics.
"""

from __future__ import annotations

import numpy as np
import torch

from multinerf_tpu_torch.ops import stepfun

_F32_EPS = float(np.finfo(np.float32).eps)


def lift_gaussian(d, t_mean, t_var, r_var):
  """Lift a 1D Gaussian along ray direction d into 3D (mean, full cov)."""
  mean = d[..., None, :] * t_mean[..., None]
  dir_sq_norm = torch.clamp(torch.sum(d**2, dim=-1, keepdim=True), min=1e-10)
  along_outer = d[..., :, None] * d[..., None, :]
  eye = torch.eye(d.shape[-1], dtype=d.dtype, device=d.device)
  perp_outer = eye - d[..., :, None] * (d / dir_sq_norm)[..., None, :]
  cov = (t_var[..., None, None] * along_outer[..., None, :, :] +
         r_var[..., None, None] * perp_outer[..., None, :, :])
  return mean, cov


def conical_frustum_to_gaussian(d, t0, t1, base_radius):
  """Moment-match a conical frustum along ray d (stable form, Eq 7 of
  mip-NeRF); `base_radius` is the cone radius at distance 1."""
  mid = (t0 + t1) / 2
  half = (t1 - t0) / 2
  denom = torch.clamp(3 * mid**2 + half**2, min=_F32_EPS)
  t_mean = mid + (2 * mid * half**2) / denom
  t_var = half**2 / 3 - (4 / 15) * half**4 * (12 * mid**2 - half**2) / denom**2
  r_var = mid**2 / 4 + (5 / 12) * half**2 - (4 / 15) * half**4 / denom
  r_var = r_var * base_radius**2
  return lift_gaussian(d, t_mean, t_var, r_var)


def cylinder_to_gaussian(d, t0, t1, radius):
  """Moment-match a cylinder section along ray d to a Gaussian."""
  t_mean = (t0 + t1) / 2
  r_var = radius**2 / 4
  t_var = (t1 - t0)**2 / 12
  return lift_gaussian(d, t_mean, t_var, r_var)


def cast_rays(tdist, origins, directions, radii, ray_shape):
  """Per-ray fencepost distances [..., s+1] -> (means [..., s, 3],
  covs [..., s, 3, 3]) in world space: the full covariances (diag=False
  in the JAX package), which the fused kernels take."""
  t0, t1 = tdist[..., :-1], tdist[..., 1:]
  if ray_shape == 'cone':
    to_gaussian = conical_frustum_to_gaussian
  elif ray_shape == 'cylinder':
    to_gaussian = cylinder_to_gaussian
  else:
    raise ValueError(f"ray_shape must be 'cone' or 'cylinder', got {ray_shape}")
  means, covs = to_gaussian(directions, t0, t1, radii)
  return means + origins[..., None, :], covs


def compute_alpha_weights(density, tdist, dirs, opaque_background=False):
  """(weights, alpha, transmittance) of densities over distance intervals."""
  t_delta = tdist[..., 1:] - tdist[..., :-1]
  delta = t_delta * torch.linalg.norm(dirs[..., None, :], dim=-1)
  optical_depth = density * delta

  if opaque_background:
    optical_depth = torch.cat(
        [optical_depth[..., :-1],
         torch.full_like(optical_depth[..., -1:], torch.inf)], dim=-1)

  alpha = 1 - torch.exp(-optical_depth)
  transmittance = torch.exp(-torch.cat(
      [torch.zeros_like(optical_depth[..., :1]),
       torch.cumsum(optical_depth[..., :-1], dim=-1)], dim=-1))
  weights = alpha * transmittance
  return weights, alpha, transmittance


def volumetric_rendering(rgbs, weights, tdist, bg_rgbs, t_far, compute_extras,
                         extras=None):
  """Composite per-sample colors/values into per-ray renderings.

  Returns a dict with 'rgb' and, with compute_extras, 'acc',
  'distance_mean', 'distance_median', 'distance_percentile_{5,95}' and
  every entry of `extras` ({name: [..., s, c] per-sample values, or None})
  composited by the weights.
  """
  rendering = {}

  acc = weights.sum(dim=-1)
  bg_weight = torch.clamp(1 - acc[..., None], min=0)
  rendering['rgb'] = ((weights[..., None] * rgbs).sum(dim=-2) +
                      bg_weight * bg_rgbs)

  if compute_extras:
    rendering['acc'] = acc
    for k, v in (extras or {}).items():
      if v is not None:
        rendering[k] = (weights[..., None] * v).sum(dim=-2)

    def acc_weighted_mean(x):
      return (weights * x).sum(dim=-1) / torch.clamp(acc, min=_F32_EPS)
    midpoints = 0.5 * (tdist[..., :-1] + tdist[..., 1:])
    # Log-space expectation for stability over huge depth ranges.
    rendering['distance_mean'] = torch.clamp(
        torch.nan_to_num(torch.exp(acc_weighted_mean(torch.log(midpoints))),
                         nan=torch.inf),
        tdist[..., 0], tdist[..., -1])

    # A far-plane fencepost carries the background weight, so the weights
    # sum to exactly 1 before taking percentiles.
    fence_dists = torch.cat([tdist, t_far], dim=-1)
    fence_weights = torch.cat([weights, bg_weight], dim=-1)
    ps = [5, 50, 95]
    pct = stepfun.weighted_percentile(fence_dists, fence_weights, ps)
    for i, p in enumerate(ps):
      name = 'median' if p == 50 else f'percentile_{p}'
      rendering[f'distance_{name}'] = pct[..., i]

  return rendering
