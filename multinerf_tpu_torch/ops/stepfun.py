"""Step-function algebra for hierarchical sampling and its losses.

Torch port of the parts of ``multinerf_tpu.ops.stepfun`` that rendering and
training run: max-dilation of the proposal histogram, the stratified
inverse-CDF sampler (deterministic, or jittered from a ``torch.Generator``),
interval sampling, weighted percentiles, the proposal (outer-measure) loss
and the O(n) distortion loss.  The ``MULTINERF_REFERENCE_ALGOS`` variants
of the JAX package are not ported.  Conventions as there: ``t`` are sorted
endpoints [..., n+1], ``w`` bin weights [..., n].
"""

from __future__ import annotations

import math

import numpy as np
import torch

from multinerf_tpu_torch.ops import mathx

_F32_EPS = float(np.finfo(np.float32).eps)


def weight_to_pdf(t, w, eps=_F32_EPS**2):
  """Weights (sum<=1) -> densities (integral<=1) over bins of t."""
  return w / torch.clamp(t[..., 1:] - t[..., :-1], min=eps)


def pdf_to_weight(t, p):
  """Densities -> weights over bins of t."""
  return p * (t[..., 1:] - t[..., :-1])


def max_dilate(t, w, dilation, domain=(-math.inf, math.inf)):
  """Max-pool dilate a non-negative step function by +-dilation."""
  t0 = t[..., :-1] - dilation
  t1 = t[..., 1:] + dilation
  t_d = torch.sort(torch.cat([t, t0, t1], dim=-1), dim=-1).values
  t_d = torch.clamp(t_d, *domain)
  # New bin value = max over all dilated source bins covering its left edge.
  covers = ((t0[..., None, :] <= t_d[..., None]) &
            (t1[..., None, :] > t_d[..., None]))
  w_d = torch.where(covers, w[..., None, :], 0).amax(dim=-1)[..., :-1]
  return t_d, w_d


def max_dilate_weights(t, w, dilation, domain=(-math.inf, math.inf),
                       renormalize=False, eps=_F32_EPS**2):
  """Dilate weights in *density* space so wide bins don't dominate."""
  p = weight_to_pdf(t, w)
  t_d, p_d = max_dilate(t, p, dilation, domain=domain)
  w_d = pdf_to_weight(t_d, p_d)
  if renormalize:
    w_d = w_d / torch.clamp(torch.sum(w_d, dim=-1, keepdim=True), min=eps)
  return t_d, w_d


def integrate_weights(w):
  """CDF fenceposts of w: starts at exactly 0, ends at exactly 1."""
  cw = torch.clamp(torch.cumsum(w[..., :-1], dim=-1), max=1)
  pad = torch.zeros(cw.shape[:-1] + (1,), dtype=cw.dtype, device=cw.device)
  return torch.cat([pad, cw, torch.ones_like(pad)], dim=-1)


def invert_cdf(u, t, w_logits, use_gpu_resampling=False):
  """Inverse-CDF lookup of the step fn (t, softmax(w_logits)) at u."""
  w = torch.softmax(w_logits, dim=-1)
  cw = integrate_weights(w)
  interp = mathx.interp_gather if use_gpu_resampling else mathx.interp_sorted
  return interp(u, cw, t)


def sample(rng, t, w_logits, num_samples, single_jitter=False,
           deterministic_center=False, use_gpu_resampling=False):
  """Stratified inverse-CDF sampling from a step function.

  One sample per stratum of [0, 1).  With ``rng=None`` the samples sit at
  fixed points of their strata; with a ``torch.Generator`` each stratum
  ``[i * pitch, i * pitch + pitch - eps)`` gets a uniform jitter, shared
  along a ray with ``single_jitter`` (stepfun.py:174-201).  The generator
  lives on t's device; its bits are not JAX's.
  """
  eps = _F32_EPS
  strata = torch.arange(num_samples, dtype=t.dtype, device=t.device)
  if rng is None:
    if deterministic_center:
      pad = 1 / (2 * num_samples)
      u = pad + strata * ((1 - 2 * pad - eps) / (num_samples - 1))
    else:
      u = strata * ((1 - eps) / (num_samples - 1))
    u = torch.broadcast_to(u, t.shape[:-1] + (num_samples,))
  else:
    u_max = eps + (1 - eps) / num_samples
    pitch = (1 - u_max) / (num_samples - 1)
    jitter_shape = t.shape[:-1] + ((1,) if single_jitter else (num_samples,))
    u = strata * pitch + torch.rand(jitter_shape, generator=rng,
                                    dtype=t.dtype, device=t.device) * (
                                        pitch - eps)
  return invert_cdf(u, t, w_logits, use_gpu_resampling=use_gpu_resampling)


def sample_intervals(rng, t, w_logits, num_samples, single_jitter=False,
                     domain=(-math.inf, math.inf), use_gpu_resampling=False):
  """Sample `num_samples` intervals: [..., num_samples + 1] sorted fences.

  Midpoints of stratum-centered samples, with a linearly extrapolated
  ghost sample past each end; the end fences are clamped to `domain`.
  """
  if num_samples <= 1:
    raise ValueError(f'num_samples must be > 1, got {num_samples}.')
  centers = sample(rng, t, w_logits, num_samples, single_jitter,
                   deterministic_center=True,
                   use_gpu_resampling=use_gpu_resampling)
  ghost_lo = 2 * centers[..., :1] - centers[..., 1:2]
  ghost_hi = 2 * centers[..., -1:] - centers[..., -2:-1]
  padded = torch.cat([ghost_lo, centers, ghost_hi], dim=-1)
  fences = 0.5 * (padded[..., :-1] + padded[..., 1:])
  minval, maxval = domain
  return torch.cat([
      torch.clamp(fences[..., :1], min=minval), fences[..., 1:-1],
      torch.clamp(fences[..., -1:], max=maxval)
  ], dim=-1)


def weighted_percentile(t, w, ps):
  """Percentiles of the step fn (t, w); w must sum to 1 along the last axis."""
  cw = integrate_weights(w)
  q = torch.broadcast_to(
      mathx.constant(np.asarray(ps) / 100, t.device, t.dtype),
      t.shape[:-1] + (len(ps),))
  return mathx.interp_sorted(q, cw, t)


def outer_measure(t0, t1, y1):
  """Upper bound on the mass of (t1, y1) touching each bin of t0:
  outer[i] = sum_j y1[j] * 1[t1[j] <= t0[i+1] and t1[j+1] > t0[i]]."""
  left = t1[..., :-1, None] <= t0[..., None, 1:]  # [..., m, n]
  right = t1[..., 1:, None] > t0[..., None, :-1]
  return torch.sum(torch.where(left & right, y1[..., None], 0), dim=-2)


def lossfun_outer(t, w, t_env, w_env, eps=_F32_EPS):
  """Proposal loss: the mass of (t, w) above the upper envelope of
  (t_env, w_env), half-quadratic and scaled by 1 / w."""
  w_outer = outer_measure(t, t_env, w_env)
  return torch.clamp(w - w_outer, min=0)**2 / (w + eps)


def lossfun_distortion(t, w):
  """Distortion loss of mip-NeRF 360 (Eq 15), in the O(n) prefix-sum form:
  sum_ij w_i w_j |m_i - m_j| = 2 sum_i w_i (m_i P_i - Q_i), P and Q the
  exclusive prefix sums of w and w * m, plus the intra-bin w^2 width / 3."""
  mids = 0.5 * (t[..., 1:] + t[..., :-1])
  wm = w * mids
  p = torch.cumsum(w, dim=-1) - w
  q = torch.cumsum(wm, dim=-1) - wm
  loss_inter = 2 * torch.sum(w * (mids * p - q), dim=-1)
  loss_intra = torch.sum(w**2 * (t[..., 1:] - t[..., :-1]), dim=-1) / 3
  return loss_inter + loss_intra
