"""Coordinate-space warps and ray-distance parameterizations.

Torch port of ``multinerf_tpu.ops.coord``: the scene contraction, its
inverse and its analytic Gaussian warp, ``track_linearize`` for any warp,
the t <-> s ray-distance bijection, the integrated positional encoding
(composed from ``lift_and_diagonalize``, and lifted, direct or in its
recurrence form) and ``pos_enc``.  Every function is differentiable in the
Gaussians' means, as the density-gradient normals of Ref-NeRF need.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from multinerf_tpu_torch.ops import mathx

_F32_EPS = float(np.finfo(np.float32).eps)


def contract(x):
  """mip-NeRF 360 scene contraction (Eq 10 of arxiv.org/abs/2111.12077)."""
  r_sq = torch.clamp(torch.sum(x**2, dim=-1, keepdim=True), min=_F32_EPS)
  scale = (2 * torch.sqrt(r_sq) - 1) / r_sq
  return torch.where(r_sq <= 1, x, scale * x)


def inv_contract(z):
  """Inverse of contract()."""
  r_sq = torch.clamp(torch.sum(z**2, dim=-1, keepdim=True), min=_F32_EPS)
  return torch.where(r_sq <= 1, z, z / (2 * torch.sqrt(r_sq) - r_sq))


def contract_gaussian(mean, cov):
  """Warp Gaussians (mean [..., 3], cov [..., 3, 3]) through contract().

  Outside the unit ball J = g I + c x x^T with g = (2r - 1)/r^2 and
  c = (2 - 2r)/r^4, and cov' = J cov J^T expands term for term as in
  coord.py:39-73.  At far = 1e6 the three terms cancel to a few ulps, so
  their order is kept exactly.
  """
  r_sq = torch.clamp(torch.sum(mean**2, dim=-1, keepdim=True), min=_F32_EPS)
  r = torch.sqrt(r_sq)
  g = (2 * r - 1) / r_sq
  c = (2 - 2 * r) / (r_sq * r_sq)

  inside = r_sq <= 1
  new_mean = torch.where(inside, mean, g * mean)

  m = torch.einsum('...ij,...j->...i', cov, mean)  # cov @ x
  xcx = torch.sum(mean * m, dim=-1)  # x^T cov x
  outer_xm = mean[..., :, None] * m[..., None, :]
  outer_xx = mean[..., :, None] * mean[..., None, :]
  g_ = g[..., None]
  c_ = c[..., None]
  new_cov = (g_**2 * cov
             + g_ * c_ * (outer_xm + outer_xm.transpose(-1, -2))
             + c_**2 * xcx[..., None, None] * outer_xx)
  new_cov = torch.where(inside[..., None], cov, new_cov)
  return new_mean, new_cov


def track_linearize(fn, mean, cov):
  """Warp Gaussians through fn: (fn(mean), J cov J^T), J the Jacobian of
  fn at each mean (coord.py:76-92).  ``contract`` takes the analytic path;
  any other warp pushes the covariance's columns, then the result's, through
  the warp's linearization (one ``torch.func.jvp`` per column)."""
  if mean.dim() + 1 != cov.dim():
    raise ValueError('cov must be a full (non-diagonal) covariance.')
  if fn is contract:
    return contract_gaussian(mean, cov)

  def push(m):
    """[..., 3, 3] -> [..., 3, 3]: out[..., j, :] = J m[..., :, j]."""
    return torch.stack(
        [torch.func.jvp(fn, (mean,), (m[..., :, j],))[1]
         for j in range(m.shape[-1])], dim=-2)

  return fn(mean), push(push(cov))


_INVERSES = {
    'reciprocal': torch.reciprocal,
    'log': torch.exp,
    'exp': torch.log,
    'sqrt': torch.square,
    'square': torch.sqrt,
}


def construct_ray_warps(fn, t_near, t_far):
  """(t_to_s, s_to_t): metric ray distance <-> normalized distance in [0, 1].

  `fn` is None (identity), 'piecewise', or one of torch.reciprocal/log/exp/
  sqrt/square (matched by name, as the JAX version matches jnp's).
  """
  if fn is None:
    fwd, inv = (lambda x: x), (lambda x: x)
  elif fn == 'piecewise':
    fwd = lambda x: torch.where(x < 1, 0.5 * x, 1 - 0.5 / x)
    inv = lambda x: torch.where(x < 0.5, 2 * x, 0.5 / (1 - x))
  else:
    fwd = fn
    inv = _INVERSES[fn.__name__]

  s_near, s_far = fwd(t_near), fwd(t_far)
  t_to_s = lambda t: (fwd(t) - s_near) / (s_far - s_near)
  s_to_t = lambda s: inv(s * s_far + (1 - s) * s_near)
  return t_to_s, s_to_t


def expected_sin(mean, var):
  """E[sin(x)] for x ~ N(mean, var)."""
  return torch.exp(-0.5 * var) * mathx.safe_sin(mean)


def integrated_pos_enc(mean, var, min_deg, max_deg):
  """Integrated positional encoding (mip-NeRF Eq 14): each coordinate's sin
  at scales 2^[min_deg, max_deg), attenuated by its variance; the cos half
  is the sin shifted by pi/2.  [..., d] -> [..., 2 * d * (max - min)]."""
  scales = 2.0**torch.arange(min_deg, max_deg, dtype=mean.dtype,
                             device=mean.device)
  shape = mean.shape[:-1] + (-1,)
  sm = torch.reshape(mean[..., None, :] * scales[:, None], shape)
  sv = torch.reshape(var[..., None, :] * scales[:, None]**2, shape)
  return expected_sin(torch.cat([sm, sm + 0.5 * math.pi], dim=-1),
                      torch.cat([sv, sv], dim=-1))


def lift_and_diagonalize(mean, cov, basis):
  """Project (mean, cov) onto `basis` [3, L] columns, keeping only the
  diagonal variances."""
  basis = mathx.constant(basis, mean.device)
  lifted_mean = mathx.matmul_hp(mean, basis)
  lifted_var = torch.sum(basis * mathx.matmul_hp(cov, basis), dim=-2)
  return lifted_mean, lifted_var


def integrated_pos_enc_lifted(mean, cov, basis, min_deg, max_deg):
  """lift_and_diagonalize + integrated_pos_enc in one (coord.py:168-222):
  the degree recurrence past two degrees, else the direct sin/exp form with
  the frequency scaling folded into the projections.  f32 features."""
  if max_deg - min_deg > 2:
    return integrated_pos_enc_lifted_recurrence(mean, cov, basis, min_deg,
                                                max_deg)
  basis = np.asarray(basis)
  scales = 2.0**np.arange(min_deg, max_deg)
  b_scaled = np.concatenate([basis * s for s in scales], axis=-1)
  bb = np.einsum('ik,jk->ijk', basis, basis).reshape(9, basis.shape[-1])
  bb_scaled = np.concatenate([bb * (s * s) for s in scales], axis=-1)
  args = mathx.matmul_hp(mean, mathx.constant(b_scaled, mean.device))
  var = mathx.matmul_hp(cov.reshape(cov.shape[:-2] + (9,)),
                        mathx.constant(bb_scaled, mean.device))
  atten = torch.exp(-0.5 * var)
  return torch.cat([atten * mathx.safe_sin(args),
                    atten * mathx.safe_sin(args + 0.5 * math.pi)], dim=-1)


def lifted_basis(basis, min_deg):
  """(basis_t [L, 3], bb_t [L, 9]) f32 numpy, scaled to degree min_deg.

  Row l of bb_t is vec(b_l b_l^T), so the lifted variance is bb_t @ vec(cov).
  """
  basis = np.asarray(basis, np.float32)  # [3, L]
  base = 2.0**min_deg
  basis_t = np.asarray(base * basis.T, np.float32)
  bb_t = np.asarray(
      (base * base) *
      np.einsum('ik,jk->kij', basis, basis).reshape(basis.shape[-1], 9),
      np.float32)
  return basis_t, bb_t


def integrated_pos_enc_lifted_recurrence(mean, cov, basis, min_deg, max_deg,
                                         anchor_every=4):
  """Lifted IPE with degree recurrences (coord.py:224-302).

  Every ``anchor_every``-th degree evaluates sin/cos/exp directly; the
  degrees in between use sin 2a = 2 sin a cos a, cos 2a = 1 - 2 sin^2 a and
  two squarings of the attenuation.  Feature f = d * L + l holds the sin of
  degree d and basis direction l, and feature D * L + f its cos: the JAX
  row order, which JAX weights depend on.

  Args:
    mean: [..., 3]; cov: [..., 3, 3]; basis: [3, L] numpy.

  Returns:
    [..., 2 * L * (max_deg - min_deg)] f32 features.
  """
  basis_t, bb_t = lifted_basis(basis, min_deg)
  batch_shape = mean.shape[:-1]
  mean_flat = mean.reshape(-1, 3)
  cov_flat = cov.reshape(-1, 9)
  # [N, L]; full f32 (the einsums of coord.py:276-279 are HIGHEST).
  args0 = mathx.matmul_hp(mean_flat, mathx.constant(basis_t.T, mean.device))
  var0 = mathx.matmul_hp(cov_flat, mathx.constant(bb_t.T, mean.device))

  sins, coss = [], []
  s = c = e = None
  for d in range(max_deg - min_deg):
    if d % anchor_every == 0:
      freq = 2.0**d
      a = args0 if d == 0 else freq * args0
      s, c = mathx.safe_sin(a), mathx.safe_cos(a)
      e = torch.exp((-0.5 * freq * freq) * var0)
    else:
      s, c = 2.0 * (s * c), 1.0 - 2.0 * (s * s)
      e2 = e * e
      e = e2 * e2
    sins.append(e * s)
    coss.append(e * c)
  feats = torch.cat(sins + coss, dim=-1)
  return feats.reshape(batch_shape + (feats.shape[-1],))


def pos_enc(x, min_deg, max_deg, append_identity=True):
  """Classic NeRF positional encoding (no integration)."""
  scales = 2.0**torch.arange(min_deg, max_deg, dtype=x.dtype, device=x.device)
  shape = x.shape[:-1] + (-1,)
  sx = torch.reshape(x[..., None, :] * scales[:, None], shape)
  feats = torch.sin(torch.cat([sx, sx + 0.5 * math.pi], dim=-1))
  if append_identity:
    return torch.cat([x, feats], dim=-1)
  return feats
