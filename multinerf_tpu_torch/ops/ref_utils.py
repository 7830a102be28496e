"""Reflection directions and (integrated) directional encodings for Ref-NeRF.

Torch port of ``multinerf_tpu.ops.ref_utils`` (Eq 6-8 of
arxiv.org/abs/2112.03907).  The spherical-harmonic coefficient tables are
pure numpy, copied here so the port imports nothing of the JAX package.
The azimuthal factor (x + iy)^m comes from a real recurrence, as there.

The IDE's polar part is a Vandermonde in z up to z^16 against a table of
large alternating coefficients (up to 9e4 at l = 16): the terms cancel to
O(1), so its product runs in full f32 (``mathx.matmul_hp``, the JAX
package's ``Precision.HIGHEST``), never in TF32 or bf16.  Even in f32 the
cancellation leaves ~5e-3 of rounding in the l = 16 components, in both
packages; they differ from each other by about that much.
"""

from __future__ import annotations

import math as pymath

import numpy as np
import torch

from multinerf_tpu_torch.ops import mathx

_F32_EPS = float(np.finfo(np.float32).eps)


def reflect(viewdirs, normals):
  """Reflect view directions about unit normals: u = 2(n.v)n - v."""
  return 2.0 * torch.sum(normals * viewdirs, dim=-1,
                         keepdim=True) * normals - viewdirs


def l2_normalize(x, eps=_F32_EPS):
  """Normalize x to unit length along the last axis (grad-safe at 0)."""
  return x / torch.sqrt(torch.clamp(torch.sum(x**2, dim=-1, keepdim=True),
                                    min=eps))


def compute_weighted_mae(weights, normals, normals_gt, weight_sum=None):
  """Weighted mean angular error in degrees; normals assumed unit length.
  `weight_sum` replaces the weights' own sum as the denominator (a sum over
  ranks, of which this call then gives one rank's share)."""
  one_eps = 1 - _F32_EPS
  angles = torch.arccos(
      torch.clamp((normals * normals_gt).sum(-1), -one_eps, one_eps))
  if weight_sum is None:
    weight_sum = weights.sum()
  return (weights * angles).sum() / weight_sum * 180.0 / np.pi


def generalized_binomial_coeff(a, k):
  """Generalized binomial coefficient C(a, k) for real a."""
  return np.prod(a - np.arange(k)) / pymath.factorial(k)


def assoc_legendre_coeff(l, m, k):
  """Coefficient of cos^k sin^m in the associated Legendre polynomial P_l^m."""
  return ((-1)**m * 2**l * pymath.factorial(l) / pymath.factorial(k) /
          pymath.factorial(l - k - m) *
          generalized_binomial_coeff(0.5 * (l + k + m - 1.0), l))


def sph_harm_coeff(l, m, k):
  """Real spherical harmonic coefficient for the (l, m, k) term."""
  return (np.sqrt(
      (2.0 * l + 1.0) * pymath.factorial(l - m) /
      (4.0 * np.pi * pymath.factorial(l + m))) * assoc_legendre_coeff(l, m, k))


def get_ml_array(deg_view):
  """All (m, l) pairs used by the encoding: l in {1,2,...,2^(deg-1)}, m<=l."""
  ml_list = []
  for i in range(deg_view):
    l = 2**i
    for m in range(l + 1):
      ml_list.append((m, l))
  return np.array(ml_list).T


def _integer_pow(x, y):
  """x**y by binary exponentiation, the products of jax.lax.integer_pow."""
  if y == 0:
    return torch.ones_like(x)
  acc = None
  while y > 0:
    if y & 1:
      acc = x if acc is None else acc * x
    y >>= 1
    if y > 0:
      x = x * x
  return acc


def generate_ide_fn(deg_view):
  """The integrated directional encoding (IDE) of Ref-NeRF:
  fn(xyz [..., 3], kappa_inv [..., 1]) -> [..., 2 * num_components].

  The expectation of real spherical harmonics under a von Mises-Fisher
  distribution: SH attenuated by exp(-sigma_l * kappa_inv).
  """
  if deg_view > 5:
    raise ValueError('Only deg_view of at most 5 is numerically stable.')

  ml_array = get_ml_array(deg_view)
  l_max = 2**(deg_view - 1)

  # mat[k, i]: coefficient of z^k for component i.
  mat = np.zeros((l_max + 1, ml_array.shape[1]))
  for i, (m, l) in enumerate(ml_array.T):
    for k in range(l - m + 1):
      mat[k, i] = sph_harm_coeff(l, m, k)

  m_per_col = [int(m) for m in ml_array[0, :]]
  sigma = 0.5 * ml_array[1, :] * (ml_array[1, :] + 1)

  def integrated_dir_enc_fn(xyz, kappa_inv):
    """IDE of directions xyz with vMF concentration 1/kappa_inv."""
    x = xyz[..., 0:1]
    y = xyz[..., 1:2]
    z = xyz[..., 2:3]
    # Polar part: Vandermonde in z against the coefficient matrix.
    vmz = torch.cat([_integer_pow(z, i) for i in range(mat.shape[0])],
                    dim=-1)
    as_xyz = lambda a: mathx.constant(a, xyz.device, xyz.dtype)
    polar = mathx.matmul_hp(vmz, as_xyz(mat))

    # Re/Im of (x + iy)^m: (re, im)_{m+1} = (re x - im y, re y + im x).
    re_pows = [torch.ones_like(x)]
    im_pows = [torch.zeros_like(x)]
    for _ in range(l_max):
      re, im = re_pows[-1], im_pows[-1]
      re_pows.append(re * x - im * y)
      im_pows.append(re * y + im * x)
    # The columns of azimuthal order m, in the table's order: slices, whose
    # backward is cheaper than a gather's scatter-add.
    re_m = torch.cat([re_pows[m] for m in m_per_col], dim=-1)
    im_m = torch.cat([im_pows[m] for m in m_per_col], dim=-1)

    atten = torch.exp(-as_xyz(sigma) * kappa_inv)
    return torch.cat([re_m * polar * atten, im_m * polar * atten], dim=-1)

  return integrated_dir_enc_fn


def generate_dir_enc_fn(deg_view):
  """Non-integrated directional encoding: IDE at zero inverse-concentration."""
  ide_fn = generate_ide_fn(deg_view)
  return lambda xyz: ide_fn(xyz, torch.zeros_like(xyz[..., :1]))
