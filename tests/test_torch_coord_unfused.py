"""The L0 functions of the port's unfused MLP path (ops/coord.py) against
the JAX package's, on the same numpy inputs: the inverse contraction, the
composed and lifted integrated positional encodings, track_linearize
(analytic for ``contract``, jvp columns for any other warp), and the
gradient of the lifted IPE in the Gaussians' means, which the density
normals of Ref-NeRF are.

Tolerances: the functions are a few f32 operations per output, and the
port takes the same operations in the same order (rtol 1e-5, atol 1e-6 for
O(1) values).  Features at 16 degrees multiply the means by up to 2^15, so
an f32 rounding of an argument moves the sine by up to 2^15 ulp; their
bound is atol 2e-4.  The gradient of the summed features is a sum of
O(2^15) terms per coordinate; it is held at rtol 1e-4 against jax.grad's.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), 'helpers'))
import torch_parity as tp  # noqa: E402

from multinerf_tpu.ops import coord as jcoord  # noqa: E402
from multinerf_tpu.ops import geopoly as jgeopoly  # noqa: E402
from multinerf_tpu_torch.ops import coord  # noqa: E402

BASIS = np.array(jgeopoly.generate_basis('octahedron', 1)).T  # [3, L]


def _warp(x):
  """A smooth warp that is not the contraction: track_linearize's general
  path."""
  return x + 0.3 * jnp.sin(x) if isinstance(x, jnp.ndarray) else (
      x + 0.3 * torch.sin(x))


def test_inv_contract_and_expected_sin_match_jax():
  means, _ = tp.gaussians(256, seed=0, far_frac=0.3)
  z = np.asarray(jcoord.contract(jnp.asarray(means)))
  got = coord.inv_contract(torch.as_tensor(z))
  tp.assert_close(got.numpy(), jcoord.inv_contract(jnp.asarray(z)),
                  atol=1e-6, rtol=1e-5, what='inv_contract')
  # A round trip, where f32 can still tell contracted radii apart (at
  # radius 1e6, 2 - 1/r is 2 to f32 precision).
  near = np.linalg.norm(means, axis=-1) < 100
  tp.assert_close(got.numpy()[near], means[near], atol=1e-4, rtol=1e-3,
                  what='inv_contract(contract(x))')
  var = np.abs(means) * 0.1
  tp.assert_close(coord.expected_sin(torch.as_tensor(means),
                                     torch.as_tensor(var)).numpy(),
                  jcoord.expected_sin(jnp.asarray(means), jnp.asarray(var)),
                  atol=1e-6, rtol=1e-5, what='expected_sin')


def test_integrated_pos_enc_and_lift_match_jax():
  means, covs = tp.gaussians(128, seed=1)
  basis = BASIS.astype(np.float32)
  got_m, got_v = coord.lift_and_diagonalize(torch.as_tensor(means),
                                            torch.as_tensor(covs), basis)
  want_m, want_v = jcoord.lift_and_diagonalize(
      jnp.asarray(means), jnp.asarray(covs), jnp.asarray(basis))
  tp.assert_close(got_m.numpy(), want_m, atol=1e-6, rtol=1e-5, what='mean')
  tp.assert_close(got_v.numpy(), want_v, atol=1e-6, rtol=1e-5, what='var')
  tp.assert_close(
      coord.integrated_pos_enc(got_m, got_v, 0, 8).numpy(),
      jcoord.integrated_pos_enc(want_m, want_v, 0, 8),
      atol=2e-4, what='integrated_pos_enc')


@pytest.mark.parametrize('min_deg,max_deg', [(0, 2), (0, 16), (2, 9)])
def test_integrated_pos_enc_lifted_matches_jax(min_deg, max_deg):
  # Two degrees take the direct form, more the recurrence (coord.py:216).
  means, covs = tp.gaussians(128, seed=2)
  got = coord.integrated_pos_enc_lifted(
      torch.as_tensor(means), torch.as_tensor(covs), BASIS, min_deg, max_deg)
  want = jcoord.integrated_pos_enc_lifted(
      jnp.asarray(means), jnp.asarray(covs), BASIS, min_deg, max_deg)
  assert got.dtype == torch.float32
  tp.assert_close(got.numpy(), want, atol=2e-4, what='lifted IPE')
  # The same features as the composed form of the JAX package.
  lm, lv = jcoord.lift_and_diagonalize(jnp.asarray(means), jnp.asarray(covs),
                                       jnp.asarray(BASIS, jnp.float32))
  tp.assert_close(got.numpy(),
                  jcoord.integrated_pos_enc(lm, lv, min_deg, max_deg),
                  atol=2e-3, what='lifted IPE vs composed')


@pytest.mark.parametrize('warp', ['contract', 'other'])
def test_track_linearize_matches_jax(warp):
  means, covs = tp.gaussians(128, seed=3, far_frac=0.3)
  if warp == 'contract':
    fns = (coord.contract, jcoord.contract)
  else:
    fns = (_warp, _warp)
  got_m, got_c = coord.track_linearize(fns[0], torch.as_tensor(means),
                                       torch.as_tensor(covs))
  want_m, want_c = jcoord.track_linearize(fns[1], jnp.asarray(means),
                                          jnp.asarray(covs))
  tp.assert_close(got_m.numpy(), want_m, atol=1e-6, rtol=1e-5, what='mean')
  scale = float(np.abs(want_c).max())
  tp.assert_close(got_c.numpy(), want_c, atol=1e-6 * scale, rtol=1e-5,
                  what='cov')
  with pytest.raises(ValueError, match='full'):
    coord.track_linearize(fns[0], torch.as_tensor(means),
                          torch.as_tensor(covs[..., 0]))


def test_track_linearize_passes_gradients_to_the_means():
  # Density normals through a warp need d(warped)/d(means) as well.
  means, covs = tp.gaussians(16, seed=4)
  m = torch.as_tensor(means).requires_grad_()
  out_m, out_c = coord.track_linearize(_warp, m, torch.as_tensor(covs))
  (out_m.sum() + out_c.sum()).backward()

  def f(x):
    a, b = jcoord.track_linearize(_warp, x, jnp.asarray(covs))
    return a.sum() + b.sum()
  tp.assert_close(m.grad.numpy(), jax.grad(f)(jnp.asarray(means)),
                  atol=1e-5, rtol=1e-4, what='d/dmeans')


@pytest.mark.parametrize('max_deg', [12, 16])
def test_recurrence_gradient_in_mean_matches_jax_grad(max_deg):
  means, covs = tp.gaussians(64, seed=5)
  weights = np.random.RandomState(6).randn(
      2 * (max_deg) * BASIS.shape[-1]).astype(np.float32)
  m = torch.as_tensor(means).requires_grad_()
  feats = coord.integrated_pos_enc_lifted_recurrence(
      m, torch.as_tensor(covs), BASIS, 0, max_deg)
  grad, = torch.autograd.grad((feats @ torch.as_tensor(weights)).sum(), m)

  def f(x):
    # The recurrence form of the JAX package (coord.py:224-302).
    y = jcoord.integrated_pos_enc_lifted(x, jnp.asarray(covs), BASIS, 0,
                                         max_deg)
    return (y @ jnp.asarray(weights)).sum()
  want = jax.grad(f)(jnp.asarray(means))
  scale = float(np.abs(want).max())
  tp.assert_close(grad.numpy(), want, atol=1e-5 * scale, rtol=1e-4,
                  what='d features / d means')
