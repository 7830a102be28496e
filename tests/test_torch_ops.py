"""Parity of the port's tensor ops with multinerf_tpu.ops, in float32.

The same numpy inputs go through the JAX function and its port.  Unless a
test says otherwise the tolerance is atol 1e-5 (plus rtol 1e-5 for values
far from 1): both sides run the same f32 formulas and differ only in the
summation order of small reductions and in libm's last bits.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), 'helpers'))
import torch_parity as tp  # noqa: E402

from multinerf_tpu.ops import coord as jcoord  # noqa: E402
from multinerf_tpu.ops import geopoly as jgeopoly  # noqa: E402
from multinerf_tpu.ops import mathx as jmathx  # noqa: E402
from multinerf_tpu.ops import rendering as jrendering  # noqa: E402
from multinerf_tpu.ops import stepfun as jstepfun  # noqa: E402
from multinerf_tpu_torch.ops import coord  # noqa: E402
from multinerf_tpu_torch.ops import geopoly  # noqa: E402
from multinerf_tpu_torch.ops import image_ops  # noqa: E402
from multinerf_tpu_torch.ops import mathx  # noqa: E402
from multinerf_tpu_torch.ops import rendering  # noqa: E402
from multinerf_tpu_torch.ops import stepfun  # noqa: E402

T = torch.as_tensor
J = jnp.asarray


def _close(got, want, atol=1e-5, rtol=1e-5, what=''):
  tp.assert_close(got, want, atol=atol, rtol=rtol, what=what)


# --- mathx --------------------------------------------------------------------


@pytest.mark.parametrize('fn', ['safe_sin', 'safe_cos'])
def test_safe_trig_matches_jax_including_huge_arguments(fn):
  # The verify-skill probe safe_sin(1e20) plus the modulo branch on both
  # signs: a floor modulo, where torch.fmod would truncate.
  x = np.concatenate([
      np.linspace(-50, 50, 101),
      [314.159, -314.2, 1e3, -1e3, 12345.678, -98765.4, 1e6, -3e7, 1e20,
       -1e20]]).astype(np.float32)
  got = getattr(mathx, fn)(T(x)).numpy()
  want = np.asarray(getattr(jmathx, fn)(J(x)))
  assert np.isfinite(got).all()
  _close(got, want, atol=2e-6, rtol=0, what=fn)


def test_safe_exp_is_finite_and_matches():
  x = np.array([-100, -1, 0, 1, 50, 88, 89, 1e6], np.float32)
  got = mathx.safe_exp(T(x)).numpy()
  assert np.isfinite(got).all()
  # XLA flushes exp(-100) (a denormal) to zero; torch keeps it.
  _close(got, np.asarray(jmathx.safe_exp(J(x))), atol=1e-37, rtol=1e-6)


def _interp_inputs():
  rng = np.random.RandomState(0)
  xp = np.sort(rng.rand(5, 9).astype(np.float32), axis=-1)
  xp[:, 0], xp[:, -1] = 0, 1
  xp[1, 3:6] = xp[1, 3]  # Repeated fenceposts (a flat CDF run).
  fp = np.sort(rng.rand(5, 9).astype(np.float32) * 4, axis=-1)
  fp[2, 2:7] = fp[2, 2]  # A flat run of values.
  x = np.sort(rng.uniform(-0.1, 1.1, (5, 12)).astype(np.float32), axis=-1)
  x[1, :4] = xp[1, 3]  # Queries exactly on the tie.
  return x, xp, fp


@pytest.mark.parametrize('fn', ['interp_sorted', 'interp_gather'])
def test_interp_matches_jax_including_ties(fn):
  x, xp, fp = _interp_inputs()
  got = getattr(mathx, fn)(T(x), T(xp), T(fp)).numpy()
  want = np.asarray(getattr(jmathx, fn)(J(x), J(xp), J(fp)))
  _close(got, want, what=fn)


# --- coord --------------------------------------------------------------------


def test_contract_matches_jax_including_origin():
  means, _ = tp.gaussians(200, seed=1, far_frac=0.3)
  means[0] = 0  # The verify-skill probe contract(0).
  got = coord.contract(T(means)).numpy()
  want = np.asarray(jcoord.contract(J(means)))
  assert np.isfinite(got).all()
  _close(got, want)


def test_contract_gaussian_matches_jax_far_out():
  # Far points (radius up to 1e6) are where the three covariance terms
  # cancel; the port keeps JAX's term order, so even there the gap stays
  # at f32 rounding of the (tiny) warped covariance.
  means, covs = tp.gaussians(300, seed=2, far_frac=0.4)
  got_m, got_c = coord.contract_gaussian(T(means), T(covs))
  want_m, want_c = jcoord.contract_gaussian(J(means), J(covs))
  _close(got_m.numpy(), np.asarray(want_m))
  scale = np.abs(np.asarray(want_c)).max(axis=(-1, -2), keepdims=True)
  _close(got_c.numpy() / scale, np.asarray(want_c) / scale, atol=1e-5,
         rtol=0, what='cov / max|cov| per sample')


@pytest.mark.parametrize('name', ['reciprocal', 'log', 'sqrt', None])
def test_ray_warps_match_jax(name):
  fns = {None: (None, None), 'reciprocal': (torch.reciprocal,
                                            jnp.reciprocal),
         'log': (torch.log, jnp.log), 'sqrt': (torch.sqrt, jnp.sqrt)}
  tfn, jfn = fns[name]
  near = np.full((4, 1), 0.2, np.float32)
  far = np.full((4, 1), 1e6 if name == 'reciprocal' else 50.0, np.float32)
  s = np.linspace(0, 1, 33, dtype=np.float32)[None].repeat(4, 0)
  t_to_s, s_to_t = coord.construct_ray_warps(tfn, T(near), T(far))
  jt_to_s, js_to_t = jcoord.construct_ray_warps(jfn, J(near), J(far))
  t = s_to_t(T(s)).numpy()
  _close(t, np.asarray(js_to_t(J(s))), atol=1e-5, rtol=1e-5, what='s_to_t')
  _close(t_to_s(T(t)).numpy(), np.asarray(jt_to_s(J(t))), what='t_to_s')


@pytest.mark.parametrize('far_frac', [0.0, 0.3])
def test_ipe_recurrence_matches_jax(far_frac):
  means, covs = tp.gaussians(128, seed=3, far_frac=far_frac)
  means, covs = jcoord.contract_gaussian(J(means), J(covs))
  means, covs = np.array(means), np.array(covs)  # Writable copies.
  basis = np.array(jgeopoly.generate_basis('icosahedron', 2)).T
  got = coord.integrated_pos_enc_lifted_recurrence(T(means), T(covs), basis,
                                                   0, 12).numpy()
  want = np.asarray(jcoord._integrated_pos_enc_lifted_recurrence(
      J(means), J(covs), basis, 0, 12))
  assert got.shape == (128, 504)
  # Degree-11 arguments reach 2^11 * |args0|: an f32 ulp of args0 there is
  # ~1e-4 rad, so the tolerance is wider than elsewhere.
  _close(got, want, atol=5e-4, rtol=0, what='features')


def test_pos_enc_matches_jax():
  x = tp.rays(16, seed=4)['viewdirs']
  got = coord.pos_enc(T(x), 0, 4, append_identity=True).numpy()
  _close(got, np.asarray(jcoord.pos_enc(J(x), 0, 4, append_identity=True)))


# --- geopoly ------------------------------------------------------------------


@pytest.mark.parametrize('shape,subdiv', [('icosahedron', 2),
                                          ('icosahedron', 1),
                                          ('octahedron', 2)])
def test_basis_is_bitwise_equal(shape, subdiv):
  got = geopoly.generate_basis(shape, subdiv)
  want = jgeopoly.generate_basis(shape, subdiv)
  np.testing.assert_array_equal(got, want)
  if (shape, subdiv) == ('icosahedron', 2):
    assert got.shape == (21, 3)  # 2 * 12 * 21 = 504 IPE features.


# --- stepfun ------------------------------------------------------------------


def _histogram(n_rays=6, n=10, seed=5, zero_width=True):
  """Sorted edges on [0, 1] with (optionally) zero-width intervals, and
  weights summing to 1."""
  rng = np.random.RandomState(seed)
  t = np.sort(rng.rand(n_rays, n + 1).astype(np.float32), axis=-1)
  t[:, 0], t[:, -1] = 0, 1
  if zero_width:
    t[0, 3:6] = t[0, 3]
    t[1, 1:3] = t[1, 1]
  w = rng.rand(n_rays, n).astype(np.float32)
  w /= w.sum(-1, keepdims=True)
  return t, w


def test_max_dilate_weights_matches_jax():
  t, w = _histogram()
  got_t, got_w = stepfun.max_dilate_weights(T(t), T(w), 0.03,
                                            domain=(0.0, 1.0),
                                            renormalize=True)
  want_t, want_w = jstepfun.max_dilate_weights(J(t), J(w), 0.03,
                                               domain=(0.0, 1.0),
                                               renormalize=True)
  _close(got_t.numpy(), np.asarray(want_t), what='edges')
  _close(got_w.numpy(), np.asarray(want_w), what='weights')


@pytest.mark.parametrize('use_gpu_resampling', [False, True])
def test_sample_intervals_with_zero_width_bins_matches_jax(
    use_gpu_resampling):
  # Zero-width intervals get -inf logits exactly as Model does, which puts
  # flat runs into the CDF and exercises the interpolation's tie rule.
  t, w = _histogram()
  logits = np.where(t[..., 1:] > t[..., :-1], np.log(w), -np.inf).astype(
      np.float32)
  got = stepfun.sample_intervals(None, T(t), T(logits), 16,
                                 domain=(0.0, 1.0),
                                 use_gpu_resampling=use_gpu_resampling)
  want = jstepfun.sample_intervals(None, J(t), J(logits), 16,
                                   domain=(0.0, 1.0),
                                   use_gpu_resampling=use_gpu_resampling)
  got = got.numpy()
  assert np.isfinite(got).all() and (np.diff(got, axis=-1) >= 0).all()
  _close(got, np.asarray(want), what='fences')


@pytest.mark.parametrize('deterministic_center', [False, True])
def test_sample_matches_jax(deterministic_center):
  t, w = _histogram(zero_width=False)
  got = stepfun.sample(None, T(t), T(np.log(w)), 7,
                       deterministic_center=deterministic_center).numpy()
  want = np.asarray(jstepfun.sample(
      None, J(t), J(np.log(w)), 7,
      deterministic_center=deterministic_center))
  _close(got, want)


def test_weighted_percentile_with_opaque_background_matches_jax():
  # With opaque_background the last interval's alpha is 1, so the weights
  # sum to exactly 1 and the background fencepost carries none.
  fields = tp.rays(6, seed=6)
  t, _ = _histogram(zero_width=False)
  tdist = 0.2 + 10 * t
  density = np.random.RandomState(7).rand(6, 10).astype(np.float32) * 2
  w, _, _ = jrendering.compute_alpha_weights(
      J(density), J(tdist), J(fields['directions']), opaque_background=True)
  fence = np.concatenate([tdist, fields['far']], -1)
  fence_w = np.concatenate([np.asarray(w), np.zeros((6, 1), np.float32)],
                           -1)
  got = stepfun.weighted_percentile(T(fence), T(fence_w), [5, 50, 95])
  want = jstepfun.weighted_percentile(J(fence), J(fence_w), [5, 50, 95])
  _close(got.numpy(), np.asarray(want))


# --- rendering ----------------------------------------------------------------


@pytest.mark.parametrize('ray_shape', ['cone', 'cylinder'])
def test_cast_rays_full_covariance_matches_jax(ray_shape):
  fields = tp.rays(8, seed=8)
  t, _ = _histogram(n_rays=8, zero_width=False)
  tdist = 0.2 + 20 * t
  got_m, got_c = rendering.cast_rays(
      T(tdist), T(fields['origins']), T(fields['directions']),
      T(fields['radii']), ray_shape)
  want_m, want_c = jrendering.cast_rays(
      J(tdist), J(fields['origins']), J(fields['directions']),
      J(fields['radii']), ray_shape, diag=False)
  assert got_c.shape == (8, 10, 3, 3)
  _close(got_m.numpy(), np.asarray(want_m), what='means')
  _close(got_c.numpy(), np.asarray(want_c), atol=1e-5, rtol=1e-4,
         what='covs')


@pytest.mark.parametrize('opaque_background', [False, True])
def test_alpha_weights_and_volumetric_rendering_match_jax(opaque_background):
  fields = tp.rays(6, seed=9)
  rng = np.random.RandomState(10)
  t, _ = _histogram(zero_width=False)
  tdist = 0.2 + 10 * t
  density = rng.rand(6, 10).astype(np.float32) * 2
  rgbs = rng.rand(6, 10, 3).astype(np.float32)
  got_w = rendering.compute_alpha_weights(
      T(density), T(tdist), T(fields['directions']),
      opaque_background=opaque_background)
  want_w = jrendering.compute_alpha_weights(
      J(density), J(tdist), J(fields['directions']),
      opaque_background=opaque_background)
  for g, w, name in zip(got_w, want_w, ['weights', 'alpha', 'trans']):
    _close(g.numpy(), np.asarray(w), what=name)
  got = rendering.volumetric_rendering(
      T(rgbs), got_w[0], T(tdist), 1.0, T(fields['far']), True)
  want = jrendering.volumetric_rendering(
      J(rgbs), want_w[0], J(tdist), 1.0, J(fields['far']), True)
  assert sorted(got) == sorted(want)
  for key in want:
    _close(got[key].numpy(), np.asarray(want[key]), what=key)


def test_linear_to_srgb_matches_jax():
  from multinerf_tpu.ops import image_ops as jimage_ops
  x = np.linspace(0, 1, 101, dtype=np.float32)
  want = np.asarray(jimage_ops.linear_to_srgb(J(x)))
  _close(image_ops.linear_to_srgb(x), want)
  _close(image_ops.linear_to_srgb(T(x), xnp=torch).numpy(), want)
