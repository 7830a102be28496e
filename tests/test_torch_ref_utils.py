"""The port's ops/ref_utils.py against the JAX package's, on the same numpy
inputs: reflections, normalization, the weighted angular error, the
spherical-harmonic tables and the (integrated) directional encodings.

Tolerances: reflect, l2_normalize and the weighted MAE are a few f32
operations, rtol 1e-5 (atol 1e-6 for values near 0).  The IDE's polar part
is a Vandermonde in z against coefficients of up to 9e4 (l = 16 at
deg_view 5) whose terms cancel to O(1): both packages compute it in full
f32, but their products sum the 17 terms in different orders, so the f32
rounding of the large terms shows.  Measured gaps between the two, over
4,096 directions: 3e-8, 1.2e-7, 3.6e-7, 1.8e-6 and 6.3e-3 at deg_view 1-5;
the JAX package's own gap to a float64 evaluation at deg_view 5 is 6.8e-3.
The bounds: atol 1e-6 (deg_view 1-3), 1e-5 (4), 2e-2 (5), and at 5 the
port within 2e-2 of float64 too.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), 'helpers'))
import torch_parity as tp  # noqa: E402

from multinerf_tpu.ops import ref_utils as jref  # noqa: E402
from multinerf_tpu_torch.ops import ref_utils  # noqa: E402

IDE_ATOL = {1: 1e-6, 2: 1e-6, 3: 1e-6, 4: 1e-5, 5: 2e-2}


def _dirs(n, seed):
  rng = np.random.RandomState(seed)
  x = rng.randn(n, 3).astype(np.float32)
  return x / np.linalg.norm(x, axis=-1, keepdims=True)


def test_reflect_normalize_and_weighted_mae_match_jax():
  rng = np.random.RandomState(0)
  v, n = _dirs(64, 1), _dirs(64, 2)
  tp.assert_close(ref_utils.reflect(torch.as_tensor(v), torch.as_tensor(n)),
                  jref.reflect(jnp.asarray(v), jnp.asarray(n)), atol=1e-6,
                  rtol=1e-5, what='reflect')
  x = (rng.randn(64, 3) * 10.0**rng.uniform(-5, 2, (64, 1))).astype(
      np.float32)
  x[0] = 0.0  # Grad-safe at zero: the eps floor.
  tp.assert_close(ref_utils.l2_normalize(torch.as_tensor(x)),
                  jref.l2_normalize(jnp.asarray(x)), atol=1e-6, rtol=1e-5,
                  what='l2_normalize')
  w = rng.rand(64).astype(np.float32)
  mae = ref_utils.compute_weighted_mae(
      torch.as_tensor(w), torch.as_tensor(n), torch.as_tensor(v))
  want = jref.compute_weighted_mae(jnp.asarray(w), jnp.asarray(n),
                                   jnp.asarray(v))
  assert float(mae) == pytest.approx(float(want), rel=1e-5)
  # Identical normals: the clip keeps arccos finite at exactly 1.
  same = ref_utils.compute_weighted_mae(
      torch.as_tensor(w), torch.as_tensor(n), torch.as_tensor(n))
  assert np.isfinite(float(same)) and float(same) < 0.1


def test_spherical_harmonic_tables_match_jax():
  for deg_view in range(1, 6):
    np.testing.assert_array_equal(ref_utils.get_ml_array(deg_view),
                                  jref.get_ml_array(deg_view))
  for l in (1, 2, 4, 8, 16):
    for m in range(l + 1):
      for k in range(l - m + 1):
        assert ref_utils.sph_harm_coeff(l, m, k) == jref.sph_harm_coeff(
            l, m, k)
  assert ref_utils.generalized_binomial_coeff(2.5, 3) == (
      jref.generalized_binomial_coeff(2.5, 3))


@pytest.mark.parametrize('deg_view', [1, 2, 3, 4, 5])
def test_integrated_dir_enc_matches_jax(deg_view):
  xyz = _dirs(4096, 3)
  kappa_inv = np.random.RandomState(4).uniform(0, 0.1, (4096, 1)).astype(
      np.float32)
  got = ref_utils.generate_ide_fn(deg_view)(torch.as_tensor(xyz),
                                            torch.as_tensor(kappa_inv))
  want = jref.generate_ide_fn(deg_view)(jnp.asarray(xyz),
                                        jnp.asarray(kappa_inv))
  assert got.dtype == torch.float32
  assert got.shape == (4096, 2 * ref_utils.get_ml_array(deg_view).shape[1])
  tp.assert_close(got.numpy(), want, atol=IDE_ATOL[deg_view], rtol=1e-5,
                  what=f'IDE deg_view {deg_view}')
  if deg_view == 5:
    exact = ref_utils.generate_ide_fn(deg_view)(
        torch.as_tensor(xyz, dtype=torch.float64),
        torch.as_tensor(kappa_inv, dtype=torch.float64))
    tp.assert_close(got.numpy(), exact.numpy(), atol=IDE_ATOL[deg_view],
                    what='IDE deg_view 5 against float64')
  # The non-integrated encoding is the IDE at zero inverse concentration.
  tp.assert_close(
      ref_utils.generate_dir_enc_fn(deg_view)(torch.as_tensor(xyz)).numpy(),
      jref.generate_dir_enc_fn(deg_view)(jnp.asarray(xyz)),
      atol=IDE_ATOL[deg_view], rtol=1e-5, what='dir enc')


def test_ide_takes_no_tf32_even_when_the_backend_allows_it():
  # The polar product goes through mathx.matmul_hp, which turns TF32 off
  # around the call, forward and backward, and restores the setting.
  flags = torch.backends.cuda.matmul
  before = flags.allow_tf32
  seen = []
  real = torch.Tensor.__matmul__

  def spy(a, b):
    seen.append(flags.allow_tf32)
    return real(a, b)

  flags.allow_tf32 = True
  torch.Tensor.__matmul__ = spy
  try:
    xyz = torch.as_tensor(_dirs(8, 5), dtype=torch.float32).requires_grad_()
    out = ref_utils.generate_ide_fn(5)(xyz, torch.zeros(8, 1))
    out.sum().backward()
  finally:
    torch.Tensor.__matmul__ = real
    flags.allow_tf32 = before
  assert seen and not any(seen)
  assert torch.isfinite(xyz.grad).all()


def test_ide_refuses_degrees_past_5():
  with pytest.raises(ValueError, match='at most 5'):
    ref_utils.generate_ide_fn(6)


def test_matmul_hp_and_constants():
  from multinerf_tpu_torch.ops import mathx
  rng = np.random.RandomState(7)
  a = torch.as_tensor(rng.randn(5, 4, 3).astype(np.float32),
                      dtype=torch.float64).requires_grad_()
  b = torch.as_tensor(rng.randn(3, 2), dtype=torch.float64)
  # Values, gradients and second derivatives are those of a @ b.
  assert torch.autograd.gradcheck(mathx.matmul_hp, (a, b))
  assert torch.autograd.gradgradcheck(mathx.matmul_hp, (a, b))
  np.testing.assert_array_equal(mathx.matmul_hp(a, b).detach().numpy(),
                                (a @ b).detach().numpy())
  # A table is copied to its device once; one first asked for under
  # inference_mode can still be saved by autograd.
  table = np.arange(6.0).reshape(2, 3) + 0.123
  with torch.inference_mode():
    first = mathx.constant(table, 'cpu')
  assert not first.is_inference() and first.dtype == torch.float32
  assert mathx.constant(table, 'cpu') is first
  assert mathx.constant(table, 'cpu', torch.float64).dtype == torch.float64
  x = torch.ones(2, 2, requires_grad=True)
  (x @ first).sum().backward()
  np.testing.assert_allclose(x.grad.numpy(), np.tile(
      table.astype(np.float32).sum(1), (2, 1)), rtol=1e-6)
