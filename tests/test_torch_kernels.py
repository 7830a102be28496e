"""The fused kernels' plain versions against the JAX twins and the Pallas
kernels (interpreted on the CPU).  The CUDA kernels themselves are held
against the plain versions in tests/test_torch_cuda.py.

Tolerances:
* plain vs the jnp twin: the same algorithm with the same bf16 roundings;
  they differ where an f32 feature or activation lands on the other side
  of a bf16 rounding boundary, so max |diff| <= 5e-3 * max(1, max|want|).
* plain vs the interpreted Pallas kernel: the kernel's own formula order
  as well, so the bf16-level bound of tests/test_pallas_*.py,
  2e-2 * max(1, max|want|).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), 'helpers'))
import torch_parity as tp  # noqa: E402

from multinerf_tpu.ops import geopoly as jgeopoly  # noqa: E402
from multinerf_tpu.ops.pallas import density_mlp as jdm  # noqa: E402
from multinerf_tpu.ops.pallas import featurize_dense as jfd  # noqa: E402
from multinerf_tpu_torch.ops.kernels import density_mlp as dm  # noqa: E402
from multinerf_tpu_torch.ops.kernels import featurize_dense as fd  # noqa: E402

N = 600  # Not a multiple of any tile: exercises the ragged edge.
BASIS = np.array(jgeopoly.generate_basis('icosahedron', 2)).T  # [3, 21]
TWIN_TOL = 5e-3
KERNEL_TOL = 2e-2


def _far_frac(use_contract):
  """Share of samples at radius 1e3..1e6.  Only with the contraction:
  uncontracted, an f32 ulp of such a mean is 0.06 and degree d multiplies
  it by 2^d, so two correct summation orders give unrelated features."""
  return 0.1 if use_contract else 0.0


def _check(got, want, tol, what):
  want = np.asarray(want)
  tp.assert_close(np.asarray(got), want,
                  atol=tol * max(1.0, float(np.abs(want).max())), what=what)


def _dense_inputs(width=64, seed=0):
  rng = np.random.RandomState(seed)
  kernel = (rng.randn(504, width) * 0.05).astype(np.float32)
  bias = (rng.randn(width) * 0.1).astype(np.float32)
  return kernel, bias


def _mlp_inputs(depth=2, width=32, seed=0):
  rng = np.random.RandomState(seed)
  ws, bs, c_in = [], [], 504
  for _ in range(depth):
    ws.append((rng.randn(c_in, width) / np.sqrt(c_in)).astype(np.float32))
    bs.append((rng.randn(width) * 0.01).astype(np.float32))
    c_in = width
  wd = (rng.randn(width, 1) / np.sqrt(width)).astype(np.float32)
  return ws, bs, wd, np.float32(0.1)


@pytest.mark.parametrize('use_contract', [True, False])
@pytest.mark.parametrize('against', ['twin', 'pallas'])
def test_featurize_dense_plain_matches_jax(use_contract, against):
  means, covs = tp.gaussians(N, seed=1,
                             far_frac=_far_frac(use_contract))
  kernel, bias = _dense_inputs()
  got = fd.featurize_dense(torch.as_tensor(means), torch.as_tensor(covs),
                           torch.as_tensor(kernel), torch.as_tensor(bias),
                           BASIS, use_contract=use_contract)
  args = (jnp.asarray(means), jnp.asarray(covs), jnp.asarray(kernel),
          jnp.asarray(bias), BASIS)
  if against == 'twin':
    want = jfd.featurize_dense_reference(*args, use_contract=use_contract)
  else:
    want = jfd.featurize_dense(*args, use_contract=use_contract,
                               interpret=True)
  assert got.shape == (N, 64)
  _check(got, want, TWIN_TOL if against == 'twin' else KERNEL_TOL,
         f'featurize_dense vs {against}')


@pytest.mark.parametrize('use_contract', [True, False])
@pytest.mark.parametrize('against', ['twin', 'pallas'])
def test_density_mlp_plain_matches_jax(use_contract, against):
  means, covs = tp.gaussians(N, seed=2,
                             far_frac=_far_frac(use_contract))
  ws, bs, wd, bd = _mlp_inputs()
  got = dm.density_mlp(
      torch.as_tensor(means), torch.as_tensor(covs),
      [torch.as_tensor(w) for w in ws], [torch.as_tensor(b) for b in bs],
      torch.as_tensor(wd), torch.as_tensor(bd), BASIS,
      use_contract=use_contract)
  args = (jnp.asarray(means), jnp.asarray(covs),
          [jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs],
          jnp.asarray(wd), jnp.asarray(bd), BASIS)
  if against == 'twin':
    want = jdm.density_mlp_reference(*args, use_contract=use_contract)
  else:
    want = jdm.density_mlp(*args, use_contract=use_contract, interpret=True)
  assert got.shape == (N,)
  _check(got, want, TWIN_TOL if against == 'twin' else KERNEL_TOL,
         f'density_mlp vs {against}')


def test_wrappers_take_the_plain_version_on_cpu_and_keep_batch_shape():
  means, covs = tp.gaussians(60, seed=3)
  kernel, bias = _dense_inputs(width=32)
  ws, bs, wd, bd = _mlp_inputs()
  m = torch.as_tensor(means).reshape(6, 10, 3)
  c = torch.as_tensor(covs).reshape(6, 10, 3, 3)
  fd.reset_counts()
  dm.reset_counts()
  out = fd.featurize_dense(m, c, torch.as_tensor(kernel),
                           torch.as_tensor(bias), BASIS)
  dens = dm.density_mlp(m, c, [torch.as_tensor(w) for w in ws],
                        [torch.as_tensor(b) for b in bs],
                        torch.as_tensor(wd), torch.as_tensor(bd), BASIS)
  assert out.shape == (6, 10, 32) and dens.shape == (6, 10)
  assert fd.counts == {'launches': 0, 'plain_calls': 1}
  assert dm.counts == {'launches': 0, 'plain_calls': 1}
  flat = fd.featurize_dense(m.reshape(60, 3), c.reshape(60, 3, 3),
                            torch.as_tensor(kernel), torch.as_tensor(bias),
                            BASIS)
  torch.testing.assert_close(out.reshape(60, 32), flat, rtol=0, atol=0)


def test_wrappers_reject_other_devices():
  means = torch.zeros((4, 3), device='meta')
  covs = torch.zeros((4, 3, 3), device='meta')
  with pytest.raises(ValueError, match='unsupported device'):
    fd.featurize_dense(means, covs, torch.zeros((504, 32), device='meta'),
                       torch.zeros((32,), device='meta'), BASIS)
  with pytest.raises(ValueError, match='unsupported device'):
    dm.density_mlp(means, covs, [torch.zeros((504, 32), device='meta')],
                   [torch.zeros((32,), device='meta')],
                   torch.zeros((32, 1), device='meta'),
                   torch.zeros((), device='meta'), BASIS)
