"""The int8 trunk of the port (ops/kernels/int8_trunk.py: K5's and K6's
plain versions and the int8 MLP) against the JAX package: the jnp twin
``int8_trunk_reference``, the Pallas kernel interpreted on the CPU and the
JAX ``Model`` under ``trunk_dtype='int8'`` and ``'int8_hybrid'``.  The
training step is held against JAX's in tests/test_torch_int8_train_step.py,
the CUDA kernels against the plain versions in tests/test_torch_cuda.py.

Tolerances, and why:
* forward, relative L2 < 2e-2 (tests/test_pallas_int8_trunk.py:74): the two
  featurizations differ where an f32 feature lands on the other side of a
  bf16 rounding boundary, and such a delta can move a quantized value by
  one step; measured 9e-4 at most here.
* backward, per leaf relative L2 < 3e-2 and cosine > 0.999: the same
  deltas flip a ReLU mask or a rounding now and then, and each flip moves
  a gradient leaf by one sample's term; measured at most 1.0e-2 and
  0.99995 on these inputs, in both modes.
* the model: the bounds of tests/test_torch_model.py where the proposal
  levels set the value (they ignore trunk_dtype); twice them where the
  int8 NerfMLP does (the last level's weights, rgb, acc and distances): a
  one-step flip of an int8 value moves it by 1/127 of its row's absmax,
  where a bf16 boundary crossing moves a value by 2^-8 of itself.
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

from multinerf_tpu import ginlite as jax_gin  # noqa: E402
from multinerf_tpu.ops import geopoly as jgeopoly  # noqa: E402
from multinerf_tpu.ops.pallas import int8_trunk as ji8  # noqa: E402
from multinerf_tpu_torch import bridge  # noqa: E402
from multinerf_tpu_torch.models import nerf  # noqa: E402
from multinerf_tpu_torch.ops.kernels import int8_trunk as i8t  # noqa: E402

BASIS = np.array(jgeopoly.generate_basis('icosahedron', 2)).T  # [3, 21]
N = 600  # Not a multiple of 128: the JAX kernel pads it to 768.
KW = dict(min_deg=0, max_deg=4, use_contract=True)
FWD_TOL = 2e-2
BWD_TOL = 3e-2
BWD_COS = 0.999
MODES = ('int8', 'int8_hybrid')


def _setup(skip, depth=3, width=64, seed=0):
  """tests/test_pallas_int8_trunk.py's inputs at N samples, plus a
  cotangent of the output."""
  rs = np.random.RandomState(seed)
  num_feats = 2 * 4 * BASIS.shape[-1]
  means = (rs.randn(N, 3) * 2.0).astype(np.float32)
  covs = (np.einsum('nij,nkj->nik', rs.randn(N, 3, 3) * 0.1,
                    rs.randn(N, 3, 3) * 0.1) + 0.01 * np.eye(3)).astype(
                        np.float32)
  ws, bs = [], []
  for l in range(depth):
    rows = num_feats if l == 0 else (
        width + num_feats if l in skip else width)
    ws.append((rs.randn(rows, width) / np.sqrt(rows)).astype(np.float32))
    bs.append((rs.randn(width) * 0.01).astype(np.float32))
  co = np.random.RandomState(1).randn(N, width).astype(np.float32)
  return means, covs, ws, bs, co


def _rel(got, want):
  return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize('skip', [(), (2,)])
@pytest.mark.parametrize('against', ['twin', 'pallas'])
def test_forward_plain_matches_jax(skip, against):
  means, covs, ws, bs, _ = _setup(skip)
  i8t.reset_counts()
  got = i8t.int8_trunk(torch.as_tensor(means), torch.as_tensor(covs),
                       [torch.as_tensor(w) for w in ws],
                       [torch.as_tensor(b) for b in bs], BASIS,
                       skip_layers=skip, **KW)
  assert i8t.counts == {'launches': 0, 'plain_calls': 1}
  assert got.dtype == torch.bfloat16 and got.shape == (N, 64)
  if against == 'twin':
    want = ji8.int8_trunk_reference(means, covs, ws, bs, BASIS,
                                    skip_layers=skip, **KW)
  else:
    want = ji8.int8_trunk(means, covs, ws, bs, BASIS, skip_layers=skip,
                          interpret=True, **KW)
  rel = _rel(got.float().numpy(), np.asarray(want, np.float32))
  assert rel < FWD_TOL, rel


@pytest.mark.parametrize('skip', [(), (2,)])
@pytest.mark.parametrize('bwd_bf16', [False, True])
def test_backward_plain_matches_jax_grad(skip, bwd_bf16):
  means, covs, ws, bs, co = _setup(skip)

  def loss(ws, bs):
    out = ji8.int8_trunk(means, covs, ws, bs, BASIS, skip_layers=skip,
                         interpret=True, bwd_bf16=bwd_bf16, **KW)
    return jnp.sum(out.astype(jnp.float32) * co)

  want = jax.grad(loss, argnums=(0, 1))(tuple(jnp.asarray(w) for w in ws),
                                        tuple(jnp.asarray(b) for b in bs))
  m = torch.as_tensor(means).requires_grad_()
  c = torch.as_tensor(covs).requires_grad_()
  tws = [torch.as_tensor(w).requires_grad_() for w in ws]
  tbs = [torch.as_tensor(b).requires_grad_() for b in bs]
  i8t.reset_counts()
  out = i8t.int8_trunk(m, c, tws, tbs, BASIS, skip_layers=skip,
                       bwd_bf16=bwd_bf16, **KW)
  (out.float() * torch.as_tensor(co)).sum().backward()
  assert i8t.bwd_counts == {'launches': 0, 'plain_calls': 1}
  # The sample positions get no gradient (the JAX VJP returns zeros).
  assert m.grad is None and c.grad is None
  got = [t.grad.numpy() for t in tws + tbs]
  for i, (a, b) in enumerate(zip(got, list(want[0]) + list(want[1]))):
    b = np.asarray(b)
    assert a.shape == b.shape, i
    cos = float(np.sum(a * b) / (np.linalg.norm(a) * np.linalg.norm(b)))
    assert _rel(a, b) < BWD_TOL and cos > BWD_COS, (i, _rel(a, b), cos)


def test_jax_groups_follow_the_jax_padding():
  assert i8t.jax_groups(131072) == (131072, 512)
  assert i8t.jax_groups(600) == (768, 256)
  assert i8t.jax_groups(384) == (384, 128)
  assert i8t.jax_groups(4096 * 32 - 37) == (131072, 512)


def _model_pair(mode, extra=()):
  """(JAX config, JAX model, its params, port config, port Model) with
  both MLPs bound to `mode`; the JAX parameters load by name (strict)."""
  bindings = tp.SMALL_BINDINGS + tp.FUSED_BINDINGS + (
      f"NerfMLP.trunk_dtype = '{mode}'", f"PropMLP.trunk_dtype = '{mode}'")
  jax_config, torch_config = tp.configs(bindings + tuple(extra))
  params = tp.jax_params(jax_config)
  jmodel = jax_gin.make('Model', config=jax_config)
  model = nerf.construct_model(torch_config,
                               torch.Generator().manual_seed(0), 'cpu')
  bridge.load_jax_params(model, params)
  return jax_config, jmodel, params, torch_config, model


@pytest.mark.parametrize('mode,activation', [
    ('int8', 'relu'), ('int8_hybrid', 'relu'), ('int8', 'silu')])
def test_model_forward_matches_jax(mode, activation):
  # With another activation than ReLU the NerfMLP takes the fused
  # featurize -> Dense kernel and QuantDense hidden layers (mlp.py:360-374)
  # instead of the int8 trunk kernel.
  _, jmodel, params, _, model = _model_pair(
      mode, [f'NerfMLP.net_activation = @jax.nn.{activation}'])
  fields = tp.rays(24, seed=4)
  want_r, want_h = jax.jit(lambda p, r: jmodel.apply(
      {'params': p}, None, r, train_frac=1.0, compute_extras=True))(
          params, tp.jax_rays(fields))
  i8t.reset_counts()
  with torch.inference_mode():
    got_r, got_h = model(tp.torch_rays(fields), 1.0, True)
  # With ReLU the NerfMLP ran its trunk through K5's plain version; the
  # PropMLPs ignore trunk_dtype (full density fusion comes first, as in JAX).
  assert i8t.counts['plain_calls'] == (activation == 'relu')
  last = len(got_h) - 1
  for level, (g, w) in enumerate(zip(got_h, want_h)):
    tp.assert_close(g['sdist'].numpy(), w['sdist'], atol=2e-3,
                    what=f'level {level} sdist')
    tp.assert_close(g['weights'].numpy(), w['weights'],
                    atol=6e-3 if level == last else 3e-3,
                    what=f'level {level} weights')
  got, want = got_r[-1], want_r[-1]
  for key in ('rgb', 'acc'):
    tp.assert_close(got[key].numpy(), want[key], atol=6e-3, what=key)
  for key in ('distance_mean', 'distance_median'):
    tp.assert_close(0.2 / got[key].numpy(), 0.2 / np.asarray(want[key]),
                    atol=4e-3, what=f'near / {key}')
