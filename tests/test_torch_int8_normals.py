"""Int8 trunks with density-gradient normals in the port against the JAX
package: the second derivatives of both int8 matmuls, the int8 Ref-NeRF
Model's normals and predicted-normal loss, and one ``blender_refnerf.gin``
step per int8 binding, on the same (bridged) weights with rng=None, at the
test size of tests/test_torch_refnerf.py.

JAX's ``int8_matmul_hybrid`` forward rule computes its output in plain code
(multinerf_tpu/ops/quant.py:123-127), where ``int8_matmul``'s rule returns
the custom function's own output (quant.py:88-89).  So inside
``jax.value_and_grad``, as the density is taken for its normals
(multinerf_tpu/models/mlp.py:422), the derivative of the hybrid's returned
value reaches the weights through the absmax scales alone: about 1% of the
gradient the custom backward gives (test_jax_hybrid_value_gradient_*).
The port follows the function JAX means to define.  The hybrid is held
against JAX with the forward rule corrected in the test process only
(``patched_hybrid``), as tests/test_torch_refnerf.py corrects flax's
``clone``; the JAX package's files stay as they are.

Tolerances.  The matmul derivatives within 1e-5 of the largest value
(both sides quantize the same f32 values to the same codes; measured
7.6e-6 of 50).  The Model: both sides run the unfused path (density
normals turn fusion off) with f32 features quantized per row to int8, so
an IPE feature that rounds differently across the frameworks (3e-5 of the
largest, tests/test_torch_refnerf.py) may flip one int8 code, 1/127 of its
row's absmax: the int8 bounds of tests/test_torch_int8_trunk.py (6e-3 on
densities and colors), and 2e-2 on normals, a density gradient over its own
length.  The steps: each gradient leaf by ``train_lib.leaf_gaps`` against
JAX's own move under the 1e-6 nudge, with the int8 cap of
tests/test_torch_int8_train_step.py; each loss term within 1e-3 relative
plus twice JAX's move under the nudge.  The hybrid's second-derivative
test fails on the hybrid that saved its dequantized weights from the
forward (45 of 9.4 apart).
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
from multinerf_tpu import train_lib as jtrain_lib  # noqa: E402
from multinerf_tpu.data import types as jtypes  # noqa: E402
from multinerf_tpu.ops import quant as jquant  # noqa: E402
from multinerf_tpu.parallel import mesh as mesh_lib  # noqa: E402
from multinerf_tpu_torch import bridge  # noqa: E402
from multinerf_tpu_torch import train_lib  # noqa: E402
from multinerf_tpu_torch.data import datasets  # noqa: E402
from multinerf_tpu_torch.models import nerf  # noqa: E402
from multinerf_tpu_torch.ops import quant  # noqa: E402

CONFIG_REFNERF = os.path.join(tp.REPO, 'configs', 'blender_refnerf.gin')
SMALL_REFNERF = (
    "Config.dataset_loader = 'dummy_specular'",
    'NerfMLP.net_depth = 4',
    'NerfMLP.net_width = 32',
    'NerfMLP.net_depth_viewdirs = 2',
    'NerfMLP.net_width_viewdirs = 16',
    'NerfMLP.bottleneck_width = 16',
    'Model.num_prop_samples = 16',
    'Model.num_nerf_samples = 16',
)
MODES = ('int8', 'int8_hybrid')
TRAIN_FRAC = 0.5
INT8_GAP_CAP = 0.15


@jax.custom_vjp
def _hybrid(x, w):
  return jquant.int8_matmul(x, w)


def _hybrid_fwd(x, w):
  # The custom function's own output, as _int8_matmul_fwd returns it.
  wq, sw = jquant.absmax_quantize(w, axis=0)
  return _hybrid(x, w), (x, wq.astype(jnp.float32) * sw)


_hybrid.defvjp(_hybrid_fwd, jquant._int8_matmul_hybrid_bwd)  # pylint: disable=protected-access


@pytest.fixture
def patched_hybrid(monkeypatch):
  """JAX's int8_matmul_hybrid with its forward rule corrected, in this
  process only: QuantDense looks the function up when it is called."""
  monkeypatch.setattr(jquant, 'int8_matmul_hybrid', _hybrid)


def _operands():
  rng = np.random.RandomState(0)
  return (rng.randn(8, 16).astype(np.float32),
          rng.randn(16, 4).astype(np.float32))


def _jax_second_order(matmul, x, w):
  """d/d(x, w) of v + sum(d^2), (v, d) = value_and_grad of
  sum(tanh(matmul(x, w))) in x: density normals' pattern."""
  def f(x, w):
    v, d = jax.value_and_grad(lambda x: jnp.sum(jnp.tanh(matmul(x, w))))(x)
    return v + jnp.sum(d ** 2)
  return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1))(x, w)]


def _torch_second_order(matmul, x, w):
  x = torch.tensor(x, requires_grad=True)
  w = torch.tensor(w, requires_grad=True)
  v = torch.tanh(matmul(x, w)).sum()
  d, = torch.autograd.grad(v, x, create_graph=True)
  return [g.numpy() for g in torch.autograd.grad(v + (d ** 2).sum(),
                                                 (x, w))]


@pytest.mark.parametrize('mode', MODES)
def test_int8_second_derivatives_match_jax(mode, patched_hybrid):
  del patched_hybrid  # int8: JAX as it is; the hybrid: its rule corrected.
  x, w = _operands()
  jax_fn = (jquant.int8_matmul if mode == 'int8' else
            jquant.int8_matmul_hybrid)
  port_fn = quant.int8_matmul if mode == 'int8' else quant.int8_matmul_hybrid
  want = _jax_second_order(jax_fn, x, w)
  got = _torch_second_order(port_fn, x, w)
  for name, g, ref in zip(('x', 'w'), got, want):
    tp.assert_close(g, ref, atol=1e-5 * float(np.abs(ref).max()),
                    what=f'{mode} d/d{name}')


def test_jax_hybrid_value_gradient_goes_through_the_scales_alone():
  """The fault of the reference this file patches: JAX's gradient, in w,
  of the value value_and_grad returns is ~1% of the direct gradient; the
  port's is the direct gradient (its custom bf16 backward)."""
  x, w = _operands()
  inner = lambda x, w: jnp.sum(jnp.tanh(jquant.int8_matmul_hybrid(x, w)))
  via_value = np.asarray(jax.grad(
      lambda w: jax.value_and_grad(inner)(x, w)[0], argnums=0)(w))
  direct = np.asarray(jax.grad(inner, argnums=1)(x, w))
  ratio = np.linalg.norm(via_value) / np.linalg.norm(direct)
  assert ratio < 0.05, ratio
  xt = torch.tensor(x, requires_grad=True)
  wt = torch.tensor(w, requires_grad=True)
  v = torch.tanh(quant.int8_matmul_hybrid(xt, wt)).sum()
  torch.autograd.grad(v, xt, create_graph=True)
  got, = torch.autograd.grad(v, wt)
  tp.assert_close(got.numpy(), direct, atol=1e-5 * float(np.abs(direct).max()),
                  what='port: the value gradient')


def test_hybrid_first_order_is_unchanged():
  """The repair touches only the second order: the hybrid's first-order
  gradients stay the f32 products of bf16-rounded operands, dx through the
  forward's dequantized weights, bitwise (tests/test_torch_quant.py holds
  int8_matmul's bitwise against JAX)."""
  x, w = _operands()
  g = torch.tensor(np.random.RandomState(1).randn(8, 4).astype(np.float32))
  xt = torch.tensor(x, requires_grad=True)
  wt = torch.tensor(w, requires_grad=True)
  dx, dw = torch.autograd.grad(quant.int8_matmul_hybrid(xt, wt), (xt, wt), g)
  _, wq, sw = quant._forward(torch.tensor(x), torch.tensor(w))  # pylint: disable=protected-access
  bf = lambda a: a.to(torch.bfloat16).float()
  assert torch.equal(dx, bf(g) @ bf(wq.float() * sw).T)
  assert torch.equal(dw, bf(torch.tensor(x)).T @ bf(g))


def _configs(mode, *more):
  return tp.configs(SMALL_REFNERF + (f"NerfMLP.trunk_dtype = '{mode}'",) +
                    tuple(more), files=(CONFIG_REFNERF,))


@pytest.mark.parametrize('mode', MODES)
def test_int8_refnerf_model_normals_match_jax(mode, patched_hybrid):
  del patched_hybrid
  jax_config, torch_config = _configs(mode)
  params = tp.jax_params(jax_config, seed=0)
  model = nerf.construct_model(torch_config,
                               torch.Generator().manual_seed(0), 'cpu')
  bridge.load_jax_params(model, params)
  mlp = model.NerfMLP_0
  assert mlp.int8 and not mlp.fused  # Density normals: the unfused path.
  jmodel = jax_gin.make('Model', config=jax_config)
  fields = tp.rays(12, seed=4, near=2.0, far=6.0)

  def jax_forward(p):
    renderings, history = jmodel.apply({'params': p}, None,
                                       tp.jax_rays(fields), train_frac=1.0,
                                       compute_extras=True)
    loss = jnp.mean(jnp.stack([
        jnp.mean(jnp.sum(h['weights'] * jnp.sum(
            (h['normals'] - h['normals_pred']) ** 2, -1), -1))
        for h in history]))
    return loss, (renderings, history)

  (want_loss, (want_r, want_h)), want_g = jax.value_and_grad(
      jax_forward, has_aux=True)(params)
  got_r, got_h = model(tp.torch_rays(fields), 1.0, True)
  got_loss = torch.stack([
      torch.mean(torch.sum(h['weights'] * torch.sum(
          (h['normals'] - h['normals_pred']) ** 2, -1), -1))
      for h in got_h]).mean()
  for level, (g, w) in enumerate(zip(got_h, want_h)):
    for key, atol in (('density', 6e-3), ('normals', 2e-2),
                      ('normals_pred', 2e-2), ('roughness', 6e-3),
                      ('rgb', 6e-3)):
      tp.assert_close(g[key].detach().numpy(), w[key], atol=atol, rtol=6e-3,
                      what=f'level {level} {key}')
  for key in ('rgb', 'normals', 'normals_pred'):
    tp.assert_close(got_r[-1][key].detach().numpy(), want_r[-1][key],
                    atol=2e-2, what=f'rendered {key}')
  assert float(got_loss.detach()) == pytest.approx(float(want_loss),
                                                   rel=1e-2)
  # The predicted-normal loss reaches the trunk through the density
  # gradient's own gradient, inside the int8 products.
  names = ('NerfMLP_0/Dense_0/kernel', 'NerfMLP_0/Dense_3/kernel')
  params_t = bridge.named_parameters(model)
  grads = torch.autograd.grad(got_loss, [params_t[n] for n in names])
  want_g = bridge.flatten(want_g)
  for name, got_g in zip(names, grads):
    w = np.asarray(want_g[name], np.float64)
    gap = np.linalg.norm(got_g.numpy() - w) / np.linalg.norm(w)
    assert np.linalg.norm(w) > 0 and gap <= 5e-2, (name, gap)


def _jax_batch(batch):
  fields = {k: jnp.asarray(v.numpy()) for k, v in vars(batch).items()
            if k != 'rays' and v is not None}
  return jtypes.Batch(
      rays=jtypes.Rays(**{k: jnp.asarray(v.numpy()) for k, v in
                          vars(batch.rays).items() if v is not None}),
      **fields)


def _jax_grads(jax_config, params, batch):
  """The raw gradient of JAX's step (what it hands clip_gradients) on
  `batch` and on its nudged copy."""
  jmodel = jax_gin.make('Model', config=jax_config)
  jstate, _ = jtrain_lib.create_optimizer(jax_config, {'params': params})
  step = jtrain_lib.create_train_step(jmodel, jax_config,
                                      mesh_lib.create_mesh(), jit=False)
  clip = jtrain_lib.clip_gradients

  def run(b):
    captured = {}

    def recording_clip(grad, config):
      captured['grad'] = grad['params']
      return clip(grad, config)

    jtrain_lib.clip_gradients = recording_clip
    try:
      _, stats, _ = step(jax.random.PRNGKey(0), jstate, b, TRAIN_FRAC, 1.0)
    finally:
      jtrain_lib.clip_gradients = clip
    return stats, captured['grad']

  run = jax.jit(run)
  return [jax.device_get(run(_jax_batch(b)))
          for b in (batch, train_lib.nudge_origins(batch))]


@pytest.mark.parametrize('mode', MODES)
def test_int8_refnerf_step_matches_jax(mode, patched_hybrid):
  del patched_hybrid
  jax_config, torch_config = _configs(mode, 'Config.batch_size = 16',
                                      'Config.randomized = False')
  params = tp.jax_params(jax_config, seed=1)
  host = next(datasets.load_dataset('train', None, torch_config, seed=3))
  batch = train_lib.batch_to_device(host, 'cpu')
  (want_stats, want), (nudged_stats, want_nudged) = _jax_grads(
      jax_config, params, batch)
  model = nerf.construct_model(torch_config,
                               torch.Generator().manual_seed(0), 'cpu')
  bridge.load_jax_params(model, params)
  loss, losses, _, grads = train_lib.loss_and_grads(model, torch_config,
                                                    batch, TRAIN_FRAC)
  assert set(losses) == {'data', 'orientation', 'predicted_normals'}
  assert float(loss) == pytest.approx(float(want_stats['loss']), rel=1e-3)
  # Each term within 1e-3 relative plus twice JAX's own move under the
  # nudge: the normals' terms follow flips of int8 codes (JAX's
  # orientation term moves by 7.7e-4 relative under the nudge, the port is
  # 1.4e-3 from it under 'int8').
  for key, value in losses.items():
    want_term = float(want_stats['losses'][key])
    sens = abs(float(nudged_stats['losses'][key]) - want_term)
    assert abs(float(value) - want_term) <= 1e-3 * abs(want_term) + 2 * sens, (
        key, float(value), want_term, sens)
  want, want_nudged = bridge.flatten(want), bridge.flatten(want_nudged)
  assert set(grads) == set(want)
  for name, (gap, sens, bound) in train_lib.leaf_gaps(
      grads, want, want_nudged, cap=INT8_GAP_CAP).items():
    assert gap <= bound, (f'{name}: relative L2 error {gap:.3e} > '
                          f'{bound:.3e} (JAX moved {sens:.3e})')
