"""The port's whole training step against JAX's ``create_train_step(
jit=False)``, from the same (bridged) weights on the same batch, at the 360
config cut to test size with ``Config.randomized=False``.

The JAX step runs once per module, in a fixture: its Pallas kernels are
interpreted on the CPU, which is slow.  Its raw gradient is read by wrapping
``train_lib.clip_gradients``, which the step calls on it.

Tolerances, and why:
* the loss and each loss term, 1e-3 relative: both sides round features and
  activations to bf16 at the same places and differ where an f32 value lands
  on the other side of a bf16 boundary (see tests/test_torch_model.py);
* each gradient leaf and each update p1 - p0: the same differences,
  carried back through the bf16 roundings and ReLU masks of every layer,
  grow toward the first layers, and the reference step itself is that
  sensitive.  The fixture runs the JAX step a second time with the ray
  origins moved by a relative 1e-6; per leaf, the relative L2 error of the
  port's gradient and update is bounded by train_lib.leaf_gaps from JAX's
  own move `sens`: 5e-2 + 2 * sens, at most 0.1.  The largest gradient gap
  is also bounded by GRAD_TOL * max |want|; a wrong gradient is off by
  O(1).  Adam's first update is lr * g / (|g| + eps): after the clip to
  norm 1e-3 many entries of g are near eps, where a small gradient gap
  moves the update by up to ~2 lr, so updates are not bounded per element;
  tests/test_torch_train_ops.py holds the optimizer's own arithmetic to
  1e-6.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), 'helpers'))
import torch_parity as tp  # noqa: E402

from multinerf_tpu import ginlite as jax_gin  # noqa: E402
from multinerf_tpu import train_lib as jtrain_lib  # noqa: E402
from multinerf_tpu.data import types as jtypes  # noqa: E402
from multinerf_tpu.parallel import mesh as mesh_lib  # noqa: E402
from multinerf_tpu_torch import bridge  # noqa: E402
from multinerf_tpu_torch import train_lib  # noqa: E402
from multinerf_tpu_torch.data import datasets  # noqa: E402

BINDINGS = tp.SMALL_BINDINGS + tp.FUSED_BINDINGS + (
    "Config.dataset_loader = 'dummy_unbounded'", 'Config.batch_size = 256',
    'Config.randomized = False')
TRAIN_FRAC = 0.5
GRAD_TOL = 0.2


def _jax_batch(batch):
  return jtypes.Batch(
      rays=jtypes.Rays(**{k: jnp.asarray(v.numpy()) for k, v in
                          vars(batch.rays).items() if v is not None}),
      rgb=jnp.asarray(batch.rgb.numpy()))


@pytest.fixture(scope='module')
def steps():
  """The JAX step (raw gradient, new params), the same step on rays moved by
  train_lib.NUDGE, and the port's step, from the same weights."""
  jax_config, torch_config = tp.configs(BINDINGS)
  params = tp.jax_params(jax_config, seed=1)
  host = next(datasets.load_dataset('train', None, torch_config, seed=3))
  batch = train_lib.batch_to_device(host, 'cpu')  # float32, flat rays.

  jmodel = jax_gin.make('Model', config=jax_config)
  jstate, _ = jtrain_lib.create_optimizer(jax_config, {'params': params})
  step = jtrain_lib.create_train_step(jmodel, jax_config,
                                      mesh_lib.create_mesh(), jit=False)
  clip = jtrain_lib.clip_gradients
  want = {}
  nudged = train_lib.nudge_origins(batch)
  for key, b in (('jax', batch), ('jax_nudged', nudged)):
    captured = {}

    def recording_clip(grad, config):
      captured['grad'] = grad['params']
      return clip(grad, config)

    jtrain_lib.clip_gradients = recording_clip
    try:
      new_jstate, jstats, _ = step(jax.random.PRNGKey(0), jstate,
                                   _jax_batch(b), TRAIN_FRAC, 1.0)
    finally:
      jtrain_lib.clip_gradients = clip
    want[key] = {'stats': jax.device_get(jstats),
                 'grads': bridge.flatten(jax.device_get(captured['grad'])),
                 'params1': bridge.flatten(
                     jax.device_get(new_jstate.params['params']))}
  params0 = bridge.flatten(jax.device_get(params))
  for run in want.values():
    run['updates'] = {k: np.asarray(v) - np.asarray(params0[k])
                      for k, v in run['params1'].items()}

  model, state, _, train_step, _ = train_lib.setup_model(torch_config, 0,
                                                         'cpu')
  bridge.load_jax_params(model, params)
  _, _, _, grads = train_lib.loss_and_grads(model, torch_config, batch,
                                            TRAIN_FRAC)
  got = {'grads': {k: v.clone() for k, v in grads.items()}}
  state, stats = train_step(None, state, batch, TRAIN_FRAC, False)
  got['stats'] = stats
  got['updates'] = {k: v.detach().numpy() - np.asarray(params0[k])
                    for k, v in state.params.items()}
  return got, want['jax'], want['jax_nudged']


def _assert_within_gaps(got, want, want_nudged, what):
  for name, (gap, sens, bound) in train_lib.leaf_gaps(
      got, want, want_nudged).items():
    assert gap <= bound, (f'{name}: {what} relative L2 error {gap:.3e} > '
                          f'{bound:.3e} (JAX moved {sens:.3e})')


def test_loss_and_loss_terms_match_jax(steps):
  got, want, _ = steps
  terms = ['loss'] + [f'losses/{k}' for k in want['stats']['losses']]
  assert set(terms) == {'loss', 'losses/data', 'losses/interlevel',
                        'losses/distortion'}
  for key in terms:
    w = (want['stats']['loss'] if key == 'loss'
         else want['stats']['losses'][key[7:]])
    assert float(got['stats'][key]) == pytest.approx(float(w), rel=1e-3), key
  np.testing.assert_allclose(got['stats']['psnrs'].numpy(),
                             want['stats']['psnrs'], rtol=1e-3)


def test_every_gradient_leaf_matches_jax(steps):
  got, want, want_nudged = steps
  assert set(got['grads']) == set(want['grads'])
  # The skip layer's kernel is one [width + 504, width] parameter whose two
  # row blocks get their gradients from the plain product (x half) and
  # from the fused dW kernel (feature half).
  assert got['grads']['NerfMLP_0/Dense_5/kernel'].shape == (64 + 504, 64)
  for name, w in want['grads'].items():
    scale = float(np.abs(w).max())
    assert scale > 0, name
    tp.assert_close(got['grads'][name].numpy(), np.asarray(w),
                    atol=GRAD_TOL * scale, what=name)
  _assert_within_gaps(got['grads'], want['grads'], want_nudged['grads'],
                      'gradient')


def test_one_step_updates_match_jax(steps):
  got, want, want_nudged = steps
  assert set(got['updates']) == set(want['updates'])
  _assert_within_gaps(got['updates'], want['updates'],
                      want_nudged['updates'], 'update')
