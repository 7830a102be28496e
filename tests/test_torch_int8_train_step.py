"""One training step of the port under ``trunk_dtype='int8'`` and
``'int8_hybrid'`` against JAX's ``create_train_step(jit=False)``, from the
same (bridged) weights on the same batch, at the 360 config cut to test
size with ``Config.randomized=False``, as tests/test_torch_train_step.py
does for the f32 trunk.  Each JAX step runs once per mode, in a module
fixture (its Pallas kernels are interpreted on the CPU).

Tolerances: the loss terms within 1e-3 relative; each gradient leaf by
train_lib.leaf_gaps from JAX's own move under a 1e-6 nudge of the ray
origins, with the cap raised from 0.1 to INT8_GAP_CAP: the int8 step is
more sensitive than the f32 one (a nudge flips int8 roundings, each 1/127
of a row's absmax).  At NerfMLP_0/Dense_0/kernel JAX moves by 1.39e-1
under the nudge, and the port is 1.15e-1 from JAX there (both modes
alike), so a cap of 0.1 would fail the reference against itself.
"""

import os
import sys

import jax
import jax.numpy as jnp
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
from multinerf_tpu_torch.ops.kernels import int8_trunk as i8t  # noqa: E402

MODES = ('int8', 'int8_hybrid')
INT8_GAP_CAP = 0.15


@pytest.fixture(scope='module', params=MODES)
def steps(request):
  """As tests/test_torch_train_step.py: the JAX step's raw gradient, the
  same step on nudged rays, and the port's gradient, from the same weights,
  under trunk_dtype=`mode`."""
  mode = request.param
  jax_config, torch_config = tp.configs(
      tp.SMALL_BINDINGS + tp.FUSED_BINDINGS + (
          f"NerfMLP.trunk_dtype = '{mode}'", f"PropMLP.trunk_dtype = '{mode}'",
          "Config.dataset_loader = 'dummy_unbounded'",
          'Config.batch_size = 256', 'Config.randomized = False'))
  params = tp.jax_params(jax_config, seed=1)
  host = next(datasets.load_dataset('train', None, torch_config, seed=3))
  batch = train_lib.batch_to_device(host, 'cpu')
  jmodel = jax_gin.make('Model', config=jax_config)
  jstate, _ = jtrain_lib.create_optimizer(jax_config, {'params': params})
  step = jtrain_lib.create_train_step(jmodel, jax_config,
                                      mesh_lib.create_mesh(), jit=False)
  clip = jtrain_lib.clip_gradients
  want = {}
  for key, b in (('jax', batch), ('nudged', train_lib.nudge_origins(batch))):
    captured = {}

    def recording_clip(grad, config):
      captured['grad'] = grad['params']
      return clip(grad, config)

    rays = jtypes.Rays(**{k: jnp.asarray(v.numpy()) for k, v in
                          vars(b.rays).items() if v is not None})
    jtrain_lib.clip_gradients = recording_clip
    try:
      _, jstats, _ = step(jax.random.PRNGKey(0), jstate,
                          jtypes.Batch(rays=rays, rgb=jnp.asarray(
                              b.rgb.numpy())), 0.5, 1.0)
    finally:
      jtrain_lib.clip_gradients = clip
    want[key] = (jax.device_get(jstats),
                 bridge.flatten(jax.device_get(captured['grad'])))
  model = train_lib.setup_model(torch_config, 0, 'cpu')[0]
  bridge.load_jax_params(model, params)
  i8t.reset_counts()
  loss, losses, _, grads = train_lib.loss_and_grads(model, torch_config,
                                                    batch, 0.5)
  counts = (dict(i8t.counts), dict(i8t.bwd_counts))
  return dict(losses, loss=loss), grads, want['jax'], want['nudged'], counts


def test_train_step_loss_matches_jax(steps):
  got, _, (jstats, _), _, counts = steps
  assert counts == ({'launches': 0, 'plain_calls': 1},
                    {'launches': 0, 'plain_calls': 1})
  assert set(got) == {'loss', 'data', 'interlevel', 'distortion'}
  for key, value in got.items():
    want = jstats['loss'] if key == 'loss' else jstats['losses'][key]
    assert float(value) == pytest.approx(float(want), rel=1e-3), key


def test_train_step_gradients_match_jax(steps):
  _, grads, (_, want), (_, nudged), _ = steps
  assert set(grads) == set(want)
  for name, (gap, sens, bound) in train_lib.leaf_gaps(
      grads, want, nudged, cap=INT8_GAP_CAP).items():
    assert gap <= bound, (f'{name}: relative L2 {gap:.3e} > {bound:.3e} '
                          f'(JAX moved {sens:.3e})')
