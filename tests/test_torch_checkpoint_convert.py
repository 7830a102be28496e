"""``scripts/convert_checkpoint.py`` in both directions, plain and under
``Config.occupancy_culling``: a scene trained two steps by one package is
converted, resumed by the other, and its third step held against the
third step of the package that trained it.

At the small widths of tests/helpers/torch_parity.py, on
``dummy_unbounded`` with ``Config.randomized = False``, both MLPs unfused
on both sides (plain f32 products: the conversion, not the kernels, is
under test), 16 rays a step.

- JAX -> port: JAX trains 2 steps (``create_train_step(jit=False)``) and
  saves through its CheckpointManager; the converter writes the port's
  checkpoint; the port's ``restore_latest`` gives JAX's step, variables
  (the occupancy grid included) and Adam's moments bitwise, and the port's
  step 3 moves the parameters as JAX's step 3 does, by
  ``train_lib.leaf_gaps`` against JAX's own move under the 1e-6 nudge.
  With a wrong Adam count the bias correction alone would move every
  update by far more.
- port -> JAX: the port trains 2 steps and saves; the converter writes an
  orbax checkpoint; JAX's ``restore_latest`` loads it with the structure of
  JAX's own state, bitwise; the two step 3s are held as above.
- ``.pt`` -> orbax -> ``.pt`` is bitwise, the Adam state included.
The grids after step 3, the densities of step 3's samples, agree within
the unfused f32 density bounds of tests/test_torch_refnerf.py (rtol 1e-3,
atol 1e-5; 2.2e-4 relative measured).
"""

import os
import sys

import jax
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), 'helpers'))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'scripts'))
import convert_checkpoint  # noqa: E402
import torch_parity as tp  # noqa: E402

from multinerf_tpu import ginlite as jax_gin  # noqa: E402
from multinerf_tpu import train_lib as jtrain_lib  # noqa: E402
from multinerf_tpu.data import types as jtypes  # noqa: E402
from multinerf_tpu.models import nerf as jnerf  # noqa: E402
from multinerf_tpu.parallel import mesh as mesh_lib  # noqa: E402
from multinerf_tpu.utils import checkpoints as jcheckpoints  # noqa: E402
from multinerf_tpu_torch import bridge  # noqa: E402
from multinerf_tpu_torch import train_lib  # noqa: E402
from multinerf_tpu_torch.data import datasets  # noqa: E402
from multinerf_tpu_torch.utils import checkpoints  # noqa: E402

BINDINGS = tp.SMALL_BINDINGS + (
    "Config.dataset_loader = 'dummy_unbounded'", 'Config.batch_size = 16',
    'Config.randomized = False', 'NerfMLP.use_fused_featurize = False',
    'PropMLP.use_fused_featurize = False', 'Config.lr_delay_steps = 0')
CULL = ('Config.occupancy_culling = True',
        'Config.occupancy_grid_resolution = 8')
TRAIN_FRAC = 0.5


def _jax_batch(batch):
  return jtypes.Batch(
      rays=jtypes.Rays(**{k: np.asarray(v.numpy()) for k, v in
                          vars(batch.rays).items() if v is not None}),
      **{k: np.asarray(v.numpy()) for k, v in vars(batch).items()
         if k != 'rays' and v is not None})


def _argv(bindings):
  return [f'--gin_configs={tp.CONFIG_360}'] + [
      f'--gin_bindings={b}' for b in bindings]


def _flat_opt(optimizer, params):
  """{name: {'step', 'exp_avg', 'exp_avg_sq'}} of a torch Adam."""
  return {n: {k: v.detach().clone() for k, v in optimizer.state[p].items()}
          for n, p in params.items()}


def _jax_moments(opt_state):
  """(mu, nu, counts) of optax's state as {name: array} trees."""
  out = {'mu': {}, 'nu': {}}
  counts = []
  for path, leaf in jax.tree_util.tree_flatten_with_path(opt_state)[0]:
    keys = [convert_checkpoint._key(k) for k in path]  # pylint: disable=protected-access
    if keys[-1] == 'count':
      counts.append(int(leaf))
    for field in out:
      if field in keys:
        rest = keys[keys.index(field) + 1:]
        out[field]['/'.join(rest[1:])] = np.asarray(leaf)
  return out['mu'], out['nu'], counts


@pytest.fixture(scope='module', params=['plain', 'culled'])
def scene(request, tmp_path_factory):
  """Everything both directions share: the configs and their flags, the
  JAX variables at step 0, 3 batches and the nudged third, and JAX's
  jitted step."""
  bindings = BINDINGS + (CULL if request.param == 'culled' else ())
  jax_config, torch_config = tp.configs(bindings)
  variables = jax.jit(lambda key: jnerf.construct_model(
      key, jtypes.dummy_rays(include_exposure_values=True),
      jax_config)[1])(jax.random.PRNGKey(1))
  variables = jax.device_get(dict(variables))
  assert ('occupancy' in variables) == (request.param == 'culled')
  with datasets.load_dataset('train', None, torch_config, seed=3) as dataset:
    batches = [train_lib.batch_to_device(next(dataset), 'cpu')
               for _ in range(3)]
  batches.append(train_lib.nudge_origins(batches[2]))
  jmodel = jax_gin.make('Model', config=jax_config)
  step = jtrain_lib.create_train_step(jmodel, jax_config,
                                      mesh_lib.create_mesh(), jit=False)
  run = jax.jit(lambda state, b: step(jax.random.PRNGKey(0), state, b,
                                      TRAIN_FRAC, 1.0)[0])
  return dict(bindings=bindings, jax_config=jax_config,
              torch_config=torch_config, variables=variables,
              batches=batches, jax_step=lambda s, b: jax.device_get(
                  run(s, _jax_batch(b))),
              tmp=tmp_path_factory.mktemp(request.param))


def _jax_state0(scene):
  return jtrain_lib.create_optimizer(scene['jax_config'],
                                     scene['variables'])[0]


def _jax_updates(scene, state2):
  """JAX's step 3 from `state2` on the third batch and on its nudged copy:
  ({name: update}, {name: update}, grid after step 3 or None)."""
  params2 = bridge.flatten(state2.params['params'])
  out = []
  for b in scene['batches'][2:]:
    state3 = scene['jax_step'](state2, b)
    out.append({k: np.asarray(v) - np.asarray(params2[k])
                for k, v in bridge.flatten(state3.params['params']).items()})
    if len(out) == 1:
      grid = (np.asarray(state3.params['occupancy']['grid'])
              if 'occupancy' in state3.params else None)
  return out[0], out[1], grid


def _port_step(scene, model, state, batch):
  step = train_lib.create_train_step(model, scene['torch_config'], 'cpu')
  return step(None, state, batch, TRAIN_FRAC, False)[0]


def _assert_updates(got, want, want_nudged):
  assert set(got) == set(want)
  for name, (gap, sens, bound) in train_lib.leaf_gaps(
      got, want, want_nudged).items():
    assert gap <= bound, (f'{name}: relative L2 error {gap:.3e} > '
                          f'{bound:.3e} (JAX moved {sens:.3e})')


def _assert_grid(model, want):
  if want is None:
    assert not hasattr(model, 'occupancy')
    return
  tp.assert_close(model.occupancy.grid.numpy(), want, atol=1e-5, rtol=1e-3,
                  what='occupancy/grid')


def test_jax_checkpoint_resumes_in_the_port(scene):
  tmp = scene['tmp']
  state = _jax_state0(scene)
  for b in scene['batches'][:2]:
    state = scene['jax_step'](state, b)
  manager = jcheckpoints.CheckpointManager(str(tmp / 'jax'))
  manager.save(2, state)
  manager.wait_until_finished()
  manager.close()
  assert convert_checkpoint.main(
      ['--direction=jax-to-torch', f'--src={tmp}/jax',
       f'--dst={tmp}/from_jax'] + _argv(scene['bindings'])) == 2

  model, port, _, _, _ = train_lib.setup_model(scene['torch_config'], 9,
                                               'cpu')
  port = checkpoints.CheckpointManager(str(tmp / 'from_jax')).restore_latest(
      port)
  assert port.step == 2
  want_vars = bridge.flatten(state.params['params'])
  if 'occupancy' in state.params:
    want_vars['occupancy/grid'] = state.params['occupancy']['grid']
  assert set(port.params) == set(want_vars)
  for name, value in port.params.items():
    np.testing.assert_array_equal(value.detach().numpy(), want_vars[name],
                                  err_msg=name)
  mu, nu, counts = _jax_moments(state.opt_state)
  assert set(counts) == {2}
  params = bridge.named_parameters(model)
  for name, s in _flat_opt(port.optimizer, params).items():
    assert float(s['step']) == 2.0, name
    np.testing.assert_array_equal(s['exp_avg'].numpy(), mu[name])
    np.testing.assert_array_equal(s['exp_avg_sq'].numpy(), nu[name])

  want, want_nudged, grid = _jax_updates(scene, state)
  before = {k: p.detach().clone() for k, p in params.items()}
  port = _port_step(scene, model, port, scene['batches'][2])
  assert port.step == 3
  _assert_updates({k: (p.detach() - before[k]).numpy()
                   for k, p in params.items()}, want, want_nudged)
  _assert_grid(model, grid)


def test_port_checkpoint_resumes_in_jax(scene):
  tmp = scene['tmp']
  model, port, _, _, _ = train_lib.setup_model(scene['torch_config'], 9,
                                               'cpu')
  bridge.load_jax_variables(model, scene['variables'])
  for b in scene['batches'][:2]:
    port = _port_step(scene, model, port, b)
  checkpoints.CheckpointManager(str(tmp / 'port')).save(2, port)
  assert convert_checkpoint.main(
      ['--direction=torch-to-jax', f'--src={tmp}/port',
       f'--dst={tmp}/from_port'] + _argv(scene['bindings'])) == 2

  # JAX's own restore, into the structure of JAX's own state: strict.
  abstract = _jax_state0(scene)
  manager = jcheckpoints.CheckpointManager(str(tmp / 'from_port'))
  restored = manager.restore_latest(abstract)
  strict = ocp.CheckpointManager(str(tmp / 'from_port')).restore(
      2, args=ocp.args.StandardRestore(jax.tree_util.tree_map(
          ocp.utils.to_shape_dtype_struct, abstract)))
  manager.close()
  assert jax.tree_util.tree_structure(strict) == jax.tree_util.tree_structure(
      abstract)
  assert int(restored.step) == 2
  params = bridge.named_parameters(model)
  got_vars = bridge.flatten(restored.params['params'])
  if 'occupancy' in restored.params:
    got_vars['occupancy/grid'] = restored.params['occupancy']['grid']
  assert set(got_vars) == set(port.params)
  for name, value in port.params.items():
    np.testing.assert_array_equal(np.asarray(got_vars[name]),
                                  value.detach().numpy(), err_msg=name)
  mu, nu, counts = _jax_moments(restored.opt_state)
  assert set(counts) == {2}
  for name, s in _flat_opt(port.optimizer, params).items():
    np.testing.assert_array_equal(mu[name], s['exp_avg'].numpy())
    np.testing.assert_array_equal(nu[name], s['exp_avg_sq'].numpy())

  want, want_nudged, grid = _jax_updates(scene, restored)
  before = {k: p.detach().clone() for k, p in params.items()}
  port = _port_step(scene, model, port, scene['batches'][2])
  _assert_updates({k: (p.detach() - before[k]).numpy()
                   for k, p in params.items()}, want, want_nudged)
  _assert_grid(model, grid)

  # .pt -> orbax -> .pt: bitwise, the Adam state included.
  convert_checkpoint.main(['--direction=jax-to-torch',
                           f'--src={tmp}/from_port', f'--dst={tmp}/again'] +
                          _argv(scene['bindings']))
  first, again = (torch.load(os.path.join(tmp, d, 'checkpoint_2.pt'),
                             weights_only=True) for d in ('port', 'again'))
  assert first['step'] == again['step'] == 2
  assert list(first['params']) == list(again['params'])
  for name, value in first['params'].items():
    assert torch.equal(value, again['params'][name]), name
  assert first['opt_state']['param_groups'] == again['opt_state'][
      'param_groups']
  assert set(first['opt_state']['state']) == set(again['opt_state']['state'])
  for i, s in first['opt_state']['state'].items():
    for k, v in s.items():
      assert torch.equal(v, again['opt_state']['state'][i][k]), (i, k)
