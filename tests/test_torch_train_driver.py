"""The port's train driver against JAX train.py: its TensorBoard tags, its
config.gin, its resume and checkpoint cadence, its profile window.

JAX train.py runs once, in a subprocess (tests/helpers/cli_runner.py), at
the small test widths; the port's driver runs in this process on the CPU
with the same configuration.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), 'helpers'))
import torch_parity as tp  # noqa: E402

from multinerf_tpu.utils import visualize as jvis  # noqa: E402
from multinerf_tpu_torch import train  # noqa: E402
from multinerf_tpu_torch import train_lib  # noqa: E402
from multinerf_tpu_torch.data import datasets  # noqa: E402
from multinerf_tpu_torch.models import nerf  # noqa: E402
from multinerf_tpu_torch.utils import checkpoints  # noqa: E402
from multinerf_tpu_torch.utils import summary  # noqa: E402

# One step, which prints (the first of a run) and saves.
COMMON = tp.SMALL_BINDINGS + (
    "Config.dataset_loader = 'dummy_unbounded'", 'Config.batch_size = 32',
    'Config.max_steps = 2', 'Config.early_exit_steps = 1',
    'Config.checkpoint_every = 2')
RENDER_TAGS = {'test_rays_per_sec', 'train_metrics/psnr',
               'train_metrics/ssim', 'test_true_color'}


def _argv(bindings):
  return [f'--gin_configs={tp.CONFIG_360}'] + [
      f'--gin_bindings={b}' for b in bindings]


@pytest.fixture(scope='module')
def jax_run(tmp_path_factory):
  """JAX train.py, no in-train render: its checkpoint dir."""
  ckpt_dir = str(tmp_path_factory.mktemp('jax_train'))
  env = dict(os.environ, JAX_PLATFORMS='cpu', OMP_NUM_THREADS='1',
             XLA_FLAGS='--xla_force_host_platform_device_count=1',
             PYTHONPATH=tp.REPO + os.pathsep + os.environ.get('PYTHONPATH',
                                                              ''))
  cmd = [sys.executable, os.path.join(tp.REPO, 'tests', 'helpers',
                                      'cli_runner.py'),
         os.path.join(tp.REPO, 'train.py')] + _argv(COMMON + (
             'Config.train_render_every = 100',
             f"Config.checkpoint_dir = '{ckpt_dir}'"))
  proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                        timeout=600, check=False)
  assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
  return ckpt_dir


@pytest.fixture(scope='module')
def port_run(tmp_path_factory):
  """The port's driver on the same configuration, rendering test view 0
  at step 1: (checkpoint dir, what main returned)."""
  ckpt_dir = str(tmp_path_factory.mktemp('port_train'))
  out = train.main(['--device=cpu'] + _argv(COMMON + (
      'Config.train_render_every = 1',
      f"Config.checkpoint_dir = '{ckpt_dir}'")))
  return ckpt_dir, out


def _jax_scalars(ckpt_dir):
  """{tag: {step: value}} of JAX train.py's event file (TF2 tensors)."""
  from tensorboard.backend.event_processing import event_accumulator
  from tensorboard.util import tensor_util
  acc = event_accumulator.EventAccumulator(
      ckpt_dir, size_guidance={event_accumulator.TENSORS: 0})
  acc.Reload()
  return {tag: {e.step: tensor_util.make_ndarray(e.tensor_proto)
                for e in acc.Tensors(tag)}
          for tag in acc.Tags()['tensors']}


def test_driver_writes_the_tags_of_jax_train(jax_run, port_run):
  pytest.importorskip('tensorboard')
  ckpt_dir, out = port_run
  events = summary.read_events(ckpt_dir)
  got = {e['tag'] for e in events}
  want = _jax_scalars(jax_run)
  # The in-train render's tags: its metrics and ground truth, and one image
  # per key of the JAX suite on the same rendering.
  _, config = tp.configs(COMMON)
  render_fn = train_lib.setup_model(config, train.SEED, 'cpu')[2]
  test = datasets.load_dataset('test', None, config)
  rendering = nerf.DeviceImageRenderer(render_fn, config, test, 'cpu')(1.0, 0)
  suite = jvis.visualize_suite(rendering, test.generate_ray_batch(0).rays)
  render_tags = RENDER_TAGS | {f'test_output_{k}' for k in suite}
  assert got - render_tags == set(want), (
      sorted((got - render_tags) ^ set(want)))
  assert render_tags <= got
  assert {e['step'] for e in events if e['tag'] in render_tags} == {1}
  assert len(out['test_rays_per_sec']) == 1

  scalars = {(e['tag'], e['step']): e['value'] for e in events
             if e['kind'] == 'scalar'}
  assert scalars['train_num_params', 1] == float(
      want['train_num_params'][1])
  assert scalars['train_learning_rate', 1] == pytest.approx(
      float(want['train_learning_rate'][1]), rel=1e-6)
  hist = [e for e in events if e['tag'] == 'train_psnr' and e['step'] == 1]
  assert hist[0]['kind'] == 'histogram' and hist[0]['value']['num'] == 1


def test_driver_writes_the_config_of_jax_train(jax_run, port_run):
  def lines(ckpt_dir):
    with open(os.path.join(ckpt_dir, 'config.gin')) as f:
      return {line for line in f.read().splitlines()
              if not line.startswith(('Config.checkpoint_dir',
                                      'Config.train_render_every'))}
  assert lines(port_run[0]) == lines(jax_run)


def test_resume_restores_params_and_adam_and_keeps_the_cadence(
    tmp_path, monkeypatch):
  ckpt_dir = str(tmp_path / 'ckpt')
  bindings = tp.SMALL_BINDINGS + (
      "Config.dataset_loader = 'dummy_unbounded'", 'Config.batch_size = 32',
      'Config.max_steps = 8', 'Config.print_every = 2',
      'Config.train_render_every = 0', f"Config.checkpoint_dir = '{ckpt_dir}'")
  first = train.main(['--device=cpu'] + _argv(bindings + (
      'Config.checkpoint_every = 2', 'Config.early_exit_steps = 4')))
  assert first['init_step'] == 1 and len(first['losses']) == 4
  mngr = checkpoints.CheckpointManager(ckpt_dir)
  # train.py:425 and 437: step 1 and every checkpoint_every steps; no final
  # save, since 8 % 2 == 0.
  assert mngr.steps() == [1, 2, 4]
  saved = torch.load(mngr.path(4), weights_only=True)
  assert saved['step'] == 4

  restored = []
  restore_latest = checkpoints.CheckpointManager.restore_latest

  def spy(self, state):
    out = restore_latest(self, state)
    # Copies: the run goes on to update these tensors in place.
    restored.append((out.step, {k: v.detach().clone()
                                for k, v in out.params.items()},
                     {i: {k: v.clone() for k, v in s.items()} for i, s in
                      out.optimizer.state_dict()['state'].items()}))
    return out
  monkeypatch.setattr(checkpoints.CheckpointManager, 'restore_latest', spy)
  second = train.main(['--device=cpu'] + _argv(bindings + (
      'Config.checkpoint_every = 3', 'Config.profile_step = 6',
      'Config.profile_num_steps = 1')))
  assert second['init_step'] == 5 and len(second['losses']) == 4
  # Saves at 6 (6 % 3 == 0), and at max_steps since 8 % 3 != 0.
  assert mngr.steps() == [1, 2, 4, 6, 8]

  step, params, opt_state = restored[0]
  assert step == 4
  assert params.keys() == saved['params'].keys()
  for name, value in saved['params'].items():
    assert torch.equal(params[name], value), name
  want = saved['opt_state']['state']
  assert opt_state.keys() == want.keys() and want
  for i, fields in want.items():
    assert fields.keys() == {'step', 'exp_avg', 'exp_avg_sq'}
    for key, value in fields.items():
      assert torch.equal(opt_state[i][key], value), (i, key)
    assert float(fields['step']) == 4
  # Bias correction and the schedule went on from step 4.
  final = torch.load(mngr.path(8), weights_only=True)
  assert final['step'] == 8
  assert {float(s['step']) for s in final['opt_state']['state'].values()} == {
      8.0}
  assert os.listdir(os.path.join(ckpt_dir, 'profile'))


def test_tree_statistics_rows_of_a_print_window():
  row = lambda v, tree: dict({'loss': torch.tensor(v)}, **(
      {'grad_norms/NerfMLP_0': torch.tensor(10 * v)} if tree else {}))
  # Steps 3..6 at print_every 2: the tree statistics of steps 4 and 6.
  stacked = train.transpose_stats(
      [row(3., False), row(4., True), row(5., False), row(6., True)], 6, 2)
  np.testing.assert_array_equal(stacked['loss'], [3, 4, 5, 6])
  np.testing.assert_array_equal(stacked['grad_norms/NerfMLP_0'], [40, 60])
  # A resumed run's first step, off the cadence: row 0 (ADVICE.md:3).
  stacked = train.transpose_stats([row(5., True)], 5, 2)
  np.testing.assert_array_equal(stacked['grad_norms/NerfMLP_0'], [50])
  split = train.split_stats({'mses': np.arange(6.).reshape(2, 3)}, 2)
  assert list(split) == ['mses/0', 'mses/1', 'mses/2']
  np.testing.assert_array_equal(split['mses/2'], [2, 5])


def test_early_exit_steps_zero_runs_no_step_and_saves_what_jax_saves(
    tmp_path):
  # train.py:235-238: early_exit_steps = 0 runs no step; the final save of
  # train.py:456-457 then writes the initial state under max_steps.
  bindings = COMMON[:-3] + ('Config.max_steps = 3',
                            'Config.early_exit_steps = 0',
                            'Config.checkpoint_every = 2',
                            'Config.train_render_every = 0')
  jax_dir = str(tmp_path / 'jax')
  env = dict(os.environ, JAX_PLATFORMS='cpu', OMP_NUM_THREADS='1',
             XLA_FLAGS='--xla_force_host_platform_device_count=1',
             PYTHONPATH=tp.REPO + os.pathsep + os.environ.get('PYTHONPATH',
                                                              ''))
  cmd = [sys.executable, os.path.join(tp.REPO, 'tests', 'helpers',
                                      'cli_runner.py'),
         os.path.join(tp.REPO, 'train.py')] + _argv(bindings + (
             f"Config.checkpoint_dir = '{jax_dir}'",))
  proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                        timeout=600, check=False)
  assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
  jax_steps = sorted(int(n) for n in os.listdir(jax_dir) if n.isdigit())

  port_dir = str(tmp_path / 'port')
  out = train.main(['--device=cpu'] + _argv(bindings + (
      f"Config.checkpoint_dir = '{port_dir}'",)))
  assert out['losses'] == [] and out['init_step'] == 1
  assert checkpoints.CheckpointManager(port_dir).steps() == jax_steps == [3]
  saved = torch.load(out['checkpoint'], weights_only=True)
  assert saved['step'] == 0
  _, config = tp.configs(bindings)
  fresh = train_lib.setup_model(config, train.SEED, 'cpu')[1].params
  assert all(torch.equal(saved['params'][k], v) for k, v in fresh.items())
