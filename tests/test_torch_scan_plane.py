"""The multi-step train window (``device_sampler.create_scan_train_step``,
``Config.steps_per_jit_call`` > 1 on the device plane) and the culling
protocol around it, on the CPU at test size.

A window runs the same steps as that many single steps of the device
plane, with the same generator and the same ``train_lib.CullingGate``: the
parameters, Adam's state, the grid and every statistic come out bitwise
equal.  The occupancy threshold is set above every density the random
weights give, so that the gate engages the lowest rung at its first
refresh and the culled steps run inside the window.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), 'helpers'))
import torch_parity as tp  # noqa: E402

from multinerf_tpu_torch import bridge  # noqa: E402
from multinerf_tpu_torch import train  # noqa: E402
from multinerf_tpu_torch import train_lib  # noqa: E402
from multinerf_tpu_torch.data import datasets  # noqa: E402
from multinerf_tpu_torch.data import device_sampler  # noqa: E402
from multinerf_tpu_torch.utils import checkpoints  # noqa: E402

WINDOW = 8
LADDER = (0.33, 0.5, 0.67)
CULLING = (
    'Config.occupancy_culling = True',
    'Config.occupancy_grid_resolution = 8',
    'Config.occupancy_threshold = 1000.0',
    'Config.occupancy_warmup_steps = 2',
    'Config.occupancy_grid_refresh_every = 4',
    f'Config.occupancy_capacity_ladder = {LADDER}',
)
# RobustNeRF's loss: one 16 x 16 patch a step, its threshold fed from each
# step to the next.
ROBUST = ('Config.batch_size = 256', 'Config.patch_size = 16',
          "Config.data_loss_type = 'robustnerf'",
          'Config.enable_robustnerf_loss = True',
          'Config.robustnerf_inlier_quantile = 0.8')
COMMON = tp.SMALL_BINDINGS + (
    "Config.dataset_loader = 'dummy_scatter'", 'Config.batch_size = 64',
    'Config.max_steps = 16', f'Config.print_every = {WINDOW}',
    f'Config.checkpoint_every = {WINDOW}', 'Config.lr_delay_steps = 0')


def _argv(bindings):
  return ['--device=cpu', f'--gin_configs={tp.CONFIG_360}'] + [
      f'--gin_bindings={b}' for b in bindings]


def _run(config, dataset, windowed):
  """WINDOW steps from the same seeds: one window, or single steps of the
  device plane under the same protocol.  (state, per-step stats, gate,
  the loss threshold after the last step)."""
  model, state, _, train_step, _ = train_lib.setup_model(config, 0, 'cpu')
  steps = {None: train_step}
  gate = None
  if config.occupancy_culling:
    gate = train_lib.CullingGate(model, config)
    for cap in gate.ladder:
      steps[cap] = train_lib.create_train_step(model, config, 'cpu', cull=cap)
  plane = device_sampler.DeviceDataPlane(dataset, config, 'cpu')
  generator = torch.Generator().manual_seed(1)
  if windowed:
    window = device_sampler.create_scan_train_step(steps, plane, config,
                                                   WINDOW, gate)
    state, stacked, threshold = window(generator, state, 1)
    rows = [{k: v[i] for k, v in stacked.items()} for i in range(WINDOW)]
    return state, rows, gate, threshold
  rows = []
  threshold = 1.0
  for step in range(1, WINDOW + 1):
    single = device_sampler.create_device_train_step(
        steps[gate.cull(step) if gate else None], plane)
    train_frac = (step - 1) / (config.max_steps - 1)
    compute_stats = step % config.print_every == 0 or step == 1
    state, stats = single(generator, state, train_frac, compute_stats,
                          threshold)
    if gate is not None:
      gate.after_step(step, stats)
    if config.enable_robustnerf_loss:
      threshold = stats['loss_threshold']
    rows.append(stats)
  return state, rows, gate, threshold


@pytest.mark.parametrize('mode', ['plain', 'culled', 'robust'])
def test_one_window_equals_single_steps_bitwise(mode):
  culled = mode == 'culled'
  _, config = tp.configs(COMMON + {'plain': (), 'culled': CULLING,
                                   'robust': ROBUST}[mode])
  with datasets.load_dataset('train', None, config, seed=0) as dataset:
    state_w, rows_w, gate_w, threshold_w = _run(config, dataset, True)
    state_s, rows_s, gate_s, threshold_s = _run(config, dataset, False)
  if mode == 'robust':
    # The threshold went from step to step on the device, as a tensor.
    assert isinstance(threshold_w, torch.Tensor)
    assert torch.equal(threshold_w, threshold_s)
  assert state_w.step == state_s.step == WINDOW
  assert set(state_w.params) == set(state_s.params)
  for name, value in state_w.params.items():
    assert torch.equal(value, state_s.params[name]), name
  assert ('occupancy/grid' in state_w.params) == culled
  adam_w = bridge.adam_moments(state_w.params, state_w.optimizer)
  adam_s = bridge.adam_moments(state_s.params, state_s.optimizer)
  for moment in ('mu', 'nu'):
    for name, value in bridge.flatten(adam_w[moment]).items():
      np.testing.assert_array_equal(
          value, bridge.flatten(adam_s[moment])[name], err_msg=name)
  for i, (w, s) in enumerate(zip(rows_w, rows_s)):
    # The single steps compute the tree statistics where the window does.
    for key, value in s.items():
      assert torch.equal(w[key], value), (i + 1, key)
  if culled:
    assert gate_w.keep_fracs == gate_s.keep_fracs
    assert set(gate_w.keep_fracs) == {4, 8}
    # Unculled through the warmup and until the first refresh engaged the
    # lowest rung; culled after it.
    assert gate_w.rungs == gate_s.rungs == {s: LADDER[0]
                                            for s in range(5, WINDOW + 1)}


def test_host_and_window_protocols_choose_the_same_rungs(tmp_path):
  runs = {}
  for name, extra in (('host', ()), ('window', (
      'Config.device_data_plane = True',
      f'Config.steps_per_jit_call = {WINDOW}'))):
    runs[name] = train.main(_argv(COMMON + CULLING + extra + (
        f"Config.checkpoint_dir = '{tmp_path / name}'",)))
  host, window = runs['host'], runs['window']
  assert set(host['keep_fracs']) == set(window['keep_fracs']) == {4, 8, 12, 16}
  assert all(kf <= LADDER[0] for kf in host['keep_fracs'].values())
  assert host['rungs'] == window['rungs'] == {s: LADDER[0]
                                              for s in range(5, 17)}
  assert len(window['losses']) == len(host['losses']) == 16
  assert np.isfinite(window['losses']).all()


# The protocol against JAX's scan (device_sampler.py:150-241) at the
# smallest model.  Under opaque_background and a threshold no density
# reaches, the keep fraction is exact whatever the random streams: 0 on an
# unculled step, 1/4 on a culled one (the terminal sample of 4).  So with
# the rungs 0.1 and 0.2 the gate engages 0.1 after an unculled step and
# unculls after a culled one; the warmup holds step 4 unculled although the
# rung was engaged at step 3, and that rung crosses into the next window.
PROTOCOL_WINDOW = 4
PROTOCOL = ('PropMLP.net_depth = 2', 'PropMLP.net_width = 16',
            'NerfMLP.net_depth = 2', 'NerfMLP.net_width = 16',
            'Model.num_prop_samples = 8', 'Model.num_nerf_samples = 4',
            'Model.num_levels = 2', "Config.dataset_loader = 'dummy_scatter'",
            'Config.batch_size = 64', 'Config.max_steps = 12',
            'Config.lr_delay_steps = 0', 'Config.occupancy_culling = True',
            'Config.occupancy_grid_resolution = 8',
            'Config.occupancy_threshold = 1000.0',
            'Config.occupancy_warmup_steps = 4',
            'Config.occupancy_grid_refresh_every = 3',
            'Config.occupancy_capacity_ladder = (0.1, 0.2)')


def _jax_protocol(config):
  """JAX's scan over 3 windows: (the capacity each step ran at, 0 for
  unculled; the keep fraction of each step; cull_idx after each window)."""
  import jax
  from multinerf_tpu import train_lib as jtrain_lib
  from multinerf_tpu.data import datasets as jdatasets
  from multinerf_tpu.data import device_sampler as jdevice_sampler
  from multinerf_tpu.parallel import mesh as mesh_lib
  create = jtrain_lib.create_train_step

  def recording_create(*args, cull=False, **kwargs):
    step = create(*args, cull=cull, **kwargs)

    def recorded(*step_args):
      state, stats, rng = step(*step_args)
      return state, dict(stats, capacity=jax.numpy.float32(cull or 0)), rng
    return recorded

  mesh = mesh_lib.create_mesh()
  dataset = jdatasets.load_dataset('train', '', config)
  model, state, _, _, _ = jtrain_lib.setup_model(
      config, jax.random.PRNGKey(0), mesh=mesh, dataset=dataset)
  plane = jdevice_sampler.DeviceDataPlane(dataset, config, mesh)
  jtrain_lib.create_train_step = recording_create
  try:
    window = jdevice_sampler.create_scan_train_step(
        model, config, plane, mesh, num_steps=PROTOCOL_WINDOW)
  finally:
    jtrain_lib.create_train_step = create
  rng, threshold, cull_idx = jax.random.PRNGKey(1), 1.0, 0
  capacities, keep_fracs, cull_idxs = [], [], []
  for start in range(1, 13, PROTOCOL_WINDOW):
    state, stats, rng, threshold, cull_idx = window(rng, state, start,
                                                    threshold, cull_idx)
    capacities += np.asarray(stats['capacity']).tolist()
    keep_fracs += np.asarray(stats['occ_keep_frac']).tolist()
    cull_idxs.append(int(cull_idx))
  return capacities, keep_fracs, cull_idxs


def test_window_protocol_matches_jax_scan():
  jax_config, config = tp.configs(PROTOCOL)
  capacities, keep_fracs, cull_idxs = _jax_protocol(jax_config)
  ladder = (0.1, 0.2)
  # JAX's own run takes the course the comment above sets out.
  assert capacities == pytest.approx([0] * 4 + [0.1] * 2 + [0] * 3 +
                                     [0.1] * 3)
  model, state, _, train_step, _ = train_lib.setup_model(config, 0, 'cpu')
  gate = train_lib.CullingGate(model, config)
  steps = {None: train_step}
  for cap in ladder:
    steps[cap] = train_lib.create_train_step(model, config, 'cpu', cull=cap)
  with datasets.load_dataset('train', None, config, seed=0) as dataset:
    plane = device_sampler.DeviceDataPlane(dataset, config, 'cpu')
  window = device_sampler.create_scan_train_step(steps, plane, config,
                                                 PROTOCOL_WINDOW, gate)
  generator = torch.Generator().manual_seed(1)
  rungs = []
  for start in range(1, 13, PROTOCOL_WINDOW):
    state, _, _ = window(generator, state, start)
    rungs.append(gate.rung)
  assert gate.rungs == {s: 0.1 for s, c in enumerate(capacities, 1) if c}
  assert gate.keep_fracs == {s: keep_fracs[s - 1] for s in (3, 6, 9, 12)}
  assert rungs == [None if i == 0 else ladder[i - 1] for i in cull_idxs]

@pytest.mark.parametrize('bindings,match', [
    (('Config.print_every = 10',), 'print_every=10 must be a multiple'),
    (('Config.checkpoint_every = 12',),
     'checkpoint_every=12 must be a multiple'),
    (('Config.train_render_every = 4',),
     'train_render_every=4 must be a multiple'),
    (('Config.gc_every = 100',), 'gc_every=100 must be a multiple'),
    (CULLING + ('Config.steps_per_jit_call = 1',),
     'occupancy_culling with device_data_plane requires'),
])
def test_window_raises_jax_errors(tmp_path, bindings, match):
  with pytest.raises(ValueError, match=match):
    train.main(_argv(COMMON + (
        'Config.device_data_plane = True',
        f'Config.steps_per_jit_call = {WINDOW}') + bindings + (
            f"Config.checkpoint_dir = '{tmp_path}'",)))


def test_grid_is_saved_resumed_and_restored_across_culling(tmp_path):
  ckpt_dir = str(tmp_path / 'culled')
  out = train.main(_argv(COMMON + CULLING + (
      'Config.early_exit_steps = 8', f"Config.checkpoint_dir = '{ckpt_dir}'")))
  saved = torch.load(out['checkpoint'], weights_only=True)['params']
  grid = saved['occupancy/grid']
  assert grid.shape == (8**3,) and (grid > 0).all()
  manager = checkpoints.CheckpointManager(ckpt_dir)

  _, culled = tp.configs(COMMON + CULLING)
  state = manager.restore_latest(train_lib.setup_model(culled, 5, 'cpu')[1])
  assert torch.equal(state.params['occupancy/grid'], grid)
  # A culled checkpoint into an unculled state: the grid is dropped.
  _, plain = tp.configs(COMMON)
  state = manager.restore_latest(train_lib.setup_model(plain, 5, 'cpu')[1])
  assert 'occupancy/grid' not in state.params
  for name, value in state.params.items():
    assert torch.equal(value, saved[name]), name
  # An unculled checkpoint into a culled state: the grid keeps its zeros.
  plain_dir = str(tmp_path / 'plain')
  out = train.main(_argv(COMMON + (
      'Config.early_exit_steps = 1', f"Config.checkpoint_dir = '{plain_dir}'")))
  state = checkpoints.CheckpointManager(plain_dir).restore_latest(
      train_lib.setup_model(culled, 5, 'cpu')[1])
  assert torch.equal(state.params['occupancy/grid'], torch.zeros(8**3))
  # And the culled run resumes with its grid and its rung: the gate is
  # engaged again at the first refresh after the resume.
  out = train.main(_argv(COMMON + CULLING + (
      'Config.early_exit_steps = 12', f"Config.checkpoint_dir = '{ckpt_dir}'")))
  assert out['init_step'] == 9 and set(out['keep_fracs']) == {12}


def test_transpose_stats_reads_the_first_row_of_every_window():
  def window(first_step):
    rows = {'loss': torch.arange(4.0) + first_step,
            'grad_norms/NerfMLP_0': torch.zeros(4)}
    rows['grad_norms/NerfMLP_0'][0] = 10.0 * first_step
    if first_step + 3 == 10:
      rows['grad_norms/NerfMLP_0'][3] = 100.0
    return rows

  # A resumed run's windows 3-6 and 7-10, printing at step 10 (every 10).
  stacked = train.transpose_stats([window(3), window(7)], 10, 10, 4)
  np.testing.assert_array_equal(stacked['loss'], np.arange(3.0, 11.0))
  # Rows of steps 3 and 7 (each window's first) and 10 (a print step).
  np.testing.assert_array_equal(stacked['grad_norms/NerfMLP_0'],
                                [30.0, 70.0, 100.0])
