"""``correct`` comes out false when the timed path is broken underneath a
run, or computed in the next lower precision (the control).

Each fault test skips the harness's look for a card and drives the rest of
a run at debug widths on the CPU, with the program patched where the fault
would be: a step that returns its state unchanged, half of each batch left
out with the mean taken over the rest, an answer altered where the
renderer produces it.  The limits are the committed ones.
"""

import dataclasses
import time

import pytest
import torch

from benchmark import calibrate
from benchmark import run
from benchmark.lib import harness
from benchmark.tests import small


def _run(cell_name, seconds=0.3):
  return run.execute(small.small_cell(cell_name), 2**33 + 5, seconds, False,
                     torch.device('cpu'), time.perf_counter())


TRAIN_CELLS = ['mipnerf360_bf16.train', 'refnerf.train']


@pytest.mark.parametrize('cell', TRAIN_CELLS)
def test_a_state_left_unchanged_is_caught(cell, monkeypatch):
  from multinerf_tpu_torch import train_lib
  from multinerf_tpu_torch.utils import checkpoints

  def unchanged(state, grads, config, lr_fn):
    del grads, config, lr_fn
    return checkpoints.TrainState(step=state.step + 1, params=state.params,
                                  optimizer=state.optimizer)

  monkeypatch.setattr(train_lib, 'apply_gradients', unchanged)
  result = _run(cell)
  assert result['correct'] is False
  assert result['checks']['update_gap']['value'] >= 0.99


@pytest.mark.parametrize('cell', TRAIN_CELLS)
def test_half_the_batch_left_out_is_caught(cell, monkeypatch):
  from multinerf_tpu_torch import train_lib
  whole = train_lib.loss_and_grads

  def half(model, config, batch, *args, **kw):
    n = batch.rgb.shape[0] // 2
    cut = lambda x: None if x is None else x[:n]
    rays = dataclasses.replace(batch.rays, **{
        f: cut(getattr(batch.rays, f))
        for f in batch.rays.__dataclass_fields__})
    batch = dataclasses.replace(batch, rays=rays, **{
        f: cut(getattr(batch, f)) for f in ('rgb', 'disps', 'normals',
                                             'alphas')})
    return whole(model, config, batch, *args, **kw)

  monkeypatch.setattr(train_lib, 'loss_and_grads', half)
  result = _run(cell)
  assert result['correct'] is False
  checks = result['checks']
  assert checks['loss_gap']['value'] > checks['loss_gap']['limit']


def test_an_altered_answer_is_caught(monkeypatch):
  from multinerf_tpu_torch.models import nerf
  render = nerf.DeviceImageRenderer.__call__

  def altered(self, train_frac, cam_idx):
    out = render(self, train_frac, cam_idx)
    rgb = out['rgb'].reshape(-1, 3)
    chunk = self._config.render_chunk_size  # pylint: disable=protected-access
    rgb[chunk:2 * chunk] = (rgb[chunk:2 * chunk] + 0.05).clip(0, 1)
    return out

  monkeypatch.setattr(nerf.DeviceImageRenderer, '__call__', altered)
  result = _run('mipnerf360_bf16.render')
  assert result['correct'] is False


def test_a_sound_run_is_correct():
  assert _run('mipnerf360_bf16.render')['correct'] is True


def _control_fails(cell_name, readings):
  """The control fails the cell's limits, and reads above the sound run on
  every number compared."""
  limits = harness.Cell(cell_name).workload['limits']
  correct, _ = harness.judge(readings['control'], limits)
  above = all(readings['control'][k] > readings['sound'][k]
              for k in limits if k in readings['sound'])
  return above and not correct


def test_control_fails_mipnerf360_train():
  """The program's int8 trunk in place of its bf16 one."""
  cell = small.small_cell('mipnerf360_bf16.train', batch=256)
  readings = calibrate.train_readings(cell, harness.seeds(4), torch.device(
      'cpu'), control=True, faults=False)
  assert _control_fails('mipnerf360_bf16.train', readings)


def test_control_fails_mipnerf360_render():
  cell = small.small_cell('mipnerf360_bf16.render')
  readings = calibrate.render_readings(cell, harness.seeds(4), torch.device(
      'cpu'), control=True, faults=False, n_frames=2)
  assert _control_fails('mipnerf360_bf16.render', readings)


@pytest.mark.cuda
def test_control_fails_refnerf_train():
  """The reference in TF32 in place of the program's f32: TF32 exists on
  the card only."""
  if not torch.cuda.is_available():
    pytest.skip('TF32 is a mode of the card; the CPU has none.')
  cell = small.small_cell('refnerf.train', batch=1024)
  readings = calibrate.train_readings(cell, harness.seeds(4), torch.device(
      'cuda'), control=True, faults=False)
  assert _control_fails('refnerf.train', readings)
