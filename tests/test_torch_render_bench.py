"""``multinerf_tpu_torch.render_bench`` (the port of scripts/render_bench.py)
and ``ImageRenderer.render_rays(fetch=False)`` on the CPU, at the 360
config cut to test size.

* each arm's PSNR (the mean over frames of -10 log10 of the frame's mean
  squared error, computed on the device in float32) against
  ``harness.render_psnrs`` through the host-fetching renderer on the same
  restored weights (float64 on the host): within 1e-5 dB;
* a checkpoint trained under the bf16 trunk restores into the bf16 and
  the int8 arm, bitwise;
* ``fetch=False`` leaves on the device the frame ``fetch=True`` reads back,
  bit for bit.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), 'helpers'))
import torch_parity as tp  # noqa: E402

from multinerf_tpu_torch import harness  # noqa: E402
from multinerf_tpu_torch import render_bench  # noqa: E402
from multinerf_tpu_torch import train  # noqa: E402
from multinerf_tpu_torch import train_lib  # noqa: E402
from multinerf_tpu_torch.data import datasets  # noqa: E402
from multinerf_tpu_torch.models import nerf  # noqa: E402
from multinerf_tpu_torch.utils import checkpoints as ckpt_lib  # noqa: E402

FRAMES = 2
ARMS = ('bfloat16', 'int8')
PSNR_TOL = 1e-5


@pytest.fixture(scope='module')
def bf16_checkpoint(tmp_path_factory):
  ckpt = str(tmp_path_factory.mktemp('ckpt'))
  train.main([f'--gin_configs={tp.CONFIG_360}', '--device=cpu'] + [
      f'--gin_bindings={b}' for b in tp.SMALL_BINDINGS + tuple(
          harness.trunk_bindings('bfloat16')) + (
              "Config.dataset_loader = 'dummy_unbounded'",
              f"Config.checkpoint_dir = '{ckpt}'", 'Config.max_steps = 2',
              'Config.batch_size = 32')])
  return ckpt


def _small_configs(monkeypatch):
  make_config = harness.make_config
  monkeypatch.setattr(harness, 'make_config', lambda b, gin_files=(), **kw:
                      make_config(list(b) + list(tp.SMALL_BINDINGS),
                                  gin_files, **kw))


def _arm_model(trunk_dtype, ckpt):
  """The arm's model, renderer and test cases, restored as render_bench
  restores it; and its parameters before the restore."""
  config = harness.make_config(
      harness.trunk_bindings(trunk_dtype), [harness.CONFIG_360],
      dataset_loader='dummy_unbounded', near=0.2, far=1e6,
      render_chunk_size=16384, batch_size=render_bench.BATCH_SIZE)
  _, state, render_fn, _, _ = train_lib.setup_model(config, render_bench.SEED,
                                                    'cpu')
  fresh = {k: v.clone() for k, v in state.params.items()}
  state = ckpt_lib.CheckpointManager(ckpt).restore_latest(
      ckpt_lib.TrainState(step=0, params=state.params))
  with datasets.load_dataset('test', '', config) as dataset:
    cases = [next(dataset) for _ in range(FRAMES)]
  renderer = nerf.ImageRenderer(render_fn, config, None, 'cpu')
  return state, fresh, renderer, cases


def test_render_bench_on_a_bf16_checkpoint(monkeypatch, capsys,
                                           bf16_checkpoint):
  _small_configs(monkeypatch)
  arms, comparison = render_bench.main(
      ['--checkpoint_dir', bf16_checkpoint, '--frames', str(FRAMES),
       '--trunk_dtypes', ','.join(ARMS)], device='cpu')
  lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()
           if l.startswith('{')]
  assert lines == json.loads(json.dumps(arms + [{'comparison':
                                                 comparison}]))
  keys = {'trunk_dtype', 'checkpoint_step', 'frame_hw', 'sec_per_frame',
          'rays_per_sec', 'first_frame_s', 'psnr', 'frames', 'device'}
  assert [set(a) for a in arms] == [keys] * len(ARMS)
  assert [a['trunk_dtype'] for a in arms] == list(ARMS)
  for arm in arms:
    assert arm['checkpoint_step'] == 2 and arm['frames'] == FRAMES
    assert arm['device'] == 'cpu' and arm['frame_hw'] == [64, 64]
    assert arm['rays_per_sec'] == pytest.approx(64 * 64 /
                                                arm['sec_per_frame'])
  assert set(comparison) == set(ARMS[1:])
  for dtype in ARMS[1:]:
    arm = arms[ARMS.index(dtype)]
    assert comparison[dtype] == {
        'speedup_vs_bfloat16': arms[0]['sec_per_frame'] /
                               arm['sec_per_frame'],
        'psnr_delta': arm['psnr'] - arms[0]['psnr']}

  saved = torch.load(os.path.join(bf16_checkpoint, 'checkpoint_2.pt'),
                     weights_only=True)['params']
  for arm in arms:
    state, fresh, renderer, cases = _arm_model(arm['trunk_dtype'],
                                               bf16_checkpoint)
    assert state.step == 2
    for name, value in state.params.items():
      assert torch.equal(value, saved[name]), (arm['trunk_dtype'], name)
    # The weights came from the checkpoint, not from the seed.
    assert not all(torch.equal(fresh[k], saved[k]) for k in fresh)
    psnrs, _ = harness.render_psnrs(renderer, cases, 1.0)
    assert abs(arm['psnr'] - np.mean(psnrs)) <= PSNR_TOL, arm


def test_render_bench_without_a_checkpoint_renders_the_seed(monkeypatch):
  _small_configs(monkeypatch)
  arms, comparison = render_bench.main(
      ['--frames', '1', '--trunk_dtypes', 'float32'], device='cpu')
  assert comparison is None
  assert arms[0]['checkpoint_step'] == 0 and np.isfinite(arms[0]['psnr'])


def test_render_rays_without_fetch_is_the_fetched_frame():
  _, config = tp.configs(tp.SMALL_BINDINGS + (
      "Config.dataset_loader = 'dummy_unbounded'",
      'Config.render_chunk_size = 1536'))
  _, _, render_fn, _, _ = train_lib.setup_model(config, 0, 'cpu')
  with datasets.load_dataset('test', None, config) as dataset:
    rays = dataset.generate_ray_batch(0).rays
  renderer = nerf.ImageRenderer(render_fn, config, None, 'cpu')
  fetched = renderer.render_rays(1.0, rays)
  kept = renderer.render_rays(1.0, rays, fetch=False)
  assert set(kept) == set(fetched)
  for key, value in kept.items():
    if isinstance(value, list):
      assert all(isinstance(v, torch.Tensor) for v in value)
      pairs = zip(value, fetched[key])
    else:
      assert isinstance(value, torch.Tensor)
      pairs = [(value, fetched[key])]
    for got, want in pairs:
      np.testing.assert_array_equal(got.numpy(), want)
