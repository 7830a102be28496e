"""The quality harnesses of the port (``multinerf_tpu_torch.harness``,
``cull_quality``, ``keep_frac_probe``, ``int8_eval_decision``) against the
JAX scripts they port: scripts/cull_quality_experiment.py,
scripts/keep_frac_probe.py and scripts/int8_eval_decision.py.

* the bindings lists are the scripts' own, read from their source;
* a culled arm's gate (``train_lib.CullingGate`` on the one rung) culls on
  the steps the script's loop culls, over one sequence of keep fractions;
* the probe's keep fraction equals JAX's (the unculled final level's
  ``occ_keep_frac``, rng None) on the same weights, grid and rays: both
  sides compare the same grid values with the same rule;
* the int8 decision is the script's at the edges of its rule, read from the
  script's own main over made-up arms;
* each entry point runs end to end on the CPU for a few steps at debug
  widths (fewer samples, small batches: the harnesses take no flag for
  them, so the test narrows their module-level settings) and writes the
  JAX script's keys.
"""

import ast
import importlib.util
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), 'helpers'))
import torch_parity as tp  # noqa: E402

from multinerf_tpu import ginlite as jax_gin  # noqa: E402
from multinerf_tpu_torch import bridge  # noqa: E402
from multinerf_tpu_torch import cull_quality  # noqa: E402
from multinerf_tpu_torch import harness  # noqa: E402
from multinerf_tpu_torch import int8_eval_decision  # noqa: E402
from multinerf_tpu_torch import keep_frac_probe  # noqa: E402
from multinerf_tpu_torch import train  # noqa: E402
from multinerf_tpu_torch import train_lib  # noqa: E402
from multinerf_tpu_torch.data import types  # noqa: E402
from multinerf_tpu_torch.models import nerf  # noqa: E402

SCRIPTS = os.path.join(tp.REPO, 'scripts')
# Debug widths with fewer samples a ray: the CPU's cost is the resampling.
SMALL = harness.BASE_BINDINGS + harness.DEBUG_WIDTHS + [
    'Model.num_prop_samples = 8', 'Model.num_nerf_samples = 4']


def _script_lists(name):
  """{name: value} of the module-level list assignments of scripts/name."""
  with open(os.path.join(SCRIPTS, name)) as f:
    tree = ast.parse(f.read())
  out = {}
  for node in tree.body:
    if (isinstance(node, ast.Assign) and len(node.targets) == 1 and
        isinstance(node.targets[0], ast.Name) and
        isinstance(node.value, ast.List)):
      out[node.targets[0].id] = ast.literal_eval(node.value)
  return out


def test_bindings_are_the_scripts():
  cull = _script_lists('cull_quality_experiment.py')
  for name in ('BASE_BINDINGS', 'DEBUG_WIDTHS', 'FLAGSHIP_WIDTHS'):
    assert getattr(harness, name) == cull[name], name
  decision = _script_lists('int8_eval_decision.py')
  assert sorted(harness.FLAGSHIP) == sorted(decision['FLAGSHIP'])
  assert harness.REFNERF == decision['REFNERF']


def _script_rule(keep_fracs, capacity, warmup, refresh_every):
  """The culled steps of scripts/cull_quality_experiment.py:133-144's loop,
  given each refresh step's keep fraction."""
  culled, engaged = [], False
  for step in range(1, len(keep_fracs) + 1):
    if engaged and step > warmup:
      culled.append(step)
    if step % refresh_every == 0:
      engaged = keep_fracs[step - 1] <= capacity
  return culled


def test_one_rung_gate_culls_on_the_scripts_steps():
  capacity, warmup, refresh_every = 0.33, 5, 4
  _, config = tp.configs(tp.SMALL_BINDINGS + (
      'Config.occupancy_culling = True',
      'Config.occupancy_grid_resolution = 4',
      f'Config.occupancy_capacity_frac = {capacity}',
      f'Config.occupancy_warmup_steps = {warmup}',
      f'Config.occupancy_grid_refresh_every = {refresh_every}'))
  model = nerf.construct_model(config, torch.Generator().manual_seed(0),
                               'cpu')
  # Over, at, under and over the rung, each at a refresh: engaged at step
  # 4 (held back by the warmup until 6), released at 12 and 20.
  keep_fracs = np.full(32, 0.9)
  for step, kf in ((4, 0.33), (8, 0.2), (12, 0.34), (16, 0.1), (20, 0.5),
                   (24, 0.0), (28, 0.33001), (32, 0.3)):
    keep_fracs[step - 1] = kf
  gate = train_lib.CullingGate(model, config)
  assert gate.ladder == (capacity,)
  culled = []
  for step in range(1, 33):
    if gate.cull(step) is not None:
      culled.append(step)
    gate.after_step(step, {'occ_keep_frac': torch.tensor(keep_fracs[step - 1])})
  want = _script_rule(keep_fracs, capacity, warmup, refresh_every)
  assert culled == want
  assert want == [6, 7, 8, 9, 10, 11, 12, 17, 18, 19, 20, 25, 26, 27, 28]
  assert set(gate.rungs.values()) == {capacity}


@pytest.mark.parametrize('rule', ['density:5e-3', 'alpha:3e-2'])
def test_probe_keep_fraction_matches_jax(rule):
  kind, value = rule.split(':')
  setting = ('occupancy_threshold' if kind == 'density'
             else 'occupancy_alpha_eps')
  jax_config, torch_config = tp.configs(tp.SMALL_BINDINGS + tp.FUSED_BINDINGS
                                        + (
      'Config.occupancy_culling = True',
      'Config.occupancy_grid_resolution = 8',
      f"Config.occupancy_keep_rule = '{kind}'",
      f'Config.{setting} = {value}', 'Config.randomized = False'))
  grid = np.random.RandomState(3).uniform(0, 2e-2, 8**3).astype(np.float32)
  variables = {'params': tp.jax_params(jax_config, seed=2),
               'occupancy': {'grid': grid}}
  jmodel = jax_gin.make('Model', config=jax_config)
  fields = tp.rays(128, seed=6)
  _, history = jax.jit(lambda v, r: jmodel.apply(
      v, None, r, train_frac=1.0, compute_extras=False))(
          variables, tp.jax_rays(fields))
  want = float(history[-1]['occ_keep_frac'])
  model = nerf.construct_model(torch_config,
                               torch.Generator().manual_seed(0), 'cpu')
  bridge.load_jax_variables(model, variables)
  got = keep_frac_probe.keep_fraction(
      model, torch_config, types.Batch(rays=tp.torch_rays(fields)), None)
  assert 0.05 < want < 0.95, want
  assert got == want


def _jax_decision(monkeypatch, tmp_path, arms):
  """scripts/int8_eval_decision.py's main over `arms` in place of its
  training runs: its decision."""
  monkeypatch.setenv('MULTINERF_NO_COMPILE_CACHE', '1')
  spec = importlib.util.spec_from_file_location(
      'int8_eval_decision_script', os.path.join(SCRIPTS,
                                                'int8_eval_decision.py'))
  script = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(script)
  made = iter(arms)
  monkeypatch.setattr(script, 'run_arm', lambda name, *_: dict(
      next(made), arm=name))
  monkeypatch.setattr(sys, 'argv', ['int8_eval_decision.py',
                                    f'--out={tmp_path}'])
  script.main()
  with open(tmp_path / 'INT8_EVAL_DECISION.json') as f:
    return json.load(f)['decision']


# (360 deltas, Ref-NeRF delta, Ref-NeRF speedup) at the rule's edges.
DECISION_CASES = [
    ((0.0, -0.049, 0.1), -0.049, 1.0),
    ((0.0, -0.05, 0.1), 0.0, 1.5),
    ((0.0, 0.0, 0.0), -0.05, 1.5),
    ((0.2, 0.1, 0.0), 0.1, 0.999),
    ((-0.011, -0.009, -0.001), 0.0, 0.992),
]


@pytest.mark.parametrize('deltas,ref_delta,speedup', DECISION_CASES)
def test_decision_is_the_scripts(monkeypatch, tmp_path, deltas, ref_delta,
                                 speedup):
  arms = [{'psnr_delta_int8': d, 'render_speedup_int8': 1.0}
          for d in deltas] + [{'psnr_delta_int8': ref_delta,
                               'render_speedup_int8': speedup}]
  want = _jax_decision(monkeypatch, tmp_path, arms)
  assert int8_eval_decision.decide(list(deltas), ref_delta, speedup) == want


def test_cull_quality_end_to_end(monkeypatch, tmp_path):
  # A density threshold no weights reach keeps only the forced last sample:
  # the gate engages at the first refresh (step 2) and culls from step 3.
  monkeypatch.setattr(harness, 'DEBUG_WIDTHS', SMALL[len(
      harness.BASE_BINDINGS):])
  monkeypatch.setattr(harness, 'TRAIN_SETTINGS', dict(
      harness.TRAIN_SETTINGS, occupancy_grid_refresh_every=2,
      occupancy_threshold=1000.0, occupancy_grid_resolution=8))
  results = cull_quality.main(
      ['--steps', '6', '--batch', '64', '--eval_every', '3',
       '--capacities', '0.5', '--trunk_dtype', 'bfloat16', '--tag', 't',
       f'--out={tmp_path}'], device='cpu')
  with open(tmp_path / 'cull_quality_t.json') as f:
    written = json.load(f)
  assert written == json.loads(json.dumps(results))
  assert set(written) == {'steps', 'batch', 'loader', 'flagship',
                          'trunk_dtype', 'keep_rule', 'alpha_eps', 'runs',
                          'device'}
  assert written['device'] == 'cpu'
  assert list(written['runs']) == ['full', 'cull_0.5']
  full, culled = written['runs']['full'], written['runs']['cull_0.5']
  entry_keys = {'step', 'test_psnr', 'train_psnr', 'keep_frac', 'cull_steps'}
  assert [set(e) for e in full] == [entry_keys, entry_keys | {'train_time_s'}]
  assert [set(e) for e in culled] == [
      entry_keys | {'test_psnr_cull_render'},
      entry_keys | {'test_psnr_cull_render', 'train_time_s',
                    'keep_frac_trace'}]
  assert [e['cull_steps'] for e in culled] == [1, 4]
  assert [e['keep_frac'] for e in full] == [None, None]
  # Unculled, no sample is kept; culled, the last of each ray's 4.
  assert culled[-1]['keep_frac_trace'] == [[2, 0.0], [4, 0.25], [6, 0.25]]
  for e in full + culled:
    assert all(np.isfinite(e[k]) for k in e if 'psnr' in k), e


def test_keep_frac_probe_end_to_end(monkeypatch, tmp_path, capsys):
  small = SMALL + harness.trunk_bindings('bfloat16')
  ckpt = str(tmp_path / 'ckpt')
  train.main([f'--gin_configs={tp.CONFIG_360}', '--device=cpu'] + [
      f'--gin_bindings={b}' for b in small + [
          "Config.dataset_loader = 'dummy_unbounded'",
          f"Config.checkpoint_dir = '{ckpt}'", 'Config.max_steps = 2',
          'Config.batch_size = 32']])
  make_config = harness.make_config
  monkeypatch.setattr(harness, 'make_config', lambda b, gin_files=(), **kw:
                      make_config(list(b) + SMALL, gin_files,
                                  occupancy_grid_resolution=8, **kw))
  saved = os.path.getmtime(os.path.join(ckpt, 'checkpoint_2.pt'))
  results = keep_frac_probe.main(
      ['--checkpoint_dir', ckpt, '--batch', '32',
       '--rules', 'density:5e-3,alpha:1e-2'], device='cpu')
  lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()
           if l.startswith('{')]
  assert lines[-3:-1] == [
      {'density:5e-3': results['density:5e-3']},
      {'alpha:1e-2': results['alpha:1e-2']}]
  assert lines[-1] == {'checkpoint': ckpt, 'loader': 'dummy_unbounded',
                       'keep_fracs': results, 'device': 'cpu'}
  assert all(0 <= v <= 1 for v in results.values())
  assert os.path.getmtime(os.path.join(ckpt, 'checkpoint_2.pt')) == saved
  with pytest.raises(FileNotFoundError):
    keep_frac_probe.main(['--checkpoint_dir', str(tmp_path / 'none')],
                         device='cpu')


def test_int8_eval_decision_end_to_end(monkeypatch, tmp_path):
  monkeypatch.setattr(harness, 'FLAGSHIP', SMALL)
  monkeypatch.setattr(harness, 'REFNERF', [
      b for b in harness.REFNERF if 'net_' not in b and 'samples' not in b]
                      + SMALL[-2:] + ['NerfMLP.net_depth = 4',
                                      'NerfMLP.net_width = 64'])
  monkeypatch.setattr(int8_eval_decision, 'BATCH', 32)
  monkeypatch.setattr(int8_eval_decision, 'FRAMES', 1)
  decision = int8_eval_decision.main(
      ['--steps', '2', '--refnerf_steps', '2', f'--out={tmp_path}'],
      device='cpu')
  with open(tmp_path / 'INT8_EVAL_DECISION.json') as f:
    written = json.load(f)
  assert written == json.loads(json.dumps(decision))
  assert set(written) == {'measurements', 'min_psnr_delta_360',
                          'refnerf_psnr_delta', 'refnerf_render_speedup',
                          'decision', 'device'}
  assert [m['arm'] for m in written['measurements']] == [
      '360_dummy_sphere', '360_dummy_scatter', '360_dummy_unbounded',
      'refnerf_dummy_sphere']
  for m in written['measurements']:
    assert set(m) == {'arm', 'loader', 'train_steps', 'train_s',
                      'psnr_bfloat16', 'sec_per_frame_bfloat16', 'psnr_int8',
                      'sec_per_frame_int8', 'psnr_delta_int8',
                      'render_speedup_int8'}
    assert np.isfinite(m['psnr_int8']) and np.isfinite(m['psnr_bfloat16'])
  assert written['decision'] == int8_eval_decision.decide(
      [m['psnr_delta_int8'] for m in written['measurements'][:3]],
      written['refnerf_psnr_delta'], written['refnerf_render_speedup'])
