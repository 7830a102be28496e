"""The reference stands alone, and computes what the program computes."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from benchmark.generators import train as train_gen
from benchmark.lib import harness
from benchmark.reference import train as ref_train
from benchmark.tests import small

REF_DIR = os.path.join(harness.BENCH_DIR, 'reference')


def _imports(path):
  tree = ast.parse(open(path).read())
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      yield from (a.name for a in node.names)
    elif isinstance(node, ast.ImportFrom):
      yield node.module


@pytest.mark.parametrize('name', sorted(
    f for f in os.listdir(REF_DIR) if f.endswith('.py')))
def test_reference_sources_import_nothing_of_the_program(name):
  for module in _imports(os.path.join(REF_DIR, name)):
    top = module.split('.')[0]
    assert top not in ('multinerf_tpu_torch', *harness.FORBIDDEN), module
    if top == 'benchmark':
      assert module.startswith('benchmark.reference'), module


def test_reference_loads_nothing_of_the_program():
  probe = (
      'import sys, torch\n'
      f'sys.path.insert(0, {harness.ROOT!r})\n'
      'from benchmark.reference import model, ops, scene, train\n'
      'cfg = __import__("json").load(open("benchmark/configs/refnerf.json"))\n'
      'w = model.make_weights(cfg["model"], torch.Generator().manual_seed(1),'
      ' "cpu")\n'
      'print(sorted({m.split(".")[0] for m in sys.modules}))\n')
  out = subprocess.run([sys.executable, '-c', probe], cwd=harness.ROOT,
                       capture_output=True, text=True, timeout=300,
                       check=True).stdout
  assert 'multinerf_tpu' not in out and "'jax'" not in out


@pytest.mark.parametrize('cell', ['mipnerf360_bf16.train', 'refnerf.train'])
def test_reference_steps_are_the_programs_in_f32(cell):
  """With the trunk in f32 and no featurize -> Dense kernel (the program's
  unfused path), the program's first steps and the reference's agree to
  the last bit but for summation order."""
  c = small.small_cell(cell, batch=32)
  for key in ('nerf_mlp', 'prop_mlp'):
    if key in c.config['model']:
      c.config['model'][key]['trunk_dtype'] = 'float32'
      c.config['model'][key].pop('fused_numerics', None)
  c.config['gin_bindings'] = list(c.config['gin_bindings']) + [
      "NerfMLP.trunk_dtype = 'float32'", "PropMLP.trunk_dtype = 'float32'",
      'NerfMLP.use_fused_featurize = False',
      'PropMLP.use_fused_featurize = False']
  seeds = harness.seeds(99)
  device = torch.device('cpu')
  loop = train_gen.Loop(c, seeds, device)
  got = loop.record(3)
  config = loop.config
  loop.close()
  want = train_gen.reference_readings(c, seeds, device, 3, config)
  gaps = ref_train.gaps(got, want)
  assert gaps['loss_gap'] < 1e-6
  assert gaps['grad_gap'] < 1e-6
  assert gaps['update_gap'] < 1e-6
