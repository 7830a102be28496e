"""BENCHMARK.json and every file a cell names load, and keep the format."""

import json
import os
import re

import pytest

from benchmark.lib import harness
from benchmark.reference import model as ref_model

SPEC = harness.load_json(os.path.join(harness.ROOT, 'BENCHMARK.json'))
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


def test_top_level_keys():
  assert set(SPEC) == {'command', 'paths', 'run_seconds', 'configs',
                       'workloads', 'end_to_end', 'per_layer'}
  assert SPEC['command'] == ['python3', 'benchmark/run.py']
  assert SPEC['paths'] == ['benchmark']
  assert 1 <= SPEC['run_seconds'] <= 51
  assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_keys():
  names = set()
  for group, keys in (('configs', {'name', 'source', 'file', 'reduced',
                                   'why'}),
                      ('workloads', {'name', 'config', 'traffic', 'chips',
                                     'why'}),
                      ('end_to_end', {'name', 'unit', 'better', 'bound',
                                      'source', 'workloads'}),
                      ('per_layer', {'name', 'unit', 'better', 'source',
                                     'layer', 'moves', 'workloads'})):
    for entry in SPEC[group]:
      assert set(entry) <= keys, entry
      assert NAME.match(entry['name']), entry['name']
      assert (group, entry['name']) not in names
      names.add((group, entry['name']))
      if 'unit' in entry:
        assert UNIT.match(entry['unit']), entry['unit']
        assert entry['better'] in ('lower', 'higher')
      if 'why' in entry:
        assert 1 <= len(entry['why']) <= 200 and '\n' not in entry['why']
  for m in SPEC['end_to_end']:
    assert m['source'] in ('host_clock', 'device_trace')
    assert 0 < m['bound'] <= 0.25
    if m['name'] != 'setup_s':
      assert m['bound'] >= 0.01


@pytest.mark.parametrize('cell', [w['name'] for w in SPEC['workloads']])
def test_cell_files_load(cell):
  c = harness.Cell(cell)
  assert c.traffic['generator'] in ('train', 'render')
  assert c.chips == c.entry['chips']
  for key in ('gin_configs', 'gin_bindings', 'source', 'reduced', 'scene',
              'model', 'train', 'control'):
    assert key in c.config, key
  for path in c.config['gin_configs']:
    assert os.path.exists(os.path.join(harness.ROOT, path))
  assert ref_model.param_shapes(c.config['model'])
  moved = {m['name'] for m in c.end_to_end}
  assert 'setup_s' in moved and len(moved) >= 2
  assert c.per_layer
  for m in c.per_layer:
    assert m['moves'] in moved, (m['name'], m['moves'])
    assert hasattr(harness.reader(m['name']), 'read')
  assert c.workload['limits']


def test_configs_used_and_reduced_listed():
  used = {w['config'] for w in SPEC['workloads']}
  files = set()
  for c in SPEC['configs']:
    assert c['name'] in used
    assert c['file'].startswith('benchmark/configs/')
    assert c['file'] not in files
    files.add(c['file'])
    config = harness.load_json(os.path.join(harness.ROOT, c['file']))
    assert config['reduced'] == c['reduced']
    for key in c['reduced']:
      assert not key.endswith(('_dim', '_rank', 'width'))


def test_layers_are_named_alike():
  layers = {}
  for m in SPEC['per_layer']:
    layers.setdefault(m['layer'], []).append(m['name'])
    assert '\n' not in m['layer'] and len(m['layer']) <= 200
  assert {'data plane', 'train step', 'renderer', 'kernels',
          'device'} <= set(layers)
