"""A run of each cell at debug widths on the CPU, the refusal to measure
without a card, and the modules a run loads."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from benchmark import run
from benchmark.lib import harness
from benchmark.tests import small

CELLS = [w['name'] for w in harness.load_json(
    os.path.join(harness.ROOT, 'BENCHMARK.json'))['workloads']]
KEYS = ['correct', 'attempted', 'failed', 'metrics', 'device']


@pytest.mark.parametrize('traced', [False, True])
@pytest.mark.parametrize('cell', CELLS)
def test_cpu_run_prints_the_result_line(cell, traced):
  result = run.execute(small.small_cell(cell), 2**40 + 17, 0.3, traced,
                       torch.device('cpu'), time.perf_counter())
  line = json.loads(json.dumps(result))
  assert list(line)[:5] == KEYS and list(line)[-1] == 'checks'
  # Whether it is correct at these widths is the fault tests' matter: the
  # limits are set for the cell's own widths.
  assert isinstance(line['correct'], bool)
  assert line['attempted'] >= 1 and line['failed'] == 0
  assert line['device']['platform'] == 'cpu'
  assert line['device']['kind'] == 'cpu'
  for check in line['checks'].values():
    assert set(check) == {'value', 'limit'}
  if traced:
    # No device metric from a CPU run: the readers find no device time.
    assert line['metrics'] == {}
    assert line['device']['busy_s'] == 0.0
    assert set(line['breakdown']) == {'device_ops', 'idle_gaps'}
  else:
    assert 'setup_s' in line['metrics']
    assert len(line['metrics']) >= 2


def test_no_card_no_result(tmp_path):
  env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
  proc = subprocess.run(
      [sys.executable, 'benchmark/run.py', '--workload', CELLS[0], '--seed',
       '3', '--seconds', '1', '--trace', '0'], cwd=harness.ROOT, env=env,
      capture_output=True, text=True, timeout=300, check=False)
  assert proc.returncode != 0
  assert proc.stdout.strip() == ''


def test_alone_the_benchmark_fails(tmp_path):
  """In a directory that holds only BENCHMARK.json and benchmark/, a run
  exits non-zero and prints no result."""
  subprocess.run(['cp', '-r', os.path.join(harness.ROOT, 'benchmark'),
                  os.path.join(harness.ROOT, 'BENCHMARK.json'),
                  str(tmp_path)], check=True)
  proc = subprocess.run(
      [sys.executable, 'benchmark/run.py', '--workload', CELLS[0], '--seed',
       '3', '--seconds', '1', '--trace', '0'], cwd=tmp_path,
      capture_output=True, text=True, timeout=300, check=False)
  assert proc.returncode != 0
  assert proc.stdout.strip() == ''


_PROBE = """
import sys, time, torch
sys.path.insert(0, {root!r})
from benchmark import run
from benchmark.lib import harness
from benchmark.tests import small
for name in {cells!r}:
  run.execute(small.small_cell(name), 5, 0.2, True, torch.device('cpu'),
              time.perf_counter())
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""


def test_a_run_loads_no_jax():
  proc = subprocess.run(
      [sys.executable, '-c', _PROBE.format(root=harness.ROOT, cells=CELLS)],
      cwd=harness.ROOT, capture_output=True, text=True, timeout=600,
      check=True)
  loaded = set(json.loads(proc.stdout.strip().splitlines()[-1].replace(
      "'", '"')))
  assert 'multinerf_tpu_torch' in loaded
  assert not loaded & set(harness.FORBIDDEN)


def test_forbidden_names_compare_whole(monkeypatch):
  monkeypatch.setitem(sys.modules, 'multinerf_tpu_torch_probe', sys)
  assert 'multinerf_tpu' not in harness.forbidden_modules()
  monkeypatch.setitem(sys.modules, 'jax.numpy', sys)
  assert harness.forbidden_modules() == ['jax']
