"""The benchmark's frame: cells from BENCHMARK.json and their files, seeds,
the per-layer readers, the import check and the result line.

Everything that belongs to one cell, configuration or metric is data or a
file of its own, found by name:

* ``benchmark/traffic/<traffic>.json``: the traffic mix (its generator, batch
  or frame size, warm-up, traced units, the program's gin bindings for it);
* ``benchmark/workloads/<cell>.json``: the cell's chips and the limits of
  the numbers that decide ``correct``, with the readings they were set
  from;
* ``benchmark/configs/<config>.json``: gin files and bindings of the
  program, the reference's description of the model, the train settings;
* ``benchmark/metrics/<metric>.py``: ``read(summary) -> float or None``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH_DIR = os.path.join(ROOT, 'benchmark')
# Whole top-level module names that no run may load.
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'multinerf_tpu')


T_START = time.perf_counter()  # The process's start, set by run.py.


def log(what):
  """A line on standard error: `what`, at seconds since the start."""
  print(f'[{time.perf_counter() - T_START:9.3f} s] {what}', file=sys.stderr,
        flush=True)


def load_json(path):
  with open(path) as f:
    return json.load(f)


class Cell:
  """One entry of BENCHMARK.json's workloads, with its files."""

  def __init__(self, name, spec_path=None):
    spec = load_json(spec_path or os.path.join(ROOT, 'BENCHMARK.json'))
    entries = {w['name']: w for w in spec['workloads']}
    if name not in entries:
      raise SystemExit(f'unknown workload {name!r}; BENCHMARK.json has '
                       f'{sorted(entries)}')
    self.name = name
    self.entry = entries[name]
    self.chips = self.entry['chips']
    configs = {c['name']: c for c in spec['configs']}
    self.config = load_json(os.path.join(ROOT, configs[self.entry['config']]
                                         ['file']))
    self.traffic = load_json(os.path.join(BENCH_DIR, 'traffic',
                                          f'{self.entry["traffic"]}.json'))
    self.workload = load_json(os.path.join(BENCH_DIR, 'workloads',
                                           f'{name}.json'))
    self.end_to_end = [m for m in spec['end_to_end']
                       if name in m.get('workloads', [name])]
    self.per_layer = [m for m in spec['per_layer']
                      if name in m.get('workloads', [name])]


def seeds(seed):
  """Independent 32-bit seeds of a run from one whole number of any size:
  {'data', 'jitter', 'weights', 'sample'}."""
  words = np.random.SeedSequence(int(seed)).generate_state(4, np.uint32)
  return dict(zip(('data', 'jitter', 'weights', 'sample'),
                  (int(w) for w in words)))


def read_per_layer(metrics, summary):
  """{name: {'value', 'unit'}} of every per-layer metric whose reader
  finds something to read."""
  out = {}
  for m in metrics:
    value = reader(m['name']).read(summary)
    if value is not None:
      if not math.isfinite(value):
        raise ValueError(f'{m["name"]} read {value}')
      out[m['name']] = {'value': float(value), 'unit': m['unit']}
  return out


def reader(name):
  """The module of ``benchmark/metrics/<name>.py`` (names hold dots, so
  it is loaded by its path)."""
  path = os.path.join(BENCH_DIR, 'metrics', f'{name}.py')
  spec = importlib.util.spec_from_file_location(f'bench_metric_{name}', path)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


def forbidden_modules():
  """The loaded modules whose top-level name is forbidden, compared whole."""
  return sorted({name.split('.')[0] for name in list(sys.modules)
                 if name.split('.')[0] in FORBIDDEN})


def judge(numbers, limits):
  """(correct, checks): each number beside its limit, in order.  A number
  that is missing or not finite fails."""
  checks = {}
  correct = True
  for name, limit in limits.items():
    value = numbers.get(name)
    ok = value is not None and math.isfinite(value) and value <= limit
    correct &= ok
    checks[name] = {'value': value, 'limit': limit}
  return correct, checks


def print_checks(checks):
  for name, c in checks.items():
    print(f'check {name} = {c["value"]!r} (limit {c["limit"]!r})',
          file=sys.stderr, flush=True)


def device_info(torch, chips, memory_peak, trace_summary=None):
  if torch.cuda.is_available():
    info = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
            'count': chips, 'memory_peak_bytes': int(memory_peak)}
  else:
    info = {'platform': 'cpu', 'kind': 'cpu', 'count': chips,
            'memory_peak_bytes': int(memory_peak)}
  if trace_summary is not None:
    info['busy_s'] = trace_summary['busy_s']
    info['window_s'] = trace_summary['window_s']
  return info
