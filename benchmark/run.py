"""Run one cell of the port's benchmark and print its result line.

    python3 benchmark/run.py --workload mipnerf360_bf16.train --seed 7 \
        --seconds 40 --trace 0

From the root of a checkout, on a machine with as many CUDA cards as the
cell asks for.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``, each number that decided
``correct`` beside its limit (also the last lines of standard error).
"""

import time

T_START = time.perf_counter()

# pylint: disable=g-import-not-at-top,wrong-import-position
import argparse
import json
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Every build and kernel cache in fixed directories inside the checkout.
os.environ['TRITON_CACHE_DIR'] = os.path.join(_ROOT, 'build', 'triton_cache')
# Compiled Python too, written even where the environment asks for none:
# the card's machine keeps none for its packages, and compiling torch's
# modules anew takes seconds of every run's set-up.
sys.pycache_prefix = os.path.join(_ROOT, 'build', 'pycache')
sys.dont_write_bytecode = False
os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(_ROOT, 'build',
                                                  'torch_extensions')
os.environ['USE_FLAX'] = '0'
os.environ['USE_TF'] = '0'
os.environ['USE_JAX'] = '0'
if _ROOT not in sys.path:
  sys.path.insert(0, _ROOT)

from benchmark.lib import harness

harness.T_START = T_START
harness.log('interpreter up')
import torch

harness.log('torch imported')


def parse(argv):
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--workload', required=True)
  parser.add_argument('--seed', type=int, required=True)
  parser.add_argument('--seconds', type=float, required=True)
  parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
  return parser.parse_args(argv)


def execute(cell, seed, seconds, traced, device, t_start):
  """Run `cell` on `device`: the result dict (the result line's keys)."""
  import importlib
  gen = importlib.import_module(
      f'benchmark.generators.{cell.traffic["generator"]}')
  out = gen.run(cell, harness.seeds(seed), device, seconds, traced,
                   t_start)
  numbers = dict(out['numbers'])
  limits = dict(cell.workload['limits'])
  if device.type == 'cuda':
    # The hand-written kernels ran on the card, as many as the cell's
    # traffic launches, and nothing fell back to their plain versions.
    want = cell.workload['launches_per_unit']
    numbers['launch_mismatch'] = float(sum(
        abs(out['counts'][k][0] - want.get(k, 0) * out['units']) +
        out['counts'][k][1] for k in out['counts']))
    limits['launch_mismatch'] = 0.0
  correct, checks = harness.judge(numbers, limits)
  if traced:
    metrics = harness.read_per_layer(cell.per_layer, out['summary'])
  else:
    metrics = {m['name']: {'value': out['metrics'][m['name']],
                           'unit': m['unit']}
               for m in cell.end_to_end if m['name'] != 'setup_s'}
    metrics['setup_s'] = {'value': out['setup_s'], 'unit': 's'}
  result = {'correct': bool(correct), 'attempted': out['attempted'],
            'failed': out['failed'], 'metrics': metrics,
            'device': harness.device_info(torch, cell.chips,
                                          out['memory_peak'],
                                          out['summary'])}
  if traced:
    result['breakdown'] = {'device_ops': out['summary']['device_ops'],
                           'idle_gaps': out['summary']['idle_gaps']}
  result['launches'] = out['counts']
  result['checks'] = checks
  return result


def main(argv=None):
  args = parse(argv)
  cell = harness.Cell(args.workload)
  if not torch.cuda.is_available():
    print('no CUDA device: the benchmark measures the card only.',
          file=sys.stderr)
    return 2
  if torch.cuda.device_count() < cell.chips:
    print(f'{args.workload} needs {cell.chips} cards; this machine has '
          f'{torch.cuda.device_count()}.', file=sys.stderr)
    return 2
  from benchmark.lib import program
  device = program.setup_device('cuda')
  result = execute(cell, args.seed, args.seconds, bool(args.trace), device,
                   T_START)
  found = harness.forbidden_modules()
  if found:
    print(f'the run loaded forbidden modules: {found}', file=sys.stderr)
    return 3
  harness.print_checks(result['checks'])
  print(json.dumps(result), flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
