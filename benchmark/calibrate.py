"""Readings that the limits of ``correct`` are set from, for one cell.

    python3 benchmark/calibrate.py --workload mipnerf360_bf16.train \
        --seeds 1,2,3 [--control] [--faults] [--frames 2] [--out FILE]

For each seed, one JSON line: the gaps of the program's sound run against
the reference (the lower reading), with ``--control`` those of the
configuration's control (a path of the program in the next lower
precision, or the reference computed in it), and with ``--faults`` those
of the faults a run of the cell can have, planted in the reference put in
the program's place (train: half of each batch left out, a state left
unchanged) or in the program's output (render: one chunk's colors moved).
Train cells read the recorded first steps at the cell's own batch, render
cells ``--frames`` whole frames at the cell's own size.  The benchmark's
own runs do not run this.
"""

import argparse
import json
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ['TRITON_CACHE_DIR'] = os.path.join(_ROOT, 'build', 'triton_cache')
# Compiled Python too, written even where the environment asks for none:
# the card's machine keeps none for its packages, and compiling torch's
# modules anew takes seconds of every run's set-up.
sys.pycache_prefix = os.path.join(_ROOT, 'build', 'pycache')
sys.dont_write_bytecode = False
if _ROOT not in sys.path:
  sys.path.insert(0, _ROOT)

# pylint: disable=g-import-not-at-top,wrong-import-position
import numpy as np
import torch

from benchmark.generators import render as render_gen
from benchmark.generators import train as train_gen
from benchmark.lib import harness
from benchmark.lib import program
from benchmark.reference import train as ref_train


def _free(device):
  import gc
  gc.collect()
  if device.type == 'cuda':
    torch.cuda.empty_cache()


def _with_tf32(fn):
  matmul = torch.backends.cuda.matmul
  saved = (matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
  matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
  try:
    return fn()
  finally:
    matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def train_readings(cell, seeds, device, control, faults):
  steps = cell.traffic['record_steps']
  loop = train_gen.Loop(cell, seeds, device)
  got = loop.record(steps)
  config = loop.config
  loop.close()
  del loop
  _free(device)
  want = train_gen.reference_readings(cell, seeds, device, steps, config)
  out = {'sound': ref_train.gaps(got, want)}
  spec = cell.config['control']
  if control and 'gin_bindings' in spec:
    loop = train_gen.Loop(cell, seeds, device, spec['gin_bindings'])
    got = loop.record(steps)
    loop.close()
    del loop
    _free(device)
    out['control'] = ref_train.gaps(got, want)
  elif control and spec.get('tf32'):
    got = _with_tf32(lambda: train_gen.reference_readings(
        cell, seeds, device, steps, config))
    out['control'] = ref_train.gaps(got, want)
  if faults:
    for fault in ('half_batch', 'unchanged'):
      got = train_gen.reference_readings(cell, seeds, device, steps,
                                            config, fault)
      out[fault] = ref_train.gaps(got, want)
  return out


def render_readings(cell, seeds, device, control, faults, n_frames):
  def frames_of(extra=()):
    frames = render_gen.Frames(cell, seeds, device, extra)
    frames.warm_up()
    kept = [frames.frame(i) for i in range(n_frames)]
    config = frames.config
    frames.close()
    del frames
    _free(device)
    return [(cam, rgb) for cam, _, rgb in kept], config

  kept, config = frames_of()
  out = {'sound': render_gen.reference_gaps(cell, seeds, device, kept,
                                               config)}
  if control:
    controlled, _ = frames_of(cell.config['control']['gin_bindings'])
    out['control'] = render_gen.reference_gaps(cell, seeds, device,
                                                  controlled, config)
  if faults:
    chunk = cell.traffic['frame']['chunk']
    altered = []
    for cam, rgb in kept:
      rgb = np.array(rgb)
      flat = rgb.reshape(-1, rgb.shape[-1])
      flat[chunk:2 * chunk] = np.clip(flat[chunk:2 * chunk] + 0.05, 0, 1)
      altered.append((cam, flat.reshape(rgb.shape)))
    out['altered_chunk'] = render_gen.reference_gaps(cell, seeds, device,
                                                        altered, config)
  return out


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--workload', required=True)
  parser.add_argument('--seeds', required=True)
  parser.add_argument('--control', action='store_true')
  parser.add_argument('--faults', action='store_true')
  parser.add_argument('--frames', type=int, default=2)
  parser.add_argument('--out', default=None)
  args = parser.parse_args(argv)
  cell = harness.Cell(args.workload)
  device = program.setup_device('cuda' if torch.cuda.is_available()
                                else 'cpu')
  lines = []
  for seed in [int(s) for s in args.seeds.split(',')]:
    seeds = harness.seeds(seed)
    if cell.traffic['generator'] == 'train':
      out = train_readings(cell, seeds, device, args.control, args.faults)
    else:
      out = render_readings(cell, seeds, device, args.control, args.faults,
                            args.frames)
    line = json.dumps({'workload': cell.name, 'seed': seed, **out})
    print(line, flush=True)
    lines.append(line)
    if args.out:
      with open(args.out, 'a') as f:
        f.write(line + '\n')
  return 0


if __name__ == '__main__':
  sys.exit(main())
