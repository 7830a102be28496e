"""Where a training step's (or a rendered frame's) device time goes, from
torch.profiler.

    python -m multinerf_tpu_torch.profile_step --gin_configs=configs/360.gin \
        --gin_bindings="Config.dataset_loader='dummy_unbounded'" \
        --gin_bindings='Config.batch_size=4096' [--warmup=13] [--steps=3] \
        [--cull[=0.5]] [--window=8]

Sets the model up as ``python -m multinerf_tpu_torch.train`` does (same
seeds, TF32 off, host batches prefetched or, with
``Config.device_data_plane``, drawn on the device), runs `warmup` steps,
then `steps` more under the profiler, each synchronised.  ``--cull`` forces
the culled step at rung 0.33 (``--cull=0.5`` or ``--cull=0.67`` another
rung of bench.py:495-502's ladder) on bench.py:143-149's half-occupied grid
(``culling.half_grid``), as JAX's scripts/profile_step.py --cull does: no
warmup, refresh or gate decides it.  ``--window=K`` (under
``Config.device_data_plane``) profiles windows of K steps
(``device_sampler.create_scan_train_step``), forced at the rung through a
``train_lib.CullingGate`` whose rung is set and which never refreshes;
`warmup` and `steps` then count windows, and every number is per step.
With ``--frame`` it sets the model up as
``python -m multinerf_tpu_torch.render`` does with no checkpoint (the same
seed) and renders test frame 0 instead of taking a step, `warmup` times and
then `steps` times under the profiler (``Config.render_path`` and
``Config.render_resolution`` choose the frame); a frame ends in its copy to
the host.  Device busy time is the union of the CUDA
kernel, copy and memset intervals of the profiled steps (the CPU ops'
``key_averages()`` rows also carry their children's device time, so they
are not summed); the idle share is 1 - busy / wall, wall being the host
clock around the profiled steps.  ``step_ms`` is the median of the
synchronised warm-up steps after the fifth, unprofiled.  The port's spans
(``utils/trace.py``) split both: ``span_ms`` is each span's device time
(``trace.device_us_by_span``: the work launched inside it and the backward
of the ops it made), ``idle_ms`` the device's idle gaps, each by the
host's innermost span where it begins (``trace.idle_by_span``).  A culled step's
``compaction_ms`` is the device time of ``culling.COMPACTION``'s span
(the compaction and its gathers, forward and backward).  Prints the spans
and kernels by device time per step and, as the last line, one JSON
object with the same numbers.

Under ``python -m torch.distributed.run --nproc_per_node=N`` every rank
takes its steps (``Config.batch_size`` is the global batch; the seeds are
train.py's, shifted by the rank), and rank 0 profiles and prints, with
``allreduce_ms``, the device time per step of the NCCL kernels.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from multinerf_tpu_torch import configs
from multinerf_tpu_torch import render
from multinerf_tpu_torch import train
from multinerf_tpu_torch import train_lib
from multinerf_tpu_torch.data import datasets
from multinerf_tpu_torch.data import device_sampler
from multinerf_tpu_torch.models import culling
from multinerf_tpu_torch.models import nerf
from multinerf_tpu_torch.parallel import mesh
from multinerf_tpu_torch.utils import trace


def forced_gate(model, config, capacity):
  """A ``train_lib.CullingGate`` that runs every step at `capacity` and
  never refreshes the grid (bench.build(cull=True)'s forced step): its
  rung set, no warmup, a refresh cadence past any run."""
  gate = train_lib.CullingGate(model, dataclasses.replace(
      config, occupancy_warmup_steps=0,
      occupancy_grid_refresh_every=sys.maxsize))
  gate.rung = capacity
  return gate


def setup(config, device, capacity=None, window=1, rank=0):
  """The profiled unit: (dataset, state, run, info).

  ``run(i, state) -> (state, stats)`` takes step i on the host path or the
  device plane (`window` 1), or the window of steps (i - 1) * window + 1 to
  i * window (its stats stacked [window, ...]); with `capacity` every step
  is the culled step at that rung, on ``culling.half_grid``.  info:
  'capacity', 'compact_n' (K2/K4's N in a culled step,
  ``culling.round_capacity`` of a rank's final-level samples; None
  unculled) and 'window'.  The caller closes the dataset.
  """
  if window > 1 and not config.device_data_plane:
    raise ValueError('--window needs Config.device_data_plane.')
  if capacity is not None:
    config = dataclasses.replace(config, occupancy_culling=True,
                                 occupancy_capacity_frac=capacity)
  dataset = datasets.load_dataset('train', config.data_dir, config,
                                  seed=train.DATA_SEED + rank)
  model, state, _, train_step, _ = train_lib.setup_model(
      config, train.SEED, device, dataset)
  compact_n = None
  if capacity is not None:
    grid = model.occupancy.grid
    with torch.no_grad():
      grid.copy_(culling.half_grid(config.occupancy_grid_resolution,
                                   grid.device))
    train_step = train_lib.create_train_step(model, config, device,
                                             cull=capacity, dataset=dataset)
    compact_n = culling.round_capacity(
        config.batch_size // mesh.data_size() * model.cfg.num_nerf_samples,
        capacity)
  generator = torch.Generator(device=device).manual_seed(train.SEED + rank)
  train_frac = lambda step: float(np.clip(
      (step - 1) / (config.max_steps - 1), 0, 1))
  if window > 1:
    plane = device_sampler.DeviceDataPlane(dataset, config, device)
    gate = (None if capacity is None else
            forced_gate(model, config, capacity))
    scan = device_sampler.create_scan_train_step({capacity: train_step},
                                                 plane, config, window, gate)

    def run(i, state):
      state, stats, _ = scan(generator, state, (i - 1) * window + 1)
      return state, stats
  elif config.device_data_plane:
    plane = device_sampler.DeviceDataPlane(dataset, config, device)
    device_step = device_sampler.create_device_train_step(train_step, plane)

    def run(i, state):
      return device_step(generator, state, train_frac(i), False)
  else:
    prefetcher = train_lib.Prefetcher(dataset, device)

    def run(i, state):
      state, stats = train_step(generator, state, prefetcher.take(),
                                train_frac(i), False)
      prefetcher.stage()  # As the train driver does.
      return state, stats

  info = {'capacity': capacity, 'compact_n': compact_n, 'window': window}
  return dataset, state, run, info


def main(argv=None):
  """Returns {'wall_ms', 'busy_ms', 'idle', 'step_ms', 'allreduce_ms',
  'world_size', 'capacity', 'compact_n', 'keep_frac', 'window',
  'compaction_ms', 'span_ms': {span: ms}, 'idle_ms': {span: ms},
  'kernels': [[name, ms]]}, per profiled step (or frame)."""
  parser = argparse.ArgumentParser(
      description='Profile training steps or rendered frames.')
  configs.add_common_flags(parser)
  parser.add_argument('--warmup', type=int, default=13)
  parser.add_argument('--steps', type=int, default=3)
  parser.add_argument('--top', type=int, default=20)
  parser.add_argument('--frame', action='store_true',
                      help='profile rendering test frame 0, not steps.')
  parser.add_argument('--cull', type=float, nargs='?', const=0.33,
                      default=None,
                      help='force the culled step at this rung (0.33 '
                      'alone) on the half-occupied grid.')
  parser.add_argument('--window', type=int, default=1,
                      help='profile windows of this many steps on the '
                      'device plane.')
  args = parser.parse_args(argv)
  if args.frame and (args.cull is not None or args.window > 1):
    parser.error('--frame takes neither --cull nor --window.')
  if not torch.cuda.is_available():
    raise RuntimeError('profile_step needs CUDA.')
  device = configs.setup_device()
  rank = mesh.data_rank()

  config = configs.load_config(args)
  info = {'capacity': None, 'compact_n': None, 'window': 1}
  if args.frame:
    dataset = datasets.load_dataset('test', config.data_dir, config)
    _, state, render_fn, _, _ = train_lib.setup_model(config, render.SEED,
                                                      device)
    renderer = nerf.DeviceImageRenderer(render_fn, config, dataset, device)

    def step(i, state):
      del i
      renderer(1.0, 0)  # Ends in the rendering's copy to the host.
      return state, None
  else:
    dataset, state, run, info = setup(config, device, args.cull,
                                      args.window, rank)

    def step(i, state):
      state, stats = run(i, state)
      torch.cuda.synchronize(device)
      return state, stats

  total = args.warmup + args.steps
  activities = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
  warmup_s = []
  with dataset:
    for i in range(1, args.warmup + 1):
      t0 = time.perf_counter()
      state, stats = step(i, state)
      torch.cuda.synchronize(device)
      warmup_s.append((time.perf_counter() - t0) / info['window'])
    if rank == 0:
      with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for i in range(args.warmup + 1, total + 1):
          state, stats = step(i, state)
        wall_us = (time.perf_counter() - t0) * 1e6
    else:
      for i in range(args.warmup + 1, total + 1):
        state, stats = step(i, state)
  if rank != 0:
    mesh.shutdown()
    return None

  events = prof.events()
  device_events = trace.device_events(events)
  if not device_events:
    raise RuntimeError('The profiler recorded no device activity.')
  busy_us = trace.union_us([(e.time_range.start, e.time_range.end)
                            for e in device_events])
  by_name = collections.Counter()
  for e in device_events:
    by_name[e.name] += e.time_range.end - e.time_range.start
  kernel_us = sum(by_name.values())
  per_step = lambda us: us / 1e3 / (args.steps * info['window'])
  keep_frac = None
  if stats is not None and 'occ_keep_frac' in stats:
    keep_frac = float(stats['occ_keep_frac'].reshape(-1)[-1])
  span_us = trace.device_us_by_span(events)
  compaction_ms = None
  if info['capacity'] is not None:
    compaction_ms = per_step(span_us.get(culling.COMPACTION, 0.0))
  by_ms = lambda us: {k: per_step(v) for k, v in sorted(
      us.items(), key=lambda kv: -kv[1])}
  out = {'wall_ms': per_step(wall_us), 'busy_ms': per_step(busy_us),
         'idle': 1 - busy_us / wall_us,
         'step_ms': (1e3 * float(np.median(warmup_s[5:]))
                     if len(warmup_s) > 5 else None),
         'allreduce_ms': per_step(sum(us for name, us in by_name.items()
                                      if 'nccl' in name.lower())),
         'world_size': mesh.world_size(), **info, 'keep_frac': keep_frac,
         'compaction_ms': compaction_ms, 'span_ms': by_ms(span_us),
         'idle_ms': by_ms(trace.idle_by_span(events)),
         'kernels': [[name, per_step(us)]
                     for name, us in by_name.most_common(args.top)]}
  what = 'frame' if args.frame else 'step'
  print(f'{args.steps} x {info["window"]} {what}s after {args.warmup}: wall '
        f'{out["wall_ms"]:.3f} ms, device busy {out["busy_ms"]:.3f} ms, '
        f'idle {out["idle"]:.2%} per {what}')
  if compaction_ms is not None:
    print(f'capacity {info["capacity"]} (compact N {info["compact_n"]:,}, '
          f'keep {keep_frac:.4f}): compaction {compaction_ms:.3f} ms a step')
  spans, idle = out['span_ms'], out['idle_ms']
  print(f'device ms, idle ms (gaps by the innermost span where they begin) '
        f'per {what}:')
  for name in list(spans) + [k for k in idle if k not in spans]:
    print(f'{spans.get(name, 0.0):9.3f} {idle.get(name, 0.0):9.3f}  {name}')
  for name, ms in out['kernels']:
    print(f'{ms:9.3f} ms {ms / per_step(kernel_us):6.1%}  {name[:100]}')
  print(json.dumps(out))
  mesh.shutdown()
  return out


if __name__ == '__main__':
  main(sys.argv[1:])
