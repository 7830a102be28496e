"""Where a training step's (or a rendered frame's) device time goes, from
torch.profiler.

    python -m multinerf_tpu_torch.profile_step --gin_configs=configs/360.gin \
        --gin_bindings="Config.dataset_loader='dummy_unbounded'" \
        --gin_bindings='Config.batch_size=4096' [--warmup=13] [--steps=3]

Sets the model up as ``python -m multinerf_tpu_torch.train`` does (same
seeds, TF32 off, host batches prefetched or, with
``Config.device_data_plane``, drawn on the device), runs `warmup` steps,
then `steps` more under the profiler, each synchronised.  With ``--frame`` it sets the model up as
``python -m multinerf_tpu_torch.render`` does with no checkpoint (the same
seed) and renders test frame 0 instead of taking a step, `warmup` times and
then `steps` times under the profiler (``Config.render_path`` and
``Config.render_resolution`` choose the frame); a frame ends in its copy to
the host.  Device busy time is the union of the CUDA
kernel, copy and memset intervals of the profiled steps (the CPU ops'
``key_averages()`` rows also carry their children's device time, so they
are not summed); the idle share is 1 - busy / wall, wall being the host
clock around the profiled steps.  ``step_ms`` is the median of the
synchronised warm-up steps after the fifth, unprofiled.  Prints the kernels
by device time per step and, as the last line, one JSON object with the
same numbers.

Under ``python -m torch.distributed.run --nproc_per_node=N`` every rank
takes its steps (``Config.batch_size`` is the global batch; the seeds are
train.py's, shifted by the rank), and rank 0 profiles and prints, with
``allreduce_ms``, the device time per step of the NCCL kernels.
"""

from __future__ import annotations

import argparse
import collections
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
from multinerf_tpu_torch.models import nerf
from multinerf_tpu_torch.parallel import mesh


def _union_us(intervals):
  """Total length of the union of (start, end) intervals."""
  total, end = 0.0, -np.inf
  for lo, hi in sorted(intervals):
    if hi > end:
      total += hi - max(lo, end)
      end = hi
  return total


def main(argv=None):
  """Returns {'wall_ms', 'busy_ms', 'idle', 'step_ms', 'allreduce_ms',
  'world_size', 'kernels': [[name, ms]]}, per profiled step (or frame)."""
  parser = argparse.ArgumentParser(
      description='Profile training steps or rendered frames.')
  configs.add_common_flags(parser)
  parser.add_argument('--warmup', type=int, default=13)
  parser.add_argument('--steps', type=int, default=3)
  parser.add_argument('--top', type=int, default=20)
  parser.add_argument('--frame', action='store_true',
                      help='profile rendering test frame 0, not steps.')
  args = parser.parse_args(argv)
  if not torch.cuda.is_available():
    raise RuntimeError('profile_step needs CUDA.')
  device = configs.setup_device()
  rank = mesh.data_rank()

  config = configs.load_config(args)
  total = args.warmup + args.steps
  if args.frame:
    dataset = datasets.load_dataset('test', config.data_dir, config)
    _, state, render_fn, _, _ = train_lib.setup_model(config, render.SEED,
                                                      device)
    renderer = nerf.DeviceImageRenderer(render_fn, config, dataset, device)

    def step(i, state):
      del i
      renderer(1.0, 0)  # Ends in the rendering's copy to the host.
      return state
  else:
    dataset = datasets.load_dataset('train', config.data_dir, config,
                                    seed=train.DATA_SEED + rank)
    _, state, _, train_step, _ = train_lib.setup_model(config, train.SEED,
                                                       device, dataset)
    generator = torch.Generator(device=device).manual_seed(train.SEED +
                                                           rank)
    if config.device_data_plane:
      plane = device_sampler.DeviceDataPlane(dataset, config, device)
      device_step = device_sampler.create_device_train_step(train_step,
                                                            plane)
    else:
      prefetcher = train_lib.Prefetcher(dataset, device)

    def step(i, state):
      train_frac = float(np.clip((i - 1) / (config.max_steps - 1), 0, 1))
      if config.device_data_plane:
        state, _ = device_step(generator, state, train_frac, False)
      else:
        state, _ = train_step(generator, state, prefetcher.take(),
                              train_frac, False)
        prefetcher.stage()  # As the train driver does.
      torch.cuda.synchronize(device)
      return state

  activities = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
  warmup_s = []
  with dataset:
    for i in range(1, args.warmup + 1):
      t0 = time.perf_counter()
      state = step(i, state)
      torch.cuda.synchronize(device)
      warmup_s.append(time.perf_counter() - t0)
    if rank == 0:
      with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for i in range(args.warmup + 1, total + 1):
          state = step(i, state)
        wall_us = (time.perf_counter() - t0) * 1e6
    else:
      for i in range(args.warmup + 1, total + 1):
        state = step(i, state)
  if rank != 0:
    mesh.shutdown()
    return None

  device_events = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA and
                   not e.is_user_annotation]
  if not device_events:
    raise RuntimeError('The profiler recorded no device activity.')
  busy_us = _union_us([(e.time_range.start, e.time_range.end)
                       for e in device_events])
  by_name = collections.Counter()
  for e in device_events:
    by_name[e.name] += e.time_range.end - e.time_range.start
  kernel_us = sum(by_name.values())
  per_step = lambda us: us / 1e3 / args.steps
  out = {'wall_ms': per_step(wall_us), 'busy_ms': per_step(busy_us),
         'idle': 1 - busy_us / wall_us,
         'step_ms': (1e3 * float(np.median(warmup_s[5:]))
                     if len(warmup_s) > 5 else None),
         'allreduce_ms': per_step(sum(us for name, us in by_name.items()
                                      if 'nccl' in name.lower())),
         'world_size': mesh.world_size(),
         'kernels': [[name, per_step(us)]
                     for name, us in by_name.most_common(args.top)]}
  what = 'frames' if args.frame else 'steps'
  print(f'{args.steps} {what} after {args.warmup}: wall {out["wall_ms"]:.3f} '
        f'ms, device busy {out["busy_ms"]:.3f} ms, idle {out["idle"]:.2%} '
        f'per {what[:-1]}')
  for name, ms in out['kernels']:
    print(f'{ms:9.3f} ms {ms / per_step(kernel_us):6.1%}  {name[:100]}')
  print(json.dumps(out))
  mesh.shutdown()
  return out


if __name__ == '__main__':
  main(sys.argv[1:])
