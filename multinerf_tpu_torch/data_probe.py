"""Where the train step's batch comes from, and what that costs the step.

    python -m multinerf_tpu_torch.data_probe [--steps=40] [--rounds=3]

Times the configs/360.gin step at full width, 4,096 rays, on
dummy_unbounded, under float32, bfloat16 and int8 trunks, with five data
paths taken in turns in one process (each a fresh dataset, `steps` steps,
the median of steps 6 on, each step synchronised):

* ``sync``: the host batch drawn and copied at the top of the step (the
  train driver before it prefetched);
* ``thread_start``: the producer thread's batch, the next one staged at the
  top of the step, before the step's launches;
* ``thread_staged``: the same, the next one staged after the launches (the
  train driver);
* ``nothread_staged``: staged after the launches, drawn on the main thread;
* ``device_plane``: ``Config.device_data_plane``'s draw on the device.

Prints one line per run and, last, one JSON object {dtype: {path: [ms per
round]}}.  Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from multinerf_tpu_torch import configs
from multinerf_tpu_torch import train
from multinerf_tpu_torch import train_lib
from multinerf_tpu_torch.data import datasets
from multinerf_tpu_torch.data import device_sampler

PATHS = ('sync', 'thread_start', 'thread_staged', 'nothread_staged',
         'device_plane')
TRUNKS = {'float32': (), 'bfloat16': ('bfloat16',), 'int8': ('int8',)}


def _median_step_ms(path, config, state, train_step, steps, device):
  generator = torch.Generator(device=device).manual_seed(1)
  times = []
  with datasets.load_dataset('train', None, config,
                             seed=train.DATA_SEED) as dataset:
    source = (iter(dataset._next_train, None)  # pylint: disable=protected-access
              if path == 'nothread_staged' else dataset)
    prefetcher = train_lib.Prefetcher(source, device)
    plane = device_sampler.DeviceDataPlane(dataset, config, device)
    for _ in range(steps):
      t0 = time.perf_counter()
      if path == 'sync':
        batch = train_lib.batch_to_device(
            dataset._next_train(), device)  # pylint: disable=protected-access
      elif path == 'device_plane':
        batch = plane.sample_batch(generator)
      else:
        batch = prefetcher.take()
        if path == 'thread_start':
          prefetcher.stage()
      state, _ = train_step(generator, state, batch, 0.5, False)
      if path in ('thread_staged', 'nothread_staged'):
        prefetcher.stage()
      torch.cuda.synchronize(device)
      times.append(time.perf_counter() - t0)
  return statistics.median(times[5:]) * 1e3, state


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--steps', type=int, default=40)
  parser.add_argument('--rounds', type=int, default=3)
  args = parser.parse_args(argv)
  if not torch.cuda.is_available():
    raise RuntimeError('data_probe needs CUDA.')
  device = torch.device('cuda')
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  out = {}
  for trunk, dtype in TRUNKS.items():
    config = configs.load_config(argparse.Namespace(
        gin_configs=['configs/360.gin'],
        gin_bindings=["Config.dataset_loader = 'dummy_unbounded'",
                      'Config.batch_size = 4096', 'Config.max_steps = 100',
                      'Config.lr_delay_steps = 0'] + [
                          f"{mlp}.trunk_dtype = '{d}'" for d in dtype
                          for mlp in ('NerfMLP', 'PropMLP')]))
    _, state, _, train_step, _ = train_lib.setup_model(config, train.SEED,
                                                       device)
    out[trunk] = {path: [] for path in PATHS}
    for i in range(args.rounds):
      for path in PATHS if i % 2 == 0 else PATHS[::-1]:
        ms, state = _median_step_ms(path, config, state, train_step,
                                    args.steps, device)
        out[trunk][path].append(ms)
        print(f'{trunk} {path}: {ms:.3f} ms', flush=True)
  print(json.dumps(out))
  return out


if __name__ == '__main__':
  main(sys.argv[1:])
