"""Train entry point of the port: a short run of optimizer steps.

    python -m multinerf_tpu_torch.train --gin_configs=configs/360.gin \
        --gin_bindings="Config.checkpoint_dir='...'" [--device=cuda]

The host-batch path of train.py:117-440, reduced to what this slice needs:
the same seeds (weights from 20200823, ray draws from 20201473),
``train_frac = clip((step - 1) / (max_steps - 1), 0, 1)``, the tree
statistics on the first step and every ``print_every``-th, the console line of
train.py:411-415 at step 1 and every ``print_every`` steps, and the final
state saved at ``max_steps``.  Each step is synchronised with the device, so
the step times it reports are device-complete.  Not ported yet (ROADMAP.md
Queue 1 item 2b): restore-latest and the ``checkpoint_every`` cadence, the
prefetch thread, TensorBoard summaries, ``save_config``, in-train test
renders and the GPU-resident sampler.  ``--device`` defaults to ``cuda``
and the run fails when CUDA is not available: there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from multinerf_tpu_torch import configs
from multinerf_tpu_torch import train_lib
from multinerf_tpu_torch.data import datasets
from multinerf_tpu_torch.utils import checkpoints as ckpt_lib

# train.py:118-120: the key of the weights and the numpy seed of the rays.
SEED = 20200823
DATA_SEED = 20201473


def _console_line(step, config, buffer, lr, rays_per_sec):
  """train.py:403-415: averages over the steps since the last line."""
  avg = {k: float(np.mean([float(s[k]) for s in buffer]))
         for k in buffer[-1] if k == 'loss' or k == 'psnr' or
         k.startswith('losses/')}
  precision = int(np.ceil(np.log10(config.max_steps))) + 1
  str_losses = {  # Each "losses/x" as "x[:4]".
      k[7:11]: (f'{v:0.5f}' if 1e-4 <= v < 10 else f'{v:0.1e}')
      for k, v in avg.items() if k.startswith('losses/')}
  return (f'{step:{precision}d}' + f'/{config.max_steps:d}: ' +
          f'loss={avg["loss"]:0.5f}, ' + f'psnr={avg["psnr"]:6.3f}, ' +
          f'lr={lr:0.2e} | ' +
          ', '.join([f'{k}={s}' for k, s in str_losses.items()]) +
          f', {rays_per_sec:0.0f} r/s')


def main(argv=None):
  """Train for Config.max_steps steps.  Returns {'losses', 'data_losses',
  'step_seconds' (per step), 'stats' (the last step's, as floats or lists),
  'checkpoint' (the final file)}."""
  parser = argparse.ArgumentParser(description='Train a model.')
  configs.add_common_flags(parser)
  parser.add_argument('--device', default='cuda',
                      help="torch device: 'cuda' (default) or 'cpu'.")
  args = parser.parse_args(argv)
  device = torch.device(args.device)
  if device.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError('--device=cuda but CUDA is not available.')
  # 360.gin's hidden layers are float32: keep their products in full f32.
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False

  config = configs.load_config(args)
  if config.checkpoint_dir is None:
    raise ValueError('Config.checkpoint_dir must name the output directory.')
  dataset = datasets.load_dataset('train', config.data_dir, config,
                                  seed=DATA_SEED)
  _, state, _, train_step, lr_fn = train_lib.setup_model(config, SEED, device)
  generator = torch.Generator(device=device).manual_seed(SEED)
  ckpt = ckpt_lib.CheckpointManager(config.checkpoint_dir, keep=100)
  num_steps = config.early_exit_steps or config.max_steps

  out = {'losses': [], 'data_losses': [], 'step_seconds': []}
  buffer = []
  window_start = time.perf_counter()
  init_step = state.step + 1
  for step in range(init_step, num_steps + 1):
    t0 = time.perf_counter()
    batch = train_lib.batch_to_device(next(dataset), device)
    train_frac = float(np.clip((step - 1) / (config.max_steps - 1), 0, 1))
    # train.py:265: the tree statistics on the first step and every
    # print_every-th.
    state, stats = train_step(
        generator, state, batch, train_frac,
        step == init_step or step % config.print_every == 0)
    if device.type == 'cuda':
      torch.cuda.synchronize(device)
    out['step_seconds'].append(time.perf_counter() - t0)
    out['losses'].append(float(stats['loss']))
    out['data_losses'].append(float(stats['losses/data']))
    buffer.append(stats)
    if step == 1 or step % config.print_every == 0:
      elapsed = time.perf_counter() - window_start
      print(_console_line(step, config, buffer, float(lr_fn(step)),
                          config.batch_size * len(buffer) / elapsed),
            flush=True)
      buffer = []
      window_start = time.perf_counter()

  ckpt.save(num_steps, state)
  out['stats'] = {k: v.tolist() for k, v in stats.items()}
  out['checkpoint'] = ckpt.path(num_steps)
  return out


if __name__ == '__main__':
  main(sys.argv[1:])
