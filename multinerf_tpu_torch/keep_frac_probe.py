"""The culling keep fraction a trained checkpoint yields per keep rule (port
of scripts/keep_frac_probe.py).

Restores the latest checkpoint of ``--checkpoint_dir`` (the port's ``.pt``
files, e.g. a run of ``python -m multinerf_tpu_torch.train``, or a JAX
checkpoint converted by scripts/convert_checkpoint.py) into configs/360.gin
with the bf16 trunk, refreshes the occupancy grid from the trained density
with jitter from a generator seeded 1, and reports the final level's keep
fraction on one train batch (the jittered forward of a train step, its
generator seeded 0) under each rule: the quantity the gate compares with
the capacity ladder.  The checkpoint on disk is not changed.

Usage (on the card):

    python -m multinerf_tpu_torch.keep_frac_probe --checkpoint_dir DIR \\
        --loader dummy_unbounded --near 0.2 --far 1e6 \\
        --rules density:5e-3,alpha:1e-3,alpha:3e-3,alpha:1e-2

It prints one JSON line per rule, then one with every rule's keep fraction
and ``device`` (the card's ``nvidia-smi`` name and power limit, or 'cpu');
``main(argv, device='cpu')`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from multinerf_tpu_torch import configs
from multinerf_tpu_torch import harness
from multinerf_tpu_torch import train_lib
from multinerf_tpu_torch.data import datasets
from multinerf_tpu_torch.models import culling
from multinerf_tpu_torch.utils import checkpoints as ckpt_lib

REFRESH_SEED = 1  # The script's PRNGKey(1).
STEP_SEED = 0  # Its train step's PRNGKey(0).


def keep_fraction(model, config, batch, generator):
  """The share of final-level samples of `batch` whose grid cell clears
  the keep rule, measured in the forward of a train step at train_frac 1
  (its jitter from `generator` under Config.randomized)."""
  with torch.inference_mode():
    _, history = model(batch.rays, 1.0, compute_extras=False,
                       generator=generator if config.randomized else None,
                       zero_glo=False)
  return float(history[-1]['occ_keep_frac'])


def main(argv=None, device='cuda'):
  """Returns {'rule:value': keep fraction}."""
  p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  p.add_argument('--checkpoint_dir', type=str, required=True)
  p.add_argument('--loader', type=str, default='dummy_unbounded')
  p.add_argument('--near', type=float, default=0.2)
  p.add_argument('--far', type=float, default=1e6)
  p.add_argument('--batch', type=int, default=4096)
  p.add_argument('--rules', type=str,
                 default='density:5e-3,alpha:1e-3,alpha:3e-3,alpha:1e-2')
  args = p.parse_args(argv)
  device = configs.setup_device(device)

  manager = ckpt_lib.CheckpointManager(args.checkpoint_dir)
  if manager.latest_step() is None:
    raise FileNotFoundError(f'No checkpoint in {args.checkpoint_dir}.')
  results = {}
  for spec in args.rules.split(','):
    rule, value = spec.split(':')
    kwargs = dict(occupancy_keep_rule=rule)
    if rule == 'density':
      kwargs['occupancy_threshold'] = float(value)
    else:
      kwargs['occupancy_alpha_eps'] = float(value)
    config = harness.make_config(
        harness.trunk_bindings('bfloat16'), gin_files=[harness.CONFIG_360],
        dataset_loader=args.loader, near=args.near, far=args.far,
        batch_size=args.batch, data_loss_type='mse', occupancy_culling=True,
        **kwargs)
    with datasets.load_dataset('train', '', config) as dataset:
      model, state, _, _, _ = train_lib.setup_model(config, STEP_SEED, device,
                                                    dataset)
      manager.restore_latest(state)
      # The grid from the trained density field (train.py's refresh).
      culling.refresh_grid(
          model, config, torch.Generator(device).manual_seed(REFRESH_SEED))
      batch = train_lib.batch_to_device(next(dataset), device)
    key = f'{rule}:{value}'
    results[key] = round(keep_fraction(
        model, config, batch,
        torch.Generator(device).manual_seed(STEP_SEED)), 4)
    print(json.dumps({key: results[key]}), flush=True)

  print(json.dumps({'checkpoint': args.checkpoint_dir,
                    'loader': args.loader, 'keep_fracs': results,
                    'device': harness.device_name(device)}), flush=True)
  return results


if __name__ == '__main__':
  main(sys.argv[1:])
