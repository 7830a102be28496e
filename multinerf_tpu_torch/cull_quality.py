"""Occupancy-culling quality at the flagship sampling geometry (port of
scripts/cull_quality_experiment.py).

Trains the model once unculled (the ``full`` arm) and once per capacity,
then reports held-out PSNR on the first test view through the unculled
renderer and, in a culled arm, through the grid-culled one
(``train_lib.create_render_fn(model, cull=True)``), beside the measured
keep fraction (the share of final-level samples whose grid cell clears the
keep rule).  A culled arm runs ``train_lib.CullingGate`` with the one rung
`capacity`: every ``occupancy_grid_refresh_every`` steps the grid is
refreshed with jitter from a generator seeded by the step, and the culled
step engages while the step's keep fraction is at or under the capacity,
past ``occupancy_warmup_steps`` (steps // 8).  Default widths are debug
size; ``--flagship`` takes 360.gin's (PropMLP 4x256, NerfMLP 8x1024).

Usage (on the card; the output goes to docs/torch/, not to the JAX
package's records in docs/):

    python -m multinerf_tpu_torch.cull_quality --flagship \\
        --trunk_dtype bfloat16 --loader dummy_scatter \\
        --capacities 0.5,0.33 --tag flagship_bf16

``main(argv, device='cpu')`` runs it on the CPU.  The output holds the JAX
script's keys, and ``device``: the card's ``nvidia-smi`` name and power
limit, or 'cpu'.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from multinerf_tpu_torch import configs
from multinerf_tpu_torch import harness
from multinerf_tpu_torch import train_lib
from multinerf_tpu_torch.data import datasets
from multinerf_tpu_torch.models import nerf

SEED = 0  # The weights and the jitter, as the script's PRNGKey(0).


def run(steps, capacity, eval_every, batch_size, bindings, device,
        loader='dummy_sphere', near=2.0, far=6.0, keep_rule='density',
        alpha_eps=1e-3):
  """Train once (capacity None: unculled) and return the PSNR curve: one
  entry per evaluation, the last with 'train_time_s' and, where the grid
  was refreshed, 'keep_frac_trace' ([step, keep fraction] per refresh)."""
  kwargs = dict(dataset_loader=loader, batch_size=batch_size, near=near,
                far=far, max_steps=steps, **harness.TRAIN_SETTINGS)
  if capacity is not None:
    kwargs.update(occupancy_culling=True, occupancy_capacity_frac=capacity,
                  occupancy_warmup_steps=max(1, steps // 8),
                  occupancy_keep_rule=keep_rule,
                  occupancy_alpha_eps=alpha_eps)
  config = harness.make_config(bindings, **kwargs)
  with datasets.load_dataset('train', '', config) as dataset, \
      datasets.load_dataset('test', '', config) as test_dataset:
    test_case = test_dataset.generate_ray_batch(0)
    model, state, render_fn, train_step, _ = train_lib.setup_model(
        config, SEED, device, dataset)
    steps_by_cap = {None: train_step}
    renderers = {'test_psnr': nerf.ImageRenderer(render_fn, config, None,
                                                 device)}
    gate = None
    if capacity is not None:
      gate = train_lib.CullingGate(model, config)
      steps_by_cap[capacity] = train_lib.create_train_step(
          model, config, device, cull=capacity, dataset=dataset)
      # The grid-culled render, for reference: eval renders every sample
      # (train_lib.setup_model).
      renderers['test_psnr_cull_render'] = nerf.ImageRenderer(
          train_lib.create_render_fn(model, cull=True), config, None, device)
    generator = torch.Generator(device).manual_seed(SEED)

    curve = []
    keep_frac = None
    t0 = time.time()
    for step, train_frac, batch in harness.train_batches(dataset, device,
                                                         steps):
      state, stats = steps_by_cap[gate.cull(step) if gate else None](
          generator, state, batch, train_frac, False)
      if gate is not None:
        gate.after_step(step, stats)
      if step % eval_every == 0 or step == steps:
        if 'occ_keep_frac' in stats:
          keep_frac = float(stats['occ_keep_frac'])
        entry = {'step': step}
        for key, renderer in renderers.items():
          rendering = renderer.render_rays(train_frac, test_case.rays)
          entry[key] = round(harness.psnr(rendering['rgb'], test_case.rgb), 3)
        entry.update(train_psnr=round(float(stats['psnr']), 3),
                     keep_frac=keep_frac,
                     cull_steps=len(gate.rungs) if gate else 0)
        curve.append(entry)
        print(json.dumps({'capacity': capacity, **entry}), flush=True)
  curve[-1]['train_time_s'] = round(time.time() - t0, 1)
  if gate is not None and gate.keep_fracs:
    curve[-1]['keep_frac_trace'] = [[s, round(k, 4)]
                                    for s, k in gate.keep_fracs.items()]
  return curve


def main(argv=None, device='cuda'):
  """The script's flags and defaults, but ``--out`` (docs/torch).  Returns
  the results written."""
  p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  p.add_argument('--steps', type=int, default=2000)
  p.add_argument('--batch', type=int, default=4096)
  p.add_argument('--eval_every', type=int, default=500)
  p.add_argument('--capacities', type=str, default='0.5,0.33,0.25')
  p.add_argument('--out', type=str, default=harness.OUT_DIR)
  p.add_argument('--loader', type=str, default='dummy_sphere')
  p.add_argument('--near', type=float, default=2.0)
  p.add_argument('--far', type=float, default=6.0)
  p.add_argument('--flagship', action='store_true',
                 help='Real 360.gin widths (PropMLP 4x256, NerfMLP 8x1024).')
  p.add_argument('--trunk_dtype', type=str, default='float32',
                 choices=['float32', 'bfloat16', 'int8'])
  p.add_argument('--keep_rule', type=str, default='density',
                 choices=['density', 'alpha'],
                 help='Culling keep rule (Config.occupancy_keep_rule).')
  p.add_argument('--alpha_eps', type=float, default=1e-3,
                 help='Per-sample alpha bound for --keep_rule alpha.')
  p.add_argument('--tag', type=str, default='',
                 help='Extra output-filename tag (e.g. the trunk dtype).')
  p.add_argument('--skip_full', action='store_true',
                 help='Only run the culled arms (reuse a prior full run).')
  args = p.parse_args(argv)
  device = configs.setup_device(device)

  bindings = (harness.BASE_BINDINGS +
              (harness.FLAGSHIP_WIDTHS if args.flagship
               else harness.DEBUG_WIDTHS) +
              harness.trunk_bindings(args.trunk_dtype))
  results = {'steps': args.steps, 'batch': args.batch, 'loader': args.loader,
             'flagship': args.flagship, 'trunk_dtype': args.trunk_dtype,
             'keep_rule': args.keep_rule, 'alpha_eps': args.alpha_eps,
             'device': harness.device_name(device), 'runs': {}}
  kw = dict(loader=args.loader, near=args.near, far=args.far,
            keep_rule=args.keep_rule, alpha_eps=args.alpha_eps)
  arms = [] if args.skip_full else [('full', None)]
  arms += [(f'cull_{c}', c) for c in
           (float(c) for c in args.capacities.split(',') if c)]
  for name, capacity in arms:
    results['runs'][name] = run(args.steps, capacity, args.eval_every,
                                args.batch, bindings, device, **kw)
  suffix = '' if args.loader == 'dummy_sphere' else f'_{args.loader}'
  if args.tag:
    suffix += f'_{args.tag}'
  os.makedirs(args.out, exist_ok=True)
  out = os.path.join(args.out, f'cull_quality{suffix}.json')
  with open(out, 'w') as f:
    json.dump(results, f, indent=1)
  print('wrote', out)
  return results


if __name__ == '__main__':
  main(sys.argv[1:])
