"""Whether the int8 trunk becomes the eval and render default (port of
scripts/int8_eval_decision.py).

Arm A, the int8 kernel's regime (360 widths, density normals off): for each
dummy scene, train the flagship model in bf16, then render the same weights
through the bf16 and the int8 trunks (the parameter trees are the same
across trunk dtypes) on 6 test views; report the PSNR delta and seconds a
frame.  Arm B, the Ref-NeRF head stack with density normals on, as
configs/blender_refnerf.gin: the int8 trunk then takes the unfused
``ops/quant.py`` path, with no kernel (multinerf_tpu/models/mlp.py:281-289);
the arm measures what a user flipping the binding gets, PSNR and speed.

The decision is 'default-on' when every 360 delta and the Ref-NeRF delta
are above -0.05 dB and the Ref-NeRF render speedup is at least 1, else
'opt-in'.

Usage (on the card; the output goes to docs/torch/INT8_EVAL_DECISION.json,
beside one JSON line per arm):

    python -m multinerf_tpu_torch.int8_eval_decision [--steps 2500]

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

from multinerf_tpu_torch import bridge
from multinerf_tpu_torch import configs
from multinerf_tpu_torch import harness
from multinerf_tpu_torch import train_lib
from multinerf_tpu_torch.data import datasets
from multinerf_tpu_torch.models import nerf

SCENES = {
    'dummy_sphere': dict(near=2.0, far=6.0),
    'dummy_scatter': dict(near=2.0, far=6.0),
    'dummy_unbounded': dict(near=0.2, far=1e6),
}
BATCH = 4096
FRAMES = 6
MODEL_SEED = 0  # The script's PRNGKey(0) ...
TRAIN_SEED = 1  # ... and its train loop's PRNGKey(1).
MIN_DELTA_DB = -0.05
MIN_SPEEDUP = 1.0


def build(bindings, trunk_dtype, loader, near, far, steps, device):
  """The model, its state and train step, its renderer and the two splits
  of `loader`, under `bindings` on a `trunk_dtype` trunk."""
  config = harness.make_config(
      bindings + harness.trunk_bindings(trunk_dtype), dataset_loader=loader,
      batch_size=BATCH, near=near, far=far, max_steps=steps,
      **harness.TRAIN_SETTINGS)
  train_data = datasets.load_dataset('train', '', config)
  test_data = datasets.load_dataset('test', '', config)
  model, state, render_fn, train_step, _ = train_lib.setup_model(
      config, MODEL_SEED, device, train_data)
  renderer = nerf.ImageRenderer(render_fn, config, None, device)
  return dict(model=model, state=state, train_step=train_step,
              renderer=renderer, train_data=train_data, test_data=test_data,
              device=device)


def close(ctx):
  ctx['train_data'].close()
  ctx['test_data'].close()


def train(ctx, steps):
  """`steps` steps of the context's model; returns its state."""
  state = ctx['state']
  generator = torch.Generator(ctx['device']).manual_seed(TRAIN_SEED)
  for _, train_frac, batch in harness.train_batches(ctx['train_data'],
                                                    ctx['device'], steps):
    state, stats = ctx['train_step'](generator, state, batch, train_frac,
                                     False)
  float(stats['loss'])  # Sync.
  return state


def render_psnr(ctx):
  """Mean held-out PSNR and steady-state seconds a frame over the first
  FRAMES test views (after one untimed render of the first)."""
  cases = [ctx['test_data'].generate_ray_batch(i) for i in range(FRAMES)]
  ctx['renderer'].render_rays(1.0, cases[0].rays)
  psnrs, sec = harness.render_psnrs(ctx['renderer'], cases, 1.0)
  return sum(psnrs) / len(psnrs), sec


def run_arm(name, bindings, loader, near, far, steps, device):
  """Train once on the bf16 trunk, then render those weights through the
  bf16 and the int8 trunks."""
  bf16 = build(bindings, 'bfloat16', loader, near, far, steps, device)
  t0 = time.time()
  train(bf16, steps)
  result = {'arm': name, 'loader': loader, 'train_steps': steps,
            'train_s': round(time.time() - t0, 1)}
  params = {k: v.detach() for k, v in
            bridge.named_parameters(bf16['model']).items()}
  for dtype in ('bfloat16', 'int8'):
    ctx = bf16
    if dtype == 'int8':
      ctx = build(bindings, dtype, loader, near, far, steps, device)
      bridge.load_flat(ctx['model'], params)
    psnr, sec = render_psnr(ctx)
    result[f'psnr_{dtype}'] = round(psnr, 3)
    result[f'sec_per_frame_{dtype}'] = round(sec, 4)
    close(ctx)
  result['psnr_delta_int8'] = round(
      result['psnr_int8'] - result['psnr_bfloat16'], 3)
  result['render_speedup_int8'] = round(
      result['sec_per_frame_bfloat16'] / result['sec_per_frame_int8'], 3)
  print(json.dumps(result), flush=True)
  return result


def decide(deltas_360, refnerf_delta, refnerf_speedup):
  """'default-on' when no 360 scene and not the Ref-NeRF arm loses PSNR
  materially and the Ref-NeRF render is not slower, else 'opt-in'."""
  if (min(deltas_360) > MIN_DELTA_DB and refnerf_delta > MIN_DELTA_DB and
      refnerf_speedup >= MIN_SPEEDUP):
    return 'default-on'
  return 'opt-in'


def main(argv=None, device='cuda'):
  """The script's flags and defaults, but ``--out`` (docs/torch).  Returns
  the decision written."""
  p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  p.add_argument('--steps', type=int, default=2500)
  p.add_argument('--refnerf_steps', type=int, default=1500)
  p.add_argument('--out', default=harness.OUT_DIR)
  args = p.parse_args(argv)
  device = configs.setup_device(device)

  arms = [run_arm(f'360_{loader}', harness.FLAGSHIP, loader, nf['near'],
                  nf['far'], args.steps, device)
          for loader, nf in SCENES.items()]
  arms.append(run_arm('refnerf_dummy_sphere', harness.REFNERF,
                      'dummy_sphere', 2.0, 6.0, args.refnerf_steps, device))
  deltas_360 = [a['psnr_delta_int8'] for a in arms
                if a['arm'].startswith('360_')]
  refnerf = arms[-1]
  decision = {
      'measurements': arms,
      'min_psnr_delta_360': min(deltas_360),
      'refnerf_psnr_delta': refnerf['psnr_delta_int8'],
      'refnerf_render_speedup': refnerf['render_speedup_int8'],
      'decision': decide(deltas_360, refnerf['psnr_delta_int8'],
                         refnerf['render_speedup_int8']),
      'device': harness.device_name(device),
  }
  os.makedirs(args.out, exist_ok=True)
  path = os.path.join(args.out, 'INT8_EVAL_DECISION.json')
  with open(path, 'w') as f:
    json.dump(decision, f, indent=2)
  print(json.dumps({'decision': decision['decision'],
                    'min_psnr_delta_360': decision['min_psnr_delta_360'],
                    'refnerf_psnr_delta': decision['refnerf_psnr_delta'],
                    'refnerf_render_speedup':
                        decision['refnerf_render_speedup'],
                    'wrote': path}), flush=True)
  return decision


if __name__ == '__main__':
  main(sys.argv[1:])
