"""Render throughput and quality on a checkpoint, per trunk dtype (port of
scripts/render_bench.py).

Renders test frames of the flagship 360 architecture (``configs/360.gin``,
its Config fields for the data given by flags) through the production
render path, ``train_lib.create_render_fn`` under
``models.nerf.ImageRenderer``, once per ``trunk_dtype``.  A checkpoint is
interchangeable across the float32, bfloat16 and int8 trunks (the same
parameter tree), so each arm restores the same one.

Usage (on the card):

    python -m multinerf_tpu_torch.render_bench --checkpoint_dir D \\
        [--loader dummy_unbounded --near 0.2 --far 1e6 --chunk 16384 \\
         --frames 8 --trunk_dtypes bfloat16,int8]

With no ``--checkpoint_dir`` it renders the seed's weights at step 0.  Each
frame's mean squared error is computed on the device, and all of them are
read back once at the end of the timed loop (render_bench.py:84-96), so
the loop holds no read-back per frame; its seconds a frame are the host
clock over the loop.  The warm-up frame (``first_frame_s``) is rendered
again as the loop's first and must give the same error within 1e-6.
Prints one JSON line per arm, with the script's keys and ``device`` (the
card's ``nvidia-smi`` name and power limit, or 'cpu'), then, with two arms
or more, the comparison line.  ``main(argv, device='cpu')`` runs it on the
CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from multinerf_tpu_torch import configs
from multinerf_tpu_torch import harness
from multinerf_tpu_torch import train_lib
from multinerf_tpu_torch.data import datasets
from multinerf_tpu_torch.models import nerf
from multinerf_tpu_torch.utils import checkpoints as ckpt_lib

SEED = 0  # The weights without a checkpoint, as the script's PRNGKey(0).
BATCH_SIZE = 4096  # The script's Config(batch_size=4096).
DETERMINISM_TOL = 1e-6  # render_bench.py:97.


def run_arm(trunk_dtype, args, device):
  """Render `args.frames` test frames under `trunk_dtype`: the arm's JSON
  line as a dict."""
  config = harness.make_config(
      harness.trunk_bindings(trunk_dtype), [harness.CONFIG_360],
      dataset_loader=args.loader, near=args.near, far=args.far,
      render_chunk_size=args.chunk, batch_size=BATCH_SIZE)
  _, state, render_fn, _, _ = train_lib.setup_model(config, SEED, device)
  step = 0
  if args.checkpoint_dir:
    ckpt = ckpt_lib.CheckpointManager(args.checkpoint_dir, keep=100)
    state = ckpt.restore_latest(ckpt_lib.TrainState(step=0,
                                                    params=state.params))
    step = ckpt.latest_step()
  with datasets.load_dataset('test', '', config) as test_dataset:
    cases = [next(test_dataset) for _ in range(args.frames)]
  # The ground truth goes to the device beforehand: in the timed loop only
  # the rays of each frame are copied in.
  gts = [torch.as_tensor(np.asarray(c.rgb, np.float32), device=device)
         for c in cases]
  renderer = nerf.ImageRenderer(render_fn, config, None, device)

  def render_mse(case, gt):
    rendering = renderer.render_rays(1.0, case.rays, fetch=False)
    return torch.mean((rendering['rgb'] - gt)**2)  # On the device.

  t0 = time.perf_counter()
  warm_mse = float(render_mse(cases[0], gts[0]))
  first_frame_s = time.perf_counter() - t0

  t0 = time.perf_counter()
  mses = torch.stack([render_mse(c, g) for c, g in zip(cases, gts)])
  mses = mses.cpu().numpy().astype(np.float64)  # The one read-back.
  sec = (time.perf_counter() - t0) / len(cases)
  if not abs(mses[0] - warm_mse) < DETERMINISM_TOL:
    raise RuntimeError(f'{trunk_dtype}: frame 0 rendered {warm_mse} then '
                       f'{mses[0]}: the replay is not deterministic.')

  h, w = cases[0].rays.origins.shape[:2]
  result = {'trunk_dtype': trunk_dtype, 'checkpoint_step': step,
            'frame_hw': [h, w], 'sec_per_frame': sec,
            'rays_per_sec': h * w / sec, 'first_frame_s': first_frame_s,
            'psnr': float(np.mean(-10 * np.log10(mses))),
            'frames': len(mses), 'device': harness.device_name(device)}
  print(json.dumps(result), flush=True)
  return result


def main(argv=None, device='cuda'):
  """The script's flags and defaults.  Returns (the arms' results, the
  comparison or None)."""
  p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  p.add_argument('--checkpoint_dir', type=str, default='')
  p.add_argument('--loader', type=str, default='dummy_unbounded')
  p.add_argument('--near', type=float, default=0.2)
  p.add_argument('--far', type=float, default=1e6)
  p.add_argument('--chunk', type=int, default=16384)
  p.add_argument('--frames', type=int, default=8)
  p.add_argument('--trunk_dtypes', type=str, default='bfloat16,int8')
  args = p.parse_args(argv)
  device = configs.setup_device(device)

  arms = [run_arm(d, args, device) for d in args.trunk_dtypes.split(',') if d]
  comparison = None
  if len(arms) > 1:
    base = arms[0]
    comparison = {a['trunk_dtype']: {
        'speedup_vs_' + base['trunk_dtype']:
            base['sec_per_frame'] / a['sec_per_frame'],
        'psnr_delta': a['psnr'] - base['psnr']} for a in arms[1:]}
    print(json.dumps({'comparison': comparison}), flush=True)
  return arms, comparison


if __name__ == '__main__':
  main(sys.argv[1:])
