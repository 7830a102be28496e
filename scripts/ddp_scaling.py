"""Data-parallel scaling of the port's train step on 1, 2 and 4 GPUs.

    python scripts/ddp_scaling.py [--ranks 1,2,4] [--out FILE]

For each rank count, ``python -m torch.distributed.run --nproc_per_node=R
-m multinerf_tpu_torch.profile_step`` takes 360.gin's step at full width
with the bf16 trunk on ``dummy_unbounded``, on the host path: weak scaling
(4,096 rays a rank) and strong scaling (4,096 rays in all), and weak
scaling on the device plane.  From rank 0: the median synchronised step
(``step_ms``), rays/s over the global batch, the NCCL all-reduce's device
ms per step and the idle share, from torch.profiler.  Then the step of the
largest rank count on one fixed batch with no jitter
(``multinerf_tpu_torch.ddp_probe``, 4,096 rays a rank) is held against one
process's step on that global batch by ``ddp_probe.hold_parity``: the
losses of 3 steps (steps 2-3 within a bound that the control, rank 1's
gradient dropped, must miss), step 1's gradient by
``train_lib.leaf_gaps``, and the ranks' parameters bitwise equal.  Prints one line per run and, last, one JSON object, also written to
``--out``.  Imports only the port; needs as many GPUs as the largest rank
count.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from multinerf_tpu_torch import ddp_probe  # noqa: E402
from multinerf_tpu_torch.ops.kernels import build  # noqa: E402

RAYS = 4096  # A rank's batch in the weak cells; the whole batch in strong.
TIMEOUT_S = 300
PARITY_STEPS = 3
GAP_CAP = 0.15  # train_lib.leaf_gaps' cap at full width.
BINDINGS = ("Config.dataset_loader='dummy_unbounded'",
            "NerfMLP.trunk_dtype='bfloat16'", "PropMLP.trunk_dtype='bfloat16'",
            'Config.max_steps=100', 'Config.lr_delay_steps=0')
KERNELS = ('density_mlp', 'featurize_dense', 'density_mlp_bwd',
           'featurize_dense_dw')


def _gin(bindings):
  return [f'--gin_configs={os.path.join(REPO, "configs", "360.gin")}'] + [
      f'--gin_bindings={b}' for b in bindings]


def profile(ranks, batch, device_plane=False):
  """profile_step at `ranks` ranks on a global batch of `batch` rays."""
  bindings = BINDINGS + (f'Config.batch_size={batch}',)
  if device_plane:
    bindings += ('Config.device_data_plane=True',)
  try:
    out = ddp_probe.Launch(ranks, ['-m', 'multinerf_tpu_torch.profile_step',
                                   '--warmup=13', '--steps=3'] +
                           _gin(bindings)).wait(TIMEOUT_S)
  except ddp_probe.LaunchError as e:
    print(f'FAIL {e}', flush=True)
    return {'ranks': ranks, 'batch': batch, 'device_plane': device_plane,
            'error': str(e)[-2000:]}
  # Rank 0's JSON line; the launcher may log after it.
  result = next(json.loads(line) for line in reversed(out.splitlines())
                if line.startswith('{"wall_ms"'))
  result['kernels'] = result['kernels'][:8]
  result.update(ranks=ranks, batch=batch, device_plane=device_plane,
                rays_per_s=batch / (result['step_ms'] / 1e3))
  print(f'{ranks} rank(s), {batch} rays ({"device plane" if device_plane else "host path"}): '
        f'step {result["step_ms"]:.3f} ms, {result["rays_per_s"]:,.0f} '
        f'rays/s, all-reduce {result["allreduce_ms"]:.3f} ms a step, '
        f'profiled wall {result["wall_ms"]:.3f} / busy '
        f'{result["busy_ms"]:.3f} ms, idle {result["idle"]:.2%}',
        flush=True)
  return result


def parity(ranks, tmp, device='cuda', bindings=()):
  """The `ranks`-rank step on a fixed batch against one process's, and its
  control with rank 1's gradient dropped, on `device` ('cpu' rehearses it
  at the small widths of `bindings`): ddp_probe.hold_parity."""
  argv = _gin(BINDINGS + tuple(bindings) + (
      f'Config.batch_size={RAYS * ranks}', 'Config.randomized=False'))
  spec = {'device': device, 'parts': [
      {'name': 'parity', 'kind': 'step', 'argv': argv, 'rays': RAYS * ranks,
       'steps': PARITY_STEPS},
      {'name': 'parity_drop', 'kind': 'step', 'argv': argv,
       'rays': RAYS * ranks, 'steps': PARITY_STEPS, 'drop_rank': 1}]}
  ddp_probe.start_parts(ranks, spec, tmp).wait(TIMEOUT_S)
  got = ddp_probe.part_results(ranks, spec, tmp)
  device = torch.device(device)
  want, nudged = (ddp_probe.run_steps(argv, device, RAYS * ranks,
                                      PARITY_STEPS, nudge=nudge)
                  for nudge in (False, True))
  result = ddp_probe.hold_parity(got['parity'], want, nudged, GAP_CAP,
                                 ddp_probe.LATER_LOSS_RTOL,
                                 got['parity_drop'])
  result.update(ranks=ranks, rays=RAYS * ranks)
  print(f'{ranks}-rank step vs one process on {RAYS * ranks} rays: loss '
        f'gaps {result["loss_gaps"]} (bounds {result["loss_bounds"]}; rank '
        f'1\'s gradient dropped: {result["control_loss_gaps"]}), worst '
        f'gradient leaf {result["worst_gradient_leaf"][1]:.3f} of its bound '
        f'({result["worst_gradient_leaf"][0]}), parameters replicated '
        f'{result["replicated"]}: {"held" if result["ok"] else "FAILED"}',
        flush=True)
  return result


def main():
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--ranks', default='1,2,4')
  parser.add_argument('--out', default=None)
  args = parser.parse_args()
  ranks = [int(r) for r in args.ranks.split(',')]
  if torch.cuda.device_count() < max(ranks):
    raise SystemExit(f'FAIL: {max(ranks)} GPUs needed, '
                     f'{torch.cuda.device_count()} visible.')
  card = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True,
      check=False).stdout.strip()
  print(card, flush=True)
  t0 = time.perf_counter()
  build.load_all(KERNELS)  # Built once here; the ranks load the libraries.
  runs = []
  for r in ranks:
    runs.append(profile(r, RAYS * r))
    if r > 1:
      runs.append(profile(r, RAYS))
  for r in (ranks[0], ranks[-1]):
    runs.append(profile(r, RAYS * r, device_plane=True))
  with tempfile.TemporaryDirectory() as tmp:
    try:
      held = parity(ranks[-1], tmp)
    except ddp_probe.LaunchError as e:
      print(f'FAIL {e}', flush=True)
      held = {'ok': False, 'error': str(e)[-2000:]}
  out = {'card': card.splitlines(), 'runs': runs, 'parity': held,
         'seconds': time.perf_counter() - t0}
  if args.out:
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as f:
      json.dump(out, f, indent=1)
  print(json.dumps({'runs': [{k: v for k, v in run.items()
                              if k != 'kernels'} for run in runs],
                    'parity_ok': held['ok']}))
  return 0 if held['ok'] and not any('error' in r for r in runs) else 1


if __name__ == '__main__':
  sys.exit(main())
