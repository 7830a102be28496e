"""One rank of the port's data-parallel test clusters (test_torch_distributed.py).

Started by ``python -m torch.distributed.run --nproc_per_node=N
--max-restarts=0 torch_dist_worker.py SCENARIO[,SCENARIO...] OUT_DIR``: it
joins the gloo process group on the CPU, runs each SCENARIO in turn and
saves this rank's result of each to ``OUT_DIR/SCENARIO_rank{r}.pt``.  It
imports only the port.  The test process imports this module too and runs
the same functions with no process group, for the one-process reference.

Scenarios:
* ``steps``: each case of ``OUT_DIR/cases.json`` trains 3 steps on this
  rank's rows of the case's global batch (``OUT_DIR/batch_<case>.pt``):
  losses, step 1's statistics and global gradient, the parameters after
  the last step, and for culled cases the grid, keep fractions and rungs;
  across ranks also each control (a case with a rank's gradient dropped,
  ``ddp_probe.drop_gradient``); then the renderers on one set of weights
  (``render_frames``).
* ``ckpt``: one phase of save -> kill -> restore: restore the latest
  checkpoint in OUT_DIR/ckpt, if any, train 3 steps, save.
* ``drivers``: ``train.main`` on the device plane and in the multi-step
  window, then ``eval.main`` and ``render.main`` on the device plane's
  checkpoint, recording every file each rank opens for writing.
* ``raise``: rank 1 raises while rank 0 waits in an all-reduce.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
  sys.path.insert(0, REPO)

from multinerf_tpu_torch import configs  # noqa: E402
from multinerf_tpu_torch import ddp_probe  # noqa: E402
from multinerf_tpu_torch import train_lib  # noqa: E402
from multinerf_tpu_torch.data import cameras  # noqa: E402
from multinerf_tpu_torch.data import datasets  # noqa: E402
from multinerf_tpu_torch.models import nerf  # noqa: E402
from multinerf_tpu_torch.parallel import mesh  # noqa: E402
from multinerf_tpu_torch.utils import checkpoints  # noqa: E402

CONFIG_360 = os.path.join(REPO, 'configs', '360.gin')
TRAIN_FRAC = 0.5
NUM_STEPS = 3


def load_config(bindings):
  args = argparse.Namespace(gin_configs=[CONFIG_360],
                            gin_bindings=list(bindings))
  return configs.load_config(args)


def _numpy(tree):
  return {k: v.detach().cpu().numpy().copy() for k, v in tree.items()}


def run_case(case, global_batch):
  """NUM_STEPS steps of `case` on this rank's rows of `global_batch`."""
  config = load_config(case['bindings'])
  model, state, _, train_step, _ = train_lib.setup_model(config, 0, 'cpu')
  batch = ddp_probe.local_rows(global_batch)
  if 'drop_rank' in case:
    ddp_probe.drop_gradient(model, case['drop_rank'])
  gate = steps = None
  if config.occupancy_culling:
    gate = train_lib.CullingGate(model, config)
    steps = {cap: train_lib.create_train_step(model, config, 'cpu', cull=cap)
             for cap in gate.ladder}
    steps[None] = train_step
  grads = []
  apply = train_lib.apply_gradients

  def recording(state, g, *args):
    grads.append(_numpy(g))
    return apply(state, g, *args)

  out = {'losses': [], 'stats': [], 'grids': [], 'thresholds': []}
  loss_threshold = 1.0
  train_lib.apply_gradients = recording
  try:
    for step in range(1, NUM_STEPS + 1):
      step_fn = steps[gate.cull(step)] if gate else train_step
      state, stats = step_fn(None, state, batch, TRAIN_FRAC, step == 1,
                             loss_threshold)
      if gate is not None:
        gate.after_step(step, stats)
        out['grids'].append(model.occupancy.grid.numpy().copy())
      if config.enable_robustnerf_loss:
        loss_threshold = stats['loss_threshold']
        out['thresholds'].append(float(loss_threshold))
      out['losses'].append(float(stats['loss']))
      out['stats'].append({k: v.numpy().copy() for k, v in stats.items()})
  finally:
    train_lib.apply_gradients = apply
  out['grads1'] = grads[0]
  out['params'] = _numpy(state.params)
  if gate is not None:
    out['keep_fracs'], out['rungs'] = gate.keep_fracs, gate.rungs
  return out


def render_frames(bindings):
  """The renderers' frames on seed-0 weights: DeviceImageRenderer (test
  view 0), render_many (views 1 and 2), ImageRenderer on the host rays of
  view 0 (render_image) and on a 8 x 16 pano."""
  config = load_config(bindings)
  dataset = datasets.load_dataset('test', None, config)
  _, _, render_fn, _, _ = train_lib.setup_model(config, 0, 'cpu')
  device_renderer = nerf.DeviceImageRenderer(render_fn, config, dataset,
                                             'cpu')
  host = lambda r: nerf.render_image(lambda rays: render_fn(TRAIN_FRAC, rays),
                                     r, config, 'cpu')
  c2w = dataset.camtoworlds[0][:3].astype(np.float64)
  pano = cameras.cast_spherical_rays(c2w, 8, 16, dataset.near, dataset.far)
  frames = {'device': device_renderer(TRAIN_FRAC, 0),
            'many': device_renderer.render_many(TRAIN_FRAC, [1, 2]),
            'host': host(dataset.generate_ray_batch(0).rays),
            'pano': host(pano)}
  dataset.close()
  return frames


def scenario_steps(out_dir):
  with open(os.path.join(out_dir, 'cases.json')) as f:
    spec = json.load(f)
  out = {}
  cases = spec['cases'] + (spec['controls'] if mesh.world_size() > 1 else [])
  for case in cases:
    batch = torch.load(os.path.join(
        out_dir, f"batch_{case.get('batch', case['name'])}.pt"),
                       weights_only=False)
    out[case['name']] = run_case(case, batch)
  out['frames'] = render_frames(spec['render_bindings'])
  return out


def ckpt_phase(out_dir, case, batch):
  """Restore the latest checkpoint under out_dir/ckpt (if any), train
  NUM_STEPS steps, save: (start step, losses)."""
  config = load_config(case['bindings'])
  model, state, _, train_step, _ = train_lib.setup_model(config, 0, 'cpu')
  del model
  manager = checkpoints.CheckpointManager(os.path.join(out_dir, 'ckpt'))
  state = manager.restore_latest(state)
  start = state.step
  losses = []
  for _ in range(NUM_STEPS):
    state, stats = train_step(None, state, batch, TRAIN_FRAC, False)
    losses.append(float(stats['loss']))
  manager.save(state.step, state)
  return {'start_step': start, 'losses': losses,
          'params': _numpy(state.params)}


def scenario_ckpt(out_dir):
  with open(os.path.join(out_dir, 'cases.json')) as f:
    case = json.load(f)['ckpt_case']
  batch = torch.load(os.path.join(out_dir, f"batch_{case['name']}.pt"),
                     weights_only=False)
  return ckpt_phase(out_dir, case, ddp_probe.local_rows(batch))


def scenario_drivers(out_dir):
  from multinerf_tpu_torch import render
  with open(os.path.join(out_dir, 'cases.json')) as f:
    spec = json.load(f)
  flags = lambda bindings: ['--device=cpu', f'--gin_configs={CONFIG_360}'] + [
      f'--gin_bindings={b}' for b in bindings]
  out = {name: ddp_probe.run_train(flags(spec['train'][name]))
         for name in ('device_plane', 'window')}
  out['eval'] = ddp_probe.run_eval(flags(spec['eval']))
  out['render_writes'] = []
  with ddp_probe.record_writes(out['render_writes']):
    out['render'] = render.main(flags(spec['render']))['renderings']
  return out


def scenario_raise(out_dir):
  del out_dir
  if mesh.rank() == 1:
    raise RuntimeError('rank 1 fails before the all-reduce')
  mesh.all_reduce_sum(torch.ones(1))
  return {}


SCENARIOS = {'steps': scenario_steps, 'ckpt': scenario_ckpt,
             'drivers': scenario_drivers, 'raise': scenario_raise}


def main():
  scenarios, out_dir = sys.argv[1].split(','), sys.argv[2]
  torch.set_num_threads(1)
  mesh.init_from_env('cpu', timeout_seconds=120)
  for scenario in scenarios:
    result = SCENARIOS[scenario](out_dir)
    torch.save(result,
               os.path.join(out_dir, f'{scenario}_rank{mesh.rank()}.pt'))
  mesh.shutdown()


if __name__ == '__main__':
  main()
