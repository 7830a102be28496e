"""One rank of the port's tensor-parallel test clusters (test_torch_tensor_parallel.py).

Started by ``python -m torch.distributed.run --nproc_per_node=N
--max-restarts=0 torch_tp_worker.py SCENARIO[,SCENARIO...] OUT_DIR K``: it
joins the gloo process group on the CPU, lays the ranks out as a (N / K,
K) mesh (``mesh.create_mesh(model_parallel=K, min_dim_to_shard=128)``, the
threshold of tests/test_tensor_parallel.py), runs each SCENARIO in turn
and saves this rank's result of each to ``OUT_DIR/SCENARIO_rank{r}.pt``.
It imports only the port.  The test process imports this module too and
runs the same functions with no process group, for the one-process
reference.

Scenarios:
* ``steps``: each case of ``OUT_DIR/cases.json`` trains NUM_STEPS steps on
  this rank's rows of the case's global batch (``OUT_DIR/batch.pt``), with
  the tree statistics: losses, statistics, step 1's global gradient and
  the parameters after the last step (split leaves gathered), this rank's
  own parameters, whether the ranks' parameters were bitwise equal after
  every step, and the bytes of parameters and Adam state this rank holds;
  then a test view of the case ``frame`` names rendered on seed-0 weights.
* ``ckpt``: one phase of save -> kill -> restore: restore the latest
  checkpoint in OUT_DIR/ckpt, if any, train NUM_STEPS steps, save.
"""

import argparse
import json
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
  sys.path.insert(0, REPO)

from multinerf_tpu_torch import bridge  # noqa: E402
from multinerf_tpu_torch import configs  # noqa: E402
from multinerf_tpu_torch import ddp_probe  # noqa: E402
from multinerf_tpu_torch import train_lib  # noqa: E402
from multinerf_tpu_torch.data import datasets  # noqa: E402
from multinerf_tpu_torch.models import nerf  # noqa: E402
from multinerf_tpu_torch.parallel import mesh  # noqa: E402
from multinerf_tpu_torch.parallel import tensor  # noqa: E402
from multinerf_tpu_torch.utils import checkpoints  # noqa: E402

MIN_DIM_TO_SHARD = 128
TRAIN_FRAC = 0.5
NUM_STEPS = 3


def load_config(bindings):
  """The Config of `bindings` alone (no gin file), as
  tests/test_tensor_parallel.py builds its Config."""
  args = argparse.Namespace(gin_configs=[], gin_bindings=list(bindings))
  return configs.load_config(args)


def _numpy(tree):
  return {k: v.detach().cpu().numpy().copy() for k, v in tree.items()}


def _whole(tree, splits):
  return _numpy({k: tensor.gather(v, k, splits) for k, v in tree.items()})


def run_case(case, global_batch):
  """NUM_STEPS steps of `case` on this rank's rows of `global_batch`."""
  config = load_config(case['bindings'])
  model, state, _, train_step, _ = train_lib.setup_model(config, 0, 'cpu')
  batch = ddp_probe.local_rows(global_batch)
  if 'drop_model_rank' in case:
    ddp_probe.drop_model_partial(case['drop_model_rank'])
  splits = tensor.splits_of(state.params)
  grads = []
  apply = train_lib.apply_gradients

  def recording(state, g, *args):
    grads.append(_whole(g, splits))
    return apply(state, g, *args)

  out = {'losses': [], 'stats': [], 'replicated_steps': []}
  train_lib.apply_gradients = recording
  try:
    for _ in range(NUM_STEPS):
      state, stats = train_step(None, state, batch, TRAIN_FRAC, True)
      out['losses'].append(float(stats['loss']))
      out['stats'].append({k: v.numpy().copy() for k, v in stats.items()})
      out['replicated_steps'].append(ddp_probe.replicated(state.params))
  finally:
    train_lib.apply_gradients = apply
  out['grads1'] = grads[0]
  out['params'] = _whole(state.params, splits)
  out['local_params'] = _numpy(state.params)
  out['bytes'] = tensor.per_rank_bytes(bridge.named_parameters(model),
                                       state.optimizer)
  return out


def render_frame(bindings):
  """Test view 0 of `bindings` on seed-0 weights (DeviceImageRenderer)."""
  config = load_config(bindings)
  _, _, render_fn, _, _ = train_lib.setup_model(config, 0, 'cpu')
  with datasets.load_dataset('test', None, config) as dataset:
    return nerf.DeviceImageRenderer(render_fn, config, dataset,
                                    'cpu')(TRAIN_FRAC, 0)


def scenario_steps(out_dir):
  with open(os.path.join(out_dir, 'cases.json')) as f:
    spec = json.load(f)
  batch = torch.load(os.path.join(out_dir, 'batch.pt'), weights_only=False)
  out = {case['name']: run_case(case, batch) for case in spec['cases']}
  if spec.get('frame'):
    out['frame'] = render_frame(spec['frame'])
  return out


def ckpt_phase(out_dir, bindings, batch):
  """Restore the latest checkpoint under out_dir/ckpt (if any), train
  NUM_STEPS steps, save: (start step, losses, whole parameters)."""
  config = load_config(bindings)
  _, state, _, train_step, _ = train_lib.setup_model(config, 0, 'cpu')
  manager = checkpoints.CheckpointManager(os.path.join(out_dir, 'ckpt'))
  state = manager.restore_latest(state)
  start = state.step
  losses = []
  for _ in range(NUM_STEPS):
    state, stats = train_step(None, state, batch, TRAIN_FRAC, False)
    losses.append(float(stats['loss']))
  manager.save(state.step, state)
  return {'start_step': start, 'losses': losses,
          'params': _numpy(checkpoints.whole_state(state)[0])}


def scenario_ckpt(out_dir):
  with open(os.path.join(out_dir, 'cases.json')) as f:
    bindings = json.load(f)['ckpt']
  batch = torch.load(os.path.join(out_dir, 'batch.pt'), weights_only=False)
  return ckpt_phase(out_dir, bindings, ddp_probe.local_rows(batch))


SCENARIOS = {'steps': scenario_steps, 'ckpt': scenario_ckpt}


def main():
  scenarios, out_dir = sys.argv[1].split(','), sys.argv[2]
  torch.set_num_threads(1)
  mesh.init_from_env('cpu', timeout_seconds=120)
  mesh.create_mesh(int(sys.argv[3]), MIN_DIM_TO_SHARD)
  for scenario in scenarios:
    result = SCENARIOS[scenario](out_dir)
    torch.save(result,
               os.path.join(out_dir, f'{scenario}_rank{mesh.rank()}.pt'))
  mesh.shutdown()


if __name__ == '__main__':
  main()
