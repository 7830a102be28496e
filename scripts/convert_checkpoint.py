"""Convert a training checkpoint between the JAX package and the PyTorch port.

    python scripts/convert_checkpoint.py --direction=jax-to-torch \
        --src=JAX_CHECKPOINT_DIR --dst=TORCH_CHECKPOINT_DIR \
        --gin_configs=configs/360.gin [--gin_bindings=...]
    python scripts/convert_checkpoint.py --direction=torch-to-jax \
        --src=TORCH_CHECKPOINT_DIR --dst=JAX_CHECKPOINT_DIR \
        --gin_configs=configs/360.gin [--gin_bindings=...]

The latest checkpoint in ``--src`` is written to ``--dst`` under the same
step, so that the other package's train, eval and render drivers resume
from it (``Config.checkpoint_dir = DST``).  The gin flags are the scene's,
as its train run took them: they build the port's model, whose parameter
names, order and shapes the conversion follows.

What it carries:

- the parameters, under flax's ``Dense_i`` names and ``[in, out]`` layout
  (``multinerf_tpu_torch.bridge``: a renaming, no transposes);
- Adam's moments, optax's ``ScaleByAdamState`` ``mu``/``nu`` and torch
  Adam's ``exp_avg``/``exp_avg_sq``, and its update count, optax's
  ``count`` (of the Adam and the schedule states) and torch Adam's
  per-parameter ``step``, so the bias correction and the learning-rate
  schedule go on where they were;
- the ``TrainState`` step, which the drivers resume after;
- the occupancy grid of ``Config.occupancy_culling``: JAX keeps it in the
  ``occupancy`` collection of ``TrainState.params``, outside Adam (masked
  by ``optax.masked``, no moments), the port as the buffer
  ``occupancy/grid``.

Names present on one side only follow the drivers' restore: a name of the
model missing from the checkpoint keeps the model's initial value, a name
of the checkpoint the model lacks is dropped, and both are printed.

The JAX side is read with orbax's raw restore, as
``multinerf_tpu.utils.checkpoints.CheckpointManager.restore_latest`` reads
a checkpoint whose structure differs from its state, and written through
that class's ``save``, so that its ``restore_latest`` loads the result
unchanged.  The tool needs ``jax``, ``optax`` and ``orbax``, so it lives
outside both packages; the port never imports it.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import orbax.checkpoint as ocp  # noqa: E402
import torch  # noqa: E402

from multinerf_tpu import configs as jax_configs  # noqa: E402
from multinerf_tpu import train_lib as jax_train_lib  # noqa: E402
from multinerf_tpu.utils import checkpoints as jax_checkpoints  # noqa: E402
from multinerf_tpu_torch import bridge  # noqa: E402
from multinerf_tpu_torch import configs  # noqa: E402
from multinerf_tpu_torch import train_lib  # noqa: E402
from multinerf_tpu_torch.utils import checkpoints  # noqa: E402

ADAM_FIELDS = (('mu', 'exp_avg'), ('nu', 'exp_avg_sq'))


def _key(k):
  """A pytree path entry as a string (dict key, attribute or index)."""
  return str(getattr(k, 'key', getattr(k, 'name', getattr(k, 'idx', k))))


def _port_state(config):
  """The port's model on the CPU, its TrainState (parameters, buffers and
  the Adam of the train driver) at step 0, and the learning-rate
  schedule."""
  model, state, _, _, lr_fn = train_lib.setup_model(config, 0, 'cpu')
  return model, state, lr_fn


def _report(model_names, source_names):
  """Print the variable names on one side only."""
  kept = sorted(set(model_names) - set(source_names))
  dropped = sorted(set(source_names) - set(model_names))
  if kept or dropped:
    print(f'Kept at their initial values: {kept or "none"}; dropped from '
          f'the checkpoint: {dropped or "none"}.')


def read_jax(src):
  """The latest orbax checkpoint under `src`: (step, {name: variable},
  {'mu': {name: array}, 'nu': ...}, Adam's count).  Variable names are the
  port's: 'params' paths bare, other collections under their name."""
  manager = ocp.CheckpointManager(os.path.abspath(src))
  ckpt_step = manager.latest_step()
  if ckpt_step is None:
    raise FileNotFoundError(f'no checkpoint in {src}')
  raw = manager.restore(ckpt_step)
  manager.close()
  variables = bridge.flatten(raw['params']['params'])
  for collection, tree in raw['params'].items():
    if collection != 'params':
      variables.update(bridge.flatten(tree, f'{collection}/'))
  moments, counts = {'mu': {}, 'nu': {}}, set()
  for path, leaf in jax.tree_util.tree_flatten_with_path(raw['opt_state'])[0]:
    keys = [_key(k) for k in path]
    if keys[-1] == 'count':
      counts.add(int(leaf))
    for field in moments:
      if field in keys and leaf is not None:
        rest = keys[keys.index(field) + 1:]
        if rest[0] == 'params':  # Adam never sees the other collections.
          moments[field]['/'.join(rest[1:])] = np.asarray(leaf)
  if len(counts) != 1:
    raise ValueError(f'optimizer counts disagree: {sorted(counts)}')
  return int(raw['step']), variables, moments, counts.pop()


def jax_to_torch(src, dst, config):
  """The latest JAX checkpoint under `src` as the port's checkpoint in
  `dst`; returns its step."""
  step, variables, moments, count = read_jax(src)
  model, state, lr_fn = _port_state(config)
  _report(state.params, variables)
  with torch.no_grad():
    for name, value in state.params.items():
      if name in variables:
        value.copy_(torch.as_tensor(variables[name]))
  optimizer = state.optimizer
  for name, p in bridge.named_parameters(model).items():
    if name not in moments['mu']:
      continue
    optimizer.state[p] = {
        'step': torch.tensor(float(count), dtype=torch.float32),
        **{field: torch.as_tensor(moments[key][name]).clone()
           for key, field in ADAM_FIELDS}}
  for group in optimizer.param_groups:
    # The rate of the last update, as the train step leaves it set.
    group['lr'] = float(lr_fn(max(count - 1, 0)))
  checkpoints.CheckpointManager(dst).save(step, checkpoints.TrainState(
      step=step, params=state.params, optimizer=optimizer))
  return step


def torch_to_jax(src, dst, config):
  """The latest port checkpoint under `src` as an orbax checkpoint of the
  JAX package's TrainState in `dst`; returns its step."""
  manager = checkpoints.CheckpointManager(src)
  ckpt_step = manager.latest_step()
  if ckpt_step is None:
    raise FileNotFoundError(f'no checkpoint in {src}')
  saved = torch.load(manager.path(ckpt_step), map_location='cpu',
                     weights_only=True)
  model, state, _ = _port_state(config)
  _report(state.params, saved['params'])
  state = manager.restore_latest(state)
  params = bridge.named_parameters(model)
  optimizer = state.optimizer
  counts = {int(optimizer.state[p]['step']) for p in params.values()
            if p in optimizer.state}
  if len(counts) > 1:
    raise ValueError(f'Adam steps disagree: {sorted(counts)}')
  count = counts.pop() if counts else 0
  moments = bridge.adam_moments(params, optimizer)

  flat = {k: v.detach().cpu().numpy()
          for k, v in bridge.named_variables(model).items()}
  variables = {'params': bridge.unflatten({k: flat[k] for k in params})}
  for name in set(flat) - set(params):
    collection, rest = name.split('/', 1)
    variables.setdefault(collection, {}).update(
        bridge.unflatten({rest: flat[name]}))
  jax_state, _ = jax_train_lib.create_optimizer(jax_configs.Config(),
                                                variables)

  def fill(path, leaf):
    keys = [_key(k) for k in path]
    if keys[-1] == 'count':
      return np.asarray(count, np.asarray(leaf).dtype)
    for field in ('mu', 'nu'):
      if field in keys:
        value = {'params': moments[field]}  # Adam's 'params' collection.
        for k in keys[keys.index(field) + 1:]:
          value = value[k]
        return np.asarray(value, np.float32)
    return leaf

  opt_state = jax.tree_util.tree_map_with_path(fill, jax_state.opt_state)
  jax_state = jax_state.replace(step=np.int32(state.step),
                                opt_state=opt_state)
  out = jax_checkpoints.CheckpointManager(dst)
  out.save(ckpt_step, jax_state)
  out.wait_until_finished()
  out.close()
  return ckpt_step


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--direction', required=True,
                      choices=('jax-to-torch', 'torch-to-jax'))
  parser.add_argument('--src', required=True,
                      help='The checkpoint directory to read.')
  parser.add_argument('--dst', required=True,
                      help='The checkpoint directory to write.')
  configs.add_common_flags(parser)
  args = parser.parse_args(argv)
  config = configs.load_config(args)
  convert = jax_to_torch if args.direction == 'jax-to-torch' else torch_to_jax
  step = convert(args.src, args.dst, config)
  print(f'Converted the checkpoint at step {step}: {args.src} -> {args.dst} '
        f'({args.direction}).')
  return step


if __name__ == '__main__':
  main()
