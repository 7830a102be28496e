"""Checkpoints of the port: ``checkpoint_<step>.pt`` files.

Each file holds ``{'step': int, 'params': {flax name: tensor}}``, the flax
names being the '/'-joined paths of the JAX parameter tree (see
``multinerf_tpu_torch.bridge``), and, for a state that carries an
optimizer, ``'opt_state'``: its ``state_dict()`` with every tensor on the
CPU.  ``restore_latest`` keeps the contract of
``multinerf_tpu.utils.checkpoints.CheckpointManager.restore_latest``: the
state comes back unchanged when no checkpoint exists, and names present on
only one side keep the state's value or are dropped.  It copies the saved
parameters into the state's own tensors (the model's parameters) and loads
the optimizer's state, Adam's per-parameter ``step`` included, so a resumed
run goes on with the same bias correction and learning-rate schedule.

Across ranks (``parallel/mesh.py``) rank 0 writes and prunes, a ``.tmp``
file renamed into place, and the others wait at a barrier; every rank
restores the file rank 0 found, and the restored parameters are checked
equal on every rank.  Under a model axis (``parallel/tensor.py``) a rank
holds its part of each split leaf (the parameter's ``tp_split``) and of its
Adam moments: every rank gathers them over its model group before rank 0
writes, so the file holds the whole tree of one process, and a restore
keeps each rank's part of the whole leaves; split leaves are checked equal
over the data group, the others over every rank.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import re
from typing import Any, Dict, Optional

import torch

from multinerf_tpu_torch.parallel import mesh
from multinerf_tpu_torch.parallel import tensor


@dataclasses.dataclass
class TrainState:
  """The step (updates applied so far), the named parameters and, while
  training, the optimizer that updates them."""
  step: int
  params: Dict[str, torch.Tensor]
  optimizer: Optional[torch.optim.Optimizer] = None


def _to_cpu(tree: Any) -> Any:
  if isinstance(tree, torch.Tensor):
    return tree.detach().cpu()
  if isinstance(tree, dict):
    return {k: _to_cpu(v) for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return type(tree)(_to_cpu(v) for v in tree)
  return tree


_MOMENTS = ('exp_avg', 'exp_avg_sq')


def _split_moments(state: 'TrainState', saved, fn):
  """`saved` (an optimizer state_dict of `state.optimizer`'s parameters)
  with `fn(moment, name, splits)` (tensor.shard or tensor.gather) in place
  of the Adam moments of every parameter that is a rank's part of a split
  leaf."""
  splits = tensor.splits_of(state.params)
  names = {id(p): k for k, p in state.params.items()}
  params = [p for group in state.optimizer.param_groups
            for p in group['params']]
  for i, moments in saved['state'].items():
    name = names[id(params[i])]
    if name in splits:
      saved['state'][i] = {k: fn(v, name, splits) if k in _MOMENTS else v
                           for k, v in moments.items()}
  return saved


def whole_state(state: 'TrainState'):
  """(params, optimizer state_dict or None) of `state` with every split
  leaf and its Adam moments gathered over the model group: one process's
  tree.  Every rank calls it."""
  splits = tensor.splits_of(state.params)
  params = {k: tensor.gather(v, k, splits) for k, v in state.params.items()}
  opt_state = None
  if state.optimizer is not None:
    opt_state = _split_moments(state, state.optimizer.state_dict(),
                               tensor.gather)
  return params, opt_state


class CheckpointManager:
  """Save/restore-latest over ``checkpoint_<step>.pt`` in one directory."""

  def __init__(self, directory: str, keep: int = 100):
    self._dir = os.path.abspath(directory)
    self._keep = keep
    if mesh.is_main():
      os.makedirs(self._dir, exist_ok=True)

  def steps(self):
    """The steps of the checkpoints in the directory, ascending."""
    steps = []
    for path in glob.glob(os.path.join(self._dir, 'checkpoint_*.pt')):
      m = re.fullmatch(r'checkpoint_(\d+)\.pt', os.path.basename(path))
      if m:
        steps.append(int(m.group(1)))
    return sorted(steps)

  def path(self, step):
    """The file of the checkpoint at `step`."""
    return os.path.join(self._dir, f'checkpoint_{step}.pt')

  def latest_step(self) -> Optional[int]:
    steps = self.steps()
    return steps[-1] if steps else None

  def save(self, step: int, state: TrainState):
    """Write `state` as the checkpoint of `step`, keeping the newest `keep`
    checkpoints: on rank 0, while the other ranks wait (after gathering
    the split leaves with it)."""
    params, opt_state = whole_state(state)
    if mesh.is_main():
      tmp = self.path(step) + '.tmp'
      # The record keeps the state's own step: the final save of a run that
      # exits early is named after max_steps (train.py:437-438).
      record = {'step': int(state.step), 'params': _to_cpu(params)}
      if opt_state is not None:
        record['opt_state'] = _to_cpu(opt_state)
      torch.save(record, tmp)
      os.replace(tmp, self.path(step))
      for old in self.steps()[:-self._keep]:
        os.remove(self.path(old))
    mesh.barrier()

  def restore_latest(self, state: TrainState) -> TrainState:
    """The latest checkpoint loaded into `state`; `state` if none.

    The saved parameters are copied into `state.params`' tensors in place,
    and the saved optimizer state, when both sides have one, into
    `state.optimizer` (its tensors moved to the parameters' device).
    """
    latest = self.latest_step()
    step = mesh.main_value(-1 if latest is None else latest)
    if step < 0:
      return state
    saved = torch.load(self.path(step), map_location='cpu',
                       weights_only=True)
    splits = tensor.splits_of(state.params)
    with torch.no_grad():
      for name, value in state.params.items():
        if name in saved['params']:
          value.copy_(tensor.shard(saved['params'][name], name, splits))
    assert_replicated(state.params, 'restored parameters')
    if state.optimizer is not None and 'opt_state' in saved:
      state.optimizer.load_state_dict(
          _split_moments(state, saved['opt_state'], tensor.shard))
    return TrainState(step=int(saved['step']), params=state.params,
                      optimizer=state.optimizer)


def assert_replicated(params, what='parameters'):
  """Raise unless the ranks hold the same `params` ({name: tensor}): the
  leaves whole on every rank over all ranks, a rank's parts of split leaves
  over its data group (the ranks that hold the same part)."""
  splits = tensor.splits_of(params)
  mesh.assert_replicated({k: v for k, v in params.items() if k not in splits},
                         what)
  mesh.assert_replicated({k: v for k, v in params.items() if k in splits},
                         what, mesh.data_group())
