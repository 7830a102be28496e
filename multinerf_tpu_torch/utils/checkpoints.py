"""Checkpoints of the port: ``checkpoint_<step>.pt`` files.

Each file holds ``{'step': int, 'params': {flax name: tensor}}``, the flax
names being the '/'-joined paths of the JAX parameter tree (see
``multinerf_tpu_torch.bridge``), and, for a state that carries an
optimizer, ``'opt_state'``: its ``state_dict()`` with every tensor on the
CPU.  ``restore_latest`` keeps the contract of
``multinerf_tpu.utils.checkpoints.CheckpointManager.restore_latest``: the
state comes back unchanged when no checkpoint exists, and names present on
only one side keep the state's value or are dropped.  It restores the
parameters only; resuming the optimizer is not ported yet.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import re
from typing import Any, Dict, Optional

import torch


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


class CheckpointManager:
  """Save/restore-latest over ``checkpoint_<step>.pt`` in one directory."""

  def __init__(self, directory: str, keep: int = 100):
    self._dir = os.path.abspath(directory)
    self._keep = keep
    os.makedirs(self._dir, exist_ok=True)

  def _steps(self):
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
    steps = self._steps()
    return steps[-1] if steps else None

  def save(self, step: int, state: TrainState):
    """Write `state` at `step`, keeping the newest `keep` checkpoints."""
    tmp = self.path(step) + '.tmp'
    record = {'step': int(step), 'params': _to_cpu(state.params)}
    if state.optimizer is not None:
      record['opt_state'] = _to_cpu(state.optimizer.state_dict())
    torch.save(record, tmp)
    os.replace(tmp, self.path(step))
    for old in self._steps()[:-self._keep]:
      os.remove(self.path(old))

  def restore_latest(self, state: TrainState) -> TrainState:
    """The latest checkpoint grafted onto `state`; `state` if none."""
    step = self.latest_step()
    if step is None:
      return state
    saved = torch.load(self.path(step), map_location='cpu',
                       weights_only=True)
    params = {}
    for name, value in state.params.items():
      if name in saved['params']:
        params[name] = saved['params'][name].to(value.device, value.dtype)
      else:
        params[name] = value
    return TrainState(step=int(saved['step']), params=params)
