"""Checkpoints of the port: ``checkpoint_<step>.pt`` files.

Each file holds ``{'step': int, 'params': {flax name: tensor}}``, the flax
names being the '/'-joined paths of the JAX parameter tree (see
``multinerf_tpu_torch.bridge``).  ``restore_latest`` keeps the contract of
``multinerf_tpu.utils.checkpoints.CheckpointManager.restore_latest``: the
state comes back unchanged when no checkpoint exists, and names present on
only one side keep the state's value or are dropped.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import re
from typing import Dict, Optional

import torch


@dataclasses.dataclass
class TrainState:
  """What a checkpoint restores: the step and the named parameters."""
  step: int
  params: Dict[str, torch.Tensor]


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

  def _path(self, step):
    return os.path.join(self._dir, f'checkpoint_{step}.pt')

  def latest_step(self) -> Optional[int]:
    steps = self._steps()
    return steps[-1] if steps else None

  def save(self, step: int, state: TrainState):
    """Write `state` at `step`, keeping the newest `keep` checkpoints."""
    tmp = self._path(step) + '.tmp'
    torch.save({'step': int(step),
                'params': {k: v.detach().cpu() for k, v in
                           state.params.items()}}, tmp)
    os.replace(tmp, self._path(step))
    for old in self._steps()[:-self._keep]:
      os.remove(self._path(old))

  def restore_latest(self, state: TrainState) -> TrainState:
    """The latest checkpoint grafted onto `state`; `state` if none."""
    step = self.latest_step()
    if step is None:
      return state
    saved = torch.load(self._path(step), map_location='cpu',
                       weights_only=True)
    params = {}
    for name, value in state.params.items():
      if name in saved['params']:
        params[name] = saved['params'][name].to(value.device, value.dtype)
      else:
        params[name] = value
    return TrainState(step=int(saved['step']), params=params)
