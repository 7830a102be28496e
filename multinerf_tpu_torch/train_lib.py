"""Model setup and the render function (port of parts of train_lib.py).

Only ``create_render_fn`` (train_lib.py:447) and the model/parameter part
of ``setup_model`` (train_lib.py:480) are ported; the optimizer and the
train step come with the training port.
"""

from __future__ import annotations

import torch

from multinerf_tpu_torch import bridge
from multinerf_tpu_torch.models import nerf as nerf_lib
from multinerf_tpu_torch.utils import checkpoints


def create_render_fn(model):
  """(train_frac, rays) -> (renderings, ray_history), deterministic, with
  the extras, under ``torch.inference_mode``."""

  def render_eval_fn(train_frac, rays):
    with torch.inference_mode():
      return model(rays, train_frac=train_frac, compute_extras=True)

  return render_eval_fn


def setup_model(config, seed, device):
  """(model, state, render_eval_fn): the gin-configured Model with weights
  drawn from torch.Generator(seed), its TrainState at step 0 (parameters
  shared with the model) and its render function."""
  generator = torch.Generator().manual_seed(seed)
  model = nerf_lib.construct_model(config, generator, device)
  model.eval()
  state = checkpoints.TrainState(step=0, params=bridge.named_params(model))
  return model, state, create_render_fn(model)
