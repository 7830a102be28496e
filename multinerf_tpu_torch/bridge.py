"""Parameter bridge between the JAX package's flax tree and the port.

The port's modules register their parameters under the flax names and in
the flax layout (``NerfMLP_0/Dense_0/kernel`` is [in, out]), so the bridge
is a renaming: the flax path joined with '/' is the checkpoint name, and
joined with '.' the PyTorch ``state_dict`` key.  No transposes.  The
Model's embedding tables keep flax's names too: ``Embed_0/embedding``
(GLO) and ``exposure_scaling_offsets/embedding`` (RawNeRF).  The occupancy
grid, a buffer, keeps the name of its flax collection, ``occupancy/grid``.
Under a model axis (``parallel/tensor.py``) a model holds each rank's part
of its split leaves: loading keeps this rank's part of each whole leaf, and
``jax_params`` gathers them, so whole trees go in and come out.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from multinerf_tpu_torch.parallel import tensor


def flatten(tree: Dict[str, Any], prefix: str = '') -> Dict[str, Any]:
  """Nested dicts of arrays -> {'A/B/kernel': array} (leaves unchanged)."""
  flat = {}
  for key, value in tree.items():
    name = f'{prefix}{key}'
    if isinstance(value, dict) or hasattr(value, 'items'):
      flat.update(flatten(dict(value.items()), f'{name}/'))
    else:
      flat[name] = value
  return flat


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
  """{'A/B/kernel': array} -> nested dicts."""
  tree = {}
  for name, value in flat.items():
    node = tree
    *parents, leaf = name.split('/')
    for p in parents:
      node = node.setdefault(p, {})
    node[leaf] = value
  return tree


def named_parameters(model: torch.nn.Module) -> Dict[str, torch.nn.Parameter]:
  """The model's ``nn.Parameter``s (which carry ``.grad``) under their flax
  names, in the order of ``model.parameters()``."""
  return {k.replace('.', '/'): v for k, v in model.named_parameters()}


def named_variables(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
  """The parameters, then the buffers (the occupancy grid), under their
  flax names: what a checkpoint holds, as JAX's ``state.params`` holds
  every collection."""
  out = named_parameters(model)
  out.update({k.replace('.', '/'): v for k, v in model.named_buffers()})
  return out


def to_jax_tree(flat: Dict[str, Any]) -> Dict[str, Any]:
  """{'A/B/kernel': tensor} (parameters, gradients, updates) -> the nested
  numpy tree of the JAX package, e.g. to hold against a flax gradient."""
  return unflatten({k: v.detach().cpu().numpy() for k, v in flat.items()})


def adam_moments(params: Dict[str, torch.nn.Parameter],
                 optimizer: torch.optim.Optimizer):
  """optax's ScaleByAdamState fields of a torch Adam over `params` ({flax
  name: parameter}): {'mu': tree, 'nu': tree} of numpy arrays (zeros
  before the first update)."""
  out = {'mu': {}, 'nu': {}}
  for name, p in params.items():
    state = optimizer.state.get(p, {})
    for key, field in (('mu', 'exp_avg'), ('nu', 'exp_avg_sq')):
      out[key][name] = state.get(field, torch.zeros_like(p))
  return {k: to_jax_tree(v) for k, v in out.items()}


def load_flat(model: torch.nn.Module, flat: Dict[str, Any]):
  """Copy {'A/B/kernel': array} of whole leaves into the model (this
  rank's part of each split leaf); names and shapes must match its
  parameters exactly."""
  splits = tensor.splits_of(named_parameters(model))
  state = {k.replace('/', '.'): tensor.shard(
      v if isinstance(v, torch.Tensor) else torch.tensor(np.asarray(v)), k,
      splits) for k, v in flat.items()}
  model.load_state_dict(state, strict=True)


def load_jax_params(model: torch.nn.Module, params: Dict[str, Any]):
  """Load a JAX parameter tree (nested dicts of arrays, e.g.
  ``variables['params']``) into the port's model."""
  load_flat(model, flatten(params))


def load_jax_variables(model: torch.nn.Module, variables: Dict[str, Any]):
  """Load JAX variables ({'params': tree, 'occupancy': {'grid': ...}})
  into the port's model: every collection under its own name."""
  flat = flatten(variables['params'])
  for collection, tree in variables.items():
    if collection != 'params':
      flat.update(flatten(tree, f'{collection}/'))
  load_flat(model, flat)


def jax_params(model: torch.nn.Module) -> Dict[str, Any]:
  """The model's parameters as a JAX-style tree of numpy arrays (split
  leaves gathered over the model group: every rank of it calls this)."""
  params = named_parameters(model)
  splits = tensor.splits_of(params)
  return to_jax_tree({k: tensor.gather(v, k, splits)
                      for k, v in params.items()})
