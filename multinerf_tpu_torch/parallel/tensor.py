"""Tensor parallelism of the wide NerfMLP layers (port of the model axis of
parallel/mesh.py: ``infer_tree_shardings`` and ``per_chip_bytes``).

JAX puts Megatron's layout on the parameter tree and lets GSPMD insert the
collectives around every layer, Pallas calls included.  The port splits
the tensors itself and makes the collectives explicit:

* ``infer_layout`` is JAX's rule: within each module, Dense kernels in
  numeric order pair column-parallel (fan_out split over the model group)
  then row-parallel (fan_in split); a dim is split only when it is >=
  ``min_dim_to_shard`` and divisible by the model size.
* ``storage_splits`` says how each rank stores its part of a leaf
  (``Split``).  A column layer's kernel [in, out / k] and, unlike JAX, its
  bias [out / k]: the bias's gradient is then whole on the rank that holds
  it.  A row layer's kernel [in / k, out], its bias replicated and added
  after the sum.  A row layer that takes ``[x, features]`` (the trunk's
  skip layer after a column layer) splits its x rows at the column
  partner's boundary and its feature rows by columns, packed flat into one
  contiguous tensor (``kind='skip'``), where JAX splits the concatenated
  rows in halves.  These are differences of storage only: ``gather`` gives
  the full leaf, and checkpoints hold full trees.
* The autograd Functions of Megatron: ``copy_to_model`` (identity forward,
  sum over the model group backward) in front of a column layer,
  ``reduce_from_model`` (sum forward, identity backward) after a row
  layer's partial product, ``gather_from_model`` (all-gather forward, this
  rank's slice backward) where a whole leaf or activation is needed, and
  ``scatter_to_model`` (this rank's slice forward, all-gather backward).
  Each one's backward is its dual's forward, so they differentiate twice
  (density normals).  Over a model group of one rank each is the
  identity.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from multinerf_tpu_torch.parallel import mesh

COLUMN, ROW, SKIP = 'column', 'row', 'skip'


def _layer_sort_key(name):
  """Sort flax auto-names numerically: Dense_2 before Dense_10."""
  head, _, tail = name.rpartition('_')
  if head and tail.isdigit():
    return (head, int(tail))
  return (name, -1)


def _shape(x):
  return tuple(x.shape) if hasattr(x, 'shape') else tuple(x)


def infer_layout(named_params, model_size, min_dim_to_shard=512):
  """{flax name: 'column' | 'row' | None} for every leaf of `named_params`
  ({flax name: tensor or shape}): infer_tree_shardings' Megatron rule, leaf
  for leaf (column is JAX's P(None, 'model'), row P('model', None), None
  replicated).  With model size 1 nothing is split."""
  shapes = {k: _shape(v) for k, v in named_params.items()}
  out = {k: None for k in shapes}
  if model_size <= 1:
    return out

  def splittable(dim):
    return dim >= min_dim_to_shard and dim % model_size == 0

  groups = {}
  for name, shape in shapes.items():
    parts = name.split('/')
    if len(shape) == 2 and len(parts) >= 2 and parts[-1] == 'kernel':
      groups.setdefault(tuple(parts[:-2]), []).append((parts[-2], name,
                                                       shape))
  for layers in groups.values():
    layers.sort(key=lambda item: _layer_sort_key(item[0]))
    prev_was_column = False
    for _, name, (fan_in, fan_out) in layers:
      if prev_was_column and splittable(fan_in):
        out[name] = ROW
        prev_was_column = False
      elif splittable(fan_out):
        out[name] = COLUMN
        prev_was_column = True
      else:
        prev_was_column = False
  return out


@dataclasses.dataclass(frozen=True)
class Split:
  """How a leaf of full shape `shape` is stored across a model group:
  'column' (its last dim split), 'row' (its first dim split) or 'skip' (a
  [x_rows + F, W] kernel: rows [0, x_rows) split as 'row', the feature rows
  split as 'column', the two parts packed flat)."""
  kind: str
  shape: Tuple[int, ...]
  x_rows: int = 0


def storage_splits(layout, shapes, skip_x_rows=None):
  """{flax name: Split} of every leaf a rank stores a part of, from
  infer_layout's `layout` and the leaves' full `shapes`: a column kernel
  and its bias; a row kernel, or a 'skip' kernel where `skip_x_rows`
  ({kernel name: rows of x before the features}) names it."""
  skip_x_rows = skip_x_rows or {}
  out = {}
  for name, kind in layout.items():
    if kind == COLUMN:
      out[name] = Split(COLUMN, tuple(shapes[name]))
      bias = name[:-len('kernel')] + 'bias'
      if bias in shapes:
        out[bias] = Split(COLUMN, tuple(shapes[bias]))
    elif kind == ROW and name in skip_x_rows:
      out[name] = Split(SKIP, tuple(shapes[name]), skip_x_rows[name])
    elif kind == ROW:
      out[name] = Split(ROW, tuple(shapes[name]))
  return out


def _cut(n, size, index):
  step = n // size
  return slice(index * step, (index + 1) * step)


def shard_of(full, split: Split, size: int, index: int):
  """Part `index` of `size` of the full leaf `full`, contiguous."""
  if split.kind == COLUMN:
    return full[..., _cut(full.shape[-1], size, index)].contiguous()
  if split.kind == ROW:
    return full[_cut(full.shape[0], size, index)].contiguous()
  x, feats = full[:split.x_rows], full[split.x_rows:]
  return torch.cat([x[_cut(split.x_rows, size, index)].reshape(-1),
                    feats[:, _cut(full.shape[1], size, index)].reshape(-1)])


def skip_parts(packed, split: Split, size: int):
  """A 'skip' shard -> (x rows [x_rows / k, W], feature columns
  [F, W / k]), contiguous views of it."""
  rows, width = split.shape
  x_rows, cols = split.x_rows // size, width // size
  n_x = x_rows * width
  return (packed[:n_x].view(x_rows, width),
          packed[n_x:].view(rows - split.x_rows, cols))


def assemble(parts, split: Split):
  """The full leaf from every rank's part, in model rank order."""
  if split.kind == COLUMN:
    return torch.cat(list(parts), dim=-1)
  if split.kind == ROW:
    return torch.cat(list(parts), dim=0)
  pieces = [skip_parts(p, split, len(parts)) for p in parts]
  return torch.cat([torch.cat([x for x, _ in pieces], dim=0),
                    torch.cat([f for _, f in pieces], dim=1)], dim=0)


def _gather_parts(shard, group):
  """[k, ...] every rank's `shard` of `group`, in rank order."""
  k = mesh.group_size(group)
  return mesh.all_gather_rows(shard.detach().contiguous()[None],
                              group).reshape((k,) + shard.shape)


def shard(full, name, layout):
  """This rank's part of the full leaf `full` named `name` under
  `layout` ({name: Split}): `full` itself where it is not split."""
  split = layout.get(name)
  if split is None:
    return full
  return shard_of(full, split, mesh.model_size(), mesh.model_rank())


def gather(part, name, layout):
  """The full leaf named `name` from this rank's `part` under `layout`,
  through one all-gather over the model group (every rank of it calls
  this); `part` itself where it is not split.  No gradient."""
  split = layout.get(name)
  if split is None:
    return part
  with torch.no_grad():
    return assemble(_gather_parts(part, mesh.model_group()), split)


def per_rank_bytes(named_params, optimizer=None):
  """The bytes this rank holds for `named_params` ({name: tensor}, shards
  where split) and, with `optimizer`, the optimizer's tensors of them
  (Adam's moments, which follow the parameters' shards)."""
  total = sum(p.numel() * p.element_size() for p in named_params.values())
  if optimizer is not None:
    for p in named_params.values():
      for v in optimizer.state.get(p, {}).values():
        if isinstance(v, torch.Tensor) and v.dim() > 0:
          total += v.numel() * v.element_size()
  return total


# --- Megatron's operators over the model group. -------------------------------


class _CopyToModel(torch.autograd.Function):
  """Identity forward; the sum over the model group backward."""

  @staticmethod
  def forward(ctx, x):
    return x.view_as(x)

  @staticmethod
  def backward(ctx, g):
    return _ReduceFromModel.apply(g)


class _ReduceFromModel(torch.autograd.Function):
  """The sum over the model group forward; identity backward."""

  @staticmethod
  def forward(ctx, x):
    return mesh.all_reduce_sum(x.contiguous().clone(), mesh.model_group())

  @staticmethod
  def backward(ctx, g):
    return _CopyToModel.apply(g)


class _GatherFromModel(torch.autograd.Function):
  """The full tensor from every rank's part forward; this rank's part of
  the (replicated) gradient backward."""

  @staticmethod
  def forward(ctx, part, split):
    ctx.split = split
    return assemble(_gather_parts(part, mesh.model_group()), split)

  @staticmethod
  def backward(ctx, g):
    return _ScatterToModel.apply(g, ctx.split), None


class _ScatterToModel(torch.autograd.Function):
  """This rank's part forward; the full gradient from every rank's part
  backward."""

  @staticmethod
  def forward(ctx, full, split):
    ctx.split = split
    return shard_of(full, split, mesh.model_size(), mesh.model_rank())

  @staticmethod
  def backward(ctx, g):
    return _GatherFromModel.apply(g, ctx.split), None


def _alone():
  return mesh.model_size() == 1


def copy_to_model(x):
  return x if _alone() else _CopyToModel.apply(x)


def reduce_from_model(x):
  return x if _alone() else _ReduceFromModel.apply(x)


def gather_from_model(part, split: Optional[Split]):
  """The full tensor of which `part` is this rank's part under `split`."""
  if split is None or _alone():
    return part
  return _GatherFromModel.apply(part, split)


def scatter_to_model(full, split: Optional[Split]):
  """This rank's part of the replicated `full` under `split`."""
  if split is None or _alone():
    return full
  return _ScatterToModel.apply(full, split)


def activation_split(width):
  """The Split of a [N, width] activation whose columns a column layer
  leaves on the model group's ranks."""
  return Split(COLUMN, (width,))


def splits_of(named: Dict[str, torch.Tensor]):
  """{name: Split} of the tensors of `named` that are a rank's part (each
  such parameter carries its Split as ``tp_split``)."""
  return {k: v.tp_split for k, v in named.items()
          if getattr(v, 'tp_split', None) is not None}


def whole_numel(named: Dict[str, torch.Tensor]):
  """The number of entries of the whole leaves of which `named` holds this
  rank's parts."""
  return sum(math.prod(v.tp_split.shape)
             if getattr(v, 'tp_split', None) is not None else v.numel()
             for v in named.values())
